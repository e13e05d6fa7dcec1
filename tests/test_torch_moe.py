"""Parity of the PyTorch port's MoE stage with the JAX reference (CPU).

Same inputs, drawn with numpy from a seed, go through the reference
function and its port: ``route`` (with ``k_budget``), the sort plan and
dispatch, the plain versions of the ``moe_gmm`` and ``moe_decode`` kernels
(against the Pallas kernels in interpret mode and the reference's oracles),
and the ``moe`` layer under ``gmm`` and ``decode``.  The CUDA kernels
themselves are held against their plain versions by the card-only tests
at the end (and by ``chip_smoke.py``).

Tolerance: f32 throughout; products are summed in a different order by
XLA and by PyTorch, so outputs of O(1) agree to ``rtol=atol=1e-5`` unless a
test states otherwise.  Index outputs (top-k ids, sort plans) are equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: F401,E402


TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(**kw):
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    base = dict(moe_impl="gmm", **kw)
    return (jget("olmoe-1b-7b").reduced().with_(**base),
            tget("olmoe-1b-7b").reduced().with_(**base))


def _moe_params(cfg_j, seed=0):
    """The reference's MoE layer init -> (jax params, torch params)."""
    import jax
    from repro.models.moe import init_moe
    pj = init_moe(jax.random.PRNGKey(seed), cfg_j)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    return pj, pt


def _x(t, d, seed=0):
    return np.random.default_rng(seed).normal(size=(t, d)).astype(np.float32)


# --------------------------------------------------------------------------- #
# Router
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("router,norm,tau,budget", [
    ("softmax", False, 0.0, False),
    ("softmax", True, 0.0, True),       # k_budget zeroes before renorm
    ("sigmoid", True, 0.0, False),
    ("softmax", False, 0.3, True),      # NAEE dynamic skipping
])
def test_route_matches_reference(router, norm, tau, budget):
    import jax.numpy as jnp
    from repro.models.moe import route as jroute
    from repro_torch.models.moe import route as troute
    cfg_j, cfg_t = _cfgs(router_type=router, norm_topk_prob=norm,
                         dynamic_skip_tau=tau, moe_top_k=4)
    pj, pt = _moe_params(cfg_j)
    x = _x(32, cfg_j.d_model)
    kb = (np.random.default_rng(1).integers(1, 5, 32).astype(np.int32)
          if budget else None)
    wj, ij, aj = jroute(pj, cfg_j, jnp.asarray(x), 4,
                        k_budget=None if kb is None else jnp.asarray(kb))
    wt, it, at = troute(pt, cfg_t, torch.from_numpy(x), 4,
                        k_budget=None if kb is None else torch.from_numpy(kb))
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    np.testing.assert_allclose(np.asarray(wj), wt.numpy(), **TOL)
    np.testing.assert_allclose(float(aj), float(at), **TOL)
    if kb is not None:      # surplus slots carry exactly zero weight
        slot = np.arange(4)[None]
        assert (wt.numpy()[slot >= kb[:, None]] == 0.0).all()


# --------------------------------------------------------------------------- #
# Sort plan + dispatch
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("t,k,e,bm", [(1, 2, 8, 8), (5, 2, 8, 1),
                                      (64, 4, 8, 16), (33, 3, 6, 8)])
def test_sort_plan_and_dispatch_match_reference(t, k, e, bm):
    import jax.numpy as jnp
    from repro.models.moe import make_sort_plan as jplan, \
        sort_combine as jcomb, sort_dispatch as jdisp
    from repro_torch.models.moe import make_sort_plan as tplan, \
        sort_combine as tcomb, sort_dispatch as tdisp
    rng = np.random.default_rng(t * 7 + k)
    # expert 0 is never routed: an empty group at the start
    idx = np.stack([rng.permutation(np.arange(1, e))[:k]
                    for _ in range(t)]).astype(np.int32)
    pj = jplan(jnp.asarray(idx), e, bm)
    pt = tplan(torch.from_numpy(idx), e, bm)
    for name in ("dest", "group_sizes", "padded_group_sizes",
                 "tile_expert", "tile_valid"):
        np.testing.assert_array_equal(np.asarray(getattr(pj, name)),
                                      getattr(pt, name).numpy(), err_msg=name)
    assert (pj.block_m, pj.num_rows) == (pt.block_m, pt.num_rows)
    x = _x(t, 16)
    xs_j = jdisp(jnp.asarray(x), pj, k)
    xs_t = tdisp(torch.from_numpy(x), pt, k)
    np.testing.assert_array_equal(np.asarray(xs_j), xs_t.numpy())
    w = rng.random((t, k)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(jcomb(xs_j, jnp.asarray(w), pj)),
                               tcomb(xs_t, torch.from_numpy(w), pt).numpy(),
                               **TOL)


@pytest.mark.parametrize("n,floor", [(1, 1), (3, 1), (5, 8), (9, 8),
                                     (4096, 8)])
def test_default_block_m_matches_reference(n, floor):
    from repro.models.moe import default_block_m as jbm
    from repro_torch.models.moe import default_block_m as tbm
    assert jbm(n, floor=floor) == tbm(n, floor=floor)


# --------------------------------------------------------------------------- #
# Plain kernel versions vs the Pallas kernels (interpret mode) and oracles
# --------------------------------------------------------------------------- #


def _gmm_case(t, k, e, d, f, bm, seed):
    from repro_torch.models.moe import make_sort_plan, sort_dispatch
    rng = np.random.default_rng(seed)
    # the last expert is never routed: an empty group
    idx = np.stack([rng.permutation(e - 1)[:k] for _ in range(t)]).astype(np.int32)
    plan = make_sort_plan(torch.from_numpy(idx), e, bm)
    xs = sort_dispatch(torch.from_numpy(_x(t, d, seed)), plan, k)
    w1 = (rng.normal(size=(e, d, 2 * f)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(e, f, d)) * 0.1).astype(np.float32)
    return plan, xs, w1, w2


@pytest.mark.parametrize("t,k,e,bm", [(1, 2, 8, 8), (12, 2, 8, 8),
                                      (40, 3, 6, 16)])
def test_moe_gmm_plain_matches_pallas_and_ref(t, k, e, bm):
    import jax.numpy as jnp
    from repro.kernels import ref
    from repro.kernels.moe_gmm import moe_gmm_pallas
    from repro_torch.kernels import moe_gmm
    d, f = 32, 24
    plan, xs, w1, w2 = _gmm_case(t, k, e, d, f, bm, seed=t + e)
    got = moe_gmm(xs, torch.from_numpy(w1), torch.from_numpy(w2),
                  plan.tile_expert, plan.tile_valid, block_m=bm).numpy()
    want = moe_gmm_pallas(jnp.asarray(xs.numpy()), jnp.asarray(w1),
                          jnp.asarray(w2), jnp.asarray(plan.tile_expert.numpy()),
                          jnp.asarray(plan.tile_valid.numpy()), block_m=bm,
                          block_f=8, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    # the oracle takes group sizes over the *padded* layout: one group per
    # expert, covering its padded rows (padding rows are zero either way)
    oracle = ref.moe_gmm_ref(jnp.asarray(xs.numpy()), jnp.asarray(w1),
                             jnp.asarray(w2),
                             jnp.asarray(plan.padded_group_sizes.numpy()))
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)


@pytest.mark.parametrize("b,k,e", [(1, 2, 8), (8, 4, 8), (5, 1, 3)])
def test_moe_decode_plain_matches_pallas(b, k, e):
    import jax.numpy as jnp
    from repro.kernels import ref
    from repro.kernels.moe_decode import moe_decode_pallas
    from repro_torch.kernels import moe_decode
    d, f = 32, 48
    rng = np.random.default_rng(b * 13 + k)
    x = _x(b, d, b)
    w1 = (rng.normal(size=(e, d, 2 * f)) * 0.05).astype(np.float32)
    w2 = (rng.normal(size=(e, f, d)) * 0.05).astype(np.float32)
    idx = rng.integers(0, e, size=(b, k)).astype(np.int32)
    w = rng.random((b, k)).astype(np.float32)
    w[0, -1] = 0.0                      # a zero weight adds exactly nothing
    got = moe_decode(*map(torch.from_numpy, (x, w1, w2, idx, w))).numpy()
    want = moe_decode_pallas(*map(jnp.asarray, (x, w1, w2, idx, w)),
                             block_f=16, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(got, ref.moe_decode_ref(x, w1, w2, idx, w),
                               **TOL)


def test_moe_decode_plain_matches_pallas_at_ragged_f():
    """F 96: the Pallas kernel halves block_f 64 to 32 to divide it; the
    CUDA kernel masks its last 64-column block (on-card tests below)."""
    import jax.numpy as jnp
    from repro.kernels import ref
    from repro.kernels.moe_decode import moe_decode_pallas
    from repro_torch.kernels import moe_decode
    b, k, e, d, f = 4, 3, 6, 64, 96
    rng = np.random.default_rng(96)
    x = _x(b, d, 9)
    w1 = (rng.normal(size=(e, d, 2 * f)) * 0.05).astype(np.float32)
    w2 = (rng.normal(size=(e, f, d)) * 0.05).astype(np.float32)
    idx = rng.integers(0, e, size=(b, k)).astype(np.int32)
    w = rng.random((b, k)).astype(np.float32)
    got = moe_decode(*map(torch.from_numpy, (x, w1, w2, idx, w))).numpy()
    want = moe_decode_pallas(*map(jnp.asarray, (x, w1, w2, idx, w)),
                             block_f=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(got, ref.moe_decode_ref(x, w1, w2, idx, w),
                               **TOL)


# --------------------------------------------------------------------------- #
# The MoE layer
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("impl,t,use_kernel", [("gmm", 24, False),
                                               ("gmm", 24, True),
                                               ("decode", 4, True),
                                               ("decode", 4, False)])
def test_moe_layer_matches_reference(impl, t, use_kernel):
    import jax.numpy as jnp
    from repro.models.moe import moe as jmoe
    from repro_torch.models.moe import moe as tmoe
    cfg_j, cfg_t = _cfgs()
    pj, pt = _moe_params(cfg_j, seed=3)
    x = _x(t, cfg_j.d_model, 5).reshape(2, t // 2, -1)
    yj, aj = jmoe(pj, cfg_j, jnp.asarray(x), 2, impl=impl)
    yt, at = tmoe(pt, cfg_t, torch.from_numpy(x), 2, impl=impl,
                  use_kernel=use_kernel)
    np.testing.assert_allclose(np.asarray(yj), yt.numpy(), **TOL)
    np.testing.assert_allclose(float(aj), float(at), **TOL)


def test_decode_reroute_and_unported_impls():
    from repro_torch.models.moe import DECODE_TOKEN_THRESHOLD, moe, \
        moe_dense, resolve_impl
    assert resolve_impl("gmm", DECODE_TOKEN_THRESHOLD, True) == "decode"
    assert resolve_impl("gmm", DECODE_TOKEN_THRESHOLD + 1, True) == "gmm"
    assert resolve_impl("gmm", 1, False) == "gmm"
    # dense can drop copies past capacity: never rerouted
    assert resolve_impl("dense", 1, True) == "dense"
    cfg_j, cfg_t = _cfgs()
    _, pt = _moe_params(cfg_j)
    x = torch.from_numpy(_x(4, cfg_t.d_model)).reshape(1, 4, -1)
    y, aux = moe(pt, cfg_t, x, 2, impl="dense", decode_kernel=True)
    y2, aux2 = moe_dense(pt, cfg_t, x[0], 2)
    assert torch.equal(y[0], y2) and torch.equal(aux, aux2)
    # the expert-parallel impls with no mesh run dense (the reference's
    # single-device fallback), bf16 experts only, no k budget
    for impl in ("ep_a2a", "ep_psum"):
        y3, aux3 = moe(pt, cfg_t, x, 2, impl=impl)
        assert torch.equal(y3, y) and torch.equal(aux3, aux)
        with pytest.raises(ValueError, match="bf16"):
            moe(pt, cfg_t, x, 2, impl=impl, expert_dtype="int8",
                mesh=object())
        with pytest.raises(ValueError, match="k budget"):
            moe(pt, cfg_t, x, 2, impl=impl, mesh=object(),
                k_budget=torch.ones(4, dtype=torch.int32))


# --------------------------------------------------------------------------- #
# CUDA kernels vs their plain versions (need the card)
# --------------------------------------------------------------------------- #

BF16_TOL = 2e-2     # of max |plain|: f32 sums in another order, bf16 output


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present, decided when the
    test runs (never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a GPU")


def _close(got, want):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= BF16_TOL * want.float().abs().max().item()


@pytest.mark.parametrize("t,k,bm,f,d", [(1, 2, 8, 128, 128),
                                        (37, 4, 40, 128, 128),
                                        (512, 8, 128, 128, 128),
                                        (37, 4, 40, 96, 128),
                                        (64, 6, 64, 1056, 128),
                                        (37, 4, 40, 96, 192)])  # D % 128
def test_moe_gmm_kernel_matches_plain_on_card(card, t, k, bm, f, d):
    from repro_torch.kernels import moe_gmm
    from repro_torch.kernels.moe_gmm import moe_gmm_plain
    plan, xs, w1, w2 = _gmm_case(t, k, 16, d, f, bm, seed=t)
    args = [a.cuda() for a in (xs.bfloat16(), torch.from_numpy(w1).bfloat16(),
                               torch.from_numpy(w2).bfloat16(),
                               plan.tile_expert, plan.tile_valid)]
    before = moe_gmm.launches
    _close(moe_gmm(*args, block_m=bm), moe_gmm_plain(*args, bm))
    assert moe_gmm.launches == before + 1


@pytest.mark.parametrize("t,k,bm,f", [(5, 2, 8, 1024), (37, 4, 40, 1024),
                                      (512, 8, 128, 1024),
                                      (200, 6, 128, 1056)])
def test_moe_gmm_kernel_full_width_on_card(card, t, k, bm, f):
    """At the served width (D 2048): one weight tile feeds both 64-row
    halves of a row tile, tiles shorter than 64 rows leave a warpgroup
    idle, F 1056 ends in a part-filled box; expert 7 gets no rows and the
    buffer ends in dead tiles, which must come out zero."""
    from repro_torch.kernels import moe_gmm
    from repro_torch.kernels.moe_gmm import moe_gmm_plain
    from repro_torch.models.moe import make_sort_plan, sort_dispatch
    e, d = 16, 2048
    g = torch.Generator(device="cuda").manual_seed(t + bm)
    idx = torch.randint(0, e - 1, (t, k), generator=g, device="cuda")
    idx = torch.where(idx == 7, e - 1, idx).int()
    plan = make_sort_plan(idx, e, bm)
    x = torch.randn(t, d, generator=g, device="cuda").bfloat16()
    w1 = (torch.randn(e, d, 2 * f, generator=g, device="cuda") * 0.02).bfloat16()
    w2 = (torch.randn(e, f, d, generator=g, device="cuda") * 0.02).bfloat16()
    args = (sort_dispatch(x, plan, k), w1, w2, plan.tile_expert,
            plan.tile_valid)
    got = moe_gmm(*args, block_m=bm)
    _close(got, moe_gmm_plain(*args, bm))
    dead = ~plan.tile_valid.bool()
    assert dead.any()
    assert (got.reshape(-1, bm, d)[dead] == 0).all()


@pytest.mark.parametrize("b,k,f", [(1, 1, 192), (8, 8, 192), (3, 2, 192),
                                   (8, 8, 96), (8, 6, 1056)])
def test_moe_decode_kernel_matches_plain_on_card(card, b, k, f):
    from repro_torch.kernels import moe_decode
    from repro_torch.kernels.moe_decode import moe_decode_plain
    e, d = 16, 128
    g = torch.Generator(device="cuda").manual_seed(b + k)
    x = torch.randn(b, d, generator=g, device="cuda").bfloat16()
    w1 = (torch.randn(e, d, 2 * f, generator=g, device="cuda") * 0.1).bfloat16()
    w2 = (torch.randn(e, f, d, generator=g, device="cuda") * 0.1).bfloat16()
    idx = torch.randint(0, e, (b, k), generator=g, device="cuda").int()
    w = torch.rand(b, k, generator=g, device="cuda")
    _close(moe_decode(x, w1, w2, idx, w), moe_decode_plain(x, w1, w2, idx, w))


def _decode_routing(kind, b, k, e, g):
    """idx [b, k]: "random" (repeats within and across tokens), "repeat"
    (k distinct experts a token from 2k, so experts repeat across tokens),
    "one" (every token's first slot on expert 0, the rest distinct) or
    "same" (every slot of every token on expert 5: more than the 8 slots a
    pass over the weights serves)."""
    if kind == "random":
        return torch.randint(0, e, (b, k), generator=g, device="cuda").int()
    if kind == "same":
        return torch.full((b, k), 5, device="cuda", dtype=torch.int32)
    lo = 1 if kind == "one" else 0
    pool = min(e - lo, 2 * k)
    idx = torch.stack([lo + torch.randperm(pool, generator=g, device="cuda")[:k]
                       for _ in range(b)])
    if kind == "one":
        idx[:, 0] = 0
    return idx.int()


@pytest.mark.parametrize("b,k,f,e,kind", [(8, 8, 1024, 16, "repeat"),
                                          (16, 8, 1024, 16, "repeat"),
                                          (16, 8, 1056, 16, "one"),
                                          (3, 6, 1056, 16, "repeat"),
                                          (16, 2, 1024, 16, "one"),
                                          (2, 8, 1024, 16, "same"),
                                          (1, 8, 1408, 16, "repeat"),
                                          (5, 8, 1024, 40, "random")])
def test_moe_decode_kernel_groups_slots_on_card(card, b, k, f, e, kind):
    """At the served width (D 2048), the slots of one expert served
    together: experts repeated across tokens, every token on one expert,
    every slot on one expert (more than one pass of 8), fewer slots than
    experts, 40 experts, B up to 16, F 1056 and 1408.
    Held to the plain version; each row's output bitwise the same
    computed alone; a slot whose weight is 0 adds exactly nothing,
    whichever expert it names; no host sync in the call."""
    from repro_torch.kernels import moe_decode
    from repro_torch.kernels.moe_decode import moe_decode_plain
    d = 2048
    g = torch.Generator(device="cuda").manual_seed(b * k + f)
    x = torch.randn(b, d, generator=g, device="cuda").bfloat16()
    w1 = (torch.randn(e, d, 2 * f, generator=g, device="cuda")
          * 0.02).bfloat16()
    w2 = (torch.randn(e, f, d, generator=g, device="cuda") * 0.02).bfloat16()
    idx = _decode_routing(kind, b, k, e, g)
    w = torch.rand(b, k, generator=g, device="cuda")
    w[:, -1] = 0                        # a k_budget-masked slot
    moe_decode(x, w1, w2, idx, w)       # builds the library
    torch.cuda.synchronize()
    before = moe_decode.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = moe_decode(x, w1, w2, idx, w)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert moe_decode.launches == before + 1
    _close(got, moe_decode_plain(x, w1, w2, idx, w))
    for i in range(b):                  # batch invariance
        alone = moe_decode(x[i:i + 1], w1, w2, idx[i:i + 1], w[i:i + 1])
        assert torch.equal(alone[0], got[i]), i
    moved = idx.clone()
    moved[:, -1] = (idx[:, -1] + 7) % e     # the zero-weight slot elsewhere
    assert torch.equal(moe_decode(x, w1, w2, moved, w), got)
