"""Parity of the PyTorch port's quantized experts with the JAX reference
(CPU): the int8 / int4 storage format (bit-equal quantization), the plain
versions of the ``moe_gmm_quant`` and ``moe_decode_quant`` kernels against
the Pallas kernels in interpret mode, the reference's jnp paths and its
numpy oracle, and the MoE layer under ``gmm`` and ``decode`` with
``expert_dtype``.  The CUDA kernels themselves are held against their
plain versions by the card-only tests at the end (and by
``chip_smoke.py``).

Inputs are drawn with numpy from a seed.  Quantized bytes and scales are
equal, not close.  Outputs are f32 and agree to ``TOL`` (as in
``test_torch_moe.py``): products over the same integer values and scales,
summed in another order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: F401,E402


TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = ("int8", "int4")


def _w(seed, lead, e, d, f, scale=0.1):
    rng = np.random.default_rng(seed)
    w1 = (rng.normal(size=(*lead, e, d, 2 * f)) * scale).astype(np.float32)
    w2 = (rng.normal(size=(*lead, e, f, d)) * scale).astype(np.float32)
    return w1, w2


def _quant_both(w1, w2, dtype):
    """The reference's and the port's quantization of the same weights."""
    import jax.numpy as jnp
    from repro.models.moe import quantize_experts as jq
    from repro_torch.models.moe import quantize_experts as tq
    qj = [np.asarray(a) for a in jq(jnp.asarray(w1), jnp.asarray(w2), dtype)]
    qt = tq(torch.from_numpy(w1), torch.from_numpy(w2), dtype)
    return qj, qt


def _equal_bytes(a: np.ndarray, b: torch.Tensor) -> bool:
    b = b.numpy()
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


# --------------------------------------------------------------------------- #
# (a) the storage format
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_experts_bit_equal_to_reference(dtype):
    from repro.models.moe import dequantize_experts as jdq
    from repro_torch.models.moe import dequantize_experts as tdq
    w1, w2 = _w(0, (3,), 4, 32, 24)          # a leading [L] layer dim
    w1[1, 2, :, 5] = 0.0                     # an all-zero gate channel
    w2[2, 0, 7, :] = 0.0                     # an all-zero down row
    qj, qt = _quant_both(w1, w2, dtype)
    for name, a, b in zip(("w1q", "w2q", "s1", "s2"), qj, qt):
        assert _equal_bytes(a, b), name
    dp = 16 if dtype == "int4" else 32
    assert tuple(qt[0].shape) == (3, 4, dp, 48)
    assert tuple(qt[1].shape) == (3, 4, 24, dp)
    assert float(qt[2][1, 2, 0, 5]) == pytest.approx(1e-12 / (
        127 if dtype == "int8" else 7))      # the eps guard, no 0/0
    dj = jdq(*map(__import__("jax").numpy.asarray, qj), dtype)
    dt = tdq(*qt, dtype)
    for a, b in zip(dj, dt):
        assert _equal_bytes(np.asarray(a), b)


def test_int4_pack_unpack_round_trip_blocked_halves():
    from repro_torch.models.moe import unpack_int4
    from repro_torch.models.moe.params import _pack_int4
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.integers(-8, 8, size=(3, 10, 6))).int()
    for dim in range(3):
        if q.shape[dim] % 2:
            continue
        p = _pack_int4(q, dim)
        assert p.dtype == torch.int8
        assert torch.equal(unpack_int4(p, dim), q)
    # blocked halves: byte i = element i (low) | element i + n/2 (high)
    p = _pack_int4(torch.tensor([1, -2, -8, 7]), 0)
    assert p.tolist() == [(-8 << 4) | 1, (7 << 4) | (-2 & 0xF)]


# --------------------------------------------------------------------------- #
# (b) moe_gmm_quant: plain version vs Pallas (interpret) and the jnp path
# --------------------------------------------------------------------------- #


def _gmm_quant_case(t, k, e, d, f, bm, dtype, seed):
    from repro_torch.models.moe import make_sort_plan, quantize_experts, \
        sort_dispatch
    rng = np.random.default_rng(seed)
    # the last expert is never routed: an empty group
    idx = np.stack([rng.permutation(e - 1)[:k]
                    for _ in range(t)]).astype(np.int32)
    plan = make_sort_plan(torch.from_numpy(idx), e, bm)
    x = rng.normal(size=(t, d)).astype(np.float32)
    xs = sort_dispatch(torch.from_numpy(x), plan, k)
    w1, w2 = _w(seed + 1, (), e, d, f)
    return plan, xs, quantize_experts(torch.from_numpy(w1),
                                      torch.from_numpy(w2), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,k,e,bm", [(1, 2, 8, 8), (12, 2, 8, 8),
                                      (40, 3, 6, 16)])
def test_moe_gmm_quant_plain_matches_pallas_and_jnp(dtype, t, k, e, bm):
    import jax.numpy as jnp
    from repro.kernels.moe_gmm import moe_gmm_quant_pallas
    from repro.models.moe import SortPlan as JPlan, grouped_ffn_quant
    from repro_torch.kernels import moe_gmm_quant
    d, f = 32, 24
    plan, xs, q = _gmm_quant_case(t, k, e, d, f, bm, dtype, seed=t + e)
    assert int(plan.tile_valid.sum()) < len(plan.tile_valid)   # dead tiles
    got = moe_gmm_quant(xs, *q, plan.tile_expert, plan.tile_valid,
                        dtype=dtype, block_m=bm).numpy()
    jq = [jnp.asarray(a.numpy()) for a in q]
    te, tv = (jnp.asarray(a.numpy()) for a in (plan.tile_expert,
                                               plan.tile_valid))
    want = moe_gmm_quant_pallas(jnp.asarray(xs.numpy()), *jq, te, tv,
                                dtype=dtype, block_m=bm, block_f=8,
                                interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    jplan = JPlan(*(jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor)
                    else v for v in plan))
    layer = dict(zip(("w1", "w2", "w1_scale", "w2_scale"), jq))
    jnp_path = grouped_ffn_quant(layer, jnp.asarray(xs.numpy()), jplan,
                                 expert_dtype=dtype)
    np.testing.assert_allclose(got, np.asarray(jnp_path), **TOL)
    dead = ~plan.tile_valid.bool().repeat_interleave(bm)
    assert (got[dead.numpy()] == 0).all()


# --------------------------------------------------------------------------- #
# (c) moe_decode_quant: plain version vs Pallas, jnp path and oracle
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,k,e", [(1, 2, 8), (6, 4, 8), (5, 3, 3)])
def test_moe_decode_quant_plain_matches_pallas_jnp_and_oracle(dtype, b, k, e):
    import jax.numpy as jnp
    from repro.kernels import ref
    from repro.kernels.moe_decode import moe_decode_quant_pallas, \
        moe_decode_routed_quant_jnp
    from repro_torch.kernels import moe_decode_quant
    from repro_torch.models.moe import quantize_experts
    d, f = 32, 48
    rng = np.random.default_rng(b * 13 + k)
    x = rng.normal(size=(b, d)).astype(np.float32)
    w1, w2 = _w(b + k, (), e, d, f, scale=0.05)
    idx = rng.integers(0, e, size=(b, k)).astype(np.int32)
    idx[0, 1] = idx[0, 0]                    # the same expert in two slots
    w = rng.random((b, k)).astype(np.float32)
    w[-1, -1] = 0.0                          # a zero weight adds nothing
    q = quantize_experts(torch.from_numpy(w1), torch.from_numpy(w2), dtype)
    got = moe_decode_quant(torch.from_numpy(x), *q, torch.from_numpy(idx),
                           torch.from_numpy(w), dtype=dtype).numpy()
    jargs = [jnp.asarray(a) for a in (x, *(t.numpy() for t in q), idx, w)]
    want = moe_decode_quant_pallas(*jargs, dtype=dtype, block_f=16,
                                   interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(moe_decode_routed_quant_jnp(*jargs, dtype=dtype)),
        **TOL)
    oracle = ref.moe_decode_quant_ref(x, *(t.numpy() for t in q), idx, w,
                                      dtype=dtype)
    np.testing.assert_allclose(got, oracle, **TOL)
    # the zero-weight slot is exactly absent
    w_drop = w.copy()
    idx_drop = idx.copy()
    idx_drop[-1, -1] = (idx[-1, -1] + 1) % e
    again = moe_decode_quant(torch.from_numpy(x), *q,
                             torch.from_numpy(idx_drop),
                             torch.from_numpy(w_drop), dtype=dtype).numpy()
    np.testing.assert_array_equal(again[-1], got[-1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["moe_gmm_quant", "moe_decode_quant"])
def test_quant_plain_versions_match_pallas_at_ragged_f(kernel, dtype):
    """F 96: the Pallas kernels halve block_f 64 to 32 to divide it; the
    CUDA kernels mask their last 64-column block (on-card tests below)."""
    import jax.numpy as jnp
    from repro.kernels.moe_decode import moe_decode_quant_pallas
    from repro.kernels.moe_gmm import moe_gmm_quant_pallas
    from repro_torch.kernels import moe_decode_quant, moe_gmm_quant
    d, f = 64, 96
    if kernel == "moe_gmm_quant":
        plan, xs, q = _gmm_quant_case(20, 2, 6, d, f, 8, dtype, seed=96)
        got = moe_gmm_quant(xs, *q, plan.tile_expert, plan.tile_valid,
                            dtype=dtype, block_m=8).numpy()
        want = moe_gmm_quant_pallas(
            *(jnp.asarray(a.numpy()) for a in (xs, *q, plan.tile_expert,
                                               plan.tile_valid)),
            dtype=dtype, block_m=8, block_f=64, interpret=True)
    else:
        from repro_torch.models.moe import quantize_experts
        rng = np.random.default_rng(97)
        x = rng.normal(size=(4, d)).astype(np.float32)
        w1, w2 = _w(98, (), 6, d, f, scale=0.05)
        idx = rng.integers(0, 6, size=(4, 3)).astype(np.int32)
        w = rng.random((4, 3)).astype(np.float32)
        q = quantize_experts(torch.from_numpy(w1), torch.from_numpy(w2),
                             dtype)
        got = moe_decode_quant(torch.from_numpy(x), *q,
                               torch.from_numpy(idx), torch.from_numpy(w),
                               dtype=dtype).numpy()
        want = moe_decode_quant_pallas(
            *(jnp.asarray(a) for a in (x, *(t.numpy() for t in q), idx, w)),
            dtype=dtype, block_f=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


# --------------------------------------------------------------------------- #
# (d) the MoE layer with expert_dtype, (e) errors, (f) quantize-at-load
# --------------------------------------------------------------------------- #


#: the other MoE families whose quantized experts are held to the
#: reference at ``.reduced()`` (llama4-scout: top-1 and a shared expert)
FAMILIES = ("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e")


def _cfgs(arch="olmoe-1b-7b"):
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    return (jget(arch).reduced().with_(moe_impl="gmm"),
            tget(arch).reduced().with_(moe_impl="gmm"))


def _quant_layers(cfg_j, dtype, seed=3):
    """The reference's MoE layer, quantized by the reference -> (jax
    layer, the same layer as torch tensors)."""
    import jax
    from repro.models.moe import init_moe, quantize_moe_layer
    pj = quantize_moe_layer(init_moe(jax.random.PRNGKey(seed), cfg_j), dtype)
    pt = jax.tree.map(lambda v: torch.from_numpy(np.array(v)), pj)
    return pj, pt


LAYER_CASES = [("gmm", 24, False), ("gmm", 24, True), ("decode", 4, True),
               ("decode", 4, False)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl,t,use_kernel", LAYER_CASES)
def test_moe_layer_quant_matches_reference(dtype, impl, t, use_kernel):
    _layer_quant_case("olmoe-1b-7b", dtype, impl, t, use_kernel)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl,t,use_kernel", LAYER_CASES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_moe_layer_quant_matches_reference_families(arch, dtype, impl, t,
                                                    use_kernel):
    _layer_quant_case(arch, dtype, impl, t, use_kernel)


def _layer_quant_case(arch, dtype, impl, t, use_kernel):
    import jax.numpy as jnp
    from repro.models.moe import moe as jmoe
    from repro_torch.models.moe import moe as tmoe
    cfg_j, cfg_t = _cfgs(arch)
    pj, pt = _quant_layers(cfg_j, dtype)
    x = np.random.default_rng(5).normal(
        size=(2, t // 2, cfg_j.d_model)).astype(np.float32)
    yj, aj = jmoe(pj, cfg_j, jnp.asarray(x), 2, impl=impl,
                  expert_dtype=dtype)
    yt, at = tmoe(pt, cfg_t, torch.from_numpy(x), 2, impl=impl,
                  use_kernel=use_kernel, expert_dtype=dtype)
    np.testing.assert_allclose(np.asarray(yj), yt.numpy(), **TOL)
    np.testing.assert_allclose(float(aj), float(at), **TOL)


def test_quant_errors():
    from repro_torch.models.moe import moe, quantize_moe_layer
    from repro_torch.models.moe.registry import _require_bf16
    cfg_j, cfg_t = _cfgs()
    _, pt = _quant_layers(cfg_j, "int8")
    raw = {k: v for k, v in pt.items() if not k.endswith("_scale")}
    x = torch.zeros(1, 2, cfg_t.d_model)
    for impl in ("gmm", "decode"):           # never quantized: a clear error
        with pytest.raises(ValueError, match="quantize_expert_params"):
            moe(raw, cfg_t, x, 2, impl=impl, expert_dtype="int8")
    for impl in ("dense", "ep_a2a", "ep_psum"):
        with pytest.raises(ValueError, match="bf16 expert weights only"):
            moe(pt, cfg_t, x, 2, impl=impl, expert_dtype="int4")
    with pytest.raises(ValueError, match="requires 'gmm' or 'decode'"):
        _require_bf16("dense", "int8")
    _require_bf16("dense", "bf16")
    with pytest.raises(ValueError, match="already quantized"):
        quantize_moe_layer(pt, "int8")


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_expert_params_matches_reference_and_shares(dtype):
    """Both routes across: the port's quantization of the converted
    params equals the converted reference-quantized params, bit for bit,
    and every non-expert tensor is the input's own."""
    _quantize_params_case("olmoe-1b-7b", dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_quantize_expert_params_matches_reference_families(arch, dtype):
    """The same at qwen3-moe's and llama4-scout's reduced configs (the
    shared expert stays full precision, the input's own)."""
    _quantize_params_case(arch, dtype)


def _quantize_params_case(arch, dtype):
    import jax
    from repro import models as jm
    from repro.models.moe import quantize_expert_params as jqp
    from repro_torch.convert import convert_params
    from repro_torch.models.moe import quantize_expert_params as tqp
    cfg_j, cfg_t = _cfgs(arch)
    pj = jm.init_params(jax.random.PRNGKey(2), cfg_j)
    pt = convert_params(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    qt = tqp(pt, cfg_t, dtype)
    qj = convert_params(jax.tree.map(np.asarray, jqp(pj, cfg_j, dtype)),
                        cfg_t, device="cpu")
    assert qt["embed"] is pt["embed"]
    for li, (lq, lp, lj) in enumerate(zip(qt["layers"], pt["layers"],
                                          qj["layers"])):
        assert lq["attn"] is lp["attn"] and lq["norm1"] is lp["norm1"]
        assert lq["moe"]["router"] is lp["moe"]["router"]
        assert lp["moe"]["w1"].dtype == torch.float32   # input untouched
        assert set(lq["moe"]) == set(lj["moe"])
        for key in ("w1", "w2", "w1_scale", "w2_scale", "router"):
            assert _equal_bytes(lj["moe"][key].numpy(), lq["moe"][key]), \
                (li, key)
        for key in set(lp["moe"]) - {"w1", "w2"}:     # shared experts
            assert lq["moe"][key] is lp["moe"][key], (li, key)


def _meta_decode_args(b, k, e, d, f, dtype):
    dp = d // 2 if dtype == "int4" else d
    meta = torch.device("meta")
    return (torch.empty((b, d), dtype=torch.bfloat16, device=meta),
            torch.empty((e, dp, 2 * f), dtype=torch.int8, device=meta),
            torch.empty((e, f, dp), dtype=torch.int8, device=meta),
            torch.empty((e, 2, f), device=meta),
            torch.empty((e, f), device=meta),
            torch.empty((b, k), dtype=torch.int32, device=meta),
            torch.empty((b, k), device=meta))


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_decode_quant_shared_memory_is_checked_before_launch(dtype):
    """The card route's checks, run on ``meta``: llama4-scout's experts
    (D 5120, F 8192) fit, since pass 2 stages 4096 h rows at a time; a
    shape whose pass would need more shared memory than a block may have
    is refused with the figure, before any launch."""
    from repro_torch.kernels import moe_decode_quant
    from repro_torch.kernels.moe_decode import SMEM_MAX, quant_smem
    s1, s2 = quant_smem(16, 5120, 8192, dtype)
    assert s2 == quant_smem(16, 5120, 4096, dtype)[1] <= SMEM_MAX
    assert s1 <= SMEM_MAX
    y = moe_decode_quant(*_meta_decode_args(8, 2, 16, 5120, 8192, dtype),
                         dtype=dtype)
    assert y.is_meta and tuple(y.shape) == (8, 5120)
    with pytest.raises(ValueError, match="pass 2 needs .* shared memory"):
        moe_decode_quant(*_meta_decode_args(4096, 8, 4, 2048, 8192, dtype),
                         dtype=dtype)
    with pytest.raises(ValueError, match="pass 1 needs .* shared memory"):
        moe_decode_quant(*_meta_decode_args(2, 1, 4, 16384, 64, dtype),
                         dtype=dtype)


# --------------------------------------------------------------------------- #
# CUDA kernels vs their plain versions (need the card)
# --------------------------------------------------------------------------- #

ROW_TOL = 1e-2      # per row, of its own norm: f32 sums in another order,
#                     bf16 output (and moe_gmm_quant's bf16 hidden)


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present, decided when the
    test runs (never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a GPU")


def _close_rows(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).norm(dim=-1)
    ref = want.norm(dim=-1)
    assert (err <= ROW_TOL * ref).all() and (err[ref == 0] == 0).all(), \
        (err / ref.clamp(min=1e-30)).max().item()


def _card_weights(e, d, f, dtype, seed, scale=0.1):
    from repro_torch.models.moe import quantize_experts
    g = torch.Generator(device="cuda").manual_seed(seed)
    w1 = (torch.randn(e, d, 2 * f, generator=g, device="cuda") * scale).bfloat16()
    w2 = (torch.randn(e, f, d, generator=g, device="cuda") * scale).bfloat16()
    # channels scaled apart, so that each has a scale of its own
    w1 = w1 * torch.exp(0.5 * torch.randn(e, 1, 2 * f, generator=g,
                                          device="cuda")).bfloat16()
    w2 = w2 * torch.exp(0.5 * torch.randn(e, f, 1, generator=g,
                                          device="cuda")).bfloat16()
    return g, quantize_experts(w1, w2, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,k,bm,f", [(1, 2, 8, 128), (37, 4, 40, 128),
                                      (512, 8, 128, 128), (37, 4, 40, 96),
                                      (64, 6, 64, 1056)])
def test_moe_gmm_quant_kernel_matches_plain_on_card(card, dtype, t, k, bm, f):
    from repro_torch.kernels import moe_gmm_quant
    from repro_torch.kernels.moe_gmm import moe_gmm_quant_plain
    from repro_torch.models.moe import make_sort_plan, sort_dispatch
    e, d = 16, 256
    g, q = _card_weights(e, d, f, dtype, t)
    idx = torch.stack([torch.randperm(e - 1, generator=g, device="cuda")[:k]
                       for _ in range(t)]).int()
    plan = make_sort_plan(idx, e, bm)
    x = torch.randn(t, d, generator=g, device="cuda").bfloat16()
    xs = sort_dispatch(x, plan, k)
    args = (xs, *q, plan.tile_expert, plan.tile_valid)
    before = moe_gmm_quant.launches
    got = moe_gmm_quant(*args, dtype=dtype, block_m=bm)
    assert moe_gmm_quant.launches == before + 1
    _close_rows(got, moe_gmm_quant_plain(*args, bm, dtype=dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,k,e,bm,f", [(512, 8, 64, 128, 1024),
                                        (200, 6, 16, 128, 1056),
                                        (100, 4, 16, 40, 1024),
                                        (512, 8, 128, 128, 1536),
                                        (256, 2, 16, 128, 8192)])
def test_moe_gmm_quant_kernel_full_width_on_card(card, dtype, t, k, e, bm, f):
    """At the served width (D 2048; 64 experts, 512 tokens x top-8 is the
    prefill check's shape): every token's first slot on expert 3, so that
    expert spans several row tiles; expert 7 gets no rows; two live tiles
    made dead between live ones, and the buffer's own dead tiles at its
    end -- all must come out zero; F 1056 ends in a part-filled box;
    qwen3-moe's experts (128, F 1536) and llama4-scout's F 8192."""
    from repro_torch.kernels import moe_gmm_quant
    from repro_torch.kernels.moe_gmm import moe_gmm_quant_plain
    from repro_torch.models.moe import make_sort_plan, sort_dispatch
    d = 2048
    g, q = _card_weights(e, d, f, dtype, t + bm, scale=0.02)
    idx = torch.stack([torch.randperm(e - 4, generator=g, device="cuda")[:k]
                       for _ in range(t)]) + 4
    idx[:, 0] = 3
    idx = torch.where(idx == 7, 1, idx).int()
    plan = make_sort_plan(idx, e, bm)
    tv = plan.tile_valid.clone()
    live = tv.nonzero().flatten()
    assert (plan.tile_expert[live] == 3).sum() >= 2     # several tiles
    tv[live[1]] = 0
    tv[live[len(live) // 2]] = 0
    x = torch.randn(t, d, generator=g, device="cuda").bfloat16()
    args = (sort_dispatch(x, plan, k), *q, plan.tile_expert, tv)
    got = moe_gmm_quant(*args, dtype=dtype, block_m=bm)
    _close_rows(got, moe_gmm_quant_plain(*args, bm, dtype=dtype))
    dead = ~tv.bool()
    assert (got.reshape(-1, bm, d)[dead] == 0).all()
    assert not (got.reshape(-1, bm, d)[tv.bool()] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,k,f", [(1, 1, 192), (8, 8, 192), (3, 2, 192),
                                   (8, 8, 96), (8, 6, 1056), (8, 8, 1536),
                                   (8, 2, 8192), (3, 1, 8192)])
def test_moe_decode_quant_kernel_matches_plain_on_card(card, dtype, b, k, f):
    """F up to 4096 stages pass 2's h rows at once; llama4-scout's F 8192
    in two chunks."""
    from repro_torch.kernels import moe_decode_quant
    from repro_torch.kernels.moe_decode import moe_decode_quant_plain
    e, d = 16, 256
    g, q = _card_weights(e, d, f, dtype, b + k)
    x = torch.randn(b, d, generator=g, device="cuda").bfloat16()
    idx = torch.randint(0, e, (b, k), generator=g, device="cuda").int()
    w = torch.rand(b, k, generator=g, device="cuda")
    w[0, -1] = 0.0
    before = moe_decode_quant.launches
    got = moe_decode_quant(x, *q, idx, w, dtype=dtype)
    assert moe_decode_quant.launches == before + 1
    _close_rows(got, moe_decode_quant_plain(x, *q, idx, w, dtype=dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,k,f,e,kind", [(8, 8, 1024, 64, "random"),
                                          (16, 2, 1024, 16, "two"),
                                          (16, 8, 1056, 16, "random"),
                                          (1, 8, 1024, 64, "random"),
                                          (3, 6, 1056, 16, "random"),
                                          (8, 8, 1536, 128, "random"),
                                          (8, 2, 8192, 16, "random"),
                                          (16, 2, 8192, 16, "two")])
def test_moe_decode_quant_kernel_groups_slots_on_card(card, dtype, b, k, f,
                                                      e, kind):
    """At the served width (D 2048), the slots of one expert served
    together: "two" routes all 16 tokens to experts 2 and 9 (16 slots on
    each, more than the 8 one pass over the weights serves; at F 8192
    each pass of 8 slots stages its h rows in two chunks); qwen3-moe's
    experts (128, F 1536) and llama4-scout's F 8192.  Held to the
    plain version; each row's output bitwise the same computed alone; a
    slot whose weight is 0 adds exactly nothing, whichever expert it
    names; no host sync in the call."""
    from repro_torch.kernels import moe_decode_quant
    from repro_torch.kernels.moe_decode import moe_decode_quant_plain
    d = 2048
    g, q = _card_weights(e, d, f, dtype, b * k + f, scale=0.02)
    x = torch.randn(b, d, generator=g, device="cuda").bfloat16()
    if kind == "two":
        idx = torch.tensor([2, 9], device="cuda").repeat(b, 1).int()
    else:
        idx = torch.randint(0, e, (b, k), generator=g, device="cuda").int()
    w = torch.rand(b, k, generator=g, device="cuda")
    w[:, -1] = 0                        # a k_budget-masked slot
    moe_decode_quant(x, *q, idx, w, dtype=dtype)     # builds the library
    torch.cuda.synchronize()
    before = moe_decode_quant.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = moe_decode_quant(x, *q, idx, w, dtype=dtype)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert moe_decode_quant.launches == before + 1
    _close_rows(got, moe_decode_quant_plain(x, *q, idx, w, dtype=dtype))
    for i in range(b):                  # batch invariance
        alone = moe_decode_quant(x[i:i + 1], *q, idx[i:i + 1], w[i:i + 1],
                                 dtype=dtype)
        assert torch.equal(alone[0], got[i]), i
    moved = idx.clone()
    moved[:, -1] = (idx[:, -1] + 5) % e     # the zero-weight slot elsewhere
    assert torch.equal(moe_decode_quant(x, *q, moved, w, dtype=dtype), got)


def test_quant_kernels_refuse_what_they_do_not_take_on_card(card):
    from repro_torch.kernels import moe_decode_quant
    e, d, f = 4, 64, 64
    _, q = _card_weights(e, d, f, "int4", 0)        # D/2 = 32: not a x64
    x = torch.zeros(2, d, device="cuda", dtype=torch.bfloat16)
    idx = torch.zeros(2, 1, device="cuda", dtype=torch.int32)
    w = torch.ones(2, 1, device="cuda")
    with pytest.raises(ValueError, match="multiples of 64"):
        moe_decode_quant(x, *q, idx, w, dtype="int4")
    _, q = _card_weights(e, d, 48, "int8", 0)      # F 48: not a x32
    with pytest.raises(ValueError, match="multiple of 32"):
        moe_decode_quant(x, *q, idx, w, dtype="int8")
    _, q = _card_weights(e, d, f, "int8", 0)
    with pytest.raises(TypeError, match="bfloat16"):
        moe_decode_quant(x.half(), *q, idx, w, dtype="int8")
    with pytest.raises(TypeError, match="int8"):
        moe_decode_quant(x, q[0].bfloat16(), *q[1:], idx, w, dtype="int8")
