"""Parity of the PyTorch port's capacity-buffer ``dense`` MoE path with the
JAX reference (CPU): ``capacity``, the capacity-buffer dispatch
(``_slot_positions``, ``_scatter``, ``_gather_combine``) with and without
dropped copies, the plain version of the ``moe_ffn`` kernel against the
Pallas kernel in interpret mode and the reference's oracle, ``moe_dense``,
the reduced OLMoE model's loss and logits, greedy serving against the JAX
engine and the launchers, all on ``dense`` -- every config's default.  The
CUDA kernel itself is held against its plain version by the card-only
tests at the end (and by ``chip_smoke.py``).

Inputs are drawn with numpy from a seed.  Slot positions, ``keep`` and
the scattered buffers are equal, not close (copies of f32 values).  Float
outputs are f32 and agree to ``TOL`` (products summed in another order by
XLA and PyTorch), the model's loss and logits to ``MODEL_TOL`` (as
``test_torch_model.py``: 4 layers of such differences).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: F401,E402


TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _cfgs(arch="olmoe-1b-7b", **kw):
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    cfg_j = jget(arch).reduced().with_(**kw)
    cfg_t = tget(arch).reduced().with_(**kw)
    assert cfg_j.moe_impl == cfg_t.moe_impl == "dense"      # the default
    return cfg_j, cfg_t


def _x(t, d, seed=0):
    return np.random.default_rng(seed).normal(size=(t, d)).astype(np.float32)


def _idx(t, k, e, seed):
    """[T, k] distinct expert ids a token, skewed to the low experts so
    that they overflow."""
    rng = np.random.default_rng(seed)
    p = np.arange(e, 0, -1, dtype=np.float64) ** 2
    return np.stack([rng.choice(e, k, replace=False, p=p / p.sum())
                     for _ in range(t)]).astype(np.int32)


# --------------------------------------------------------------------------- #
# capacity and the capacity-buffer dispatch
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("t,k,e,factor", [
    (1, 1, 64, 1.25), (8, 8, 64, 1.25), (512, 8, 64, 1.25),
    (2048, 6, 64, 1.25), (37, 3, 6, 0.5), (24, 2, 8, 8.0), (5, 2, 8, 0.0),
])
def test_capacity_matches_reference(t, k, e, factor):
    from repro.models.moe.router import capacity as jcap
    from repro_torch.models.moe import capacity as tcap
    c = tcap(t, k, e, factor)
    assert c == jcap(t, k, e, factor)
    assert isinstance(c, int) and c >= 4 and c % 4 == 0


@pytest.mark.parametrize("factor", [1.25, 0.5])
@pytest.mark.parametrize("t,k,e", [(40, 2, 8), (33, 3, 6)])
def test_capacity_dispatch_matches_reference(t, k, e, factor):
    import jax.numpy as jnp
    from repro.models.moe import dispatch as jd
    from repro.models.moe.router import capacity as jcap
    from repro_torch.models.moe import dispatch as td
    cap = jcap(t, k, e, factor)
    idx = _idx(t, k, e, seed=t + k)
    pj, kj = jd._slot_positions(jnp.asarray(idx), e, cap)
    pt, kt = td._slot_positions(torch.from_numpy(idx), e, cap)
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    np.testing.assert_array_equal(np.asarray(kj), kt.numpy())
    if factor < 1:                      # copies are dropped
        assert not kt.all()

    x = _x(t, 16, seed=t)
    bj = jd._scatter(jnp.asarray(x), jnp.asarray(idx), pj, kj, e, cap)
    bt = td._scatter(torch.from_numpy(x), torch.from_numpy(idx), pt, kt, e,
                     cap)
    assert tuple(bt.shape) == (e, cap, 16)
    np.testing.assert_array_equal(np.asarray(bj), bt.numpy())

    ye = np.random.default_rng(1).normal(size=(e, cap, 16)).astype(np.float32)
    w = np.random.default_rng(2).random((t, k)).astype(np.float32)
    yj = jd._gather_combine(jnp.asarray(ye), jnp.asarray(w), jnp.asarray(idx),
                            pj, kj, cap)
    yt = td._gather_combine(torch.from_numpy(ye), torch.from_numpy(w),
                            torch.from_numpy(idx), pt, kt, cap)
    assert yt.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(yj), yt.numpy(), **TOL)


# --------------------------------------------------------------------------- #
# moe_ffn's plain version vs the Pallas kernel (interpret) and the oracle
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("block_c,block_f", [(128, 256), (8, 64)])
def test_moe_ffn_plain_matches_pallas_and_ref(block_c, block_f):
    import jax.numpy as jnp
    from repro.kernels import ref
    from repro.kernels.moe_ffn import moe_ffn_pallas
    from repro_torch.kernels import moe_ffn
    e, c, d, f = 3, 12, 32, 96          # C and F not multiples of a tile
    rng = np.random.default_rng(block_c)
    xe = rng.normal(size=(e, c, d)).astype(np.float32)
    xe[1] = 0.0                         # an empty expert
    xe[2, 7:] = 0.0                     # rows no copy filled
    w1 = (rng.normal(size=(e, d, 2 * f)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(e, f, d)) * 0.1).astype(np.float32)
    got = moe_ffn(*map(torch.from_numpy, (xe, w1, w2))).numpy()
    want = moe_ffn_pallas(*map(jnp.asarray, (xe, w1, w2)), block_c=block_c,
                          block_f=block_f, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(ref.moe_ffn_ref(*map(jnp.asarray, (xe, w1, w2)))),
        **TOL)
    assert (got[1] == 0).all() and (got[2, 7:] == 0).all()


# --------------------------------------------------------------------------- #
# the dense MoE layer
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("case", [
    "softmax_budget", "sigmoid_drops", "shared_experts", "kernel_drops"])
def test_moe_dense_matches_reference(case):
    import jax
    import jax.numpy as jnp
    from repro.models.moe import init_moe
    from repro.models.moe import moe as jmoe
    from repro.models.moe.dense import moe_dense as jdense
    from repro_torch.models.moe import moe as tmoe
    from repro_torch.models.moe import moe_dense as tdense
    kw = {"softmax_budget": dict(norm_topk_prob=True),
          "sigmoid_drops": dict(router_type="sigmoid", norm_topk_prob=True,
                                moe_capacity_factor=0.5),
          "shared_experts": {},
          "kernel_drops": dict(moe_capacity_factor=0.5)}[case]
    arch = "deepseek-v2-lite" if case == "shared_experts" else "olmoe-1b-7b"
    cfg_j, cfg_t = _cfgs(arch, **kw)
    pj = init_moe(jax.random.PRNGKey(3), cfg_j)
    assert ("shared" in pj) == (case == "shared_experts")
    pt = _to_torch(pj)
    t, k = 48, cfg_j.moe_top_k
    x = _x(t, cfg_j.d_model, 5)
    kb = (np.random.default_rng(1).integers(1, k + 1, t).astype(np.int32)
          if case == "softmax_budget" else None)
    use_kernel = case == "kernel_drops"
    yj, aj = jdense(pj, cfg_j, jnp.asarray(x), k,
                    k_budget=None if kb is None else jnp.asarray(kb))
    yt, at = tdense(pt, cfg_t, torch.from_numpy(x), k, use_kernel,
                    k_budget=None if kb is None else torch.from_numpy(kb))
    np.testing.assert_allclose(np.asarray(yj), yt.numpy(), **TOL)
    np.testing.assert_allclose(float(aj), float(at), **TOL)
    # the registry reaches the same function under the config's default
    yr, _ = tmoe(pt, cfg_t, torch.from_numpy(x).reshape(2, t // 2, -1), k,
                 use_kernel=use_kernel, decode_kernel=True)
    if kb is None:
        np.testing.assert_array_equal(yr.reshape(t, -1).numpy(), yt.numpy())
    jr, _ = jmoe(pj, cfg_j, jnp.asarray(x).reshape(2, t // 2, -1), k)
    np.testing.assert_allclose(np.asarray(jr), yr.numpy(), **TOL)


# --------------------------------------------------------------------------- #
# the model: loss and logits, greedy serving, the launchers
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def setup():
    import jax
    from repro import models as jm
    from repro_torch.convert import convert_params
    cfg_j, cfg_t = _cfgs()
    pj = jax.jit(lambda k: jm.init_params(k, cfg_j))(jax.random.PRNGKey(1))
    pt = convert_params(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    return cfg_j, cfg_t, pj, pt


@pytest.mark.parametrize("use_moe_kernel", [True, False])
def test_loss_and_logits_match_reference_on_dense(setup, use_moe_kernel):
    import jax
    import jax.numpy as jnp
    from repro import models as jm
    from repro.models.transformer import forward as jfwd, lm_logits as jlog
    from repro_torch import models as tm
    from repro_torch.models.transformer import forward as tfwd, \
        lm_logits as tlog
    cfg_j, cfg_t, pj, pt = setup
    rng = np.random.default_rng(4)
    b, s = 2, 24
    batch = {k: rng.integers(0, cfg_j.vocab_size, (b, s)).astype(np.int32)
             for k in ("tokens", "targets")}
    batch["mask"] = (rng.random((b, s)) > 0.2).astype(np.int32)
    lj, mj = jax.jit(lambda p_, b_: jm.loss_fn(p_, cfg_j, b_))(
        pj, {k: jnp.asarray(v) for k, v in batch.items()})
    opts = tm.ModelOpts(use_moe_kernel=use_moe_kernel)
    lt, mt = tm.loss_fn(pt, cfg_t, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, opts=opts)
    np.testing.assert_allclose(lt.item(), float(lj), **MODEL_TOL)
    np.testing.assert_allclose(mt["aux"].item(), float(mj["aux"]),
                               **MODEL_TOL)
    pos = np.arange(s)[None].repeat(b, 0).astype(np.int32)
    gj = jax.jit(lambda p_, t_, q_: jlog(
        p_, cfg_j, jfwd(p_, cfg_j, t_, q_)[0]))(
        pj, jnp.asarray(batch["tokens"]), jnp.asarray(pos))
    gt = tlog(pt, cfg_t, tfwd(pt, cfg_t, torch.from_numpy(batch["tokens"]),
                              torch.from_numpy(pos), opts=opts)[0])
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **MODEL_TOL)


def _requests(mod, n, lo, hi, max_new, seed=0):
    rng = np.random.default_rng(seed)
    return [mod.Request(uid=i, prompt=rng.integers(
        0, 256, rng.integers(lo, hi)).astype(np.int32),
        max_new_tokens=max_new) for i in range(n)]


def _synchronous(engine):
    """Block on each of the JAX engine's device steps before it goes on.
    Its paged block table is a device array made from the host table
    without a copy (CPU), which admissions then update in place while an
    asynchronous step may still read it.  A pad row (position -1) attends
    every key its table maps, so its hidden state, and under ``dense`` the
    capacity slots it takes, followed the race: the reference's tokens
    changed from run to run.  Blocking changes no value a step computes."""
    import jax
    for name in ("chunk_prefill", "decode", "whole_prefill"):
        fn = getattr(engine.runner, name)
        setattr(engine.runner, name,
                lambda *a, fn=fn, **kw: jax.block_until_ready(fn(*a, **kw)))
    return engine


def _serve_both(ej, et, plan=None, n=4, max_new=8):
    from repro import serving as js
    from repro_torch import serving as ts
    rj = ej.serve(_requests(js, n, 5, 30, max_new), plan=plan)
    rt = et.serve(_requests(ts, n, 5, 30, max_new), plan=plan)
    assert [r.uid for r in rj] == [r.uid for r in rt]
    for a, b in zip(rj, rt):
        assert b.tokens == a.tokens, (a.uid, a.tokens, b.tokens)
        assert b.finished_reason == a.finished_reason
    assert et.stats["steps"] == ej.stats["steps"]


def test_greedy_tokens_match_reference_on_dense_paged(setup):
    """Chunk steps are [max_batch, chunk] and decode steps [max_batch] in
    both engines, idle rows routed as token 0: T, capacity and the dropped
    copies are the same, so tokens are equal at the default factor."""
    from repro import models as jm
    from repro.serving import Engine as JEngine
    from repro_torch import kernels
    from repro_torch.models import ModelOpts
    from repro_torch.serving import Engine as TEngine
    cfg_j, cfg_t, pj, pt = setup
    assert cfg_t.moe_capacity_factor == 1.25
    common = dict(max_batch=3, max_len=64, prefill_chunk=16, page_size=16,
                  use_kernel=True, use_moe_decode=True)
    ej = _synchronous(JEngine(cfg_j, pj, opts=jm.ModelOpts(), **common))
    et = TEngine(cfg_t, pt, opts=ModelOpts(use_moe_kernel=True),
                 device="cpu", **common)
    kernels.reset_launch_counts()
    _serve_both(ej, et)
    plan = (2, 1, 1, 2)
    ej.add_plan("lexi", plan)
    et.add_plan("lexi", plan)
    _serve_both(ej, et, plan="lexi")
    counts = kernels.launch_counts()     # the plain versions ran on the CPU
    assert not any(counts.values())


def test_greedy_tokens_match_reference_on_dense_contiguous(setup):
    """Whole-prompt prefill: the JAX engine right-aligns a prompt in a
    padded window whose pads are routed and, first in token order, take
    capacity slots; the port prefills at the prompt's own length.  So at
    a factor that can drop the two drop different copies: this test runs
    a dropless factor (C = T*k, as ``tests/test_moe_dispatch.py``)."""
    from repro import models as jm
    from repro.serving import Engine as JEngine
    from repro_torch.models import ModelOpts
    from repro_torch.serving import Engine as TEngine
    cfg_j, cfg_t, pj, pt = setup
    e = cfg_t.num_experts
    common = dict(max_batch=3, max_len=64, cache_layout="contiguous",
                  prefill_chunk=0, use_moe_decode=True)
    ej = _synchronous(JEngine(cfg_j.with_(moe_capacity_factor=float(e)), pj,
                              opts=jm.ModelOpts(use_flash_decode=True),
                              **common))
    et = TEngine(cfg_t.with_(moe_capacity_factor=float(e)), pt,
                 opts=ModelOpts(use_flash=True, use_flash_decode=True,
                                use_moe_kernel=True), device="cpu", **common)
    _serve_both(ej, et)
    plan = (2, 1, 1, 2)
    ej.add_plan("lexi", plan)
    et.add_plan("lexi", plan)
    _serve_both(ej, et, plan="lexi")


def test_launchers_run_dense_on_cpu(capsys):
    import json
    from repro_torch.launch.forward import main as forward
    from repro_torch.launch.serve import main as serve
    assert serve(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                  "--requests", "3", "--max-new", "4", "--max-len", "64",
                  "--max-batch", "2", "--prefill-chunk", "16",
                  "--use-kernel", "--use-moe-kernel",
                  "--lexi-budget-frac", "0.5"]) == 0
    out = capsys.readouterr().out
    assert "moe=dense" in out and "baseline:" in out and "LExI:" in out
    assert forward(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                    "--batch", "1", "--seq", "16", "--reps", "1"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    impls = {n: m["moe_impl"] for n, m in rec["models"].items()}
    assert impls == {"baseline": "dense", "lexi": "dense",
                     "baseline~gmm": "gmm", "lexi~gmm": "gmm",
                     "inter_prune_0.25": "dense", "intra_prune_0.25": "dense",
                     "dyn_skip_tau0.3": "dense"}
    assert all(np.isfinite(m["xent"]) for m in rec["models"].values())


def test_launcher_serves_quantized_experts_on_gmm(capsys):
    from repro_torch.launch.serve import main as serve
    assert serve(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                  "--requests", "2", "--max-new", "3", "--max-len", "64",
                  "--max-batch", "2", "--prefill-chunk", "16",
                  "--use-moe-kernel", "--expert-dtype", "int4"]) == 0
    assert "moe=gmm experts=int4" in capsys.readouterr().out


# --------------------------------------------------------------------------- #
# the CUDA kernel vs its plain version (needs the card)
# --------------------------------------------------------------------------- #

ROW_TOL = 1e-2      # per row, of its own norm: f32 sums in another order,
#                     the kernel's bf16 hidden, bf16 output


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present, decided when the
    test runs (never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a GPU")


def _ffn_case(e, c, d, f, seed, scale):
    """Capacity buffers with an empty expert (3) and an expert (5) whose
    rows past C/2 no copy filled, and random experts, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    xe = torch.randn(e, c, d, generator=g, device="cuda").bfloat16()
    xe[3] = 0                           # an empty expert
    xe[5, c // 2:] = 0                  # rows no copy filled
    w1 = (torch.randn(e, d, 2 * f, generator=g, device="cuda")
          * scale).bfloat16()
    w2 = (torch.randn(e, f, d, generator=g, device="cuda") * scale).bfloat16()
    return xe, w1, w2


def _check_ffn(xe, w1, w2):
    from repro_torch.kernels import moe_ffn
    from repro_torch.kernels.moe_ffn import moe_ffn_plain
    before = moe_ffn.launches
    got = moe_ffn(xe, w1, w2)
    assert moe_ffn.launches == before + 1
    want = moe_ffn_plain(xe, w1, w2)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).norm(dim=-1)
    ref = want.float().norm(dim=-1)
    assert (err <= ROW_TOL * ref).all(), (err / ref.clamp(min=1e-30)).max()
    zero = xe.float().abs().sum(-1) == 0
    assert zero[3].all() and zero[5].any()
    assert (got[zero] == 0).all()       # exact zeros where no copy landed


@pytest.mark.parametrize("c", [4, 12, 320])
@pytest.mark.parametrize("f", [96, 1056])
def test_moe_ffn_kernel_matches_plain_on_card(card, c, f):
    _check_ffn(*_ffn_case(8, c, 256, f, seed=c + f, scale=0.1))


@pytest.mark.parametrize("c", [4, 12, 80, 240, 320])
@pytest.mark.parametrize("f", [1024, 1056, 1408])
def test_moe_ffn_kernel_full_width_on_card(card, c, f):
    """At the served width (D 2048): C of one row tile in one warpgroup
    (4, 12), in two (80), and of three (240: 128, 112; 320: 128, 128,
    64), each ending past C in a box TMA zero-fills; F 1056 ends in a
    part-filled box; the empty expert and the unfilled rows come out
    exactly zero."""
    _check_ffn(*_ffn_case(8, c, 2048, f, seed=c * f, scale=0.02))


def test_moe_ffn_refuses_what_it_does_not_take_on_card(card):
    from repro_torch.kernels import moe_ffn
    e, c, d, f = 2, 4, 64, 48           # F not a multiple of 32
    xe = torch.zeros(e, c, d, device="cuda", dtype=torch.bfloat16)
    w1 = torch.zeros(e, d, 2 * f, device="cuda", dtype=torch.bfloat16)
    w2 = torch.zeros(e, f, d, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 32"):
        moe_ffn(xe, w1, w2)
    with pytest.raises(TypeError, match="bfloat16"):
        moe_ffn(xe.float(), w1[..., :64], w2[:, :32])
