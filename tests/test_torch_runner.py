"""The port's runner: its specialization table, mixed-plan steps, the
persistent block table, and its CUDA graphs against the eager oracle.

On the CPU (the plain kernel versions): the runner's
``compiled_specializations()`` equals the JAX runner's on a paged
workload with a plan and a preemption, decode and chunk keys, bucket keys
included, with the tokens equal; a request in a mixed-plan batch gets the
tokens of a solo serve of its plan baked into the weights; homogeneous
serves make no bucket key, and plan combinations that round to one bucket
share its keys (as ``tests/test_per_request_plans.py`` pins the
reference); the KV manager's device table is one tensor across
allocations that holds the host table after each one.

On the card (skipped elsewhere): a graphed engine against an eager one
(``graphs=False``) on OLMoE at reduced width -- paged on ``gmm`` with the
fused decode path, paged on ``dense``, contiguous, int8 experts, and MLA
on DeepSeek-V2-Lite's attention widths -- greedy tokens equal and every
decode step's logits within LOGITS_TOL row by row; launch counts through
replays equal to the eager serve's; a mixed-plan batch token-exact
against solo serves; a replay after a cache tensor was replaced raises.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: F401,E402


#: the model's logits, graphed against eager, per row (one token's
#: logits): ||graphed - eager|| <= LOGITS_TOL * ||eager|| (chip_smoke's)
LOGITS_TOL = 3e-2


def _synchronous(engine):
    """Block on each of the JAX engine's device steps before it goes on
    (its paged block table may share the host buffer that admissions then
    update in place; see ``tests/test_torch_dense.py``)."""
    import jax
    for name in ("chunk_prefill", "decode"):
        fn = getattr(engine.runner, name)
        setattr(engine.runner, name,
                lambda *a, fn=fn, **kw: jax.block_until_ready(fn(*a, **kw)))
    return engine


def _requests(mod, lens, max_new, plans=None, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return [mod.Request(uid=i, prompt=rng.integers(0, vocab, n).astype(
        np.int32), max_new_tokens=max_new,
        plan=plans[i] if plans else None) for i, n in enumerate(lens)]


# --------------------------------------------------------------------------- #
# CPU: against the JAX runner
# --------------------------------------------------------------------------- #


def test_specialization_keys_match_reference():
    import jax
    from repro import models as jm
    from repro import serving as js
    from repro.configs import get_config as jget
    from repro_torch import serving as ts
    from repro_torch.configs import get_config as tget
    from repro_torch.convert import convert_params
    from repro_torch.models import ModelOpts
    cfg_j = jget("olmoe-1b-7b").reduced().with_(moe_impl="gmm")
    cfg_t = tget("olmoe-1b-7b").reduced().with_(moe_impl="gmm")
    pj = jax.jit(lambda k: jm.init_params(k, cfg_j))(jax.random.PRNGKey(1))
    pt = convert_params(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    # 3 slots x 4 pages is the worst case; 6 pages force preemption
    common = dict(max_batch=3, max_len=64, prefill_chunk=16, page_size=16,
                  num_pages=6, use_kernel=True, use_moe_decode=True)
    ej = _synchronous(js.Engine(cfg_j, pj, **common))
    et = ts.Engine(cfg_t, pt, opts=ModelOpts(use_moe_kernel=True),
                   device="cpu", **common)
    for eng in (ej, et):
        eng.add_plan("lexi", (2, 1, 1, 2))
    lens, plans = (24, 29, 21, 27), ["lexi", "base", "lexi", "lexi"]
    rj = ej.serve(_requests(js, lens, 14, plans))
    rt = et.serve(_requests(ts, lens, 14, plans))
    assert [r.tokens for r in rt] == [r.tokens for r in rj]
    assert et.stats["preemptions"] == ej.stats["preemptions"] > 0
    assert et.stats["mixed_plan_steps"] == ej.stats["mixed_plan_steps"] > 0
    keys = et.runner.compiled_specializations()
    assert keys == ej.runner.compiled_specializations()
    kinds = {k[1] for k in keys}
    heads = {k[0] for k in keys}
    assert kinds == {"decode", "chunk"}
    assert {"lexi", ("bucket", 2, 2, 2, 2)} <= heads
    assert et.runner.stats["graphs"] == 0          # the CPU runs eagerly


# --------------------------------------------------------------------------- #
# CPU: the port's own invariants (per-request plans, as the reference's)
# --------------------------------------------------------------------------- #

#: the reduced OLMoE's per-layer k is (2, 2, 2, 2)
PLANS = {"k1": (1, 1, 1, 1), "k12": (1, 2, 1, 2), "k21": (2, 1, 2, 1)}
EKW = dict(max_batch=4, max_len=64, prefill_chunk=8, use_kernel=True,
           use_moe_decode=True)


@pytest.fixture(scope="module")
def port():
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("olmoe-1b-7b").reduced().with_(moe_impl="gmm")
    return cfg, init_params(cfg, 0, device="cpu")


def _plans_engine(cfg, params, **kw):
    from repro_torch.models import ModelOpts
    from repro_torch.serving import Engine
    eng = Engine(cfg, params, opts=ModelOpts(use_moe_kernel=True),
                 device="cpu", **{**EKW, **kw})
    for name, ks in PLANS.items():
        eng.add_plan(name, ks)
    return eng


def test_mixed_batch_token_exact_vs_solo_serves(port):
    """One batch, four distinct plans, the fused decode path on: each
    request's tokens equal those of an engine whose config and weights
    have its plan baked in."""
    from repro_torch import serving as ts
    from repro_torch.core import LexiPlan, apply_plan_params
    from repro_torch.models import ModelOpts
    cfg, params = port
    plans = ["base", "k1", "k12", "k21"]
    lens = (5, 9, 13, 7)
    eng = _plans_engine(cfg, params)
    out = eng.serve(_requests(ts, lens, 6, plans, seed=3))
    assert eng.stats["mixed_plan_steps"] > 0
    assert any(k[0][0] == "bucket"
               for k in eng.runner.compiled_specializations()
               if isinstance(k[0], tuple))
    for i, name in enumerate(plans):
        cfg_p, params_p = cfg, params
        if name != "base":
            ks = PLANS[name]
            cfg_p, params_p = apply_plan_params(params, cfg, LexiPlan(
                arch=cfg.name, budget=sum(ks), plan=ks, fitness=0.0,
                method="uniform", k_base=cfg.moe_top_k))
        solo = ts.Engine(cfg_p, params_p, opts=ModelOpts(use_moe_kernel=True),
                         device="cpu", **EKW)
        ref = solo.serve([_requests(ts, lens, 6, seed=3)[i]])
        assert out[i].tokens == ref[0].tokens, name
        assert out[i].plan == out[i].served_plan == name


def test_homogeneous_serves_build_no_bucket_specializations(port):
    from repro_torch import serving as ts
    cfg, params = port
    eng = _plans_engine(cfg, params)
    for name in ("k1", "k12", "base"):
        eng.serve(_requests(ts, (5, 9), 4, [name, name]))
    assert eng.stats["mixed_plan_steps"] == 0
    assert not any(isinstance(k[0], tuple)
                   for k in eng.runner.compiled_specializations())


def test_plan_combinations_share_bucket_specializations(port):
    """{k1, base} and {k12, base} both round to (2, 2, 2, 2): the second
    mixed serve adds no bucket key (a request finishing first leaves a
    homogeneous remainder that makes its own plan's key)."""
    from repro_torch import serving as ts
    cfg, params = port
    eng = _plans_engine(cfg, params)
    buckets = lambda: {k for k in eng.runner.compiled_specializations()
                       if isinstance(k[0], tuple)}
    eng.serve(_requests(ts, (5, 9), 4, ["k1", "base"]))
    first = buckets()
    assert first and all(k[0] == ("bucket", 2, 2, 2, 2) for k in first)
    eng.serve(_requests(ts, (5, 9), 4, ["k12", "base"]))
    assert buckets() == first
    eng.serve(_requests(ts, (5, 9), 4, ["k12", "k1"]))      # a new bucket
    assert {k[0] for k in buckets() - first} == {("bucket", 1, 2, 1, 2)}


def test_kv_cache_device_table_is_one_tensor(port):
    from repro_torch.serving.kv_cache import KVCache
    cfg, _ = port
    kv = KVCache(cfg, 3, 64, page_size=16, num_pages=8, device="cpu")
    bt = kv.block_tables()
    ptr = bt.data_ptr()
    for op in (lambda: kv.allocate(0, 20), lambda: kv.allocate(2, 5),
               lambda: kv.allocate_append(0, 40), lambda: kv.release(0),
               lambda: kv.allocate(1, 64)):
        assert op() is not False
        got = kv.block_tables()
        assert got is bt and got.data_ptr() == ptr
        assert np.array_equal(got.numpy(), kv.table)
    assert kv.table[1].tolist() != [0] * kv.blocks_per_slot


# --------------------------------------------------------------------------- #
# on the card: CUDA graphs against the eager oracle
# --------------------------------------------------------------------------- #


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present, decided when the
    test runs (never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs run only on a GPU")


def _card_cfg(variant):
    """OLMoE at reduced width and depth (bf16, 16 experts top-4), or
    DeepSeek-V2-Lite's MLA widths (kv_lora_rank 512, rope 64) cut the
    same way: shapes every kernel takes."""
    from repro_torch.configs import get_config
    if variant == "mla":
        return get_config("deepseek-v2-lite").with_(
            num_layers=3, d_model=512, num_heads=4, d_ff=1024,
            num_experts=16, moe_top_k=4, moe_d_ff=256,
            shared_expert_d_ff=512, vocab_size=1024, moe_impl="gmm")
    return get_config("olmoe-1b-7b").with_(
        num_layers=2, d_model=512, num_heads=4, num_kv_heads=4,
        head_dim=128, num_experts=16, moe_top_k=4, moe_d_ff=256,
        vocab_size=1024, moe_impl="dense" if variant == "dense" else "gmm")


def _card_engine(variant, params, cfg, graphs):
    from repro_torch.models import ModelOpts
    from repro_torch.serving import Engine
    kw = dict(max_batch=4, max_len=256, use_moe_decode=True, graphs=graphs,
              device="cuda")
    if variant == "contiguous":
        return Engine(cfg, params, cache_layout="contiguous",
                      prefill_chunk=0, opts=ModelOpts(
                          use_flash=True, use_flash_decode=True,
                          use_moe_kernel=True), **kw)
    return Engine(cfg, params, prefill_chunk=32, use_kernel=True,
                  expert_dtype="int8" if variant == "int8" else None,
                  opts=ModelOpts(use_moe_kernel=True), **kw)


def _recording(eng):
    """Keep a copy of every decode step's logits."""
    seen = []
    fn = eng.runner.decode

    def decode(*a, **kw):
        logits, caches = fn(*a, **kw)
        seen.append(logits.float().clone())
        return logits, caches
    eng.runner.decode = decode
    return seen


CARD_LENS = (40, 97, 23, 150, 66)


@pytest.mark.parametrize("variant", ["paged_gmm", "paged_dense",
                                     "contiguous", "int8", "mla"])
def test_graphed_serve_matches_eager_on_card(card, variant):
    from repro_torch import kernels
    from repro_torch import serving as ts
    from repro_torch.models import init_params
    cfg = _card_cfg(variant)
    params = init_params(cfg, 0, device="cuda")
    reqs = lambda: _requests(ts, CARD_LENS, 12, vocab=cfg.vocab_size)
    out, logits, counts = {}, {}, {}
    for graphs in (True, False):
        eng = _card_engine(variant, params, cfg, graphs)
        logits[graphs] = _recording(eng)
        kernels.reset_launch_counts()
        out[graphs] = eng.serve(reqs())
        torch.cuda.synchronize()
        counts[graphs] = kernels.launch_counts()
        if graphs:
            assert eng.stats["graphs_captured"] > 0
            assert eng.stats["graph_replays"] > 0
        else:
            assert eng.stats["graphs_captured"] == 0
    assert [r.tokens for r in out[True]] == [r.tokens for r in out[False]]
    assert len(logits[True]) == len(logits[False]) > 0
    worst = 0.0
    for got, want in zip(logits[True], logits[False]):
        assert torch.isfinite(got).all()
        err = (got - want).norm(dim=-1) / want.norm(dim=-1)
        worst = max(worst, err.max().item())
    print(f"{variant}: max row rel err of decode logits, graphed vs eager: "
          f"{worst:.3e}; max abs diff of the first step: "
          f"{(logits[True][0] - logits[False][0]).abs().max().item():.3e}")
    assert worst <= LOGITS_TOL
    assert counts[True] == counts[False] and any(counts[True].values())


def test_mixed_plan_batch_token_exact_vs_solo_on_card(card):
    from repro_torch import serving as ts
    from repro_torch.models import init_params
    cfg = _card_cfg("paged_gmm")
    params = init_params(cfg, 0, device="cuda")
    eng = _card_engine("paged_gmm", params, cfg, True)
    eng.add_plan("lexi", (4, 1))
    eng.add_plan("k2", (2, 2))
    plans = ["base", "lexi", "k2", "lexi", "base"]
    reqs = lambda p=None: _requests(ts, CARD_LENS, 12, p, vocab=cfg.vocab_size)
    mixed = eng.serve(reqs(plans))
    assert eng.stats["mixed_plan_steps"] > 0
    assert any(isinstance(k[0], tuple)
               for k in eng.runner.compiled_specializations())
    for name in set(plans):
        solo = eng.serve(reqs(), plan=name)
        for i, p in enumerate(plans):
            if p == name:
                assert mixed[i].tokens == solo[i].tokens, (i, name)


def test_replay_after_cache_replaced_raises_on_card(card):
    from repro_torch import serving as ts
    from repro_torch.models import init_params
    cfg = _card_cfg("paged_gmm")
    params = init_params(cfg, 0, device="cuda")
    eng = _card_engine("paged_gmm", params, cfg, True)
    eng.serve(_requests(ts, (40, 30), 4, vocab=cfg.vocab_size))
    eng.kv.caches[0]["kp"] = eng.kv.caches[0]["kp"].clone()
    with pytest.raises(RuntimeError, match="captured"):
        eng.serve(_requests(ts, (40, 30), 4, vocab=cfg.vocab_size))


def _edge_types(graph) -> dict:
    """Counts of a captured graph's dependency types (0 full, 1
    programmatic), read with ``cudaGraphGetEdges_v2``."""
    import ctypes
    rt = ctypes.CDLL("libcudart.so.12")
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert rt.cudaGraphGetEdges_v2(g, None, None, None, ctypes.byref(n)) == 0
    frm = (ctypes.c_void_p * n.value)()
    to = (ctypes.c_void_p * n.value)()
    data = (ctypes.c_uint8 * (8 * n.value))()      # cudaGraphEdgeData
    assert rt.cudaGraphGetEdges_v2(g, frm, to, data, ctypes.byref(n)) == 0
    types = [data[8 * i + 2] for i in range(n.value)]
    return {t: types.count(t) for t in set(types)}


def test_dependent_launches_under_capture_on_card(card):
    """``moe_decode`` launches its passes 2 and 3 as programmatic
    dependents (``csrc/decode_slots.cuh``).  Captured, its replay must
    give the eager call's output bit for bit; the test prints the graph's
    edge types (1 = a programmatic edge the capture kept)."""
    from repro_torch.kernels import _graphs, moe_decode
    gen = torch.Generator(device="cuda").manual_seed(0)
    e, d, f, t, k = 16, 512, 256, 8, 4

    def rnd(*shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                * 0.05).to(torch.bfloat16)
    x, w1, w2 = rnd(t, d) * 20, rnd(e, d, 2 * f), rnd(e, f, d)
    idx = torch.argsort(torch.rand((t, e), generator=gen, device="cuda"),
                        dim=1)[:, :k].int()
    weights = torch.rand((t, k), generator=gen, device="cuda")
    want = moe_decode(x, w1, w2, idx, weights)
    call = lambda: moe_decode(x, w1, w2, idx, weights)
    stream = torch.cuda.Stream()
    _graphs.on_stream(call, stream)
    n0 = moe_decode.launches
    g = _graphs.capture(call, stream=stream,
                        pool=torch.cuda.graph_pool_handle())
    assert moe_decode.launches == n0 and g.launches == {"moe_decode": 1}
    got = g.replay()
    torch.cuda.synchronize()
    assert moe_decode.launches == n0 + 1
    assert torch.equal(got, want)
    try:            # the graph itself, kept past instantiation
        kept = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.stream(stream):
            kept.capture_begin()
            call()
            kept.capture_end()
        edges = _edge_types(kept)
    except Exception as exc:        # a torch that keeps no cudaGraph_t
        edges = f"not readable ({exc!r})"
    print(f"moe_decode graph edge types {{type: count}}: {edges}")
