"""Greedy serving parity: the PyTorch port's ``Engine.serve`` against the
JAX reference's, on the same weights and requests, with the paged decode
kernel and the fused decode MoE path on both sides (their plain versions
run on the CPU).  Tokens must be equal -- for the base config, for a LExI
plan registered on the same engine, and under a half-size KV pool where
both engines preempt (the same number of times) and recompute.

A wave whose requests carry different plans (base and two LExI plans)
steps through the bucketed-k mixed-plan steps on both sides and is held
to the reference's tokens the same way.

Quantized experts (``expert_dtype="int8"`` and ``"int4"``, quantized at
load by each engine from the same weights) are held to the reference's
quantized engine the same way.

The contiguous layout with whole-prompt prefill is held to the reference's
``Engine(cache_layout="contiguous", prefill_chunk=0)`` the same way, base
and LExI plan.  The port runs it with ``use_flash`` and
``use_flash_decode``; the reference runs ``use_flash_decode`` only: its
whole prefill right-aligns each prompt in a padded window, and its
``flash_attention`` masks by index, so under ``use_flash`` real queries
would attend the pad keys (the port prefills at the prompt's own length,
so its kernel never sees a pad).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: F401,E402


@pytest.fixture(scope="module")
def setup():
    import jax
    from repro import models as jm
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    from repro_torch.convert import convert_params
    cfg_j = jget("olmoe-1b-7b").reduced().with_(moe_impl="gmm")
    cfg_t = tget("olmoe-1b-7b").reduced().with_(moe_impl="gmm")
    pj = jax.jit(lambda k: jm.init_params(k, cfg_j))(jax.random.PRNGKey(1))
    pt = convert_params(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    return cfg_j, cfg_t, pj, pt


def _requests(mod, n, lo, hi, max_new, seed=0, plans=None):
    rng = np.random.default_rng(seed)
    return [mod.Request(uid=i, prompt=rng.integers(
        0, 256, rng.integers(lo, hi)).astype(np.int32),
        max_new_tokens=max_new, plan=plans[i] if plans else None)
        for i in range(n)]


def _engines(setup, **kw):
    from repro.serving import Engine as JEngine
    from repro_torch.models import ModelOpts
    from repro_torch.serving import Engine as TEngine
    cfg_j, cfg_t, pj, pt = setup
    common = dict(max_len=64, prefill_chunk=16, page_size=16,
                  use_kernel=True, use_moe_decode=True, **kw)
    return (JEngine(cfg_j, pj, **common),
            TEngine(cfg_t, pt, opts=ModelOpts(use_moe_kernel=True),
                    device="cpu", **common))


def _serve_both(ej, et, n, lo, hi, max_new, plan=None, plans=None):
    from repro import serving as js
    from repro_torch import serving as ts
    rj = ej.serve(_requests(js, n, lo, hi, max_new, plans=plans), plan=plan)
    rt = et.serve(_requests(ts, n, lo, hi, max_new, plans=plans), plan=plan)
    assert [r.uid for r in rj] == [r.uid for r in rt]
    for a, b in zip(rj, rt):
        assert b.tokens == a.tokens, (a.uid, a.tokens, b.tokens)
        assert b.finished_reason == a.finished_reason
    return rj, rt


def test_greedy_tokens_match_reference_base_and_lexi_plan(setup):
    ej, et = _engines(setup, max_batch=3)
    _serve_both(ej, et, 4, 5, 30, 8)
    plan = (2, 1, 1, 2)
    ej.add_plan("lexi", plan)
    et.add_plan("lexi", plan)
    rj, rt = _serve_both(ej, et, 4, 5, 30, 8, plan="lexi")
    assert all(r.served_plan == "lexi" for r in rt)
    assert et.stats["decode_tokens"] == ej.stats["decode_tokens"]
    assert et.stats["prefill_tokens"] == ej.stats["prefill_tokens"]


def test_greedy_tokens_match_reference_under_preemption(setup):
    # worst case is 3 slots x 4 pages; half of it forces preemption
    ej, et = _engines(setup, max_batch=3, num_pages=6)
    _serve_both(ej, et, 4, 20, 31, 16)
    assert ej.stats["preemptions"] > 0
    assert et.stats["preemptions"] == ej.stats["preemptions"]
    assert et.stats["recompute_tokens"] == ej.stats["recompute_tokens"]
    assert et.kv.free_pages() == et.kv.num_pages - 1   # every page returned


def test_quant_greedy_tokens_match_reference_int8_base_and_lexi_plan(setup):
    ej, et = _engines(setup, max_batch=3, expert_dtype="int8")
    assert et.runner.params["layers"][0]["moe"]["w1"].dtype == torch.int8
    _serve_both(ej, et, 4, 5, 30, 8)
    plan = (2, 1, 1, 2)
    ej.add_plan("lexi", plan)
    et.add_plan("lexi", plan)
    _serve_both(ej, et, 4, 5, 30, 8, plan="lexi")
    assert et.stats["decode_tokens"] == ej.stats["decode_tokens"]


def test_quant_greedy_tokens_match_reference_int4(setup):
    ej, et = _engines(setup, max_batch=3, expert_dtype="int4")
    d = setup[1].d_model
    assert et.runner.params["layers"][0]["moe"]["w2"].shape[-1] == d // 2
    _serve_both(ej, et, 4, 5, 30, 8)


def test_quant_engine_options_are_checked(setup):
    from repro_torch.models import ModelOpts, init_params
    from repro_torch.serving import Engine
    _, cfg_t, _, pt = setup
    with pytest.raises(ValueError, match="want 'bf16'"):
        Engine(cfg_t, pt, expert_dtype="fp8", device="cpu")
    with pytest.raises(ValueError, match="gmm/decode"):
        Engine(cfg_t, pt, expert_dtype="int8",
               opts=ModelOpts(moe_impl="dense"), device="cpu")
    dense_cfg = cfg_t.with_(num_experts=0, moe_top_k=0, d_ff=256)
    assert {b.kind for b in dense_cfg.pattern()} == {"attn_mlp"}
    with pytest.raises(ValueError, match="gmm/decode"):
        Engine(dense_cfg, init_params(dense_cfg, 0, device="cpu"),
               expert_dtype="int4", device="cpu")
    # quantize-at-load leaves the caller's params as they were
    eng = Engine(cfg_t, pt, expert_dtype="int8", device="cpu")
    assert pt["layers"][0]["moe"]["w1"].dtype == torch.float32
    assert eng.runner.params["embed"] is pt["embed"]
    assert eng.expert_dtype == "int8"
    assert eng.runner.opts.expert_dtype == "int8"


def test_mixed_plan_greedy_tokens_match_reference(setup):
    """Four requests over base and two LExI plans in one wave: the mixed
    steps run the bucketed-k step on both sides, and each request's tokens
    equal the reference's."""
    ej, et = _engines(setup, max_batch=4)
    for name, plan in (("lexi", (2, 1, 1, 2)), ("k1", (1, 1, 1, 1))):
        ej.add_plan(name, plan)
        et.add_plan(name, plan)
    _serve_both(ej, et, 4, 5, 30, 6, plans=["base", "lexi", "k1", "lexi"])
    assert et.stats["mixed_plan_steps"] == ej.stats["mixed_plan_steps"] > 0
    assert ("bucket", 2, 2, 2, 2) in {
        k[0] for k in et.runner.compiled_specializations()}
    assert et.plan_stats() == ej.plan_stats()


def test_sample_per_slot_greedy_rows_exact_and_topk_cap():
    from repro_torch.serving import sample_per_slot
    g = torch.Generator().manual_seed(0)
    logits = torch.from_numpy(
        np.random.default_rng(3).normal(size=(4, 50)).astype(np.float32))
    best = logits.argmax(-1).int()
    greedy = sample_per_slot(logits, g, torch.zeros(4))
    assert torch.equal(greedy, best)
    # hot rows sample; greedy rows keep the argmax; top-1 is the argmax
    temps = torch.tensor([0.0, 1.5, 0.0, 2.0])
    out = sample_per_slot(logits, g, temps, torch.tensor([0, 1, 0, 0]))
    assert out[0] == best[0] and out[2] == best[2] and out[1] == best[1]
    assert 0 <= int(out[3]) < 50


def _contiguous_engines(setup, **kw):
    from repro import models as jm
    from repro.serving import Engine as JEngine
    from repro_torch.models import ModelOpts
    from repro_torch.serving import Engine as TEngine
    cfg_j, cfg_t, pj, pt = setup
    common = dict(max_len=64, cache_layout="contiguous", prefill_chunk=0,
                  use_moe_decode=True, **kw)
    return (JEngine(cfg_j, pj, opts=jm.ModelOpts(use_flash_decode=True),
                    **common),
            TEngine(cfg_t, pt, opts=ModelOpts(use_flash=True,
                                              use_flash_decode=True,
                                              use_moe_kernel=True),
                    device="cpu", **common))


def test_contiguous_whole_prefill_greedy_tokens_match_reference(setup):
    ej, et = _contiguous_engines(setup, max_batch=3)
    _serve_both(ej, et, 4, 5, 30, 8)
    plan = (2, 1, 1, 2)
    ej.add_plan("lexi", plan)
    et.add_plan("lexi", plan)
    _serve_both(ej, et, 4, 5, 30, 8, plan="lexi")
    assert et.stats["prefill_tokens"] == ej.stats["prefill_tokens"]
    assert et.stats["steps"] == ej.stats["steps"]
    assert all((layer["pos"] == -1).all() for layer in et.kv.caches)


def test_contiguous_whole_prefill_matches_reference_on_a_window_ring(setup):
    # a 16-slot sliding-window ring that prompts of up to 29 tokens and
    # their decode wrap; the same weights (a window adds no parameters)
    cfg_j, cfg_t, pj, pt = setup
    win = (cfg_j.with_(sliding_window=16), cfg_t.with_(sliding_window=16),
           pj, pt)
    ej, et = _contiguous_engines(win, max_batch=2)
    assert et.kv.caches[0]["k"].shape[1] == 16
    _serve_both(ej, et, 3, 10, 30, 8)


def test_cache_layout_options_are_checked(setup):
    from repro_torch.serving import Engine
    _, cfg_t, _, pt = setup
    with pytest.raises(ValueError, match="contiguous"):
        Engine(cfg_t, pt, prefill_chunk=0, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        Engine(cfg_t, pt, cache_layout="contiguous", prefill_chunk=0,
               use_kernel=True, device="cpu")
    with pytest.raises(ValueError, match="layout"):
        Engine(cfg_t, pt, cache_layout="ring", device="cpu")
    # the prefix cache needs the paged pool, on-demand pages and no ring
    with pytest.raises(ValueError, match="paged"):
        Engine(cfg_t, pt, cache_layout="contiguous", prefix_cache=True,
               device="cpu")
    with pytest.raises(ValueError, match="on-demand"):
        Engine(cfg_t, pt, cache_layout="paged", preemption=False,
               prefix_cache=True, device="cpu")
    with pytest.raises(ValueError, match="sliding-window"):
        Engine(cfg_t.with_(sliding_window=8), pt, max_len=64,
               prefix_cache=True, device="cpu")


@pytest.mark.parametrize("layout_args", [
    ["--prefill-chunk", "16", "--use-kernel"],
    ["--cache-layout", "contiguous", "--prefill-chunk", "0", "--use-flash",
     "--use-flash-decode"],
])
def test_serve_launcher_runs_each_layout_on_cpu(layout_args, capsys):
    from repro_torch.launch.serve import main
    assert main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                 "--requests", "3", "--max-new", "4", "--max-len", "64",
                 "--max-batch", "2", "--use-moe-decode", "--use-moe-kernel",
                 "--lexi-budget-frac", "0.5", *layout_args]) == 0
    out = capsys.readouterr().out
    assert "baseline:" in out and "LExI:" in out
    assert ("layout=contiguous" in out) == ("contiguous" in layout_args)


def test_serve_launcher_runs_int8_experts_on_cpu(capsys):
    from repro_torch.launch.serve import main
    assert main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                 "--requests", "3", "--max-new", "4", "--max-len", "64",
                 "--max-batch", "2", "--prefill-chunk", "16", "--use-kernel",
                 "--use-moe-decode", "--use-moe-kernel",
                 "--lexi-budget-frac", "0.5", "--expert-dtype", "int8"]) == 0
    out = capsys.readouterr().out
    assert "experts=int8" in out
    assert "baseline:" in out and "LExI:" in out
