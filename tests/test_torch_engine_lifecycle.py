"""The port's engine lifecycle, admission policies and chunked prefill on
the contiguous layout, against the JAX reference's engine.

* Open loop: requests submitted at ``arrival_times`` on a ``VirtualClock``
  (one tick a step) enter mid-flight; tokens and the queueing and
  first-token delays (in steps) equal the reference's, and the tokens equal
  the closed-loop serve's.  ``next_arrival``, an idle ``step`` and
  ``drain`` idling the clock toward the next arrival.
* ``cancel`` of a request not yet arrived, queued and live; ``pop_finished``
  mid-flight; ``truncate_prompts``; whole-lifetime reservation
  (``preemption=False``); the four admission policies on a tight pool and
  the ``sjf`` scheduler: tokens, preemptions and the pool's counters equal
  the reference's.
* Chunked prefill on the contiguous layout (the default there): tokens
  equal the reference's contiguous chunked engine, on GQA, on a
  sliding-window ring that the prompts and their decode wrap, and on MLA.
* ``launch/serve.py`` on the CPU with ``--prefix-cache``, ``--plan-ladder
  base,lexi --degrade-under-pressure`` and ``--open-loop-rate``.

Every JAX engine blocks on each device step (``_synchronous``: its CPU
block table is updated in place while an asynchronous step may still read
it).  Tiny f32 configs on ``gmm``, so tokens must be equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: F401,E402


MAX_LEN = 64
STEPS = 800


def _synchronous(engine):
    """Block on each of the JAX engine's device steps before it goes on
    (its CPU block table is updated in place while an asynchronous step
    may still read it).  Blocking changes no value a step computes."""
    import jax
    for name in ("chunk_prefill", "decode", "whole_prefill"):
        fn = getattr(engine.runner, name)
        setattr(engine.runner, name,
                lambda *a, fn=fn, **kw: jax.block_until_ready(fn(*a, **kw)))
    return engine


def _cfgs(arch="gqa"):
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    if arch == "mla":
        kw = dict(moe_impl="gmm", num_layers=3, dtype="float32")
        return (jget("deepseek-v2-lite").reduced().with_(**kw),
                tget("deepseek-v2-lite").reduced().with_(**kw))
    kw = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
              head_dim=32, num_experts=4, moe_top_k=2, moe_d_ff=64,
              vocab_size=128, vocab_pad_multiple=16, dtype="float32",
              moe_impl="gmm")
    return (jget("olmoe-1b-7b").reduced().with_(**kw),
            tget("olmoe-1b-7b").reduced().with_(**kw))


_MODELS: dict = {}


def _model(arch="gqa"):
    if arch not in _MODELS:
        import jax
        from repro import models as jm
        from repro_torch.convert import convert_params
        cfg_j, cfg_t = _cfgs(arch)
        pj = jax.jit(lambda k: jm.init_params(k, cfg_j))(
            jax.random.PRNGKey(0))
        pt = convert_params(jax.tree.map(np.asarray, pj), cfg_t,
                            device="cpu")
        _MODELS[arch] = (cfg_j, cfg_t, pj, pt)
    return _MODELS[arch]


_ENGINES: dict = {}


def _engines(arch="gqa", window=None, fresh=False, **kw):
    """The reference's engine and the port's on one model; one pair per
    setting, shared by the tests (both sides always share a history, and
    the JAX one compiles its steps once), or a new pair when ``fresh``.
    ``virtual=True`` gives each a ``VirtualClock``."""
    from repro.serving import Engine as JEngine
    from repro_torch.serving import Engine as TEngine
    key = (arch, window, tuple(sorted(kw.items())))
    if fresh or key not in _ENGINES:
        cfg_j, cfg_t, pj, pt = _model(arch)
        if window:
            cfg_j, cfg_t = (c.with_(sliding_window=window)
                            for c in (cfg_j, cfg_t))
        common = dict(max_batch=2, max_len=MAX_LEN, prefill_chunk=4,
                      page_size=4)
        common.update(kw)
        clocks = ({}, {})
        if common.pop("virtual", False):
            from repro.serving import VirtualClock as JClock
            from repro_torch.serving import VirtualClock as TClock
            clocks = (dict(clock=JClock()), dict(clock=TClock()))
        pair = (_synchronous(JEngine(cfg_j, pj, **common, **clocks[0])),
                TEngine(cfg_t, pt, device="cpu", **common, **clocks[1]))
        if fresh:
            return pair
        _ENGINES[key] = pair
    return _ENGINES[key]


def _requests(mod, n, lo=5, hi=20, max_new=6, seed=0, vocab=128):
    rng = np.random.default_rng(seed)
    return [mod.Request(uid=i, prompt=rng.integers(
        0, vocab, rng.integers(lo, hi)).astype(np.int32),
        max_new_tokens=max_new) for i in range(n)]


RESULT_KEYS = ("tokens", "finished_reason", "prompt_len", "truncated",
               "preemptions", "recompute_tokens")
#: delays in steps, compared where both engines run a VirtualClock
TIMING_KEYS = ("queue_delay_s", "ttft_s")
STAT_KEYS = ("prefill_tokens", "decode_tokens", "recompute_tokens",
             "steps", "preemptions", "live_peak")


def _same(rj, rt, keys=RESULT_KEYS):
    assert [r.uid for r in rt] == [r.uid for r in rj]
    for a, b in zip(rj, rt):
        for k in keys:
            assert getattr(b, k) == getattr(a, k), (k, a.uid)


def _serve_both(ej, et, reqs, **kw):
    from repro import serving as js
    from repro_torch import serving as ts
    rj = ej.serve(reqs(js), max_steps=STEPS, **kw)
    rt = et.serve(reqs(ts), max_steps=STEPS, **kw)
    virtual = isinstance(et.clock, ts.VirtualClock)
    _same(rj, rt, RESULT_KEYS + (TIMING_KEYS if virtual else ()))
    for k in STAT_KEYS:
        assert et.stats[k] == ej.stats[k], k
    return rj, rt


# --------------------------------------------------------------------------- #
# Open-loop arrivals
# --------------------------------------------------------------------------- #


def test_open_loop_virtual_clock_matches_reference():
    from repro_torch import serving as ts
    ej, et = _engines(virtual=True)
    reqs = lambda mod: _requests(mod, 6, max_new=5)
    arrivals = [0, 2, 4, 6, 8, 30]          # the last after an idle gap
    rj, rt = _serve_both(ej, et, reqs, arrival_times=arrivals)
    assert et.stats["ttft_p95_s"] == ej.stats["ttft_p95_s"]
    # the idle gap cost no engine steps: the clock jumped to the arrival
    assert rt[-1].queue_delay_s == 0.0
    _, closed = _serve_both(ej, et, reqs)
    assert [r.tokens for r in rt] == [r.tokens for r in closed]
    with pytest.raises(ValueError, match="arrival_times"):
        et.serve(reqs(ts), arrival_times=[0.0])


def test_next_arrival_idle_step_and_drain():
    from repro_torch import serving as ts
    _, et = _engines(virtual=True, fresh=True)      # absolute times below
    r = _requests(ts, 2)
    assert et.next_arrival() is None
    et.submit(r[1], arrival_time=7.0)
    et.submit(r[0], arrival_time=3.0)
    assert et.next_arrival() == 3.0
    assert not et.idle()
    assert et.step() == [] and et.stats["steps"] == 0   # nothing due yet
    with pytest.raises(ValueError, match="duplicate"):
        et.submit(r[0])
    done = et.drain()
    assert sorted(x.uid for x in done) == [0, 1]
    assert et.next_arrival() is None and et.idle()


# --------------------------------------------------------------------------- #
# cancel, pop_finished, truncation
# --------------------------------------------------------------------------- #


def test_cancel_in_each_place_and_pop_finished_match_reference():
    from repro import serving as js
    from repro_torch import serving as ts
    ej, et = _engines(virtual=True, fresh=True)     # absolute times below
    out = {}
    for tag, eng, mod in (("j", ej, js), ("t", et, ts)):
        reqs = _requests(mod, 5, max_new=8)
        for r in reqs[:4]:
            eng.submit(r)
        eng.submit(reqs[4], arrival_time=50.0)
        eng.step()                          # uids 0, 1 live; 2, 3 queued
        assert eng.cancel(4) and eng.cancel(3) and eng.cancel(0)
        assert not eng.cancel(0) and not eng.cancel(99)
        mid = eng.pop_finished()            # the three cancelled
        eng.submit(mod.Request(uid=0, prompt=reqs[0].prompt,
                               max_new_tokens=3))  # its uid is free again
        rest = eng.drain(max_steps=STEPS)
        out[tag] = (mid, rest, eng.pop_finished())
    for a, b in zip(out["j"], out["t"]):
        _same(sorted(a, key=lambda r: r.uid), sorted(b, key=lambda r: r.uid),
              RESULT_KEYS + TIMING_KEYS)
    mid = out["t"][0]
    assert sorted(r.uid for r in mid) == [0, 3, 4]
    assert all(r.finished_reason == "cancelled" for r in mid)
    assert et.kv.free_pages() == et.kv.num_pages - 1
    assert et.sched.finished == [] and not et.sched._uids


def test_truncate_prompts_matches_reference():
    from repro_torch import serving as ts
    reqs = lambda mod: _requests(mod, 3, lo=70, hi=90, max_new=4)
    ej, et = _engines(truncate_prompts=True)
    _, rt = _serve_both(ej, et, reqs)
    assert all(r.truncated and r.prompt_len == MAX_LEN - 1 for r in rt)
    _, plain = _engines()
    out = plain.serve(reqs(ts))
    assert all(r.finished_reason == "rejected_prompt_too_long" for r in out)


# --------------------------------------------------------------------------- #
# Reservation, admission policies, scheduler
# --------------------------------------------------------------------------- #


def test_whole_lifetime_reservation_matches_reference():
    ej, et = _engines(max_batch=3, preemption=False, num_pages=12)
    _serve_both(ej, et, lambda mod: _requests(mod, 5, 10, 25, max_new=12))
    assert et.stats["preemptions"] == 0 and not et.ondemand
    assert et.kv.stats == ej.kv.stats
    assert et.kv.free_pages() == et.kv.num_pages - 1


@pytest.mark.parametrize("policy", ["headroom", "watermark", "lookahead",
                                    "greedy"])
def test_admission_policies_match_reference_on_a_tight_pool(policy):
    ej, et = _engines(max_batch=3, num_pages=10, admission=policy,
                      admission_watermark=0.3)
    _serve_both(ej, et, lambda mod: _requests(mod, 6, 10, 25, max_new=12))
    assert et.kv.stats == ej.kv.stats
    assert et._admission_headroom() == ej._admission_headroom()
    if policy == "greedy":
        assert et.stats["preemptions"] > 0


def test_sjf_scheduler_matches_reference():
    ej, et = _engines(max_batch=1, scheduler="sjf", virtual=True)
    _, rt = _serve_both(ej, et, lambda mod: _requests(mod, 4, max_new=3))
    by_admit = sorted(rt, key=lambda r: r.queue_delay_s)
    assert [r.prompt_len for r in by_admit] == sorted(r.prompt_len
                                                      for r in rt)


def test_engine_lifecycle_options_are_checked():
    from repro_torch.serving import Engine
    _, cfg_t, _, pt = _model()
    with pytest.raises(ValueError, match="admission"):
        Engine(cfg_t, pt, admission="eager", device="cpu")
    with pytest.raises(ValueError, match="preemption=True"):
        Engine(cfg_t, pt, admission="greedy", preemption=False,
               device="cpu")
    with pytest.raises(ValueError, match="paged"):
        Engine(cfg_t, pt, cache_layout="contiguous", preemption=True,
               device="cpu")
    with pytest.raises(ValueError, match="policy"):
        Engine(cfg_t, pt, scheduler="lifo", device="cpu")


# --------------------------------------------------------------------------- #
# Chunked prefill on the contiguous layout
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("case", ["gqa", "gqa_window", "mla"])
def test_contiguous_chunked_prefill_matches_reference(case):
    arch = case.split("_")[0]
    window = 16 if case == "gqa_window" else None
    ej, et = _engines(arch, window=window, max_batch=3,
                      cache_layout="contiguous", prefill_chunk=None,
                      prefill_pad=8)
    assert et.chunked and et.prefill_chunk == ej.prefill_chunk == 8
    _, rt = _serve_both(ej, et, lambda mod: _requests(
        mod, 4, 5, 30, max_new=6, vocab=_model(arch)[1].vocab_size))
    keys = {k[1] for k in et.runner.compiled_specializations()}
    assert keys == {"chunk", "decode"}
    assert all((layer["pos"] == -1).all() for layer in et.kv.caches)


# --------------------------------------------------------------------------- #
# The launcher
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("extra,expect", [
    (["--prefix-cache"], "prefix_hit="),
    (["--plan-ladder", "base,lexi", "--degrade-under-pressure"],
     "plan degradations:"),
    (["--open-loop-rate", "200"], "open loop: Poisson arrivals"),
])
def test_serve_launcher_lifecycle_flags_on_cpu(extra, expect, capsys):
    from repro_torch.launch.serve import main
    assert main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                 "--requests", "4", "--max-new", "4", "--max-len", "64",
                 "--max-batch", "2", "--moe-impl", "gmm",
                 "--lexi-budget-frac", "0.5", *extra]) == 0
    out = capsys.readouterr().out
    assert "baseline:" in out and expect in out
    if "--plan-ladder" in extra:
        assert "ladder base->lexi:" in out
