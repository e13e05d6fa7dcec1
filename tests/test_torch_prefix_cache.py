"""The port's prefix cache and plan-degradation ladder against the JAX
reference.

* ``PrefixIndex``: the port's copy and the reference's, driven through one
  sequence of operations (roots per salt, registration, first-wins dedup,
  matching, unregistering); every return value and the index's state must
  be equal.
* ``KVCache`` sharing, GQA and MLA leaves: the same pages filled with the
  same random bytes on both sides, then one sequence of operations --
  adoption with a copy-on-write boundary, a full-page hit, release parking
  indexed pages in the LRU, LRU eviction, a rolled-back allocation.  After
  each, the host table, the refcounts, the free list, the LRU's order, the
  stats and every page leaf on the device must be equal (the copied page's
  bytes, and its ``posp`` masked to -1 at and past ``keep_below``).
* The engine with ``prefix_cache=True`` on the reference's ``_family``
  workloads (one shared head, random suffixes): greedy tokens, the prefix,
  copy-on-write and preemption counters and the per-result fields equal to
  the reference engine's, cold then warm, with the plan salts kept apart,
  and with preemption interleaved on a 13-page pool; GQA and MLA (the
  reduced DeepSeek-V2-Lite).
* The ladder: degradations, served plans and tokens equal to the
  reference's, GQA and MLA; priority requests exempt; unknown rungs refused; a request
  degraded when it resumes after preemption.

Every JAX engine here blocks on each device step (``_synchronous``): its
block table is a device array made from the host table without a copy on
the CPU, and admissions update that table in place while an asynchronous
step may still read it.  Tiny configs (2 layers, d_model 64, f32, ``gmm``),
so tokens must be equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: F401,E402


SALT = ("base", "bf16")
MAX_LEN = 64
CHUNK = 4
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


# --------------------------------------------------------------------------- #
# PrefixIndex
# --------------------------------------------------------------------------- #


def test_prefix_index_matches_reference():
    from repro.serving.prefix_cache import PrefixIndex as JIndex
    from repro_torch.serving.prefix_cache import PrefixIndex as TIndex
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 50, 16).astype(np.int32)
    other = toks.copy()
    other[5] += 1
    ix = {"j": JIndex(4), "t": TIndex(4)}

    def both(fn):
        a, b = fn(ix["j"]), fn(ix["t"])
        assert a == b
        return a
    both(lambda i: i.root(SALT))
    both(lambda i: i.root(("lexi", "bf16")))
    c = both(lambda i: i.root(SALT))
    for j, page in enumerate((7, 9, 11)):
        c = both(lambda i: i.register(c, toks[4 * j:4 * j + 4], page))
    both(lambda i: i.register(i.root(SALT), toks[:4], 5))   # first wins
    both(lambda i: i.match(SALT, toks))
    both(lambda i: i.match(SALT, toks[:11]))
    both(lambda i: i.match(SALT, other))
    both(lambda i: i.match(("lexi", "bf16"), toks))
    both(lambda i: (i.is_indexed(7), i.is_indexed(5), len(i)))
    both(lambda i: i.unregister(9))
    both(lambda i: i.match(SALT, toks))
    both(lambda i: i.unregister(9))                          # idempotent
    both(lambda i: (i.is_indexed(11), len(i)))
    assert ix["t"]._entries == ix["j"]._entries
    assert ix["t"]._keys == ix["j"]._keys
    assert ix["t"]._roots == ix["j"]._roots


# --------------------------------------------------------------------------- #
# KVCache sharing
# --------------------------------------------------------------------------- #


def _kv_cfgs(arch):
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    if arch == "mla":
        kw = dict(num_layers=2, moe_impl="gmm", dtype="float32")
        return (jget("deepseek-v2-lite").reduced().with_(**kw),
                tget("deepseek-v2-lite").reduced().with_(**kw))
    kw = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
              head_dim=16, num_experts=4, moe_top_k=2, moe_d_ff=32,
              vocab_size=64, vocab_pad_multiple=16, dtype="float32",
              moe_impl="gmm")
    return (jget("olmoe-1b-7b").reduced().with_(**kw),
            tget("olmoe-1b-7b").reduced().with_(**kw))


def _group_sizes(caches):
    """Layers in each of the reference's cache groups (a group of one
    layer is not stacked)."""
    return [g["posp"].shape[0] if g["posp"].ndim == 3 else 1 for g in caches]


def _jax_layers(caches):
    """The reference's paged caches (layer groups) as one dict of numpy
    arrays per layer, the port's layout."""
    out = []
    for group, n in zip(caches, _group_sizes(caches)):
        g = {k: np.asarray(v) for k, v in group.items()}
        if group["posp"].ndim == 2:
            out.append(g)
        else:
            out.extend({k: v[i] for k, v in g.items()} for i in range(n))
    return out


def _kv_pair(arch, num_pages=None, max_batch=3):
    """The reference's and the port's KVCache on one config, every page
    leaf (trash page 0 aside) filled with the same random bytes and each
    page's ``posp`` with positions a page would hold."""
    import jax.numpy as jnp
    from repro.serving import KVCache as JKV
    from repro_torch.serving import KVCache as TKV
    cfg_j, cfg_t = _kv_cfgs(arch)
    kw = dict(layout="paged", page_size=4, num_pages=num_pages,
              prefix_cache=True)
    kj = JKV(cfg_j, max_batch, 32, **kw)
    kt = TKV(cfg_t, max_batch, 32, device="cpu", **kw)
    rng = np.random.default_rng(1)
    for layer in kt.caches:
        for name, t in layer.items():
            if name == "posp":
                # page p as block p - 1 of a sequence (slot 0 takes
                # pages 1, 2, ... first)
                n, p = t.shape
                v = (np.arange(p)[None] + 4 * (np.arange(n)[:, None] - 1))
            else:
                v = rng.normal(size=tuple(t.shape))
            t.copy_(torch.from_numpy(v.astype(np.int32 if name == "posp"
                                              else np.float32)))
            t[0] = -1 if name == "posp" else 0
    groups, li = [], 0
    for group, n in zip(kj.caches, _group_sizes(kj.caches)):
        layers = kt.caches[li:li + n]
        li += n
        groups.append({k: jnp.asarray(
            layers[0][k].numpy() if group["posp"].ndim == 2
            else np.stack([lay[k].numpy() for lay in layers]))
            for k in group})
    kj.caches = groups
    return kj, kt


def _same_state(kj, kt):
    assert np.array_equal(kt.table, kj.table)
    assert np.array_equal(kt.ref, kj.ref)
    assert kt._free == kj._free
    assert list(kt._lru) == list(kj._lru)
    assert kt._owned == kj._owned
    assert kt.stats == kj.stats
    assert kt.free_pages() == kj.free_pages()
    assert kt.index._entries == kj.index._entries
    for layer, want in zip(kt.caches, _jax_layers(kj.caches)):
        for k, t in layer.items():
            assert np.array_equal(t.numpy(), want[k]), k
    assert np.array_equal(kt.block_tables().numpy(), kt.table)


def _seed_slot0(kv, toks):
    """Allocate slot 0 over ``toks`` and register its full pages."""
    assert kv.allocate(0, len(toks))
    chain = kv.prefix_root(SALT)
    for j in range(len(toks) // kv.page_size):
        chain = kv.register_page(
            chain, toks[j * kv.page_size:(j + 1) * kv.page_size],
            kv.slot_pages(0)[j])
    return chain


@pytest.mark.parametrize("arch", ["gqa", "mla"])
def test_kv_cache_sharing_matches_reference(arch):
    kj, kt = _kv_pair(arch)
    toks = np.arange(8, dtype=np.int32)
    both = lambda fn: (fn(kj), fn(kt))
    assert len(set(both(lambda k: _seed_slot0(k, toks)))) == 1
    _same_state(kj, kt)
    # a hit capped mid-page: adopt page 0, copy-on-write page 1
    mj, mt = both(lambda k: k.match_prefix(SALT, toks, 7))
    assert mj == mt and mt[1] == 7
    assert both(lambda k: k.allocate(1, 8, shared=mt[0], keep_below=7)) \
        == (True, True)
    _same_state(kj, kt)
    src, dst = kt.slot_pages(0)[1], kt.slot_pages(1)[1]
    assert src != dst and kt.stats["cow_copies"] == 1
    for layer in kt.caches:
        for name, leaf in layer.items():
            if name == "posp":
                want = torch.where(leaf[src] < 7, leaf[src], -1)
                assert leaf[dst].tolist() == [4, 5, 6, -1]
            else:
                want = leaf[src]
            assert torch.equal(leaf[dst], want), name
    kt.assert_private(1, 7, 8)
    with pytest.raises(AssertionError):
        kt.assert_private(1, 0, 4)
    # a page-aligned hit: both pages shared, no copy
    longer = np.concatenate([toks, np.arange(100, 103, dtype=np.int32)])
    mj, mt = both(lambda k: k.match_prefix(SALT, longer, 10))
    assert mj == mt and mt[1] == 8
    assert both(lambda k: k.allocate(2, 11, shared=mt[0], keep_below=8)) \
        == (True, True)
    _same_state(kj, kt)
    # releases: slot 1's private copy resets and frees, indexed pages park
    for slot in (1, 0, 2):
        both(lambda k: k.release(slot))
        _same_state(kj, kt)
    assert kt.stats["pages_in_use"] == 0 and len(kt._lru) == 2
    # re-adoption pins parked pages live again
    mj, mt = both(lambda k: k.match_prefix(SALT, toks, 8))
    assert mj == mt
    both(lambda k: k.allocate(0, 8, shared=mt[0], keep_below=8))
    _same_state(kj, kt)
    both(lambda k: k.release(0))
    _same_state(kj, kt)


@pytest.mark.parametrize("arch", ["gqa", "mla"])
def test_kv_cache_lru_eviction_and_rollback_match_reference(arch):
    kj, kt = _kv_pair(arch, num_pages=4, max_batch=2)
    toks = np.arange(8, dtype=np.int32)
    both = lambda fn: (fn(kj), fn(kt))
    both(lambda k: _seed_slot0(k, toks))
    # needs 2 shared + 1 copy + 2 fresh > the pool: rolled back
    mj, mt = both(lambda k: k.match_prefix(SALT, toks, 7))
    assert both(lambda k: k.allocate(1, 16, shared=mt[0], keep_below=7)) \
        == (False, False)
    _same_state(kj, kt)
    assert [int(kt.ref[p]) for p in kt.slot_pages(0)] == [1, 1]
    both(lambda k: k.release(0))            # 2 parked, 2 free
    _same_state(kj, kt)
    assert both(lambda k: k.allocate(1, 16)) == (True, True)   # evicts both
    assert kt.stats["cache_evictions"] == 2
    _same_state(kj, kt)
    assert kt.match_prefix(SALT, toks, 8)[1] == 0
    both(lambda k: k.release(1))
    _same_state(kj, kt)
    assert kt.free_pages() == 4


# --------------------------------------------------------------------------- #
# Engine end to end
# --------------------------------------------------------------------------- #


def _engine_cfgs(arch):
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


def _model(arch):
    if arch not in _MODELS:
        import jax
        from repro import models as jm
        from repro_torch.convert import convert_params
        cfg_j, cfg_t = _engine_cfgs(arch)
        pj = jax.jit(lambda k: jm.init_params(k, cfg_j))(
            jax.random.PRNGKey(0))
        pt = convert_params(jax.tree.map(np.asarray, pj), cfg_t,
                            device="cpu")
        _MODELS[arch] = (cfg_j, cfg_t, pj, pt)
    return _MODELS[arch]


_ENGINES: dict = {}


def _engines(arch, **kw):
    """The reference's engine and the port's on one model, with a ``lexi``
    plan (k 1 at every MoE layer) registered on both; one pair per
    setting, shared by the tests (both sides always share a history, and
    the JAX one compiles its steps once)."""
    from repro.serving import Engine as JEngine
    from repro_torch.serving import Engine as TEngine
    key = (arch, tuple(sorted(kw.items())))
    if key not in _ENGINES:
        cfg_j, cfg_t, pj, pt = _model(arch)
        common = dict(max_batch=4, max_len=MAX_LEN, prefill_chunk=CHUNK,
                      cache_layout="paged", page_size=4)
        common.update(kw)
        ej = _synchronous(JEngine(cfg_j, pj, **common))
        et = TEngine(cfg_t, pt, device="cpu", **common)
        plan = (1,) * cfg_t.num_moe_layers
        for e in (ej, et):
            e.add_plan("lexi", plan)
        _ENGINES[key] = (ej, et)
    return _ENGINES[key]


def _family(mod, vocab, n_req, seed, plen=18, suffix=3, max_new=5, **kw):
    """``n_req`` requests sharing one ``plen``-token head + random
    suffixes."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, plen).astype(np.int32)
    return [mod.Request(uid=i, prompt=np.concatenate(
        [head, rng.integers(0, vocab, suffix).astype(np.int32)]),
        max_new_tokens=max_new, **kw) for i in range(n_req)]


STAT_KEYS = ("prefill_tokens", "decode_tokens", "recompute_tokens",
             "steps", "preemptions", "prefix_hit_tokens", "cow_copies",
             "plan_degradations", "mixed_plan_steps", "prefix_hit_rate")
RESULT_KEYS = ("tokens", "finished_reason", "prefix_hit_tokens",
               "cow_copies", "preemptions", "recompute_tokens", "plan",
               "served_plan", "plan_degradations")


def _serve_both(ej, et, reqs, **kw):
    """Serve the same workload on both engines; tokens, counters and the
    per-result fields must be equal.  ``reqs(mod)`` builds it."""
    from repro import serving as js
    from repro_torch import serving as ts
    rj = ej.serve(reqs(js), max_steps=STEPS, **kw)
    rt = et.serve(reqs(ts), max_steps=STEPS, **kw)
    assert [r.uid for r in rt] == [r.uid for r in rj]
    for a, b in zip(rj, rt):
        for k in RESULT_KEYS:
            assert getattr(b, k) == getattr(a, k), (k, a.uid)
    for k in STAT_KEYS:
        assert et.stats[k] == ej.stats[k], k
    assert et.kv.stats == ej.kv.stats
    return rj, rt


def _drained(eng):
    assert eng.kv.stats["pages_in_use"] == 0
    assert int(eng.kv.ref.sum()) == 0
    assert eng.kv.free_pages() == eng.kv.num_pages - 1


@pytest.mark.parametrize("arch", ["gqa", "mla"])
def test_prefix_cache_cold_then_warm_matches_reference(arch):
    cfg = _model(arch)[1]
    off_j, off_t = _engines(arch)
    ej, et = _engines(arch, prefix_cache=True)
    reqs = lambda mod: _family(mod, cfg.vocab_size, 6, seed=1)
    ref, _ = _serve_both(off_j, off_t, reqs)
    for serve in ("cold", "warm"):
        _, out = _serve_both(ej, et, reqs)
        assert [r.tokens for r in out] == [r.tokens for r in ref], serve
        _drained(et)
    # the warm serve maps whole heads in: more hit than computed
    assert et.stats["prefix_hit_tokens"] > et.stats["prefill_tokens"]
    assert sum(r.cow_copies for r in out) == et.stats["cow_copies"]
    assert (et.stats["prefill_tokens"] + et.stats["prefix_hit_tokens"]
            == sum(r.prompt_len for r in out))


def test_prefix_cache_plan_salts_kept_apart():
    cfg = _model("gqa")[1]
    ej, et = _engines("gqa", prefix_cache=True)
    reqs = lambda mod: _family(mod, cfg.vocab_size, 4, seed=2)
    _serve_both(ej, et, reqs)                        # warms the base salt
    _, l1 = _serve_both(ej, et, reqs, plan="lexi")
    first = et.stats["prefix_hit_tokens"]
    _, l2 = _serve_both(ej, et, reqs, plan="lexi")
    assert et.stats["prefix_hit_tokens"] > first
    assert [r.tokens for r in l1] == [r.tokens for r in l2]
    # an expert dtype is part of the salt too
    assert et._salt_for("lexi") == ("lexi", "bf16")


@pytest.mark.parametrize("arch", ["gqa", "mla"])
def test_prefix_cache_preemption_interleaved_matches_reference(arch):
    cfg = _model(arch)[1]
    off_j, off_t = _engines(arch)
    # 6 shared-head requests, ceil(21/4) = 6 prompt pages each, 13 pages
    ej, et = _engines(arch, prefix_cache=True, num_pages=13)
    reqs = lambda mod: _family(mod, cfg.vocab_size, 6, seed=3)
    ref, _ = _serve_both(off_j, off_t, reqs)
    _, out = _serve_both(ej, et, reqs)
    assert [r.tokens for r in out] == [r.tokens for r in ref]
    assert et.stats["preemptions"] > 0
    assert et.stats["prefix_hit_tokens"] > 0
    _drained(et)


# --------------------------------------------------------------------------- #
# The plan-degradation ladder
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ["gqa", "mla"])
def test_ladder_degradations_and_tokens_match_reference(arch):
    cfg = _model(arch)[1]
    ej, et = _engines(arch, max_batch=2, degrade_under_pressure=True)
    for e in (ej, et):
        e.set_plan_ladder(["base", "lexi"])
    # budgets of 3-7 tokens, so base and lexi requests overlap
    reqs = lambda mod: [
        mod.Request(uid=r.uid, prompt=r.prompt,
                    max_new_tokens=3 + 2 * (r.uid % 3))
        for r in _family(mod, cfg.vocab_size, 6, seed=4)]
    _, out = _serve_both(ej, et, reqs)
    assert et.stats["plan_degradations"] > 0
    assert et.stats["mixed_plan_steps"] > 0
    # each request has the tokens of its served plan's single-plan serve
    _, base = _serve_both(*_engines(arch, max_batch=2), reqs)
    _, lexi = _serve_both(*_engines(arch, max_batch=2), reqs, plan="lexi")
    for r in out:
        want = lexi if r.plan_degradations else base
        assert r.served_plan == ("lexi" if r.plan_degradations else "base")
        assert r.tokens == want[r.uid].tokens, r.uid


def test_ladder_exempts_priority_requests_and_checks_names():
    cfg = _model("gqa")[1]
    ej, et = _engines("gqa", max_batch=2, degrade_under_pressure=True)
    with pytest.raises(ValueError, match="unknown plan"):
        et.set_plan_ladder(["base", "nope"])
    for e in (ej, et):
        e.set_plan_ladder(["base", "lexi"])
    reqs = lambda mod: [
        mod.Request(uid=r.uid, prompt=r.prompt, max_new_tokens=5,
                    priority=r.uid % 2)
        for r in _family(mod, cfg.vocab_size, 6, seed=5)]
    _, out = _serve_both(ej, et, reqs)
    assert et.stats["plan_degradations"] > 0
    assert all(r.plan_degradations == 0 and r.served_plan == "base"
               for r in out if r.uid % 2)
    # declared but inert without the policy
    ej, et = _engines("gqa", max_batch=2)
    for e in (ej, et):
        e.set_plan_ladder(["base", "lexi"])
    _serve_both(ej, et, reqs)
    assert et.stats["plan_degradations"] == 0


def test_ladder_degrades_a_request_when_it_resumes():
    """Admitted under base without pressure, preempted when decode drains
    the pool, re-admitted one rung down (pool pressure): the resume
    recomputes under lexi, with the prefix cache on (its salt misses the
    base pages)."""
    cfg = _model("gqa")[1]
    kw = dict(max_batch=3, num_pages=13, degrade_under_pressure=True,
              degrade_watermark=0.4, prefix_cache=True)
    ej, et = _engines("gqa", **kw)
    for e in (ej, et):
        e.set_plan_ladder(["base", "lexi"])
    resumes = []
    commit = et._commit_plan

    def recording(t, served):
        if served != t.served_plan:
            resumes.append(t.result.preemptions)
        commit(t, served)
    et._commit_plan = recording
    reqs = lambda mod: _family(mod, cfg.vocab_size, 3, seed=6, plen=12,
                               suffix=4, max_new=16)
    try:
        _, out = _serve_both(ej, et, reqs)
    finally:
        del et._commit_plan
    assert any(resumes), resumes        # one degraded at a re-admission
    assert et.stats["preemptions"] > 0
    _drained(et)
