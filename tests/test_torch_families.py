"""The seven architectures the port serves on its paged engine beside the
paper's MoE models, against the JAX reference on the CPU:
qwen3-moe-235b-a22b, llama4-scout-17b-a16e, qwen3-32b, h2o-danube-1.8b,
minicpm3-4b, olmo-1b (OLMo's non-parametric LayerNorm) and pixtral-12b (a
VLM: patch embeddings ahead of the tokens).

Each runs at ``.reduced()`` widths (d_model 128, hd 32, f32), 2 layers deep,
with its own
head grouping: 2 kv heads and 2g query heads, g being the config's own
(16, 5, 8, 4, pixtral's 4), and danube's head size of 80 (its window cut to
16, under the prompts' lengths); minicpm3 is MLA at its reduced latent
shapes; olmo keeps the reduced 4 heads (g 1, as its own).  The
attention kernels' widened shapes (a group split over the grid, hd 80
padded to 128, MLA in head tiles) run only on the card; on the CPU these
tests hold the same grouping through the plain versions.

* ``loss_fn`` (loss, xent, aux) within 1e-4 of the reference's.
* A chunk step and a decode step on the paged pool, the kernel options on
  (their plain versions here), logits within 1e-4 of the reference's.
* Greedy tokens of the port's engine equal the JAX engine's (paged; danube
  on the contiguous layout too).  The MoE configs serve on the dropless
  ``gmm``.
* qwen3-moe: the port's plan equals the reference's ``optimize`` on the
  same sensitivity table, and the planned serve's tokens match.
* llama4-scout routes top-1: its plan is all ones, profiled or not.
* pixtral: a prefill of 16 patch embeddings plus the prompt, then decode
  steps at ``S + prefix_embed_len``, and the loss with the prefix, within
  1e-4 of the reference's.
* The port's ``configs.shapes`` (``SHAPES``, ``cells``, ``applicability``)
  and ``ASSIGNED`` / ``PAPER_MOES`` equal the reference's over all ten
  assigned configs.

Every JAX oracle is built once per family (module-scoped fixtures).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_ref import reference_params  # noqa: E402
from _torch_threads import one_thread  # noqa: F401,E402

TOL = dict(rtol=1e-4, atol=1e-4)

#: name -> the overrides on ``.reduced()``: the config's own head grouping
#: at 2 kv heads, danube's hd 80 and a window under the prompts
FAMILIES = {
    "qwen3-moe-235b-a22b": dict(num_heads=32, num_kv_heads=2),
    "llama4-scout-17b-a16e": dict(num_heads=10, num_kv_heads=2),
    "qwen3-32b": dict(num_heads=16, num_kv_heads=2),
    "h2o-danube-1.8b": dict(num_heads=8, num_kv_heads=2, head_dim=80,
                            sliding_window=16),
    "minicpm3-4b": {},
    "olmo-1b": {},
    "pixtral-12b": dict(num_heads=8, num_kv_heads=2),
}


@pytest.fixture(scope="module", params=list(FAMILIES))
def fam(request):
    """(cfg_j, cfg_t, reference params, the port's copy): the port's own
    init (a torch generator, seed 0), given to the reference as its stacked
    tree (``reference_params``), which ``convert_params`` maps back to the
    same tensors."""
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    from repro_torch.convert import convert_params
    from repro_torch.models import init_params
    from repro_torch.tree import flatten_with_paths
    kw = dict(FAMILIES[request.param], num_layers=2)
    cfg_j = jget(request.param).reduced().with_(**kw)
    cfg_t = tget(request.param).reduced().with_(**kw)
    if cfg_t.is_moe:
        cfg_j, cfg_t = (c.with_(moe_impl="gmm") for c in (cfg_j, cfg_t))
    pt = init_params(cfg_t, 0, device="cpu")
    pj = reference_params(pt, cfg_t)
    back = dict(flatten_with_paths(convert_params(pj, cfg_t, device="cpu")))
    assert all(torch.equal(back[k], v) for k, v in flatten_with_paths(pt))
    return cfg_j, cfg_t, pj, pt


def test_configs_are_the_references():
    from dataclasses import asdict
    from repro.configs import get_config as jget
    from repro_torch.configs import FAMILIES as PORTED, get_config as tget
    assert PORTED == tuple(FAMILIES)
    for name in FAMILIES:
        assert asdict(tget(name)) == asdict(jget(name)), name


def test_loss_matches_reference(fam):
    import jax
    import jax.numpy as jnp
    from repro import models as jm
    from repro_torch import models as tm
    cfg_j, cfg_t, pj, pt = fam
    if cfg_t.attention == "gqa":
        assert cfg_t.num_heads // cfg_t.num_kv_heads == \
            {32: 16, 10: 5, 16: 8, 8: 4, 4: 1}[cfg_t.num_heads]
    rng = np.random.default_rng(4)
    b, s = 2, 24
    batch = {"tokens": rng.integers(0, cfg_j.vocab_size, (b, s)),
             "targets": rng.integers(0, cfg_j.vocab_size, (b, s)),
             "mask": (rng.random((b, s)) > 0.2)}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    lj, mj = jax.jit(lambda p_, b_: jm.loss_fn(p_, cfg_j, b_))(
        pj, {k: jnp.asarray(v) for k, v in batch.items()})
    lt, mt = tm.loss_fn(pt, cfg_t, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    np.testing.assert_allclose(lt.item(), float(lj), **TOL)
    np.testing.assert_allclose(mt["xent"].item(), float(mj["xent"]), **TOL)
    np.testing.assert_allclose(mt["aux"].item(), float(mj["aux"]), **TOL)


def test_chunk_and_decode_logits_match_reference(fam):
    import jax
    import jax.numpy as jnp
    from repro import models as jm
    from repro_torch import models as tm
    cfg_j, cfg_t, pj, pt = fam
    rng = np.random.default_rng(0)
    b, c, p, n = 2, 8, 16, 9
    bt = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    cj = jm.init_caches(cfg_j, b, 64, layout="paged", page_size=p,
                        num_pages=n)
    ct = tm.init_caches(cfg_t, layout="paged", page_size=p,
                        num_pages=n, device="cpu")
    kern = tm.ModelOpts(use_moe_kernel=True, use_paged_kernel=True,
                        use_moe_decode_kernel=True)
    jopts = jm.ModelOpts(use_paged_kernel=True, use_moe_decode_kernel=True)
    jchunk = jax.jit(lambda p_, t, po, c_, li, bt_: jm.chunk_prefill_fn(
        p_, cfg_j, t, po, c_, last_index=li, block_tables=bt_))
    jdecode = jax.jit(lambda p_, t, po, c_, bt_: jm.decode_fn(
        p_, cfg_j, t, po, c_, block_tables=bt_, opts=jopts, kernel_blocks=2))
    for step in range(3):
        tok = rng.integers(0, cfg_j.vocab_size, (b, c)).astype(np.int32)
        pos = (np.arange(c)[None] + step * c).repeat(b, 0).astype(np.int32)
        if step == 2:
            pos[1, 5:] = -1                 # row 1's prompt ends mid-chunk
        last = np.array([c - 1, 4], np.int32)
        lj, cj = jchunk(pj, jnp.asarray(tok), jnp.asarray(pos), cj,
                        jnp.asarray(last), jnp.asarray(bt))
        lt, ct = tm.chunk_prefill_fn(pt, cfg_t, torch.from_numpy(tok),
                                     torch.from_numpy(pos), ct,
                                     last_index=torch.from_numpy(last),
                                     block_tables=torch.from_numpy(bt),
                                     opts=kern)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    tok = np.asarray(lj).argmax(-1).astype(np.int32)
    pos = np.array([24, 21], np.int32)
    lj, _ = jdecode(pj, jnp.asarray(tok), jnp.asarray(pos), cj,
                    jnp.asarray(bt))
    lt, _ = tm.decode_fn(pt, cfg_t, torch.from_numpy(tok),
                         torch.from_numpy(pos), ct,
                         block_tables=torch.from_numpy(bt), opts=kern,
                         kernel_blocks=2)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


def _requests(mod, n=2, lo=5, hi=30, max_new=5, seed=0):
    rng = np.random.default_rng(seed)
    return [mod.Request(uid=i, prompt=rng.integers(
        0, 256, rng.integers(lo, hi)).astype(np.int32),
        max_new_tokens=max_new) for i in range(n)]


def _synchronous(engine):
    """Block on each of the JAX engine's steps before it goes on: its paged
    block table is a device array made from the host table without a copy
    on the CPU, which admissions then update in place
    (``tests/test_torch_dense.py``)."""
    import jax
    for name in ("chunk_prefill", "decode", "whole_prefill"):
        fn = getattr(engine.runner, name)
        setattr(engine.runner, name,
                lambda *a, fn=fn, **kw: jax.block_until_ready(fn(*a, **kw)))
    return engine


def _serve_both(ej, et, plan=None):
    from repro import serving as js
    from repro_torch import serving as ts
    rj = ej.serve(_requests(js), plan=plan)
    rt = et.serve(_requests(ts), plan=plan)
    assert [r.uid for r in rj] == [r.uid for r in rt]
    for a, b in zip(rj, rt):
        assert b.tokens == a.tokens, (a.uid, a.tokens, b.tokens)
        assert b.finished_reason == a.finished_reason
    return rj, rt


@pytest.fixture(scope="module")
def engines(fam):
    """The JAX and the port's paged engines of a family, kept for the
    plan tests (one JAX engine a family)."""
    from repro import models as jm
    from repro.serving import Engine as JEngine
    from repro_torch.models import ModelOpts
    from repro_torch.serving import Engine as TEngine
    cfg_j, cfg_t, pj, pt = fam
    common = dict(max_batch=3, max_len=64, prefill_chunk=16, page_size=16,
                  use_kernel=True, use_moe_decode=True)
    ej = _synchronous(JEngine(cfg_j, pj, opts=jm.ModelOpts(), **common))
    et = TEngine(cfg_t, pt, opts=ModelOpts(use_moe_kernel=True),
                 device="cpu", **common)
    return ej, et


def test_engine_tokens_match_reference(fam, engines):
    from repro_torch import kernels
    ej, et = engines
    kernels.reset_launch_counts()
    _serve_both(ej, et)
    assert not any(kernels.launch_counts().values())  # plain versions
    assert et.stats["steps"] == ej.stats["steps"]
    cfg_j, cfg_t, pj, pt = fam
    if cfg_t.sliding_window:
        from repro import models as jm
        from repro.serving import Engine as JEngine
        from repro_torch.models import ModelOpts
        from repro_torch.serving import Engine as TEngine
        common = dict(max_batch=3, max_len=64, cache_layout="contiguous",
                      prefill_chunk=0, use_moe_decode=True)
        ej = _synchronous(JEngine(cfg_j, pj, opts=jm.ModelOpts(
            use_flash_decode=True), **common))
        et = TEngine(cfg_t, pt, opts=ModelOpts(
            use_flash=True, use_flash_decode=True, use_moe_kernel=True),
            device="cpu", **common)
        from repro_torch import serving as ts
        assert max(len(r.prompt) for r in _requests(ts)) > \
            cfg_t.sliding_window                 # the ring has wrapped
        _serve_both(ej, et)


@pytest.mark.parametrize("fam", ["qwen3-moe-235b-a22b"], indirect=True)
def test_qwen3_moe_plan_and_planned_serve_match_reference(fam, engines):
    from repro.core import optimize as joptimize
    from repro.core.sensitivity import SensitivityTable as JTable
    from repro_torch.core import SensitivityTable, optimize as toptimize
    cfg_j, cfg_t, pj, pt = fam
    # a table whose layers differ, so the plan is not uniform (the port's
    # profiling is held to the reference's in tests/test_torch_model.py)
    n, kb = cfg_t.num_moe_layers, cfg_t.moe_top_k
    values = np.random.default_rng(3).random((n, kb)) * np.linspace(
        4.0, 0.0, kb)[None] * np.arange(1, n + 1)[:, None]
    kw = dict(arch=cfg_t.name, k_base=kb, moe_layer_indices=tuple(range(n)),
              target_topks=tuple(range(1, kb + 1)), n_iter=1, values=values)
    want, table = JTable(**kw), SensitivityTable(**kw)
    budget = 3 * n * kb // 4
    pj_plan = joptimize(pj, cfg_j, budget, method="dp", table=want)
    pt_plan = toptimize(pt, cfg_t, budget, method="dp", table=table,
                        device="cpu")
    assert tuple(pt_plan.plan) == tuple(pj_plan.plan)
    assert sum(pt_plan.plan) == budget and len(set(pt_plan.plan)) > 1
    ej, et = engines
    ej.add_plan("lexi", tuple(pj_plan.plan))
    et.add_plan("lexi", tuple(pt_plan.plan))
    _, rt = _serve_both(ej, et, plan="lexi")
    assert all(r.served_plan == "lexi" for r in rt)


@pytest.mark.parametrize("fam", ["llama4-scout-17b-a16e"], indirect=True)
def test_llama4_scout_plan_is_all_ones(fam):
    from repro.core import optimize as joptimize
    from repro_torch.core import optimize as toptimize
    cfg_j, cfg_t, pj, pt = fam
    n = cfg_t.num_moe_layers
    plan = toptimize(pt, cfg_t, n, method="dp", device="cpu")
    assert tuple(plan.plan) == (1,) * n and plan.k_base == 1
    # the reference's search on the same (all-zero, k = 1) table agrees
    from repro.core.sensitivity import SensitivityTable as JTable
    table = JTable(arch=cfg_j.name, k_base=1,
                   moe_layer_indices=tuple(range(n)), target_topks=(1,),
                   n_iter=0, values=np.zeros((n, 1)))
    assert tuple(joptimize(pj, cfg_j, n, method="dp",
                           table=table).plan) == (1,) * n


@pytest.mark.parametrize("fam", ["pixtral-12b"], indirect=True)
def test_pixtral_prefix_prefill_and_decode_match_reference(fam):
    """16 patch embeddings ahead of a 12-token prompt: the whole prefill
    (the kernel options on, their plain versions here), three decode steps
    from position S + prefix_embed_len, and the loss with the prefix."""
    import jax
    import jax.numpy as jnp
    from repro import models as jm
    from repro_torch import models as tm
    cfg_j, cfg_t, pj, pt = fam
    plen = cfg_t.prefix_embed_len
    assert plen == 16 and "prefix_proj" in pt
    rng = np.random.default_rng(5)
    b, s = 2, 12
    tok = rng.integers(0, cfg_t.vocab_size, (b, s)).astype(np.int32)
    pre = rng.standard_normal((b, plen, cfg_t.d_model)).astype(np.float32)
    kern = tm.ModelOpts(use_flash=True, use_flash_decode=True)
    cj = jm.init_caches(cfg_j, b, 64)
    lj, cj = jax.jit(lambda p, t, e, c: jm.prefill_fn(
        p, cfg_j, {"tokens": t, "prefix_embeds": e}, c))(
            pj, jnp.asarray(tok), jnp.asarray(pre), cj)
    ct = tm.init_caches(cfg_t, b, 64, layout="contiguous", device="cpu")
    lt, ct = tm.prefill_fn(pt, cfg_t, {"tokens": torch.from_numpy(tok),
                                       "prefix_embeds": torch.from_numpy(pre)},
                           ct, opts=kern)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert int(ct[0]["pos"].max()) == s + plen - 1
    jdecode = jax.jit(lambda p, t, po, c: jm.decode_fn(p, cfg_j, t, po, c))
    for i in range(3):
        nxt = lt.numpy().argmax(-1).astype(np.int32)
        pos = np.full((b,), s + plen + i, np.int32)
        lj, cj = jdecode(pj, jnp.asarray(nxt), jnp.asarray(pos), cj)
        lt, ct = tm.decode_fn(pt, cfg_t, torch.from_numpy(nxt),
                              torch.from_numpy(pos), ct, opts=kern)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    batch = {"tokens": tok, "targets": np.roll(tok, -1, 1),
             "mask": np.ones((b, s), np.int32), "prefix_embeds": pre}
    lj, _ = jax.jit(lambda p, b_: jm.loss_fn(p, cfg_j, b_))(
        pj, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        lt, _ = tm.loss_fn(pt, cfg_t, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    np.testing.assert_allclose(lt.item(), float(lj), **TOL)


def test_shapes_and_assigned_are_the_references():
    from dataclasses import asdict
    from repro import configs as jc
    from repro_torch import configs as tc
    assert tc.ASSIGNED == jc.ASSIGNED and tc.PAPER_MOES == jc.PAPER_MOES
    assert [asdict(x) for x in tc.SHAPES] == [asdict(x) for x in jc.SHAPES]
    assert set(tc.SHAPE_BY_NAME) == set(jc.SHAPE_BY_NAME)
    assert tc.SUBQUADRATIC_ARCHS == jc.shapes.SUBQUADRATIC_ARCHS
    for name in tc.ASSIGNED:
        assert asdict(tc.get_config(name)) == asdict(jc.get_config(name))
    got = [(c.name, sh.name, why) for c, sh, why in tc.cells(
        [tc.get_config(n) for n in tc.ASSIGNED])]
    want = [(c.name, sh.name, why) for c, sh, why in jc.cells(
        [jc.get_config(n) for n in jc.ASSIGNED])]
    assert got == want and len(got) == 40
    # long_500k skips the 7 quadratic archs; whisper also its two 32k cells
    assert sum(why is None for *_, why in got) == 40 - 7 - 2
    for n in tc.ASSIGNED:
        for sh in tc.SHAPES:
            assert tc.applicability(tc.get_config(n), sh) == \
                jc.applicability(jc.get_config(n), jc.SHAPE_BY_NAME[sh.name])
