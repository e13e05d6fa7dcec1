"""Training and held-out evaluation in the port against the JAX reference.

* ``sample_batch`` (the cached-CDF form) and ``sample_batch_plain`` draw
  the reference's ``sample_batch`` tokens bit for bit; the pipeline
  resumes at ``start_step``.
* AdamW fed the same numpy grads and moments gives the reference's
  params and moments within 1e-6 of each leaf's largest value, at the
  schedule's steps 1, warmup and total (the schedule itself at 0, warmup
  and total).
* One step's grads, OLMoE family and DeepSeek family (MLA, shared experts,
  a dense first layer), from the reference's own params converted, per
  leaf within ``1e-4 * max|g_ref|``.  Grads are compared apart from the
  optimizer: Adam's first step is about ``sign(g)``, so a parameter whose
  gradient is near zero can move by 2 lr when the two sides round
  differently.
* Five steps continued from the reference's state after two
  (``convert_train_state``) have losses within 1e-3 relative.
* Four microbatches against the reference's (loss, grad norm) and
  against one batch on the dropless ``gmm``; compression against the
  reference's ``compress_grads`` on its own stacked tree, converted, for a
  plain and a LExI-planned stack (one quantum apart where a value rounds
  either way); ``eval_perplexity`` against the
  reference's; the loss falls over 30 steps; remat ``full`` and ``dots``
  give the loss and grads of ``none``; ``launch/train.py`` runs on
  ``--device cpu``.
* Every kernel wrapper raises when handed an input that requires grad with
  grad enabled, on the CPU as on the card; on the card a train step with
  ``use_moe_kernel=True`` raises.

Tiny configs: 2 layers, d_model 64, 4 experts at top-2, vocab 128, f32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: F401,E402

TINY = dict(num_layers=2, d_model=64, num_experts=4, moe_top_k=2,
            vocab_size=128, dtype="float32")


def _cfgs(arch):
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    return (jget(arch).reduced().with_(**TINY),
            tget(arch).reduced().with_(**TINY))


def _dc(cfg, batch=8, seq=32):
    from repro_torch.data import DataConfig
    return DataConfig(cfg.vocab_size, seq_len=seq, global_batch=batch)


def _batch_t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_tree_close(got, want_numpy_tree, cfg, *, rel):
    """Leaf by leaf: |got - want| <= rel * max|want|."""
    from repro_torch.convert import convert_params
    from repro_torch.tree import flatten_with_paths
    want = dict(flatten_with_paths(
        convert_params(want_numpy_tree, cfg, device="cpu")))
    got = dict(flatten_with_paths(got))
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key].float().numpy()
        w = w.float().numpy()
        bound = rel * max(np.abs(w).max(), 1e-30)
        err = np.abs(g - w).max()
        assert err <= bound, (key, err, bound)


@pytest.fixture(scope="module", params=["olmoe-1b-7b", "deepseek-v2-lite"])
def family(request):
    """Reference params, the port's copy, a batch, and the reference's loss
    and grads of one step on it."""
    import jax
    from repro import models as jm
    from repro_torch.convert import convert_params
    from repro_torch.data import sample_batch
    cfg_j, cfg_t = _cfgs(request.param)
    pj = jax.jit(lambda k: jm.init_params(k, cfg_j))(jax.random.PRNGKey(0))
    batch = sample_batch(_dc(cfg_t), 0)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, cfg_j, batch), has_aux=True))(pj)
    pt = convert_params(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    return (cfg_j, cfg_t, pj, pt, batch, float(loss),
            jax.tree.map(np.asarray, grads))


# --------------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("vocab", [128, 512, 50304])
def test_sample_batch_equals_reference_bitwise(vocab):
    from repro.data.synthetic import DataConfig as JDC, \
        sample_batch as jsample
    from repro_torch.data import DataConfig, sample_batch, \
        sample_batch_plain
    for seed, step in ((0, 0), (3, 7), (0, 10_000)):
        want = jsample(JDC(vocab, 24, 4, seed=seed), step)
        dc = DataConfig(vocab, 24, 4, seed=seed)
        for got in (sample_batch(dc, step), sample_batch_plain(dc, step)):
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_pipeline_resumes_at_start_step():
    from repro_torch.data import DataConfig, Pipeline, sample_batch, \
        to_device
    dc = DataConfig(128, 32, 8)
    with Pipeline(dc, start_step=5) as p:
        first, second = next(p), next(p)
        assert p.step == 7 and p.seconds_per_batch() > 0
    np.testing.assert_array_equal(first["tokens"],
                                  sample_batch(dc, 5)["tokens"])
    np.testing.assert_array_equal(second["tokens"],
                                  sample_batch(dc, 6)["tokens"])
    t = to_device(first, "cpu")
    assert t["tokens"].dtype == torch.int32 and t["tokens"].shape == (8, 32)


# --------------------------------------------------------------------------- #
# AdamW and compression on identical inputs
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("at", ["first", "warmup", "total"])
def test_adamw_update_matches_reference(at):
    import jax
    import jax.numpy as jnp
    from repro.optim import AdamW as JAdamW, AdamWState as JState
    from repro_torch.optim import AdamW, AdamWState
    from repro_torch.tree import leaves, map_tree
    kw = dict(peak_lr=1e-3, warmup_steps=10, total_steps=50)
    step = {"first": 0, "warmup": 9, "total": 49}[at]  # the update's - 1
    rng = np.random.default_rng(step)
    shapes = {"a": (16, 8), "b": {"c": (5,), "d": (3, 4, 2)}}

    def tree(fn):
        return {"a": fn(shapes["a"]),
                "b": {k: fn(s) for k, s in shapes["b"].items()}}

    p, g = tree(lambda s: rng.standard_normal(s, np.float32)), \
        tree(lambda s: rng.standard_normal(s, np.float32))
    m = tree(lambda s: 0.1 * rng.standard_normal(s, np.float32))
    v = tree(lambda s: 0.01 * rng.random(s, np.float32))
    jt = lambda t: jax.tree.map(jnp.asarray, t)
    tt = lambda t: map_tree(lambda x: torch.from_numpy(x.copy()), t)
    jopt, topt = JAdamW(**kw), AdamW(**kw)
    for s in (0, 10, 50):
        np.testing.assert_allclose(topt.schedule(s),
                                   float(jopt.schedule(jnp.int32(s))),
                                   rtol=1e-6)
    ju, jstate = jopt.update(jt(g), JState(jnp.int32(step), jt(m), jt(v)),
                             jt(p))
    jp = jopt.apply_updates(jt(p), ju)
    tstate = AdamWState(step, tt(m), tt(v))
    tu, tstate = topt.update(tt(g), tstate, tt(p))
    tp = topt.apply_updates(tt(p), tu)
    assert tstate.step == int(jstate.step) == step + 1
    # relative to the leaf's largest value: a param that an update takes
    # near zero keeps the rounding of its old magnitude
    for got, want in ((tp, jp), (tstate.mu, jstate.mu),
                      (tstate.nu, jstate.nu)):
        for a, b in zip(leaves(got), jax.tree.leaves(want)):
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() <= 1e-6 * np.abs(b).max()
    # the in-place form the train step runs gives the same params
    tp2 = tt(p)
    topt.step_(tt(g), AdamWState(step, tt(m), tt(v)), tp2)
    for a, b in zip(leaves(tp2), leaves(tp)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("planned", [False, True], ids=["stack", "planned"])
def test_compression_matches_reference(family, planned):
    """The reference's ``compress_grads`` on its own stacked tree (one
    scale per stacked group; a LExI plan splits OLMoE's one group of two
    layers into two), converted, against the port's on the same grads and
    error state in its per-layer layout; a value may land one quantum (the
    group's scale) off where ``g / scale`` rounds either way."""
    import jax
    from repro.models.blocks import regroup_stack
    from repro.optim.compression import compress_grads as jcompress
    from repro_torch.convert import convert_params
    from repro_torch.optim.compression import compress_grads, \
        compression_bytes_saved
    from repro_torch.tree import flatten_with_paths, leaves
    cfg_j, cfg_t, _, _, _, _, grads = family
    if planned:
        plan = tuple(max(1, cfg_j.moe_top_k - i % 2)
                     for i in range(cfg_j.num_moe_layers))
        cfg_jp, cfg_t = cfg_j.with_lexi_plan(plan), cfg_t.with_lexi_plan(plan)
        grads = dict(grads, stack=regroup_stack(
            grads["stack"], cfg_j.pattern(), cfg_jp.pattern()))
        grads = jax.tree.map(np.asarray, grads)
    rng = np.random.default_rng(3)
    err = jax.tree.map(
        lambda g: 1e-3 * rng.standard_normal(g.shape).astype(np.float32),
        grads)
    deq_j, err2_j = jax.tree.map(np.asarray, jax.jit(jcompress)(grads, err))
    quantum = jax.tree.map(lambda d: np.full(d.shape, np.abs(d).max() / 127,
                                             np.float32), deq_j)
    conv = lambda t: dict(flatten_with_paths(
        convert_params(t, cfg_t, device="cpu")))
    deq_j, err2_j, quantum = conv(deq_j), conv(err2_j), conv(quantum)
    deq_t, err2_t = compress_grads(convert_params(grads, cfg_t, device="cpu"),
                                   convert_params(err, cfg_t, device="cpu"),
                                   cfg_t)
    for got, want in ((deq_t, deq_j), (err2_t, err2_j)):
        got = dict(flatten_with_paths(got))
        assert got.keys() == want.keys()
        for key, g in got.items():
            q = quantum[key].numpy()
            off = np.abs(g.numpy() - want[key].numpy())
            assert (off <= 1.001 * q + 1e-12).all(), key
            assert (off > 1e-3 * q).mean() <= 0.02, key
    n = sum(int(np.prod(g.shape)) for g in jax.tree.leaves(grads))
    assert compression_bytes_saved(deq_t, cfg_t) == \
        n * 4 - (n + 4 * len(jax.tree.leaves(grads)))


# --------------------------------------------------------------------------- #
# one step's grads, continued training, evaluation
# --------------------------------------------------------------------------- #


def test_one_step_grads_match_reference(family):
    from repro_torch.training import value_and_grad
    from repro_torch.tree import leaves
    cfg_j, cfg_t, pj, pt, batch, loss_j, grads_j = family
    loss, metrics, grads = value_and_grad(cfg_t)(pt, _batch_t(batch))
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
    assert set(metrics) == {"xent", "aux"}
    _assert_tree_close(grads, grads_j, cfg_t, rel=1e-4)
    assert not any(p.requires_grad for p in leaves(pt))


def test_microbatches_match_the_reference():
    """Four microbatches: the reference's loss and grad norm (on ``dense``
    each microbatch has its own capacity, so its drops are not the whole
    batch's); and on the dropless ``gmm`` the grads of one batch, up to
    the aux loss, which balances each microbatch's routing."""
    import jax
    from repro.optim import AdamW as JAdamW
    from repro.training import init_state as jinit
    from repro.training.step import make_train_step as jmake
    from repro_torch.convert import convert_train_state
    from repro_torch.data import sample_batch
    from repro_torch.optim import AdamW
    from repro_torch.training import make_train_step, value_and_grad
    from repro_torch.tree import flatten_with_paths
    cfg_j, cfg_t = _cfgs("olmoe-1b-7b")
    batch = sample_batch(_dc(cfg_t), 0)
    js = jinit(jax.random.PRNGKey(2), cfg_j, JAdamW())
    ts = convert_train_state(jax.tree.map(np.asarray, js), cfg_t,
                             device="cpu")
    _, mj = jax.jit(jmake(cfg_j, JAdamW(), microbatches=4))(js, batch)
    _, mt = make_train_step(cfg_t, AdamW(), microbatches=4)(ts,
                                                            _batch_t(batch))
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(mt["grad_norm"]),
                               float(mj["grad_norm"]), rtol=1e-4)
    assert float(mt["aux"]) == 0.0

    gmm = cfg_t.with_(moe_impl="gmm")
    _, _, g1 = value_and_grad(gmm)(ts.params, _batch_t(batch))
    loss4, m4, g4 = value_and_grad(gmm, microbatches=4)(ts.params,
                                                        _batch_t(batch))
    assert torch.equal(m4["xent"], loss4)
    g4 = dict(flatten_with_paths(g4))
    for key, a in flatten_with_paths(g1):
        assert g4[key].dtype == torch.float32
        bound = 2e-2 * a.abs().max().item() + 1e-7
        assert (g4[key] - a).abs().max().item() <= bound, key


def test_eval_perplexity_matches_reference(family):
    from repro.data.synthetic import DataConfig as JDC
    from repro.training import eval_perplexity as jeval
    from repro_torch.training import eval_perplexity
    cfg_j, cfg_t, pj, pt, _, _, _ = family
    want = jeval(pj, cfg_j, JDC(cfg_j.vocab_size, 32, 4), steps=2)
    got = eval_perplexity(pt, cfg_t, _dc(cfg_t, 4), steps=2)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_steps_continued_from_reference_state():
    """Two reference steps, then five on each side from that state."""
    import jax
    from repro.optim import AdamW as JAdamW
    from repro.training import init_state as jinit
    from repro.training.step import make_train_step as jmake
    from repro_torch.convert import convert_train_state
    from repro_torch.data import sample_batch
    from repro_torch.optim import AdamW
    from repro_torch.training import make_train_step
    cfg_j, cfg_t = _cfgs("olmoe-1b-7b")
    kw = dict(peak_lr=1e-3, total_steps=20, warmup_steps=3)
    dc = _dc(cfg_t)
    jstep = jax.jit(jmake(cfg_j, JAdamW(**kw)))
    js = jinit(jax.random.PRNGKey(1), cfg_j, JAdamW(**kw))
    for i in range(2):
        js, _ = jstep(js, sample_batch(dc, i))
    ts = convert_train_state(jax.tree.map(np.asarray, js), cfg_t,
                             device="cpu")
    assert ts.opt.step == 2 and ts.err is None
    tstep = make_train_step(cfg_t, AdamW(**kw))
    for i in range(2, 7):
        batch = sample_batch(dc, i)
        js, mj = jstep(js, batch)
        ts, mt = tstep(ts, _batch_t(batch))
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=1e-3)
        np.testing.assert_allclose(mt["lr"], float(mj["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=1e-2)


def test_loss_decreases_over_30_steps():
    from repro_torch.optim import AdamW
    from repro_torch.training import train
    _, cfg = _cfgs("olmoe-1b-7b")
    res = train(cfg, _dc(cfg), total_steps=30, device="cpu",
                optimizer=AdamW(peak_lr=1e-3, total_steps=30,
                                warmup_steps=3))
    assert res.steps_run == 30 and res.final_step == 30
    first, last = np.mean(res.losses[:5]), np.mean(res.losses[-5:])
    assert last < first - 0.3, (first, last)
    assert all(np.isfinite(res.grad_norms)) and res.data_s_per_batch > 0


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_loss_and_grads_of_none(remat):
    from repro_torch import models
    from repro_torch.data import sample_batch
    from repro_torch.training import value_and_grad
    from repro_torch.tree import leaves
    _, cfg = _cfgs("deepseek-v2-lite")
    params = models.init_params(cfg, 0, device="cpu")
    batch = _batch_t(sample_batch(_dc(cfg), 0))
    l0, _, g0 = value_and_grad(cfg)(params, batch)
    l1, _, g1 = value_and_grad(cfg, opts=models.ModelOpts(remat=remat))(
        params, batch)
    assert torch.equal(l0, l1)
    for a, b in zip(leaves(g0), leaves(g1)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError, match="remat"):
        value_and_grad(cfg, opts=models.ModelOpts(remat="some"))(params,
                                                                  batch)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_chunk_gives_the_per_layer_remat_step(remat):
    """``remat_chunk`` = 2 over a run of five identical layers (two whole
    chunks checkpointed as one each, the fifth layer on its own): the
    loss and the grads of per-layer remat bit for bit, and the
    reference's ``remat_chunk`` loss."""
    import jax
    import jax.numpy as jnp
    from repro import models as jm
    from repro_torch import models
    from repro_torch.data import sample_batch
    from repro_torch.models.blocks import _remat_chunks
    from repro_torch.training import value_and_grad
    from repro_torch.tree import leaves
    from _torch_ref import reference_params
    cfg_j, cfg = (c.with_(num_layers=5) for c in _cfgs("olmoe-1b-7b"))
    assert _remat_chunks(cfg.pattern(), 2) == {0: 2, 2: 4}
    params = models.init_params(cfg, 0, device="cpu")
    batch = sample_batch(_dc(cfg), 0)
    l0, _, g0 = value_and_grad(cfg, opts=models.ModelOpts(remat=remat))(
        params, _batch_t(batch))
    l1, _, g1 = value_and_grad(cfg, opts=models.ModelOpts(
        remat=remat, remat_chunk=2))(params, _batch_t(batch))
    assert torch.equal(l0, l1)
    for a, b in zip(leaves(g0), leaves(g1)):
        assert torch.equal(a, b)
    lj, _ = jax.jit(lambda p, b: jm.loss_fn(p, cfg_j, b, opts=jm.ModelOpts(
        remat=remat, remat_chunk=2)))(reference_params(params, cfg),
                                      {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    np.testing.assert_allclose(float(l1), float(lj), rtol=1e-4)


def test_train_launcher_runs_on_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    args = ["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
            "--steps", "4", "--batch", "2", "--seq", "16", "--eval",
            "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    assert main(args) == 0
    out = capsys.readouterr().out
    assert "ran 4 steps" in out and "held-out perplexity" in out
    # the same command resumes from the final checkpoint and runs nothing
    assert main(args) == 0
    assert "ran 0 steps" in capsys.readouterr().out


# --------------------------------------------------------------------------- #
# no kernel under autograd
# --------------------------------------------------------------------------- #


def _wrapper_args(name):
    """Small CPU inputs for each wrapper, the first float one requiring
    grad."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    b, h, d, e, f, k = 2, 2, 64, 4, 32, 2
    idx = torch.randint(0, e, (b, k), generator=g, dtype=torch.int32)
    w = torch.rand(b, k, generator=g)
    x = r(b, d).requires_grad_()
    if name in ("moe_gmm", "moe_gmm_quant"):
        from repro_torch.models.moe import make_sort_plan, quantize_experts
        plan = make_sort_plan(idx, e, 8)
        xs = r(plan.num_rows, d).requires_grad_()
        kw = dict(block_m=8)
        if name == "moe_gmm":
            return (xs, r(e, d, 2 * f), r(e, f, d), plan.tile_expert,
                    plan.tile_valid), kw
        q = quantize_experts(r(e, d, 2 * f), r(e, f, d), "int8")
        return (xs, *q, plan.tile_expert, plan.tile_valid), \
            dict(kw, dtype="int8")
    if name == "moe_decode":
        return (x, r(e, d, 2 * f), r(e, f, d), idx, w), {}
    if name == "moe_decode_quant":
        from repro_torch.models.moe import quantize_experts
        q = quantize_experts(r(e, d, 2 * f), r(e, f, d), "int8")
        return (x, *q, idx, w), dict(dtype="int8")
    if name == "moe_ffn":
        return (r(e, 4, d).requires_grad_(), r(e, d, 2 * f), r(e, f, d)), {}
    if name == "flash_attention":
        q = r(b, 8, h, 32).requires_grad_()
        return (q, r(b, 8, h, 32), r(b, 8, h, 32)), {}
    cur = torch.tensor([5, 3], dtype=torch.int32)
    if name == "flash_decode":
        pos = torch.arange(8, dtype=torch.int32).expand(b, 8).contiguous()
        return (r(b, h, 32).requires_grad_(), r(b, 8, h, 32),
                r(b, 8, h, 32), pos, cur), {}
    table = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    posp = torch.arange(4 * 4, dtype=torch.int32).reshape(4, 4) % 8
    if name == "flash_decode_paged":
        return (r(b, h, 32).requires_grad_(), r(4, 4, h, 32),
                r(4, 4, h, 32), posp, table, cur), {}
    assert name == "flash_decode_paged_mla"
    return (r(b, h, 16).requires_grad_(), r(b, h, 8), r(4, 4, 16),
            r(4, 4, 8), posp, table, cur), dict(scale=0.25)


@pytest.mark.parametrize("name", [
    "moe_gmm", "moe_gmm_quant", "moe_decode", "moe_decode_quant", "moe_ffn",
    "flash_attention", "flash_decode", "flash_decode_paged",
    "flash_decode_paged_mla"])
def test_kernel_wrappers_refuse_autograd(name):
    from repro_torch import kernels
    fn = kernels.WRAPPERS[name]
    args, kw = _wrapper_args(name)
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args, **kw)
    with torch.no_grad():          # the serving paths' case: no refusal
        out = fn(*args, **kw)
    assert torch.isfinite(out).all()


def test_train_step_refuses_the_moe_kernel_on_cpu():
    from repro_torch import models
    from repro_torch.data import sample_batch
    from repro_torch.optim import AdamW
    from repro_torch.training import init_state, make_train_step
    _, cfg = _cfgs("olmoe-1b-7b")
    state = init_state(cfg, AdamW(), 0, device="cpu")
    step = make_train_step(cfg, AdamW(), opts=models.ModelOpts(
        use_moe_kernel=True))
    with pytest.raises(RuntimeError, match="moe_ffn.*no backward"):
        step(state, _batch_t(sample_batch(_dc(cfg), 0)))
    assert state.opt.step == 0


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present, decided when the
    test runs (never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a GPU")


def test_train_step_refuses_the_moe_kernel_on_card(card):
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, sample_batch, to_device
    from repro_torch.optim import AdamW
    from repro_torch.training import init_state, make_train_step
    cfg = get_config("olmoe-1b-7b").reduced().with_(dtype="bfloat16")
    state = init_state(cfg, AdamW(), 0, device="cuda")
    batch = to_device(sample_batch(DataConfig(cfg.vocab_size, 64, 2), 0),
                      "cuda")
    step = make_train_step(cfg, AdamW(), opts=models.ModelOpts(
        use_moe_kernel=True))
    with pytest.raises(RuntimeError, match="moe_ffn.*no backward"):
        step(state, batch)
    # the plain paths train on the card
    state, metrics = make_train_step(cfg, AdamW())(state, batch)
    assert torch.isfinite(metrics["loss"]) and state.opt.step == 1


def test_serve_lexi_runs_on_cpu(capsys):
    """The example's port: trains the recipe, serves baseline and plan
    through one engine, evaluates both."""
    from repro_torch.launch.serve_lexi import main, tiny_moe_config
    cfg = tiny_moe_config()
    assert (cfg.num_layers, cfg.d_model, cfg.num_experts, cfg.moe_top_k,
            cfg.moe_d_ff, cfg.vocab_size, cfg.dtype) == (
        4, 128, 8, 4, 128, 512, "float32")
    assert main(["--device", "cpu", "--steps", "5", "--requests", "2",
                 "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "baseline  top-k=4" in out and "LExI plan" in out
