"""The reference's ``jax.jit`` sites as CUDA graphs: the train step
(``training/step.py::GraphedStep``), held-out eval
(``training/loop.py::eval_perplexity``), Alg. 1's layer deltas
(``core/sensitivity.py``) and the runner's steps on a mesh
(``test_torch_tp.py``, in its gloo world).

On the CPU every path runs eagerly whatever ``graphs`` says, so these
tests hold ``graphs=True`` to ``graphs=False`` bit for bit, and the
repairs the graphs need to today's results: AdamW's scalars read from a
device tensor, the error-feedback state updated in place, a replay's
collectives noted again.  The ``card`` cases capture and replay on the
GPU and hold each graph to the eager oracle: bits, since two eager train
steps on the card are bitwise equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: F401,E402


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present, decided when the
    test runs (never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs run only on a GPU")


def _cfg():
    from repro_torch.configs import get_config
    return get_config("olmoe-1b-7b").reduced().with_(num_layers=2)


def _params(seed=1):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((33, 17), generator=g).bfloat16(),
            "b": torch.randn((1000,), generator=g),
            "c": [torch.randn((5, 7, 3), generator=g).bfloat16(),
                  torch.randn((64,), generator=g)]}


def _adamw_run(tensor, device="cpu", steps=5):
    from repro_torch.optim import AdamW
    from repro_torch.tree import map_tree
    opt = AdamW(warmup_steps=2, total_steps=7)
    params = map_tree(lambda t: t.to(device), _params())
    state = opt.init(params)
    g = torch.Generator().manual_seed(4)
    for _ in range(steps):
        grads = map_tree(lambda p: torch.randn(p.shape, generator=g)
                         .to(p.dtype).to(device), params)
        sc = opt.scalars(state.step + 1).to(device) if tensor else None
        state = opt.step_(grads, state, params, sc)
    return params, state


def _equal_trees(a, b) -> bool:
    from repro_torch.tree import leaves
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


@pytest.mark.parametrize("chunk", [None, 900])
def test_adamw_tensor_scalars_keep_the_float_bits(monkeypatch, chunk):
    """Five AdamW steps with lr and the bias corrections read from an f32
    tensor give the bits of the float form, params and moments (also
    with the leaves split into several chunks)."""
    from repro_torch.optim import adamw
    if chunk is not None:
        monkeypatch.setattr(adamw, "CHUNK_ELEMS", chunk)
    p0, s0 = _adamw_run(False)
    p1, s1 = _adamw_run(True)
    assert s0.step == s1.step == 5
    assert _equal_trees(p0, p1) and _equal_trees(s0.mu, s1.mu) \
        and _equal_trees(s0.nu, s1.nu)


def test_adamw_scalars_are_the_float_values():
    """``AdamW.scalars``: the three floats of ``_scalars`` and the f32
    reciprocals of the two bias corrections, exactly."""
    from repro_torch.optim import AdamW
    opt = AdamW(warmup_steps=3, total_steps=9)
    for step in (1, 2, 5, 9):
        sc = opt.scalars(step)
        lr, c1, c2 = opt._scalars(step)
        assert sc.dtype == torch.float32 and sc.tolist()[:3] == [lr, c1, c2]
        f = np.float32
        assert sc[3].item() == float(f(1) / f(c1))
        assert sc[4].item() == float(f(1) / f(c2))


def _train_step_by_hand(cfg, opt, state, batch):
    """The train step as it ran before the step read its scalars from a
    tensor: ``value_and_grad``, the norm, ``step_`` on the floats."""
    from repro_torch.training import value_and_grad
    from repro_torch.training.step import _global_norm
    loss, _, grads = value_and_grad(cfg)(state.params, batch)
    gnorm = _global_norm(grads)
    opt.step_(grads, state.opt, state.params)
    return loss, gnorm


def test_train_step_keeps_the_float_form_bits():
    """Three eager train steps (``make_train_step``, scalars from a
    tensor) against the same steps with AdamW on the floats: losses, grad
    norms, params and moments bit for bit."""
    from repro_torch import models
    from repro_torch.optim import AdamW
    from repro_torch.training import init_state, make_train_step
    cfg = _cfg()
    opt = AdamW(total_steps=3, warmup_steps=1)
    gen = torch.Generator().manual_seed(2)
    batches = [models.make_train_batch(cfg, gen, 2, 16, device="cpu")
               for _ in range(3)]
    a = init_state(cfg, opt, 0, device="cpu")
    b = init_state(cfg, opt, 0, device="cpu")
    step = make_train_step(cfg, opt)
    for batch in batches:
        a, m = step(a, batch)
        loss, gnorm = _train_step_by_hand(cfg, opt, b, batch)
        b = b._replace(opt=b.opt._replace(step=b.opt.step + 1))
        assert torch.equal(m["loss"], loss)
        assert torch.equal(m["grad_norm"], gnorm)
        assert m["lr"] == opt.schedule(a.opt.step)
    assert a.opt.step == b.opt.step == 3
    assert _equal_trees(a.params, b.params)
    assert _equal_trees(a.opt.mu, b.opt.mu)
    assert _equal_trees(a.opt.nu, b.opt.nu)


def _compress_out_of_place(grads, err, cfg):
    """``compress_grads`` as it was: new error tensors every call."""
    from repro_torch.optim.compression import scale_groups
    from repro_torch.tree import leaves, unflatten
    gs, es = leaves(grads), leaves(err)
    deq, out = [None] * len(gs), [None] * len(gs)
    groups = scale_groups(grads, cfg)
    amax = torch.stack([torch.stack([(gs[i].float() + es[i]).abs().max()
                                     for i in idx]).max() for idx in groups])
    for gi, idx in enumerate(groups):
        scale = amax[gi].clamp(min=1e-12) / 127.0
        for i in idx:
            g = gs[i].float() + es[i]
            d = (g / scale).round().clamp(-127, 127).to(torch.int8).float() \
                * scale
            deq[i] = d.to(gs[i].dtype)
            out[i] = g - d
    return unflatten(grads, deq), unflatten(err, out)


def test_compress_grads_in_place_keeps_values_and_addresses():
    """Three steps of ``compress_grads``: the dequantized grads and the
    residuals of the out-of-place form, bit for bit, with every error
    tensor written where it lives."""
    from repro_torch import models
    from repro_torch.optim.compression import compress_grads, \
        init_error_state
    from repro_torch.tree import leaves, map_tree
    cfg = _cfg()
    params = models.init_params(cfg, 0, device="cpu")
    err = init_error_state(params)
    want_err = map_tree(torch.clone, err)
    ptrs = [t.data_ptr() for t in leaves(err)]
    g = torch.Generator().manual_seed(3)
    for _ in range(3):
        grads = map_tree(lambda p: (torch.randn(p.shape, generator=g)
                                    * 1e-2).to(p.dtype), params)
        want_deq, want_err = _compress_out_of_place(grads, want_err, cfg)
        deq, got = compress_grads(grads, err, cfg)
        assert got is err
        assert _equal_trees(deq, want_deq) and _equal_trees(err, want_err)
        assert [t.data_ptr() for t in leaves(err)] == ptrs


def _dc(cfg, batch=2, seq=16):
    from repro_torch.data import DataConfig
    return DataConfig(cfg.vocab_size, seq_len=seq, global_batch=batch)


@pytest.mark.parametrize("kw", [{}, {"compression": True,
                                     "microbatches": 2}])
def test_train_graphs_on_the_cpu_run_eagerly(kw):
    """``train(graphs=True)`` on the CPU runs every step eagerly: the
    losses, grad norms and final state of ``graphs=False``, bit for bit,
    and no replay."""
    from repro_torch.optim import AdamW
    from repro_torch.training import train
    cfg = _cfg()
    runs = [train(cfg, _dc(cfg), total_steps=3, seed=0, device="cpu",
                  optimizer=AdamW(total_steps=3, warmup_steps=1),
                  graphs=g, **kw) for g in (True, False)]
    a, b = runs
    assert a.losses == b.losses and a.grad_norms == b.grad_norms
    assert a.graph_replays == b.graph_replays == 0
    assert _equal_trees(a.state.params, b.state.params)
    assert _equal_trees(a.state.opt.mu, b.state.opt.mu)
    assert _equal_trees(a.state.err, b.state.err)


def test_eval_and_sensitivity_graphs_on_the_cpu_run_eagerly():
    """``eval_perplexity(graphs=True)`` and
    ``profile_sensitivity(graphs=True)`` on the CPU: the ppl and the
    table of ``graphs=False`` bit for bit."""
    from repro_torch import models
    from repro_torch.core import profile_sensitivity
    from repro_torch.training import eval_perplexity
    cfg = _cfg()
    params = models.init_params(cfg, 0, device="cpu")
    ppl = [eval_perplexity(params, cfg, _dc(cfg), steps=3, graphs=g)
           for g in (True, False)]
    assert ppl[0] == ppl[1] and np.isfinite(ppl[0])
    gmm = cfg.with_(moe_impl="gmm")
    tables = [profile_sensitivity(params, gmm, n_iter=3, batch=2, seq=8,
                                  device="cpu", use_kernel=False, graphs=g)
              for g in (True, False)]
    np.testing.assert_array_equal(tables[0].values, tables[1].values)


def test_a_replay_notes_its_captures_collectives():
    """``collectives.held`` keeps a capture's notes from the open
    ``record()`` blocks; each ``Graph.replay`` notes them again, as an
    eager step would."""
    from repro_torch.analysis import collectives, record
    from repro_torch.kernels._graphs import Graph

    class Stub:                     # a CUDA graph that runs nothing
        def replay(self):
            pass

    with record() as stats:
        with collectives.held() as notes:
            collectives.note("all-reduce", 64, 4)
            collectives.note("all-gather", 256, 4)
        assert stats.total_count == 0
        g = Graph(Stub(), "out", {}, notes)
        assert g.replay() == "out" and g.replay() == "out"
    assert stats.count_by_kind == {"all-reduce": 2, "all-gather": 2}
    assert stats.bytes_by_kind == {"all-reduce": 128, "all-gather": 128}


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

def _card_cfg():
    return _cfg().with_(dtype="bfloat16")


def test_adamw_tensor_scalars_on_card(card):
    """On the card a division by a float is a product with its f32
    reciprocal: the tensor form keeps those bits."""
    p0, s0 = _adamw_run(False, "cuda")
    p1, s1 = _adamw_run(True, "cuda")
    assert _equal_trees(p0, p1) and _equal_trees(s0.mu, s1.mu) \
        and _equal_trees(s0.nu, s1.nu)


@pytest.mark.parametrize("kw", [{}, {"compression": True,
                                     "microbatches": 2}])
def test_train_graphed_matches_eager_on_card(card, kw):
    """Four steps: the first eager, then captured; the later three replay
    the graph: losses and final state bit for bit the eager run's."""
    from repro_torch.optim import AdamW
    from repro_torch.training import train
    cfg = _card_cfg()
    a, b = (train(cfg, _dc(cfg, 4, 64), total_steps=4, seed=0,
                  device="cuda", optimizer=AdamW(total_steps=4,
                                                 warmup_steps=2),
                  graphs=g, **kw) for g in (None, False))
    assert a.graph_replays == 3 and b.graph_replays == 0
    assert a.losses == b.losses and a.grad_norms == b.grad_norms
    assert _equal_trees(a.state.params, b.state.params)
    assert _equal_trees(a.state.opt.nu, b.state.opt.nu)


def test_graphed_step_refuses_a_moved_state_on_card(card):
    """The step's graph updates the state it captured in place: a state
    whose tensors live elsewhere is refused, as is a batch of another
    shape."""
    from repro_torch import models
    from repro_torch.optim import AdamW
    from repro_torch.training import init_state, make_train_step
    cfg = _card_cfg()
    opt = AdamW(total_steps=4)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = models.make_train_batch(cfg, gen, 2, 32, device="cuda")
    step = make_train_step(cfg, opt, graphs=True)
    state, _ = step(init_state(cfg, opt, 0, device="cuda"), batch)
    state, _ = step(state, batch)
    assert step.stats["graphs"] == 1 and step.stats["replays"] == 1
    with pytest.raises(ValueError, match="captured for batch"):
        step(state, models.make_train_batch(cfg, gen, 2, 16, device="cuda"))
    with pytest.raises(RuntimeError, match="live elsewhere"):
        step(init_state(cfg, opt, 0, device="cuda"), batch)


def test_eval_and_sensitivity_graphed_match_eager_on_card(card):
    """Held-out ppl through the kernels and Alg. 1's table on ``gmm``:
    graphed bit for bit the eager ones, with the same launches."""
    from repro_torch import models
    from repro_torch.core import profile_sensitivity
    from repro_torch.kernels import launch_counts
    from repro_torch.models import ModelOpts
    from repro_torch.training import eval_perplexity
    cfg = _card_cfg().with_(moe_impl="gmm")
    params = models.init_params(cfg, 0, device="cuda")
    opts = ModelOpts(use_moe_kernel=True, moe_impl="gmm")
    ppl, launches = [], []
    for g in (None, False):
        before = launch_counts()
        ppl.append(eval_perplexity(params, cfg, _dc(cfg, 2, 64), steps=3,
                                   opts=opts, graphs=g))
        after = launch_counts()
        launches.append({k: after[k] - before[k] for k in after})
    assert ppl[0] == ppl[1] and launches[0] == launches[1]
    assert launches[0]["moe_gmm"] > 0
    tables = [profile_sensitivity(params, cfg, n_iter=3, batch=2, seq=32,
                                  device="cuda", graphs=g)
              for g in (None, False)]
    np.testing.assert_array_equal(tables[0].values, tables[1].values)
