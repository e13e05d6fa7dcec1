"""Expert parallelism, context-parallel decode and training on a mesh:
the port in a (2, 2) gloo world of four processes on the CPU, against the
port's one-process paths and the JAX reference.

One ``torch.multiprocessing.spawn`` for the module (``_torch_ep_ranks.py``
is the rank program; ``file://`` rendezvous, one torch thread a rank);
while it runs, this process computes the one-process references, then
every test reads the ranks' results.  EP is held against ``dense``, never
against the reference's ``ep_a2a`` / ``ep_psum`` (whose own tests fail
with the installed JAX).  Every config is f32 and dropless (capacity factor =
the expert count), as the reference's EP tests.

Tolerances: EP outputs against the port's dense 1e-5 (the same products
in another order; observed 0) and against the JAX dense 2e-4 (the
reference's EP test); gradients 1e-4 relative to each leaf's largest
entry (sums over four ranks in another order); losses, aux and decode
logits 1e-5 against the port, 1e-4 against JAX (``test_torch_model.py``);
train losses and params after four AdamW steps 1e-5 (with int8 gradient
compression: losses 1e-5, at most one param element in 1000 past 1e-5
and none past the learning rate, see the test).
"""

import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: F401,E402

import _torch_ep_ranks as ranks  # noqa: E402

#: seconds the four ranks may take (about 6 s on an idle host)
SPAWN_TIMEOUT = 240
PORT = dict(rtol=1e-5, atol=1e-5)
JAX_TOL = dict(rtol=2e-4, atol=2e-4)


def _join(ctx, timeout):
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the four ranks ran past {timeout} s")


def _references():
    """The one-process sides computed here while the ranks run: the port's
    ``train`` (the MoE with one microbatch a rank's block, see
    ``test_train_on_mesh_matches_one_process``) and the JAX reference's
    dense MoE and decode steps."""
    from repro_torch.training import train
    refs = {}
    for tag, (cfg, kw) in ranks.train_runs().items():
        refs[f"train_{tag}"] = train(
            cfg, ranks.data_cfg(cfg), total_steps=ranks.TRAIN_STEPS,
            optimizer=ranks.optimizer(), device="cpu",
            microbatches=ranks.one_process_microbatches(cfg), **kw)
    refs.update(_jax_references())
    return refs


def _jax_references():
    import jax
    import jax.numpy as jnp
    from repro import models as jm
    from repro.configs import get_config as jget
    from repro.models.moe import moe as jmoe
    from repro_torch import models as tm
    from _torch_ref import reference_params
    out = {}
    cfg = ranks.moe_cfg()
    mp = tm.init_params(cfg, 0, device="cpu")["layers"][0]["moe"]
    cfg_j = jget("olmoe-1b-7b").reduced().with_(
        num_experts=8, moe_top_k=2, dtype="float32", moe_capacity_factor=8.0)
    mpj = {k: jnp.asarray(v.numpy()) for k, v in mp.items()}
    x = ranks.moe_input(cfg).numpy()
    y, _ = jmoe(mpj, cfg_j, jnp.asarray(x), cfg.moe_top_k, impl="dense")
    out["jax_moe_y"] = np.asarray(y).reshape(-1, cfg.d_model)

    cfg = ranks.decode_cfg()
    cfg_j = jget("qwen3-moe-235b-a22b").reduced().with_(
        num_experts=8, moe_top_k=2, dtype="float32", moe_impl="ep_a2a",
        moe_capacity_factor=8.0, num_layers=2, num_kv_heads=2)
    pj = reference_params(tm.init_params(cfg, 0, device="cpu"), cfg)
    tokens = jnp.asarray(ranks.decode_tokens(cfg).numpy())
    b, plen = tokens.shape
    caches = jm.init_caches(cfg_j, b, 32)
    logits, caches = jm.prefill_fn(pj, cfg_j, {"tokens": tokens}, caches)
    pos = jnp.full((b,), plen, jnp.int32)
    nxt = jnp.argmax(logits, -1).astype(jnp.int32)
    step = jax.jit(lambda p, t, po, c: jm.decode_fn(p, cfg_j, t, po, c))
    l0, caches = step(pj, nxt, pos, caches)
    l0b, _ = step(pj, jnp.argmax(l0, -1).astype(jnp.int32), pos + 1, caches)
    out["jax_decode_logits"] = [np.asarray(t) for t in (logits, l0, l0b)]
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp("ep_world")
    out_path, ckpt = str(d / "out.pt"), str(d / "ckpt")
    ctx = mp.start_processes(ranks.run, args=(str(d / "rdv"), out_path, ckpt),
                             nprocs=ranks.WORLD, join=False,
                             start_method="spawn")
    try:
        refs = _references()
    finally:
        _join(ctx, SPAWN_TIMEOUT)
    out = torch.load(out_path, weights_only=False)
    return out, refs, ckpt


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def test_world_coordinates(world):
    out, _, _ = world
    assert out["coords"] == (0, 0)


@pytest.mark.parametrize("key", ["a2a_y_c1", "a2a_y_c2", "psum_y"])
def test_ep_matches_dense_and_reference(world, key):
    out, refs, _ = world
    _close(out[key], out["dense_y"], **PORT)
    _close(out[key], refs["jax_moe_y"], **JAX_TOL)


@pytest.mark.parametrize("impl", ["a2a", "psum"])
def test_ep_on_a_mesh_with_two_data_axes(world, impl):
    """A (1, 2, 2) ("pod", "data", "model") mesh of the same world: the
    same outputs, and the same aux (its data group spans two axes)."""
    out, _, _ = world
    _close(out[f"pod_{impl}_y"], out["dense_y"], **PORT)
    want = out["a2a_aux_c1" if impl == "a2a" else "psum_aux"]
    _close(out[f"pod_{impl}_aux"], want, **PORT)


@pytest.mark.parametrize("impl", ["a2a", "psum"])
def test_ep_aux_is_the_mean_of_rank_values(world, impl):
    out, _, _ = world
    keys = ["a2a_aux_c1", "a2a_aux_c2"] if impl == "a2a" else ["psum_aux"]
    want = out[f"{impl}_aux_ranks"].mean()
    for k in keys:
        _close(out[k], want, **PORT)


def test_ep_a2a_grads_match_dense(world):
    out, _, _ = world
    ep, dense = out["a2a_grads"], out["dense_grads"]
    assert sorted(ep) == sorted(dense) == ["router", "w1", "w2"]
    for n in ep:
        assert ep[n].shape == dense[n].shape
        scale = float(dense[n].abs().max())
        _close(ep[n], dense[n], rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("tag", ["base", "plan"])
def test_lexi_plan_loss_on_ep_a2a_matches_one_process(world, tag):
    """Each rank's loss is its own row's: its xent the one-process
    dense xent of that row, its aux the mean of the four rows' (the
    reference's EP aux); the rows' mean xent is the whole batch's."""
    out, _, _ = world
    ep, rows = out[f"{tag}_ep"], out[f"{tag}_dense_rows"]
    _close(ep[:, 1], rows[:, 1], **PORT)                       # xent
    _close(ep[:, 2], rows[:, 2].mean().expand(4), **PORT)      # aux
    _close(ep[:, 0], ep[:, 1] + 0.01 * ep[:, 2], **PORT)       # loss
    _close(ep[:, 1].mean(), out[f"{tag}_dense_full"], **PORT)


def test_a2a_bytes_recorded_and_smaller_under_the_plan(world):
    out, _, _ = world
    base, plan = out["base_a2a_bytes"], out["plan_a2a_bytes"]
    cfg, planned = ranks.plan_cfg()
    # two all-to-alls a MoE layer (there and back), f32 [model, E_loc, C, D]
    assert out["base_a2a_count"] == out["plan_a2a_count"] \
        == 2 * cfg.num_moe_layers
    assert 0 < plan < base
    from repro_torch.models.moe import capacity
    t_loc = 32                               # one 32-token row a rank
    want = sum(2 * cfg.num_experts * capacity(t_loc, k, cfg.num_experts,
                                              cfg.moe_capacity_factor)
               * cfg.d_model * 4 for k in planned.lexi_plan)
    assert plan == want


def test_context_parallel_decode_matches_plain_and_reference(world):
    out, refs, _ = world
    assert bool(out["prefill_cache_equal"].all())
    for got, want, jax_want in zip(out["mesh_logits"], out["plain_logits"],
                                   refs["jax_decode_logits"]):
        _close(got, want, **PORT)
        _close(got, jax_want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tag", ["moe", "moe_int8", "dense"])
def test_train_on_mesh_matches_one_process(world, tag):
    """The dense LM's mesh step is the one-process step on the global
    batch.  The MoE's aux under EP is the mean of the ranks' own, which is
    the one-process step with one microbatch a rank's block
    (``one_process_microbatches``); with compression each scale's amax is
    the max over the model ranks' expert slices."""
    from repro_torch.tree import leaves
    out, refs, _ = world
    got, want = out[f"train_{tag}"], refs[f"train_{tag}"]
    _close(got["losses"], want.losses, **PORT)
    pairs = list(zip(leaves(got["params"]), leaves(want.state.params)))
    if tag != "moe_int8":
        for a, b in pairs:
            _close(a, b, **PORT)
        return
    # int8: the gradients summed in another order can round one element to
    # the next quantization step, which moves its param by at most about
    # the learning rate; a per-rank scale would move most expert elements
    diff = torch.cat([(a - b).abs().flatten() for a, b in pairs])
    assert float(diff.max()) <= ranks.optimizer().peak_lr
    assert int((diff > PORT["atol"]).sum()) <= 1e-3 * diff.numel()


def test_checkpoint_from_the_world_resumes_in_one_process(world):
    """Saved on the (2, 2) world at steps 2 and 4, restored on it
    (each rank's block), then resumed here in one process."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.training import train
    from repro_torch.tree import leaves
    out, _, ckpt = world
    for tag in ranks.train_runs():
        got = out[f"train_{tag}"]
        assert got["restore_step"] == ranks.TRAIN_STEPS
        assert got["restore_equal"]
        ck = os.path.join(ckpt, tag)
        back, meta = CheckpointManager(ck).restore(
            {"params": got["params"]})
        for a, b in zip(leaves(back["params"]), leaves(got["params"])):
            assert torch.equal(a, b)
    cfg = ranks.train_runs()["dense"][0]
    res = train(cfg, ranks.data_cfg(cfg), total_steps=ranks.TRAIN_STEPS + 2,
                optimizer=ranks.optimizer(), device="cpu",
                ckpt_dir=os.path.join(ckpt, "dense"), ckpt_every=2,
                ckpt_async=False)
    assert res.resumed_from == ranks.TRAIN_STEPS and res.steps_run == 2
