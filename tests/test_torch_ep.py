"""Expert parallelism, context-parallel decode and training on a mesh:
the port in a (2, 2) gloo world of four processes on the CPU, against the
port's one-process paths and the JAX reference.  Every rank takes its data
block of the inputs (the same on both ranks of its ``model`` group) and
its blocks of the params (tensor parallelism over ``model`` included);
the train runs shard the moments ZeRO-1 over ``data``, and the ``*_fsdp``
runs the params too (FSDP).

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
train losses and params after four AdamW steps 1e-5, each leaf, but for
the elements whose AdamW denominator stayed within a few eps of zero (at
most one in 1000 of a leaf, none past the learning rate; see the test);
with int8 gradient compression: losses 1e-5, at most one param element
in 1000 past 1e-5 and none past the learning rate.
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
        if not kw.get("compression"):
            refs[f"adam_floor_{tag}"] = _adam_floor(cfg, kw)
    refs.update(_jax_references())
    return refs


def _adam_floor(cfg, kw):
    """Each param element's least AdamW denominator ``sqrt(v_hat)`` over
    the one-process run's steps (the steps ``train`` takes, one by one),
    and the params they end at."""
    from repro_torch.data.pipeline import Pipeline, to_device
    from repro_torch.training.step import init_state, make_train_step
    from repro_torch.tree import leaves
    opt = ranks.optimizer()
    step = make_train_step(
        cfg, opt, microbatches=ranks.one_process_microbatches(cfg),
        **{k: v for k, v in kw.items() if k == "opts"})
    state = init_state(cfg, opt, 0, device="cpu")
    floor = None
    with Pipeline(ranks.data_cfg(cfg)) as pipe:
        for t, batch in zip(range(ranks.TRAIN_STEPS), pipe):
            state, _ = step(state, to_device(batch, torch.device("cpu")))
            den = [(v / (1 - opt.b2 ** (t + 1))).sqrt()
                   for v in leaves(state.opt.nu)]
            floor = den if floor is None else [
                torch.minimum(a, b) for a, b in zip(floor, den)]
    return floor, state.params


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
    """``ep_a2a``'s aux is the mean over the ``model`` ranks of each rank's
    own rows' (rank 0's data group: ranks 0 and 1); ``ep_psum``'s the
    data block's own."""
    out, _, _ = world
    keys = ["a2a_aux_c1", "a2a_aux_c2"] if impl == "a2a" else ["psum_aux"]
    per_rank = out[f"{impl}_aux_ranks"]
    want = (per_rank[:ranks.SHAPE[1]].mean() if impl == "a2a"
            else per_rank[0])
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
    """Each rank's loss is its data block's (two rows, the same on both
    ranks of its ``model`` group): its xent the mean of the one-process
    dense xents of the block's rows, its aux the mean of the rows' (one
    row a ``model`` rank, the reference's EP aux); the blocks' mean xent
    is the whole batch's."""
    out, _, _ = world
    ep, rows = out[f"{tag}_ep"], out[f"{tag}_dense_rows"]
    m = ranks.SHAPE[1]
    block = rows.reshape(-1, m, rows.shape[-1]).mean(1).repeat_interleave(
        m, dim=0)
    _close(ep[:, 1], block[:, 1], **PORT)                      # xent
    _close(ep[:, 2], block[:, 2], **PORT)                      # aux
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
    # the sequence-sharded write, bit for bit; the prefill's k / v come
    # from the ranks' column blocks, so against one process to 1e-5
    assert bool(out["prefill_cache_equal"].all())
    assert float(out["prefill_cache_diff"].max()) <= PORT["atol"]
    for got, want, jax_want in zip(out["mesh_logits"], out["plain_logits"],
                                   refs["jax_decode_logits"]):
        _close(got, want, **PORT)
        _close(got, jax_want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tag", ["moe", "moe_int8", "dense", "moe_fsdp",
                                 "dense_fsdp"])
def test_train_on_mesh_matches_one_process(world, tag):
    """Four AdamW steps under ZeRO-1 (every mesh run) and, for ``*_fsdp``,
    FSDP.  The dense LM's mesh step is the one-process step on the global
    batch.  The MoE's aux under EP is the mean of the ranks' own, which is
    the one-process step with one microbatch a rank's rows
    (``one_process_microbatches``); with compression each scale's amax is
    the max over the ranks' blocks of its leaves."""
    from repro_torch.tree import leaves
    out, refs, _ = world
    got, want = out[f"train_{tag}"], refs[f"train_{tag}"]
    _close(got["losses"], want.losses, **PORT)
    pairs = list(zip(leaves(got["params"]), leaves(want.state.params)))
    lr = ranks.optimizer().peak_lr
    if tag == "moe_int8":
        # int8: the gradients summed in another order can round one element
        # to the next quantization step, which moves its param by at most
        # about the learning rate; a per-rank scale would move most expert
        # elements
        diff = torch.cat([(a - b).abs().flatten() for a, b in pairs])
        assert float(diff.max()) <= lr
        assert int((diff > PORT["atol"]).sum()) <= 1e-3 * diff.numel()
        return
    # Tensor parallelism sums the same products in other blocks and orders,
    # so the gradients agree to float rounding, not bit for bit.  AdamW
    # moves an element by lr * m / (sqrt(v) + eps): where sqrt(v) stays
    # within a few eps of zero (a gradient of rounding size), that rounding
    # moves the param by a share of lr (observed up to 4.7e-5).  Those
    # elements, found from the one-process run's own denominators, are
    # exempt from 1e-5, not from the learning rate; every other element of
    # every leaf, one that never had a gradient too, is held to 1e-5.
    near_zero = 10 * ranks.optimizer().eps
    floors, stepped = refs[f"adam_floor_{tag}"]
    for a, b in zip(leaves(stepped), leaves(want.state.params)):
        assert torch.equal(a, b)            # the floors are train's steps'
    for (a, b), floor in zip(pairs, floors):
        loose = (floor > 0) & (floor < near_zero)
        assert int(loose.sum()) <= 1e-3 * loose.numel()
        assert float((a - b).abs().max()) <= lr
        _close(a[~loose], b[~loose], **PORT)


def test_zero1_and_fsdp_hold_the_ranks_blocks(world):
    """Rank 0's train state: the moments' ZeRO-1 blocks are half its
    params' along a data-sharded dim; under FSDP the params are such
    blocks too."""
    import math
    out, _, _ = world
    for tag in ("dense", "moe"):
        plain, fsdp = out[f"train_{tag}"], out[f"train_{tag}_fsdp"]
        size = lambda shapes: sum(math.prod(s) for s in shapes.values())  # noqa: E731
        # ZeRO-1: the moments hold a data block of most leaves
        assert size(plain["mu_blocks"]) < size(plain["blocks"])
        # FSDP: the params themselves are the data blocks
        assert size(fsdp["blocks"]) < size(plain["blocks"])
        assert size(fsdp["mu_blocks"]) <= size(fsdp["blocks"])
    wq = "layers/0/attn/wq"
    assert out["train_dense"]["blocks"][wq] == (64, 32)          # TP
    assert out["train_dense_fsdp"]["blocks"][wq] == (32, 32)     # + FSDP


def test_checkpoint_from_the_world_resumes_in_one_process(world):
    """Saved on the (2, 2) world at steps 2 and 4, restored on it
    (each rank's block), then resumed here in one process (the ZeRO-1
    run's checkpoint and the FSDP run's)."""
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
    for tag in ("dense", "dense_fsdp"):
        cfg = ranks.train_runs()[tag][0]
        res = train(cfg, ranks.data_cfg(cfg),
                    total_steps=ranks.TRAIN_STEPS + 2,
                    optimizer=ranks.optimizer(), device="cpu",
                    ckpt_dir=os.path.join(ckpt, tag), ckpt_every=2,
                    ckpt_async=False)
        assert res.resumed_from == ranks.TRAIN_STEPS and res.steps_run == 2
