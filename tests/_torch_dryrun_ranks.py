"""The rank program of ``tests/test_torch_dryrun.py``: one process of a
(1, 4) gloo world on the CPU (``torch.multiprocessing.spawn`` imports this
module, which imports only torch, numpy, the port and the recording
helpers of ``_torch_tp_ranks.py``).

Every rank runs each cell of ``cells()`` on its blocks of real params
(``launch.dryrun.build_cell`` on the CPU), counted
(``analysis.counters.count``), and writes its counts; the test process
runs the same cells on ``meta``, the mesh placed on each rank, and holds
the two equal.  Every rank also writes the collectives of a reduced
OLMoE's ``ep_a2a`` train step, with remat off and on, beside those of its
no-grad forward (``a2a_steps``).  Rank 0 also writes whisper's loss,
gradients and logits under tensor parallelism, which the test holds to
one process and to the JAX reference, and the collectives its
vocab-parallel cross-entropy notes."""

import torch

from _torch_tp_ranks import collectives, recorded

WORLD = 4
SHAPE = (1, 4)
AXES = ("data", "model")
#: the whisper checks' batch, and the decode steps after its prefill
BATCH, SEQ, DECODE_STEPS = 4, 16, 2
BATCH_SEED = 3


def cells():
    """tag -> (config, the cell's shape): reduced, f32, two layers; the
    MoE dropless over 8 experts, which split over ``model`` (``ep_a2a`` in
    train, ``ep_psum`` in decode, as the dry run's cells); every kernel
    option off (the CPU runs the plain versions, whose aten ops the meta
    run must count alike)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import cell_config
    olmoe = get_config("olmoe-1b-7b").reduced().with_(
        num_layers=2, moe_capacity_factor=8.0)
    whisper = get_config("whisper-base").reduced().with_(num_layers=2)
    train = ShapeSpec("tiny_train", SEQ, BATCH, "train")
    prefill = ShapeSpec("tiny_prefill", SEQ, BATCH, "prefill")
    decode = ShapeSpec("tiny_decode", 32, BATCH, "decode")
    out = {"olmoe_train": (olmoe, train), "olmoe_decode": (olmoe, decode),
           "whisper_train": (whisper, train),
           "whisper_prefill": (whisper, prefill),
           "whisper_decode": (whisper, decode)}
    return {tag: (cell_config(cfg, shape), shape)
            for tag, (cfg, shape) in out.items()}


def opts_for(shape):
    from repro_torch.models.opts import ModelOpts
    return ModelOpts(remat="full" if shape.step == "train" else "none")


def counted(cfg, shape, mesh, device):
    """The rank's step of one cell on ``device``, counted -> the counts
    compared (``Counts.as_dict`` without the peak, which the two runs
    reach through different allocations of the collectives' buffers)."""
    from repro_torch.analysis.counters import count
    from repro_torch.launch.dryrun import build_cell
    step, inputs = build_cell(cfg, shape, mesh, opts_for(shape),
                              device=device)
    with count(inputs) as c:
        step()
    out = c.as_dict()
    out.pop("peak_bytes")
    return out


#: the remat settings of ``a2a_steps``: all-to-alls 2x (off: forward and
#: backward) or 3x (on: forward, the rerun, backward) the forward's
A2A_REMATS = ("none", "full")


def a2a_steps(mesh, device):
    """The ``olmoe_train`` cell's step (``launch.dryrun.build_cell``) with
    remat off and on -> {remat: {"step": its collectives, "forward": those
    of ``loss_fn`` on the same blocks under no grad}} (``collectives``)."""
    from repro_torch import models
    from repro_torch.analysis import record
    from repro_torch.launch.dryrun import build_cell
    from repro_torch.models.opts import ModelOpts
    cfg, shape = cells()["olmoe_train"]
    out = {}
    for remat in A2A_REMATS:
        opts = ModelOpts(remat=remat)
        step, inputs = build_cell(cfg, shape, mesh, opts, device=device)
        with torch.no_grad(), record() as fwd:
            models.loss_fn(inputs["params"], cfg, inputs["batch"],
                           mesh=mesh, opts=opts)
        with record() as full:
            step()
        out[remat] = {"step": collectives(full), "forward": collectives(fwd)}
    return out


def whisper_batch(cfg):
    from repro_torch import models
    return models.make_train_batch(
        cfg, torch.Generator().manual_seed(BATCH_SEED), BATCH, SEQ,
        device="cpu")


def whisper_steps(params, cfg, mesh=None):
    """Prefill of the batch's frames and tokens, then greedy decode steps
    -> the logits [B, V] of each (contiguous caches, the rank's blocks
    under a mesh)."""
    from repro_torch import models
    from repro_torch.sharding import local_cache_specs, local_tree, named
    b = whisper_batch(cfg)
    tokens = b["tokens"]
    bsz, s = tokens.shape
    caches = models.init_caches(cfg, bsz, s + DECODE_STEPS, device="cpu")
    if mesh is not None:
        caches = local_tree(caches, named(mesh, local_cache_specs(
            caches, cfg, mesh)))
    logits, caches = models.prefill_fn(
        params, cfg, {"frames": b["frames"], "tokens": tokens}, caches,
        mesh=mesh)
    out = [logits]
    pos = torch.full((bsz,), s, dtype=torch.int32)
    for i in range(DECODE_STEPS):
        nxt = out[-1].argmax(-1).int()
        lg, caches = models.decode_fn(params, cfg, nxt, pos + i, caches,
                                      mesh=mesh)
        out.append(lg)
    return out


def whisper_tp(mesh):
    """Whisper under tensor parallelism on the rank's blocks: (loss, xent,
    aux), the gradients gathered whole, the prefill and decode logits."""
    from repro_torch import models
    from repro_torch.sharding import gather_tree, local_params, \
        local_shardings
    from repro_torch.training import value_and_grad
    cfg = cells()["whisper_train"][0]
    params = models.init_params(cfg, 0, device="cpu")
    lp = local_params(params, cfg, mesh)
    from repro_torch.models import tp
    (loss, m), notes = recorded(tp, "xent", lambda: models.loss_fn(
        lp, cfg, whisper_batch(cfg), mesh=mesh))
    _, _, grads = value_and_grad(cfg, mesh=mesh)(lp, whisper_batch(cfg))
    return {"loss": torch.stack([loss, m["xent"], m["aux"]]).detach(),
            "grads": gather_tree(grads, local_shardings(params, cfg, mesh)),
            "logits": whisper_steps(lp, cfg, mesh), "xent_notes": notes}


def run(rank: int, rendezvous: str, out_dir: str) -> None:
    """One rank: bind the (1, 4) mesh on the CPU, count every cell, and
    save ``out_dir/rank<r>.pt`` (rank 0 with whisper's checks)."""
    import os
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=WORLD)
    try:
        mesh = make_test_mesh(SHAPE, AXES).bind(device="cpu")
        out = {"counts": {tag: counted(cfg, shape, mesh, "cpu")
                          for tag, (cfg, shape) in cells().items()},
               "a2a": a2a_steps(mesh, "cpu"),
               "whisper": whisper_tp(mesh)}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
