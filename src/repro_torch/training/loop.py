"""Fault-tolerant training loop and held-out evaluation (the port's
counterpart of ``repro.training.loop``).

Responsibilities:
  * auto-resume from the latest checkpoint (params, optimizer, data position);
  * periodic atomic checkpoints (async writer -- no step stall);
  * a step-time watchdog for straggler detection: steps slower than
    ``straggler_factor`` x the running median are counted and returned;
  * deterministic restart: the data pipeline replays from the checkpointed
    step, so crash + resume reproduces the uninterrupted run exactly (bit
    for bit on the CPU; on the card with deterministic algorithms on,
    since the backward of a gather accumulates with atomics otherwise).

Under a bound ``mesh`` every rank runs ``train``: the state is drawn whole
from the seed and cut to the rank's blocks (``state_shardings``: tensor
parallelism, experts, ZeRO-1 moments, and FSDP under
``opts.fsdp_params``), each step takes the rank's data block of the
global batch (rows over the data axes, the same on every rank of a
``model`` group), and a checkpoint is the whole state, gathered on every
rank and written by rank 0, so it resumes on any mesh shape or in one
process.

The reference jits the train step and the held-out ``xent``; on the card
``train`` runs the step as one CUDA graph (``training.step.GraphedStep``,
captured at the run's first step, after any restore, its NCCL
collectives inside on a mesh), and ``eval_perplexity`` the loss of its
fixed ``[B, S]`` batch shape as one graph, each held-out batch copied
into the graph's static inputs and ``xent`` read after each replay.
``graphs=False`` runs both eagerly, the oracle the graphs are held to;
on the CPU both always run eagerly.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch import models
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import Pipeline, to_device
from repro_torch.data.synthetic import DataConfig, sample_batch
from repro_torch.models.common import resolve_device
from repro_torch.models.opts import DEFAULT_OPTS, ModelOpts
from repro_torch.optim import AdamW
from repro_torch.sharding import comm
from repro_torch.sharding.rules import Sharding, data_axes, gather_tree, \
    local_tree
from repro_torch.training.step import init_state, make_train_step, \
    state_shardings


@dataclass
class TrainResult:
    steps_run: int
    final_step: int
    losses: List[float]
    step_times: List[float]
    straggler_steps: int
    resumed_from: Optional[int]
    state: Any = field(repr=False, default=None)
    grad_norms: List[float] = field(default_factory=list)
    #: host seconds the data pipeline took to make one batch
    data_s_per_batch: float = 0.0
    #: train steps that replayed a CUDA graph
    graph_replays: int = 0


def train(
    cfg: ModelConfig,
    dc: DataConfig,
    *,
    total_steps: int,
    optimizer: Optional[AdamW] = None,
    opts: ModelOpts = DEFAULT_OPTS,
    seed: int = 0,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    ckpt_async: bool = True,
    resume: bool = True,
    microbatches: int = 1,
    compression: bool = False,
    straggler_factor: float = 2.0,
    log_every: int = 10,
    crash_at_step: Optional[int] = None,   # fault-injection for tests
    verbose: bool = False,
    device=None,
    mesh=None,
    graphs: Optional[bool] = None,
) -> TrainResult:
    """Train on the card unless ``device`` asks for the CPU; under a bound
    ``mesh`` (on the same device type) every rank calls this (module
    doc).  ``graphs`` (None: True): each step after the first replays a
    CUDA graph on the card; False runs every step eagerly."""
    dev = resolve_device(device)
    if mesh is not None and mesh.device.type != dev.type:
        raise ValueError(f"train on {dev} with a mesh bound on {mesh.device}")
    optimizer = optimizer or AdamW(total_steps=total_steps)
    step_fn = make_train_step(cfg, optimizer, opts=opts, mesh=mesh,
                              microbatches=microbatches,
                              compression=compression,
                              graphs=graphs is None or bool(graphs))

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    resumed_from = None
    state = init_state(cfg, optimizer, seed, compression=compression,
                       device=dev)
    shardings = rows = None
    if mesh is not None:
        shardings = state_shardings(state, cfg, mesh, opts)
        rows = Sharding(mesh, (data_axes(mesh) or None,))  # the data block
    whole, state = state, (state if mesh is None
                           else local_tree(state, shardings))
    if mgr and resume and mgr.latest_step() is not None:
        state, meta = mgr.restore(whole, shardings=shardings)
        start_step = meta["step"]
        resumed_from = start_step
        if verbose:
            print(f"[resume] restored step {start_step} from {ckpt_dir}")
    del whole

    losses: List[float] = []
    gnorms: List[float] = []
    times: List[float] = []
    stragglers = 0

    with Pipeline(dc, start_step=start_step) as pipe:
        step = start_step
        for batch in pipe:
            if step >= total_steps:
                break
            t0 = time.time()
            batch = to_device(batch, dev)
            if rows is not None:
                batch = {k: rows.local(v) for k, v in batch.items()}
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            losses.append(loss)
            gnorms.append(float(metrics["grad_norm"]))
            times.append(dt)
            step += 1

            # straggler watchdog
            if len(times) >= 5:
                med = statistics.median(times[-50:])
                if dt > straggler_factor * med:
                    stragglers += 1
                    if verbose:
                        print(f"[watchdog] step {step} took {dt:.3f}s "
                              f"(median {med:.3f}s) -- straggler")

            if verbose and step % log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {gnorms[-1]:.3f} "
                      f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms")

            if mgr and step % ckpt_every == 0:
                _save(mgr, step, state, shardings, mesh,
                      blocking=not ckpt_async, extra={"loss": loss})

            if crash_at_step is not None and step == crash_at_step:
                mgr and mgr.wait()
                raise RuntimeError(f"injected crash at step {step}")
        data_s = pipe.seconds_per_batch()

    if mgr:
        _save(mgr, step, state, shardings, mesh, blocking=True,
              extra={"final": True})
        mgr.wait()
        if mesh is not None:        # every rank returns after the write
            comm.barrier(mesh)

    return TrainResult(steps_run=step - start_step, final_step=step,
                       losses=losses, step_times=times,
                       straggler_steps=stragglers, resumed_from=resumed_from,
                       state=state, grad_norms=gnorms,
                       data_s_per_batch=data_s,
                       graph_replays=int(getattr(step_fn, "stats", {})
                                         .get("replays", 0)))


def _save(mgr: CheckpointManager, step: int, state, shardings, mesh, *,
          blocking: bool, extra) -> None:
    """One checkpoint of the whole state: under a mesh every rank gathers
    (collective) and rank 0 writes."""
    if mesh is not None:
        state = gather_tree(state, shardings)
        if mesh.axis_index(mesh.axis_names):
            return
    mgr.save(step, state, blocking=blocking, extra=extra)


@torch.no_grad()
def eval_perplexity(state_or_params, cfg: ModelConfig, dc: DataConfig, *,
                    steps: int = 8, start_step: int = 10_000,
                    opts: ModelOpts = DEFAULT_OPTS,
                    graphs: Optional[bool] = None) -> float:
    """Held-out perplexity on fresh synthetic batches (quality proxy), on
    the device the params live on.  ``graphs`` (None: True): on the card
    the first batch runs eagerly and the later ones replay one CUDA graph
    of the loss (module doc); False runs every batch eagerly."""
    params = getattr(state_or_params, "params", state_or_params)
    dev = params["embed"].device

    def xent(batch):
        _, m = models.loss_fn(params, cfg, batch, opts=opts)
        return m["xent"]

    graphed = (graphs is None or bool(graphs)) and dev.type == "cuda"
    if graphed:
        from repro_torch.kernels import _graphs
        stream = _graphs.side_stream(dev)
    static = graph = None
    tot = 0.0
    for i in range(steps):
        batch = to_device(sample_batch(dc, start_step + i), dev)
        if not graphed:
            tot += float(xent(batch))
            continue
        if static is None:                   # the eager first batch
            static = batch
            tot += float(_graphs.on_stream(lambda: xent(static), stream))
            continue
        for k, v in batch.items():
            static[k].copy_(v)
        if graph is None:
            graph = _graphs.capture(lambda: xent(static), stream=stream,
                                    pool=torch.cuda.graph_pool_handle())
        tot += float(graph.replay())
    return float(np.exp(tot / steps))
