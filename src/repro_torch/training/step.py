"""Train-step construction: grads -> (optional compression) -> AdamW update
(the port's counterpart of ``repro.training.step``).

Supports microbatched gradient accumulation (sequential over microbatches,
f32 sums divided by the count, as the reference's scan) and int8
error-feedback gradient compression.  The step runs the model's plain
paths: a kernel wrapper handed a tensor that requires grad raises
(``kernels/_checks.py::no_grad_through``), since no kernel has a backward.
The step updates the state's params and moments in place.

Under a bound ``mesh`` the step is a per-rank program: the batch is the
rank's data block (``sharding.batch_specs``: rows over the data axes, the
same on every rank of a ``model`` group), the state the rank's blocks
(``state_shardings``): the params' tensor-parallel, expert and (under
``opts.fsdp_params``) FSDP blocks of ``sharding.local_specs``, the
moments' ZeRO-1 blocks over the data axes (``opt_state_specs``).  The
ranks of a ``model`` group compute one loss, the data block's; each data
block weighs it into a share -- its cross-entropy times its mask count
over the global count, plus its aux term over the data axes' size --
whose sum over the data axes is the global batch's loss.  Tensor
parallelism's collectives (``models/tp.py``) leave every replicated
leaf's gradient whole and equal on the ranks of a ``model`` group and
every split leaf's the gradient of its block, so the step sums each
gradient over the data axes only (an FSDP leaf's comes out of its
gather's reduce-scatter already summed, as its block).  Under ZeRO-1 each
rank then updates its block of each param from its block of the summed
gradient and its moments, and all-gathers the params over the data axes.

``make_train_step(..., graphs=True)`` makes the step one CUDA graph on the
card (``GraphedStep``), the counterpart of the reference's jitted step:
forward, backward, the microbatch sum, compression, the global norm and
the AdamW update (ZeRO-1's all-gather too), on a mesh or off one.  Its
first call runs the step eagerly on the capture stream and captures it;
each later call copies the batch into the graph's static inputs and the
step's learning rate and bias corrections into a device tensor
(``AdamW.scalars``), and replays.  The state is updated in place at the
addresses the graph captured (the error-feedback state too:
``compress_grads``); a call on a state whose tensors moved raises, so a
restored state needs a new step (``train`` makes one a run, and captures
at the first step after a restore).  The metrics a replay returns are the
graph's static outputs, valid until the next call.  The eager step reads
the same scalars from the same kind of tensor, so the graph is held to
it.  On the CPU ``GraphedStep`` runs the step eagerly.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import resolve_device
from repro_torch.models.opts import DEFAULT_OPTS, ModelOpts
from repro_torch.optim import AdamW, AdamWState
from repro_torch.optim.compression import compress_grads, init_error_state
from repro_torch.sharding import comm
from repro_torch.sharding.rules import Sharding, data_axes, \
    data_axes_size, local_shardings, local_specs, opt_state_specs, \
    shardings_for
from repro_torch.tree import leaves, unflatten


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    err: Optional[Any]          # compression error-feedback state (or None)


def init_state(cfg: ModelConfig, optimizer: AdamW, seed: int = 0, *,
               compression: bool = False, device=None) -> TrainState:
    """Random params drawn from ``seed`` on ``device`` (the card unless the
    caller asks for the CPU), zero moments."""
    params = models.init_params(cfg, seed, device=resolve_device(device))
    return TrainState(
        params=params,
        opt=optimizer.init(params),
        err=init_error_state(params) if compression else None,
    )


def state_shardings(state: TrainState, cfg: ModelConfig, mesh,
                    opts: ModelOpts = DEFAULT_OPTS) -> TrainState:
    """The shardings of a whole train state under ``mesh``: the params'
    ``local_specs`` (FSDP under ``opts.fsdp_params``), the moments' ZeRO-1
    specs over the data axes (``opt_state_specs``), the error state's the
    params', the step count whole."""
    fsdp = (opts.fsdp_params, opts.fsdp_min_size)
    ps = local_shardings(state.params, cfg, mesh, *fsdp)
    specs = opt_state_specs(state.opt, local_specs(state.params, cfg, mesh,
                                                   *fsdp), mesh)
    ms = shardings_for(state.params, specs.mu, mesh)
    return TrainState(params=ps, opt=AdamWState(step=Sharding(mesh, ()),
                                                mu=ms, nu=ms),
                      err=None if state.err is None else ps)


def whole_shardings(cfg: ModelConfig, mesh, opts: ModelOpts = DEFAULT_OPTS,
                    compression: bool = False) -> TrainState:
    """``state_shardings`` of a whole state of ``cfg`` without one (the
    specs read whole shapes, ``models.abstract_params``, never a rank's
    blocks); an error state under ``compression``."""
    params = models.abstract_params(cfg)
    return state_shardings(TrainState(params, AdamWState(0, params, params),
                                      params if compression else None),
                           cfg, mesh, opts)


def _grads(loss: torch.Tensor, live) -> Tuple[torch.Tensor, ...]:
    gs = torch.autograd.grad(loss, live, allow_unused=True)
    return tuple(torch.zeros_like(p) if g is None else g
                 for g, p in zip(gs, live))


def _psum_data(x, mesh):
    daxes = data_axes(mesh)
    return comm.psum(x, mesh, daxes) if daxes else x


def _rank_share(loss, metrics, batch, mesh):
    """-> (the data block's share of the global loss, the global loss,
    xent and aux).  share = xent * n / N + (loss - xent) / D, with n the
    block's mask count, N the global one and D the data axes' size: the
    shares sum over the data axes to the global cross-entropy plus the
    mean of the blocks' aux terms.  Every rank of a ``model`` group
    computes the same share."""
    n = batch["mask"].float().sum()
    n_all = _psum_data(n, mesh)
    d = data_axes_size(mesh)
    xent_share = metrics["xent"] * (n / n_all.clamp(min=1.0))
    share = xent_share + (loss - metrics["xent"]) / d
    out = _psum_data(torch.stack([share, xent_share, metrics["aux"] / d])
                     .detach(), mesh)
    return share, out[0], {"xent": out[1], "aux": out[2]}


def _has_data(sh: Sharding) -> bool:
    return any(a != "model" for e in sh.spec if e is not None
               for a in (e if isinstance(e, tuple) else (e,)))


def _reduce_grads(grads: List[torch.Tensor], shardings, mesh
                  ) -> List[torch.Tensor]:
    """Sum each gradient over the data axes, but an FSDP leaf's (its
    gather's reduce-scatter summed it)."""
    return [g if _has_data(sh) else _psum_data(g, mesh)
            for g, sh in zip(grads, leaves(shardings))]


def value_and_grad(cfg: ModelConfig, *, opts: ModelOpts = DEFAULT_OPTS,
                   microbatches: int = 1, mesh=None) -> Callable:
    """-> fn(params, batch) -> (loss, metrics, grads like params).  The
    grads are in each param's dtype, or f32 sums over ``microbatches``
    divided by their count.  Under ``mesh`` the loss and metrics are the
    global batch's and the grads reduced over the data axes (module
    doc)."""
    # the whole shapes' shardings, laid out here rather than in the step
    # (``abstract_params`` draws a whole tree on ``meta``: spec
    # arithmetic, no part of the step's work)
    shardings = (None if mesh is None
                 else whole_shardings(cfg, mesh, opts).params)

    def loss_of(tree, batch):
        loss, metrics = models.loss_fn(tree, cfg, batch, mesh=mesh,
                                       opts=opts)
        if mesh is None:
            return loss, loss.detach(), metrics
        return _rank_share(loss, metrics, batch, mesh)

    def fn(params, batch: Dict[str, torch.Tensor]):
        # fresh leaves on the same storage, so the state's own tensors
        # never require grad
        live = [p.detach().requires_grad_() for p in leaves(params)]
        tree = unflatten(params, live)
        with torch.enable_grad():
            if microbatches <= 1:
                share, loss, metrics = loss_of(tree, batch)
                grads = list(_grads(share, live))
                metrics = {k: v.detach() for k, v in metrics.items()}
            else:
                b = batch["tokens"].shape[0]
                if b % microbatches:
                    raise ValueError(f"batch {b} does not split into "
                                     f"{microbatches} microbatches")
                micro = {k: v.reshape(microbatches, b // microbatches,
                                      *v.shape[1:])
                         for k, v in batch.items()}
                grads = [torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device) for p in live]
                loss = torch.zeros((), device=live[0].device)
                for i in range(microbatches):
                    share, loss_i, _ = loss_of(
                        tree, {k: v[i] for k, v in micro.items()})
                    torch._foreach_add_(grads, [g.float() for g in
                                                _grads(share, live)])
                    loss = loss + loss_i
                torch._foreach_div_(grads, float(microbatches))
                loss = loss / microbatches
                metrics = {"xent": loss, "aux": torch.zeros_like(loss)}
        if mesh is not None:
            grads = _reduce_grads(grads, shardings, mesh)
        return loss, metrics, unflatten(params, grads)

    return fn


def _axes_of(sh: Sharding, mesh) -> Tuple[str, ...]:
    used = {a for e in sh.spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,))}
    return mesh.axes(used) if used else ()


def _global_norm(grads, mesh=None, shardings=None) -> torch.Tensor:
    """The norm of the whole gradient: under a mesh each leaf's squares
    are summed over the axes its block splits over."""
    sq = [torch.linalg.vector_norm(g, dtype=torch.float32).square()
          for g in leaves(grads)]
    if mesh is None:
        return torch.stack(sq).sum().sqrt()
    groups: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
    for q, sh in zip(sq, leaves(shardings)):
        groups.setdefault(_axes_of(sh, mesh), []).append(q)
    total = sq[0].new_zeros(())
    for axes in sorted(groups):
        part = torch.stack(groups[axes]).sum()
        total = total + (comm.psum(part, mesh, axes) if axes else part)
    return total.sqrt()


def _zero1_blocks(shardings: TrainState, mesh):
    """Per param leaf: the ``Sharding`` of its ZeRO-1 block (the data-axes
    entries its moments add to its own spec), or None where the moments
    split no further than the param."""
    out = []
    for ps, ms in zip(leaves(shardings.params), leaves(shardings.opt.mu)):
        extra = tuple(None if e == p else e for e, p in
                      zip(ms.spec, ps.spec + (None,) * len(ms.spec)))
        out.append(Sharding(mesh, extra, ms.fused)
                   if any(e is not None for e in extra) else None)
    return out


def make_train_step(cfg: ModelConfig, optimizer: AdamW, *,
                    opts: ModelOpts = DEFAULT_OPTS, mesh=None,
                    microbatches: int = 1, compression: bool = False,
                    graphs: bool = False) -> Callable:
    """Returns step(state, batch) -> (state, metrics): ``loss``, ``xent``,
    ``aux``, ``grad_norm`` (device scalars) and ``lr`` (the new step's).
    Under a bound ``mesh``: the rank's batch block and state (module
    doc, ``state_shardings``); the metrics are the global batch's on every
    rank.  ``graphs``: a ``GraphedStep`` (module doc)."""
    grads_of = value_and_grad(cfg, opts=opts, microbatches=microbatches,
                              mesh=mesh)
    # a scale group's amax over the ranks, whose blocks of a leaf differ
    # (whole leaves are equal on every rank after the reduction)
    amax = None if mesh is None else (
        lambda a: comm.pmax(a, mesh, mesh.axis_names))
    # spec arithmetic, once (as in ``value_and_grad``)
    whole = None if mesh is None else whole_shardings(cfg, mesh, opts)
    zero = None if mesh is None else _zero1_blocks(whole, mesh)

    def body(state: TrainState, batch, scalars: torch.Tensor) -> Dict:
        """The step's work on the device: the state in place -> the
        metrics but ``lr``."""
        loss, metrics, grads = grads_of(state.params, batch)
        if compression:
            grads, _ = compress_grads(grads, state.err, cfg,
                                      amax_reduce=amax)
        if mesh is None:
            gnorm = _global_norm(grads)
            optimizer.step_(grads, state.opt, state.params, scalars)
        else:
            gnorm = _global_norm(grads, mesh, whole.params)
            _zero1_step(optimizer, state, grads, zero, scalars)
        return dict(metrics, loss=loss, grad_norm=gnorm)

    def finish(state: TrainState, metrics: Dict
               ) -> Tuple[TrainState, Dict]:
        opt = state.opt._replace(step=state.opt.step + 1)
        return (TrainState(state.params, opt, state.err),
                dict(metrics, lr=optimizer.schedule(opt.step)))

    if graphs:
        return GraphedStep(body, finish, optimizer)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        # a copy on every device, the CPU too: a step counts the same work
        # on the CPU, on meta and on the card (``analysis/counters.py``)
        scalars = optimizer.scalars(state.opt.step + 1).to(
            _device_of(state), copy=True)
        return finish(state, body(state, batch, scalars))

    return step


def _device_of(state: TrainState) -> torch.device:
    return leaves(state.params)[0].device


def _addresses(state: TrainState) -> Tuple[int, ...]:
    """Where the step reads and writes in place: every tensor of the
    state."""
    return tuple(t.data_ptr() for t in leaves((state.params, state.opt.mu,
                                               state.opt.nu, state.err)))


class GraphedStep:
    """The train step as one CUDA graph on the card (module doc): ``body``
    does the step's device work on the state in place -> its metrics,
    ``finish`` advances the step count and adds ``lr``."""

    def __init__(self, body: Callable, finish: Callable, optimizer: AdamW):
        self._body, self._finish, self._optimizer = body, finish, optimizer
        self.graph = None
        #: static inputs: the batch's tensors and the step's scalars
        self.inputs: Dict[str, torch.Tensor] = {}
        self.scalars: Optional[torch.Tensor] = None
        self.addresses: Tuple[int, ...] = ()
        #: graphs captured, replays
        self.stats: Dict[str, int] = {"graphs": 0, "replays": 0}

    def _load(self, state: TrainState, batch) -> None:
        """The call's batch and scalars into the static inputs; first wait
        until the last copy out of the pinned staging has run."""
        if batch.keys() != self.inputs.keys() or any(
                tuple(v.shape) != tuple(self.inputs[k].shape)
                for k, v in batch.items()):
            raise ValueError(
                "the train step's CUDA graph was captured for batch "
                f"{ {k: tuple(v.shape) for k, v in self.inputs.items()} }, "
                f"got { {k: tuple(v.shape) for k, v in batch.items()} }")
        self._copied.synchronize()
        self._staging.copy_(self._optimizer.scalars(state.opt.step + 1))
        self.scalars.copy_(self._staging, non_blocking=True)
        self._copied.record()
        for k, v in batch.items():
            self.inputs[k].copy_(v, non_blocking=True)

    def __call__(self, state: TrainState, batch
                 ) -> Tuple[TrainState, Dict]:
        dev = _device_of(state)
        if dev.type != "cuda":
            scalars = self._optimizer.scalars(state.opt.step + 1)
            return self._finish(state, self._body(state, batch, scalars))
        from repro_torch.kernels import _graphs
        if self.graph is not None:
            if _addresses(state) != self.addresses:
                raise RuntimeError(
                    "the train step's CUDA graph updates the state it was "
                    "captured on in place; this state's tensors live "
                    "elsewhere (make a new step for it)")
            self._load(state, batch)
            self.stats["replays"] += 1
            return self._finish(state, self.graph.replay())
        self.inputs = {k: torch.empty_like(v, device=dev)
                       for k, v in batch.items()}
        host = self._optimizer.scalars(state.opt.step + 1)
        self.scalars = torch.empty_like(host, device=dev)
        self._staging = torch.empty_like(host).pin_memory()
        self._copied = torch.cuda.Event()
        self._load(state, batch)
        stream = _graphs.side_stream(dev)

        def run():
            return self._body(state, self.inputs, self.scalars)
        metrics = _graphs.on_stream(run, stream)
        # the eager step's temporaries back to the card before the capture
        # allocates the graph's own
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        self.graph = _graphs.capture(run, stream=stream,
                                     pool=torch.cuda.graph_pool_handle())
        self.addresses = _addresses(state)
        self.stats["graphs"] += 1
        return self._finish(state, metrics)


@torch.no_grad()
def _zero1_step(optimizer: AdamW, state: TrainState, grads, zero, scalars):
    """AdamW on each rank's ZeRO-1 block of every param (its moments'
    block), then the params all-gathered over the data axes, copied into
    the params in place."""
    ps, gs = leaves(state.params), leaves(grads)
    blocks = [p if z is None else z.local(p).clone() for p, z in zip(ps, zero)]
    gblk = [g if z is None else z.local(g) for g, z in zip(gs, zero)]
    optimizer.step_(unflatten(state.params, gblk), state.opt,
                    unflatten(state.params, blocks), scalars)
    for p, b, z in zip(ps, blocks, zero):
        if z is not None:
            p.copy_(z.gather(b))
