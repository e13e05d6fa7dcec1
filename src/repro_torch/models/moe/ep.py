"""Expert-parallel impls: ``ep_a2a`` (train / prefill) and ``ep_psum``
(decode), as ``repro.models.moe.ep``.

``ep_a2a``: tokens sharded over every mesh axis, experts sharded over
``model``.  Scatter into per-expert capacity buffers, ``all_to_all`` over
the model axis, the grouped expert FFN (the ``moe_ffn`` kernel on
``[E_loc, model * C, D]``), a2a back, weighted combine.  Collective bytes
scale with sum_j k_j -- a LExI plan buys communication, not just FLOPs.

``ep_psum``: activations replicated over ``model``, each rank computes
only its local experts' contribution (``moe_ffn`` on ``[E_loc, C, D]``),
partial outputs are ``psum``-reduced.  The right pattern when T (= the
decode batch) is small.

The reference's functions take the global token array under ``jit`` and
``shard_map`` it; the port's are a per-rank program on a bound mesh, with
the rank's ``[E / model, ...]`` expert slice (``sharding.local_params``).
Both take **the rank's data block of the tokens**, the same on every rank
of a ``model`` group, as ``sharding.batch_specs`` shards a batch, and
return the layer's output on that block, the same on every rank of the
group.  ``ep_a2a`` then does what GSPMD does around the reference's
``shard_map`` with ``in_specs=P((*token_axes, model))``: it keeps the
rank's ``1 / model`` of the rows at entry (``comm.split_to_model``) and
all-gathers the outputs over ``model`` at exit
(``comm.gather_from_model``), so each rank routes its own rows.  The aux
is the mean over the ``model`` ranks of each rank's own (its router
statistics over its rows); ``ep_psum``'s is the block's own, the same on
every rank.  Neither reduces over the data axes: the train step weighs
the data blocks' losses (``training/step.py``).

Gradients follow tensor parallelism's rule (``models/tp.py``): the
router, read by each rank for its own rows (``ep_a2a``) or for its own
experts' weights (``ep_psum``), passes ``f``, as do the inputs each rank
reads in part; shared experts run as a tensor-parallel MLP on the whole
block.  Both refuse a mesh whose ``model`` axis does not split the
experts, as the reference's ``shard_map`` does (``_ep_param_specs``): the
rules shard their F there, which ``dense``, ``gmm`` and ``decode`` run.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe.compute import add_shared, expert_ffn
from repro_torch.models.moe.dispatch import _gather_combine, _scatter, \
    _slot_positions
from repro_torch.models.moe.router import capacity, route
from repro_torch.models.tp import TP
from repro_torch.sharding import comm


def _local_experts(params: Dict, cfg: ModelConfig, model_size: int) -> int:
    e = cfg.num_experts
    if e % model_size:
        raise ValueError(
            f"expert parallelism over model={model_size}: {e} experts do "
            "not split (the reference's shard_map refuses it too); the "
            "rules shard each expert's F there instead, which dense / gmm "
            "/ decode run (ROADMAP A14)")
    if params["w1"].shape[0] != e // model_size:
        raise ValueError(
            f"expert parallelism over model={model_size}: {e} experts, "
            f"the rank holds {params['w1'].shape[0]} (want the rank's "
            "slice, sharding.local_params)")
    return e // model_size


def _router_f(params: Dict, mesh) -> Dict:
    """``params`` with the router through ``f``: each rank reads it for
    its own part, so its gradient sums over ``model``."""
    return {**params, "router": TP(mesh).f(params["router"])}


def moe_ep_a2a_local(params, cfg: ModelConfig, x_local, top_k: int, *,
                     mesh, model_axis: str, model_size: int,
                     use_kernel: bool = False, a2a_chunks: int = 1):
    """The rank's own rows x_local [T_loc, D] (its block of the data
    block's, ``moe_ep_a2a``); expert params sliced [E_loc, ...] -> (the
    routed output on those rows, the rank's aux).  No shared experts."""
    e = cfg.num_experts
    e_loc = _local_experts(params, cfg, model_size)
    t_loc, d = x_local.shape
    cap = capacity(t_loc, top_k, e, cfg.moe_capacity_factor)

    weights, idx, aux = route(_router_f(params, mesh), cfg, x_local, top_k)
    pos, keep = _slot_positions(idx, e, cap)
    buf = _scatter(x_local, idx, pos, keep, e, cap)               # [E,C,D]
    buf = buf.reshape(model_size, e_loc, cap, d)

    def run_chunk(b):
        # b [ms, E_loc, C', D] -> recv indexed by source shard on axis 0
        c = b.shape[2]
        recv = comm.all_to_all(b, mesh, model_axis)
        xe = recv.transpose(0, 1).reshape(e_loc, model_size * c, d)
        ye = expert_ffn(params["w1"], params["w2"], xe, use_kernel)
        ye = ye.reshape(e_loc, model_size, c, d).transpose(0, 1)
        return comm.all_to_all(ye, mesh, model_axis)

    if a2a_chunks > 1 and cap % a2a_chunks == 0:
        # split the capacity dim (the reference's overlap lever; here the
        # chunks run one after the other)
        back = torch.cat([run_chunk(b) for b in
                          buf.chunk(a2a_chunks, dim=2)], dim=2)
    else:
        back = run_chunk(buf)

    ye_local = back.reshape(e, cap, d)
    y = _gather_combine(ye_local, weights, idx, pos, keep,
                        cap).to(x_local.dtype)
    return y, aux


def moe_ep_psum_local(params, cfg: ModelConfig, x_rep, top_k: int, *,
                      mesh, model_axis: str, model_size: int,
                      use_kernel: bool = False):
    """``x_rep`` [T, D] the same on every rank of the model axis; expert
    params sliced [E_loc, ...].  Local contributions + psum (Megatron's
    *g*: the output is read whole on every rank); the shared experts
    added on the whole block."""
    e_loc = _local_experts(params, cfg, model_size)
    midx = mesh.axis_index(model_axis)
    t, d = x_rep.shape
    tp = TP(mesh)

    weights, idx, aux = route(params, cfg, x_rep, top_k)
    lo = midx * e_loc
    local = (idx >= lo) & (idx < lo + e_loc)                      # [T, k]
    idx_loc = torch.where(local, idx - lo, e_loc)                 # -> trash
    w_loc = torch.where(local, tp.f(weights), 0.0)

    # worst case: all T*k slots land on one local expert -> cap = T*k is
    # always safe; keep it tighter with the same global-capacity heuristic
    cap = capacity(t, top_k, e_loc, cfg.moe_capacity_factor)
    pos, keep = _slot_positions(idx_loc, e_loc + 1, cap)
    keep = keep & local
    xe = _scatter(tp.f(x_rep), idx_loc, pos, keep, e_loc + 1, cap)[:e_loc]
    ye = expert_ffn(params["w1"], params["w2"], xe, use_kernel)
    ye_pad = torch.cat([ye, ye.new_zeros((1, cap, d))], dim=0)
    y = _gather_combine(ye_pad, w_loc, idx_loc, pos, keep, cap)
    y = tp.g(y).to(x_rep.dtype)
    return add_shared(params, cfg, x_rep, y, mesh), aux


def moe_ep_a2a(params: Dict, cfg: ModelConfig, x2d, top_k: int, *, mesh,
               use_kernel: bool = False, a2a_chunks: int = 1):
    """``moe_ep_a2a_local`` over a bound (..., model) mesh: x2d [T, D] is
    the rank's data block of the tokens (T splits over ``model``); each
    rank routes its ``T / model`` rows (module doc)."""
    m = mesh.shape["model"]
    _local_experts(params, cfg, m)
    if x2d.shape[0] % m:
        raise ValueError(f"ep_a2a over model={m}: {x2d.shape[0]} tokens do "
                         "not split (models.moe.mesh_impl runs ep_psum for "
                         "them)")
    x_loc = comm.split_to_model(x2d, mesh, 0)
    y, aux = moe_ep_a2a_local(params, cfg, x_loc, top_k, mesh=mesh,
                              model_axis="model", model_size=m,
                              use_kernel=use_kernel, a2a_chunks=a2a_chunks)
    y = comm.gather_from_model(y, mesh, 0)
    aux = comm.reduce_from_model(aux, mesh) / m
    return add_shared(params, cfg, x2d, y, mesh), aux


def moe_ep_psum(params: Dict, cfg: ModelConfig, x2d, top_k: int, *, mesh,
                use_kernel: bool = False):
    """``moe_ep_psum_local`` over a bound (..., model) mesh: x2d is the
    rank's data block of the tokens, replicated over ``model``."""
    return moe_ep_psum_local(params, cfg, x2d, top_k, mesh=mesh,
                             model_axis="model",
                             model_size=mesh.shape["model"],
                             use_kernel=use_kernel)
