"""Divisibility-aware sharding rules: param paths -> specs (the port's
counterpart of ``repro.sharding.rules``).

The rules encode the reference's production layout:

  * vocab dims shard over ``model`` (vocab is padded to stay divisible);
  * attention/MLP projections shard their flattened feature dim over
    ``model`` (Megatron column/row parallel);
  * MoE expert weights shard the **expert** dim over ``model`` (EP) when
    divisible, else fall back to feature sharding (TP);
  * batch-like leading dims (batches, KV caches) shard over the data axes
    when divisible, else replicate;
  * every rule checks divisibility against the mesh's axis size and
    degrades to replication rather than produce an invalid spec.

Optimizer moments additionally shard a spare dim over the data axes
(ZeRO-1).

A spec is a plain tuple with one entry per dim: ``None``, an axis name,
or a tuple of axis names (``is_spec``).  The port keeps one param dict
per layer (``layers/<i>/...``) where the reference stacks each run of
identical layers under a leading layer dim; the same regexes match the
``/``-joined paths, and ``param_specs`` applies them to the stacked
shape, so a port leaf's spec is the reference's without that leading
entry.

What runs: ``local_specs`` is ``param_specs`` (with ``fsdp=`` from
``ModelOpts.fsdp_params``), and ``local_params`` cuts every leaf by it:
a rank holds its tensor-parallel, expert, and FSDP blocks of the params
(``opt_state_specs``' ZeRO-1 blocks of the moments, ``training/step.py``)
and the models run Megatron tensor parallelism on them
(``models/tp.py``).  A fused gate / up leaf (``w1`` ``[.., 2F]``) splits
in pairs: the rank's block is its slice of the gate columns then the same
slice of the up columns (``Sharding(fused=)``), so that SwiGLU runs on
the rank's ``F / model``.  Where the experts do not split over
``model``, ``_moe_w`` shards their F (w1's fused columns in pairs, w2's
rows) where the reference's rule shards the last dim of each.
"""

from __future__ import annotations

import math
import re
from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import flatten_with_paths, map_tree, unflatten

Spec = Tuple[Any, ...]


def is_spec(x) -> bool:
    """A spec leaf: a plain tuple (not a NamedTuple container)."""
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def _axis(mesh, name: str) -> int:
    return mesh.shape.get(name, 1)


def _div(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a != "model")


def data_axes_size(mesh) -> int:
    s = 1
    for a in data_axes(mesh):
        s *= _axis(mesh, a)
    return s


def _data_entry(mesh):
    daxes = data_axes(mesh)
    return daxes if len(daxes) > 1 else daxes[0]


# --------------------------------------------------------------------------- #
# Parameter rules
# --------------------------------------------------------------------------- #

# (path regex, base rank, trailing spec function); the function takes
# (trailing_shape, model_size) and returns the entries of those dims


def _col(shape, m):       # [in, out] -> shard out over model
    return (None, "model" if _div(shape[1], m) else None)


def _row(shape, m):       # [in, out] -> shard in over model
    return ("model" if _div(shape[0], m) else None, None)


def _embed(shape, m):     # [V, D]
    return ("model" if _div(shape[0], m) else None, None)


def _moe_w1(shape, m):    # [E, D, 2F] -> EP over experts, else F (pairs)
    if _div(shape[0], m):
        return ("model", None, None)
    if _div(shape[2] // 2, m):
        return (None, None, "model")
    return (None, None, None)


def _moe_w2(shape, m):    # [E, F, D] -> EP over experts, else F
    if _div(shape[0], m):
        return ("model", None, None)
    if _div(shape[1], m):
        return (None, "model", None)
    return (None, None, None)


def _repl(shape, m):
    return tuple(None for _ in shape)


_RULES = (
    (re.compile(r"\bembed$"), 2, _embed),
    (re.compile(r"\blm_head$"), 2, _col),
    (re.compile(r"\bprefix_proj$"), 2, _repl),
    # MoE (must precede generic w1/w2)
    (re.compile(r"moe.*\brouter$"), 2, _repl),
    (re.compile(r"moe.*\bw1$"), 3, _moe_w1),
    (re.compile(r"moe.*\bw2$"), 3, _moe_w2),
    (re.compile(r"shared.*\bw1$"), 2, _col),
    (re.compile(r"shared.*\bw2$"), 2, _row),
    # attention
    (re.compile(r"\bwq$|\bwk$|\bwv$|\bwq_b$|\bwkv_b$"), 2, _col),
    (re.compile(r"\bwo$"), 2, _row),
    (re.compile(r"\bwq_a$|\bwkv_a$"), 2, _repl),   # small latent projections
    # MLP
    (re.compile(r"\bw1$"), 2, _col),
    (re.compile(r"\bw2$"), 2, _row),
    # mamba
    (re.compile(r"\bw_in$"), 2, _repl),            # mixed-channel output
    (re.compile(r"\bw_out$"), 2, _row),
    (re.compile(r"\bconv_w$|\bconv_b$"), None, _repl),
    (re.compile(r"\bA_log$|\bdt_bias$|\bnorm_scale$"), None, _repl),
    (re.compile(r"\bD$"), None, _repl),
    # norms / everything else
    (re.compile(r"."), None, _repl),
)


def spec_for_param(path_str: str, shape: Tuple[int, ...], mesh) -> Spec:
    m = _axis(mesh, "model")
    repl = (None,) * len(shape)
    for rx, base_rank, fn in _RULES:
        if rx.search(path_str):
            if base_rank is None:
                return repl
            extra = len(shape) - base_rank
            if extra < 0:
                return repl
            return (None,) * extra + tuple(fn(shape[extra:], m))
    return repl


def _run_lengths(cfg: ModelConfig):
    """Layer index -> the length of its run of identical layers, the
    reference's stacked dim (none for a run of one).  A layer's top-k and
    serving split tag do not count: every LExI plan and the serving
    runner's per-layer split share the base config's one set of weights,
    so they share its specs."""
    from dataclasses import replace
    from repro_torch.models.blocks import group_pattern
    pattern = tuple(replace(s, moe_top_k=0, split_id=0)
                    for s in cfg.pattern())
    return {i: g.count for g in group_pattern(pattern)
            for i in range(g.start, g.start + g.count)}


def param_specs(params_tree, cfg: ModelConfig, mesh, fsdp: bool = False,
                fsdp_min_size: int = 1 << 20):
    """A spec tree mirroring a param tree (``models.abstract_params`` for
    a full-size config costs no memory).

    ``fsdp=True`` additionally shards a spare dim of every large parameter
    over the data axes (fully-sharded weights).  The rules see a layer
    leaf as the reference stores it, stacked with the other layers of its
    run (``[count, ...]``; the FSDP size bound and the choice of dim read
    that shape), and the stacked entry is dropped."""
    runs = _run_lengths(cfg) if not cfg.is_encoder_decoder else {}

    def leaf_spec(path, leaf):
        shape = tuple(leaf.shape)
        parts = path.split("/", 2)
        count = runs.get(int(parts[1]), 1) if parts[0] == "layers" else 1
        if count > 1:
            shape = (count,) + shape
        spec = spec_for_param(path, shape, mesh)
        if fsdp and math.prod(shape) >= fsdp_min_size:
            spec = _zero1(spec, shape, mesh)
        return spec[1:] if count > 1 else spec

    return unflatten(params_tree, [leaf_spec(p, x) for p, x in
                                   flatten_with_paths(params_tree)])


def param_shardings(params_tree, cfg: ModelConfig, mesh, **kw):
    return named(mesh, param_specs(params_tree, cfg, mesh, **kw))


# --------------------------------------------------------------------------- #
# Optimizer state: ZeRO-1 over the data axes
# --------------------------------------------------------------------------- #


def _zero1(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """Additionally shard the largest free dim over the data axes."""
    daxes = data_axes(mesh)
    dsize = data_axes_size(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if dsize == 1:
        return tuple(entries)
    # already data-sharded (e.g. FSDP param specs fed to opt_state_specs)
    used = {a for e in entries if e is not None
            for a in (e if isinstance(e, tuple) else (e,))}
    if used & set(daxes):
        return tuple(entries)
    best, best_dim = -1, -1
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and _div(dim, dsize) and dim > best_dim:
            best, best_dim = i, dim
    if best >= 0:
        entries[best] = _data_entry(mesh)
    return tuple(entries)


def opt_state_specs(opt_state_abstract, params_specs, mesh):
    """Specs for ``AdamWState(step, mu, nu)``: moments ZeRO-1 sharded."""
    from repro_torch.optim.adamw import AdamWState

    def moments(tree):
        return map_tree(lambda spec, leaf: _zero1(spec, tuple(leaf.shape),
                                                  mesh),
                        params_specs, tree, is_leaf=is_spec)

    return AdamWState(step=(), mu=moments(opt_state_abstract.mu),
                      nu=moments(opt_state_abstract.nu))


# --------------------------------------------------------------------------- #
# Batch / cache rules
# --------------------------------------------------------------------------- #


def batch_spec(shape: Tuple[int, ...], mesh) -> Spec:
    """Shard dim0 (batch) over the data axes when divisible."""
    if shape and _div(shape[0], data_axes_size(mesh)):
        return (_data_entry(mesh),) + (None,) * (len(shape) - 1)
    return (None,) * len(shape)


def tokens_spec(shape: Tuple[int, ...], mesh) -> Spec:
    return batch_spec(shape, mesh)


def batch_specs(batch_tree, mesh):
    return map_tree(lambda x: batch_spec(tuple(x.shape), mesh), batch_tree)


# cache leaf base ranks (the port has no stacked layer dim)
_CACHE_RANKS = (
    (re.compile(r"(^|/)(k|v|xk|xv)$"), 4),        # [B, S, Hkv, hd]
    (re.compile(r"(^|/)(pos|xpos)$"), 2),         # [B, S]
    (re.compile(r"(^|/)(ckv|krope)$"), 3),        # [B, S, r]
    (re.compile(r"(^|/)conv$"), 3),               # [B, W-1, Cc]
    (re.compile(r"(^|/)state$"), 4),              # [B, H, P, N]
)

# paged-pool leaves: dim0 is the shared page pool, not a batch dim -- never
# data-sharded (every data shard reads every page through its block
# table); kv heads still shard over `model`.  Block tables are replicated.
_PAGED_RANKS = (
    (re.compile(r"(^|/)(kp|vp)$"), 4),            # [N, P, Hkv, hd]
    (re.compile(r"(^|/)posp$"), 2),               # [N, P]
    (re.compile(r"(^|/)(ckvp|kropep)$"), 3),      # [N, P, r]
)


def cache_specs(cache_tree, cfg: ModelConfig, mesh, seq_shard: bool = False):
    """KV/SSM cache sharding: batch over data; heads over model.

    ``seq_shard=True`` shards the GQA cache *sequence* dim over ``model``
    instead (context-parallel decode; pairs with
    ``ModelOpts.decode_kv_seq_shard``)."""
    del cfg
    m = _axis(mesh, "model")
    dsize = data_axes_size(mesh)
    dentry = _data_entry(mesh)

    def leaf_spec(ps, leaf):
        shape = tuple(leaf.shape)
        paged = next((r for rx, r in _PAGED_RANKS if rx.search(ps)), None)
        if paged is not None:
            entries = [None] * len(shape)
            extra = len(shape) - paged
            if extra >= 0 and re.search(r"(^|/)(kp|vp)$", ps) \
                    and _div(shape[extra + 2], m):
                entries[extra + 2] = "model"       # kv heads
            return tuple(entries)
        base = next((r for rx, r in _CACHE_RANKS if rx.search(ps)), None)
        if base is None or len(shape) < base:
            return (None,) * len(shape)
        extra = len(shape) - base
        entries = [None] * len(shape)
        if _div(shape[extra], dsize):
            entries[extra] = dentry                # batch dim
        gqa = re.search(r"(^|/)(k|v)$", ps)
        if seq_shard and (gqa or re.search(r"(^|/)pos$", ps)) \
                and base in (4, 2) and _div(shape[extra + 1], m):
            entries[extra + 1] = "model"           # sequence dim (ctx parallel)
        elif re.search(r"(^|/)(k|v|xk|xv)$", ps) and _div(shape[extra + 2], m):
            entries[extra + 2] = "model"           # kv heads
        if ps.endswith("state") and _div(shape[extra + 1], m):
            entries[extra + 1] = "model"           # mamba heads
        return tuple(entries)

    return unflatten(cache_tree, [leaf_spec(p, x) for p, x in
                                  flatten_with_paths(cache_tree)])


# --------------------------------------------------------------------------- #
# Shardings: a spec on a mesh, and the rank's block of a tensor
# --------------------------------------------------------------------------- #


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class Sharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart).
    ``local`` cuts this rank's block of a whole tensor; ``gather``
    (collective: every rank of the mesh calls it) rebuilds the whole
    tensor from the ranks' blocks.

    ``fused``: a dim laid out as two halves (a fused gate / up ``w1``),
    which splits in pairs: the rank's block is its block of each half,
    concatenated."""

    def __init__(self, mesh, spec: Spec, fused: Optional[int] = None):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.fused = fused

    def __repr__(self) -> str:
        tail = "" if self.fused is None else f", fused={self.fused}"
        return f"Sharding({self.spec}{tail})"

    def _dims(self, ndim: int, axes_of=None):
        entries = list(self.spec) + [None] * (ndim - len(self.spec))
        out = [(d, _entry_axes(e)) for d, e in enumerate(entries) if e]
        if axes_of is not None:
            out = [(d, a) for d, a in out if axes_of(a)]
        return out

    def _halves(self, d: int, ndim: int) -> int:
        return 2 if self.fused is not None and d == self.fused % ndim else 1

    def local(self, t: torch.Tensor) -> torch.Tensor:
        for d, axes in self._dims(t.dim()):
            n, h = self.mesh.axis_size(axes), self._halves(d, t.dim())
            if t.shape[d] % (n * h):
                raise ValueError(f"dim {d} of {tuple(t.shape)} does not "
                                 f"split over {axes} ({n} ranks"
                                 f"{', in pairs' if h > 1 else ''})")
            size = t.shape[d] // (n * h)
            i = self.mesh.axis_index(axes)
            parts = [half.narrow(d, i * size, size)
                     for half in t.chunk(h, dim=d)]
            t = parts[0] if h == 1 else torch.cat(parts, dim=d)
        return t

    def gather(self, t: torch.Tensor, axes_of=None) -> torch.Tensor:
        """The whole tensor (collective; differentiable, a reduce-scatter
        backward); ``axes_of(axes) -> bool`` keeps the dims to gather."""
        from repro_torch.sharding.comm import all_gather
        for d, axes in self._dims(t.dim(), axes_of):
            halves = t.chunk(self._halves(d, t.dim()), dim=d)
            parts = [all_gather(x, self.mesh, axes, dim=d) for x in halves]
            t = parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)
        return t

    @property
    def sharded(self) -> bool:
        return any(e is not None for e in self.spec)


def named(mesh, spec_tree):
    return map_tree(lambda s: Sharding(mesh, s), spec_tree, is_leaf=is_spec)


# --------------------------------------------------------------------------- #
# What the port runs
# --------------------------------------------------------------------------- #

_FUSED = re.compile(r"\bw1$")


def _fused_dim(path: str) -> Optional[int]:
    """The fused gate / up dim of a ``w1`` leaf (its last), else None."""
    return -1 if _FUSED.search(path) else None


def local_specs(params_tree, cfg: ModelConfig, mesh, fsdp: bool = False,
                fsdp_min_size: int = 1 << 20):
    """The specs the port runs: ``param_specs(..., fsdp=fsdp,
    fsdp_min_size=...)`` as they are, except that a fused ``w1`` whose F
    does not split over ``model`` (its 2F does) stays whole over
    ``model``."""
    m = _axis(mesh, "model")
    specs = flatten_with_paths(param_specs(params_tree, cfg, mesh, fsdp=fsdp,
                                           fsdp_min_size=fsdp_min_size),
                               is_leaf=is_spec)
    shapes = dict(flatten_with_paths(params_tree))

    def keep(path, spec):
        if _fused_dim(path) is None or not spec or spec[-1] != "model":
            return spec
        if _div(shapes[path].shape[-1] // 2, m):
            return spec
        return spec[:-1] + (None,)

    return unflatten(params_tree, [keep(p, s) for p, s in specs])


def shardings_for(tree, spec_tree, mesh):
    """``named`` with each fused ``w1`` leaf's pairs marked (``Sharding(
    fused=)``); ``tree`` names the leaves (any tree of the params' paths:
    the params, their moments or grads)."""
    paths = [p for p, _ in flatten_with_paths(tree)]
    specs = [s for _, s in flatten_with_paths(spec_tree, is_leaf=is_spec)]
    return unflatten(tree, [Sharding(mesh, s, _fused_dim(p))
                            for p, s in zip(paths, specs)])


def local_shardings(params_tree, cfg: ModelConfig, mesh, fsdp: bool = False,
                    fsdp_min_size: int = 1 << 20):
    """``local_specs`` on ``mesh`` as ``Sharding`` leaves."""
    return shardings_for(params_tree, local_specs(
        params_tree, cfg, mesh, fsdp, fsdp_min_size), mesh)


def local_params(params, cfg: ModelConfig, mesh, fsdp: bool = False,
                 fsdp_min_size: int = 1 << 20):
    """The rank's block of a whole (converted) param tree under
    ``local_specs``: each sharded leaf's block is a copy (``local_tree``),
    each whole leaf is shared with ``params``."""
    return local_tree(params, local_shardings(params, cfg, mesh, fsdp,
                                              fsdp_min_size))


def fsdp_layout(cfg: ModelConfig, mesh, fsdp_min_size: int = 1 << 20):
    """The ``Sharding`` tree of ``local_specs(fsdp=True)`` for ``cfg``'s
    params, from ``models.abstract_params`` (memoized on the mesh, per
    config, whatever its plan or serving split): what a model gathers over
    the data axes where a layer uses a weight (``models/tp.py``)."""
    from dataclasses import replace
    key = (replace(cfg, block_pattern=tuple(
        replace(s, moe_top_k=0, split_id=0) for s in cfg.pattern()),
        lexi_plan=None), fsdp_min_size)
    if key not in mesh.layouts:
        from repro_torch.models import abstract_params
        mesh.layouts[key] = local_shardings(abstract_params(cfg), cfg, mesh,
                                            True, fsdp_min_size)
    return mesh.layouts[key]


def local_cache_specs(cache_tree, cfg: ModelConfig, mesh,
                      seq_shard: bool = False):
    """The cache specs the port runs: ``cache_specs`` -- the batch dim
    over the data axes, the kv heads (GQA ``k`` / ``v``, paged ``kp`` /
    ``vp``) and the mamba ``state`` heads over ``model`` where they split,
    and under ``seq_shard`` the GQA sequence dim over ``model`` in place
    of the heads (context-parallel decode) -- but for an MLA model's
    ``pos`` under ``seq_shard``, which stays whole: the MLA layer attends
    its whole latent cache on every rank, where GSPMD gathers the
    sequence-sharded ``pos`` for the reference (no collective here)."""
    specs = cache_specs(cache_tree, cfg, mesh, seq_shard)
    if not (seq_shard and cfg.attention == "mla"):
        return specs
    return unflatten(cache_tree, [
        tuple(None if e == "model" else e for e in s)
        if re.search(r"(^|/)pos$", p) else s
        for p, s in flatten_with_paths(specs, is_leaf=is_spec)])


def local_tree(tree, shardings):
    """The rank's block of every leaf of a whole tree: a block smaller
    than its leaf is copied (so the whole tensor can be freed), every
    other leaf is returned as it is."""
    def one(x, s):
        if isinstance(x, torch.Tensor) and s.sharded:
            block = s.local(x)
            return block.clone() if block.shape != x.shape else x
        return x
    return map_tree(one, tree, shardings)


def gather_tree(tree, shardings):
    """The whole tree from the ranks' blocks (collective)."""
    return map_tree(lambda x, s: s.gather(x) if isinstance(x, torch.Tensor)
                    and s.sharded else x, tree, shardings)
