"""Tensor parallelism over the ``model`` axis of a bound mesh: Megatron's
layout on the rank's blocks of the rules' specs (``sharding/rules.py``,
``local_params``), as GSPMD partitions the reference's program.

A leaf splits over ``model`` where the rules say so (its dim divides the
axis), so at ``model`` = 1 every split leaf is whole and every collective
below still runs, as a copy.  Where a rule degrades a leaf to
replication, the layer runs it whole with no collective.

* Column-parallel (``wq``, ``wk``, ``wv``, ``wq_b``, ``wkv_b``, MLP and
  shared-expert ``w1``, ``lm_head``): the input passes ``f``
  (``comm.copy_to_model``) and each rank computes its block of the
  output features.
* Row-parallel (``wo``, ``w2``, shared ``w2``, mamba ``w_out``): each rank
  multiplies its block of the input features by its rows, then ``g``
  (``comm.reduce_from_model``) sums the partial outputs.
* The embedding is vocab-parallel: a rank looks up only the tokens of its
  rows ``[r V/m, (r+1) V/m)`` (zeros elsewhere), then ``g``.
* The head's logits are gathered whole where a sampler reads a row
  (``logits``); the loss keeps them vocab-parallel (``xent``: sums of
  [B, S] over ``model``, as GSPMD partitions the reference's loss).

The gradient rule is Megatron's (``sharding/comm.py``): a tensor the same
on every rank of ``model`` carries the whole gradient on every rank, so
replicated leaves end the backward with equal, whole gradients, and every
replicated tensor (a norm's scale, a replicated projection's output) that
each rank then reads only in part passes ``f`` first.

FSDP (``ModelOpts.fsdp_params``): a leaf stored as its block over the
data axes is all-gathered over them where a layer uses it
(``gather_fsdp``; the backward is a reduce-scatter, so its gradient comes
out summed over the data axes, already the rank's block).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.sharding import comm


class TP:
    """The rank's place on ``model``: ``m`` ranks, this one ``r``; off (one
    rank, no collective) without a mesh.  ``TP(None, m=, r=)`` is rank r's
    arithmetic on an unbound axis of m ranks (its blocks and heads; no
    collective runs)."""

    __slots__ = ("mesh", "m", "r", "on")

    def __init__(self, mesh, *, m: Optional[int] = None, r: int = 0):
        self.mesh = mesh
        if mesh is not None:
            m, r = mesh.shape["model"], mesh.axis_index("model")
        self.on = m is not None
        self.m, self.r = (m, r) if self.on else (1, 0)

    def splits(self, n: int) -> bool:
        """A dim of ``n`` splits over ``model`` (the rules' divisibility)."""
        return self.on and n % self.m == 0

    def block(self, n: int) -> Tuple[int, int]:
        """(start, size) of the rank's block of a split dim of ``n``."""
        size = n // self.m
        return self.r * size, size

    def f(self, x):
        return comm.copy_to_model(x, self.mesh) if self.on else x

    def g(self, x):
        return comm.reduce_from_model(x, self.mesh) if self.on else x

    def gather(self, x, dim: int = -1):
        """The blocks along ``dim`` of a tensor each rank then reads only in
        part (a reduce-scatter backward)."""
        return comm.all_gather(x, self.mesh, "model", dim=dim % x.dim())

    def gather_whole(self, x, dim: int = -1):
        """The blocks along ``dim`` of a tensor every rank reads whole (the
        backward keeps the rank's block)."""
        return comm.gather_from_model(x, self.mesh, dim % x.dim())


def heads_of(tp: TP, n_heads: int, width: int) -> Tuple[int, int]:
    """[lo, hi): the heads of width ``width`` that overlap the rank's block
    of the row-parallel input features (all heads when they do not
    split)."""
    feat = n_heads * width
    if not tp.splits(feat):
        return 0, n_heads
    start, size = tp.block(feat)
    return start // width, -(-(start + size) // width)


def heads(tp: TP, y, n_heads: int, width: int, lo: int, hi: int, *,
          partial: bool = True):
    """Heads [lo, hi) ``[..., hi - lo, width]`` of ``y [..., features]``,
    the rank's block of ``n_heads * width`` features where they split
    (the block itself when it holds just those heads, else gathered),
    else whole.  ``partial``: the heads feed a part that this rank alone
    computes (a row-parallel block), so a whole ``y`` passes ``f`` and a
    gathered one keeps a reduce-scatter backward; else every rank reads
    the heads whole."""
    lead = y.shape[:-1]
    feat = n_heads * width
    if tp.splits(feat):
        start, size = tp.block(feat)
        if start == lo * width and size == (hi - lo) * width:
            return y.reshape(*lead, hi - lo, width)
        y = tp.gather(y) if partial else tp.gather_whole(y)
    elif partial and tp.on:
        y = tp.f(y)
    return y.reshape(*lead, n_heads, width)[..., lo:hi, :]


def rows_of(tp: TP, y_heads, n_heads: int, width: int, lo: int):
    """The rank's block of the row-parallel input features from heads
    [lo, ..) flattened: ``y_heads [..., n, width]`` -> ``[..., F / m]``."""
    flat = y_heads.reshape(*y_heads.shape[:-2], -1)
    start, size = tp.block(n_heads * width)
    return flat[..., start - lo * width:start - lo * width + size]


def project(tp: TP, x, x_f, w, n_out: int):
    """``x @ w`` for a column-parallel ``w`` of ``n_out`` output features:
    ``x_f`` (``x`` after ``f``) where ``w`` is the rank's block, else
    ``x``."""
    return (x_f if tp.splits(n_out) else x) @ w


def mlp_tp(params, x, mesh, d_ff: int):
    """The SwiGLU MLP (``models/mlp.py``) on the rank's F block when
    ``d_ff`` (the whole F) splits over ``model``: w1 column-parallel (its
    fused gate / up block), w2 row-parallel."""
    from repro_torch.models.mlp import mlp
    tp = TP(mesh)
    if not tp.splits(d_ff):
        return mlp(params, x)
    return tp.g(mlp(params, tp.f(x)))


def embed(tp: TP, table, tokens, vocab: int):
    """The embedding rows of ``tokens``: vocab-parallel when ``vocab``
    splits (each rank looks up the tokens of its rows, zeros elsewhere,
    then ``g``)."""
    if not tp.splits(vocab):
        return table[tokens.long()]
    start, size = tp.block(vocab)
    t = tokens.long() - start
    mine = (t >= 0) & (t < size)
    x = table[torch.where(mine, t, 0)]
    return tp.g(torch.where(mine[..., None], x, torch.zeros_like(x)))


def logits(tp: TP, x, head, vocab: int):
    """``(x @ head).float()`` whole on every rank: column-parallel over the
    vocab when it splits, the ranks' blocks all-gathered (the sampler
    reads a row whole)."""
    if not tp.splits(vocab):
        return (x @ head).float()
    return tp.gather_whole((tp.f(x) @ head).float(), dim=-1)


def xent(tp: TP, x, head, vocab: int, targets, mask):
    """The masked mean cross-entropy of ``logits(tp, x, head, vocab)``
    [B, S, V] against ``targets`` [B, S] (``mask`` [B, S] f32), the same
    on every rank of ``model``.  Where the vocab splits it stays
    vocab-parallel, as GSPMD partitions the reference's ``softmax_xent``:
    each rank holds its block of the logits [B, S, V / m], and the whole
    vocabulary's log-sum-exp and gold logit meet in sums of [B, S] over
    ``model`` -- the blocks' max (no gradient), then ``g`` of the exps and
    of the gold logit that the rank holding the target contributes (zero
    elsewhere).  At one rank exp(0) = 1 and log(1) = 0, so the loss and
    its gradient are the whole-vocab computation's bits."""
    if not tp.splits(vocab):
        lg = (x @ head).float()
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, targets.long()[..., None])[..., 0]
    else:
        block = (tp.f(x) @ head).float()                    # [B, S, V/m]
        start, size = tp.block(vocab)
        lse = torch.logsumexp(block, dim=-1)
        top = comm.pmax(lse, tp.mesh, "model")
        logz = top + torch.log(tp.g(torch.exp(lse - top)))
        t = targets.long() - start
        mine = (t >= 0) & (t < size)
        gold = torch.gather(block, -1,
                            torch.where(mine, t, 0)[..., None])[..., 0]
        gold = tp.g(torch.where(mine, gold, torch.zeros_like(gold)))
    nll = (logz - gold) * mask
    return nll.sum() / mask.sum().clamp(min=1.0)


def gather_fsdp(tree, layout, mesh, opts) -> Optional[dict]:
    """``tree`` with each leaf stored as its block over the data axes
    (``layout``: the matching ``Sharding`` subtree of
    ``rules.fsdp_layout``) all-gathered over them; ``tree`` itself unless
    ``opts.fsdp_params`` under a mesh."""
    if mesh is None or not opts.fsdp_params or tree is None:
        return tree
    from repro_torch.tree import map_tree

    def one(x, s):
        if not isinstance(x, torch.Tensor):
            return x
        return s.gather(x, axes_of=lambda axes: "model" not in axes)
    return map_tree(one, tree, layout)
