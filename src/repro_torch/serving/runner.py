"""Model runner: the weights plus a table of step specializations.

The port of ``repro.serving.runner``.  The runner owns the parameters and
every step the engine takes, in a specialization table keyed as the
reference's jit table, element for element:

* ``(head, "decode", B, use_kernel, kernel_blocks, moe_decode,
  expert_dtype)`` -- one-token step over all B slots.  ``use_kernel``
  switches paged decode between the gather oracle and the block-table
  kernel; ``kernel_blocks`` is that kernel's walk bound (a power-of-two
  bucket from ``KVCache.live_blocks``); ``moe_decode`` routes the step's
  MoE through the fused routed-expert path.  On the contiguous layout
  ``use_kernel=False, kernel_blocks=None``.
* ``(head, "chunk", C, expert_dtype)`` -- the fixed-width ``[B, C]``
  chunked-prefill step every prompt and every resume after preemption
  runs through.

``head`` is a plan name, or ``("bucket", k_0, ..., k_{n-1})`` for a
mixed-plan step: ``k_l`` is the power-of-two roundup of the batch's
largest plan k at MoE layer l (``bucket_for``), and each row passes its
own plan's k as a ``k_budgets [B, n_moe]`` int32 input, whose surplus
routed slots ``route`` zero-weights.  Plan combinations that round to one
bucket share its steps.  ``expert_dtype`` keeps bf16 and quantized
engines apart.  ``compiled_specializations()`` lists the keys.

On the card each key's step is captured once as a CUDA graph, the
counterpart of a jitted step, and replayed after that.  A key's first call
runs the step eagerly on the capture stream (the warm-up: kernel builds,
per-stream buffers and cuBLAS's workspace happen outside the capture) and
then captures it into the memory pool every graph of the runner shares;
its static inputs (``tokens`` and ``pos``; ``tokens``, ``positions`` and
``last_index``; ``k_budgets`` for a bucket) take each later call's values
through pinned staging, and the returned logits are the graph's static
output, valid until the key's next call.  The KV caches and the block
table are written and read in place at the addresses the graph captured:
a call whose caches or table moved raises.  ``graphs=False`` runs the same
steps eagerly on the card, the oracle the graphs are held to, as
``use_kernel=False`` is for the kernels; nothing falls back to it.  On the
CPU every step runs eagerly and the keys are recorded all the same.

Whole-prompt prefill (``whole_prefill``, the contiguous layout) runs
eagerly and records no key: the port prefills each prompt at its own
length, so a graph per length would buy nothing, and the reference's
padded ``[1, L]`` graph attends its pads under ``use_flash`` (ROADMAP.md
C, second caveat).

A mamba layer's cache is its conv and SSM state rows (``models/ssm.py``),
written in place like the KV caches, so a decode graph of a mamba stack
replays on them; the step also advances the state rows of idle slots
(their token 0 at position -1: a mamba block has no mask), which the
engine zeroes when it admits a request to the slot.

Options fixed when the engine is built live in ``opts``, so every step
and every CUDA graph of a runner carries them.  ``router_lookahead`` is
one: an engine's graphs are all captured with it on or all with it off,
and no key carries it, as in the reference's jit table.

Every serving config is a per-layer split of the pattern
(``split_pattern``), as in the reference, and all plans share one set of
weights.

``mesh=`` (a bound mesh, as the reference's runner takes one): the params
are the rank's blocks (``sharding.local_params``) and every step runs the
models' tensor and expert parallelism on them.  On the card a step on a
mesh is captured and replayed as off one, its NCCL collectives inside the
graph, as the reference jits its steps with a mesh and without one: the
key's eager first step creates each group's communicator, and a replay
notes the step's collectives again (``kernels/_graphs.py``).  Every rank
must step through the same keys in the same order (one SPMD program):
the runner keeps a checksum of the keys it has stepped through, and the
ranks compare it whenever a key is stepped through for the first time
(``sharding.comm.agree``), graphed or not; ranks out of step raise.
"""

from __future__ import annotations

import time
import zlib
from dataclasses import replace as dc_replace
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.models.opts import DEFAULT_OPTS, ModelOpts
from repro_torch.sharding import comm

BASE_PLAN = "base"


def split_pattern(cfg: ModelConfig) -> Tuple:
    """Per-layer split of ``cfg``'s resolved pattern (unique split_id each)."""
    return tuple(dc_replace(s, split_id=i)
                 for i, s in enumerate(cfg.pattern()))


def _split_cfg(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with its (plan-resolved) pattern pinned to per-layer groups."""
    return cfg.with_(block_pattern=split_pattern(cfg), lexi_plan=None)


def bucket_k(k: int, num_experts: int) -> int:
    """Power-of-two roundup of ``k``, clamped to the expert count."""
    b = 1
    while b < k:
        b *= 2
    return min(b, num_experts)


def _addresses(caches, block_tables) -> Tuple[int, ...]:
    """Where a step reads and writes in place: every cache tensor and the
    block table."""
    ptrs = [t.data_ptr() for layer in caches for t in layer.values()]
    ptrs.append(0 if block_tables is None else block_tables.data_ptr())
    return tuple(ptrs)


class _Step:
    """One key's captured step: static inputs on the card, the pinned
    staging the caller's values pass through, the graph, and the addresses
    of the buffers it works on in place."""

    def __init__(self, values: Mapping, device: torch.device):
        shapes = {n: np.shape(v) for n, v in values.items()}
        self.inputs = {n: torch.empty(sh, dtype=torch.int32, device=device)
                       for n, sh in shapes.items()}
        self.staging = {n: torch.empty(sh, dtype=torch.int32,
                                       pin_memory=True)
                        for n, sh in shapes.items()}
        self.copied = torch.cuda.Event()
        self.graph = None
        self.addresses: Tuple[int, ...] = ()

    def load(self, values: Mapping) -> None:
        """Copy the call's values into the static inputs, asynchronously;
        first wait until the last copy out of the staging has run."""
        self.copied.synchronize()
        for n, v in values.items():
            self.staging[n].copy_(torch.as_tensor(v))
            self.inputs[n].copy_(self.staging[n], non_blocking=True)
        self.copied.record()


class ModelRunner:
    def __init__(self, cfg: ModelConfig, params, *,
                 opts: ModelOpts = DEFAULT_OPTS,
                 graphs: Optional[bool] = None, mesh=None):
        if mesh is not None and not mesh.bound:
            raise ValueError(f"a runner serves on a bound mesh, not on "
                             f"{mesh!r} (a placed mesh only counts its "
                             "collectives)")
        self.mesh = mesh
        self.opts = opts
        self.base_cfg = cfg
        self.params = params
        self.device = params["embed"].device
        serve_cfg = _split_cfg(cfg)
        #: plan name -> split serving config; "base" is the config as given
        self.plans: Dict[str, ModelConfig] = {BASE_PLAN: serve_cfg}
        #: plan name -> per-MoE-layer top-k tuple (budget source for mixing)
        self.plan_ks: Dict[str, Tuple[int, ...]] = {
            BASE_PLAN: self._moe_ks(serve_cfg)}
        self._bucket_cfgs: Dict[Tuple[int, ...], ModelConfig] = {}
        #: the specialization table: key -> its captured step (None where
        #: the step runs eagerly)
        self._steps: Dict[Tuple, Optional[_Step]] = {}
        #: capture graphs on the card (False: the eager oracle), on a mesh
        #: or off one
        self.graphs = True if graphs is None else bool(graphs)
        #: checksum of the keys stepped through, in order (module doc)
        self._trail = 0
        self._graphed = self.graphs and self.device.type == "cuda"
        self._stream = self._pool = None
        if self._graphed:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        #: graphs captured, host seconds their first calls took (the eager
        #: warm-up step and the capture), replays
        self.stats: Dict[str, float] = {"graphs": 0, "capture_s": 0.0,
                                        "replays": 0}

    @staticmethod
    def _moe_ks(cfg: ModelConfig) -> Tuple[int, ...]:
        return tuple(s.moe_top_k for s in cfg.pattern()
                     if s.kind == "attn_moe")

    # ------------------------------------------------------------------ #
    # Plans
    # ------------------------------------------------------------------ #
    def add_plan(self, name: str, plan) -> ModelConfig:
        """Register a LExI plan under ``name``; returns its config."""
        if name == BASE_PLAN:
            raise ValueError(f"{BASE_PLAN!r} names the unplanned base "
                             "config; register plans under another name")
        ks = tuple(int(k) for k in getattr(plan, "plan", plan))
        plan_cfg = self.base_cfg.with_lexi_plan(ks)
        plan_cfg.pattern()                     # validate lengths / ranges
        self.plans[name] = _split_cfg(plan_cfg)
        self.plan_ks[name] = ks
        return plan_cfg

    def cfg_for(self, plan: str = BASE_PLAN) -> ModelConfig:
        return self.plans[plan]

    def bucket_for(self, ks: Tuple[int, ...]) -> Tuple[int, ...]:
        """Per-layer max-k vector -> its power-of-two bucket vector."""
        e = self.base_cfg.num_experts
        return tuple(bucket_k(int(k), e) for k in ks)

    def _cfg_for_bucket(self, bucket: Tuple[int, ...]) -> ModelConfig:
        if bucket not in self._bucket_cfgs:
            base = self.plans[BASE_PLAN]
            pat, mi = [], 0
            for s in base.pattern():
                if s.kind == "attn_moe":
                    pat.append(dc_replace(s, moe_top_k=int(bucket[mi])))
                    mi += 1
                else:
                    pat.append(s)
            if mi != len(bucket):
                raise ValueError(f"bucket length {len(bucket)} != "
                                 f"#MoE layers {mi}")
            self._bucket_cfgs[bucket] = base.with_(block_pattern=tuple(pat))
        return self._bucket_cfgs[bucket]

    def _resolve(self, plan: str, bucket):
        """-> (key head, serving cfg) for a homogeneous plan or a bucket."""
        if bucket is None:
            return plan, self.plans[plan]
        bucket = tuple(int(b) for b in bucket)
        return ("bucket", *bucket), self._cfg_for_bucket(bucket)

    def compiled_specializations(self) -> Tuple[Tuple, ...]:
        """Keys of every step specialization made so far (introspection /
        tests): the same on the CPU and on the card."""
        return tuple(sorted(self._steps, key=str))

    # ------------------------------------------------------------------ #
    # Steps
    # ------------------------------------------------------------------ #
    def _run(self, key: Tuple, fn: Callable, values: Dict, caches,
             block_tables):
        """One step of ``key``: ``fn(**inputs)`` -> logits, where the
        inputs are ``values`` on the device."""
        if self.mesh is not None:
            self._trail = zlib.crc32(repr(key).encode(), self._trail)
            if key not in self._steps:
                comm.agree(self._trail, self.mesh, f"new step {key}: the "
                           "checksum of the keys stepped through")
        if not self._graphed:
            self._steps.setdefault(key, None)
            return fn(**{n: torch.as_tensor(v).to(self.device)
                         for n, v in values.items()})
        from repro_torch.kernels import _graphs
        step = self._steps.get(key)
        if step is None:
            t0 = time.perf_counter()
            step = _Step(values, self.device)
            step.load(values)
            out = _graphs.on_stream(lambda: fn(**step.inputs), self._stream)
            step.graph = _graphs.capture(lambda: fn(**step.inputs),
                                         stream=self._stream, pool=self._pool)
            step.addresses = _addresses(caches, block_tables)
            self._steps[key] = step
            self.stats["graphs"] += 1
            self.stats["capture_s"] += time.perf_counter() - t0
            return out
        if _addresses(caches, block_tables) != step.addresses:
            raise RuntimeError(
                f"step {key}: a KV cache or the block table is not the "
                "tensor its CUDA graph was captured on; the graph writes and "
                "reads the captured addresses (update caches in place)")
        step.load(values)
        self.stats["replays"] += 1
        return step.graph.replay()

    def decode(self, tokens, pos, caches, block_tables=None, *,
               plan: str = BASE_PLAN, use_kernel: Optional[bool] = None,
               kernel_blocks: Optional[int] = None,
               moe_decode: Optional[bool] = None,
               bucket: Optional[Tuple[int, ...]] = None, k_budgets=None):
        """One decode step over all slots -> (logits [B,V], caches).

        ``tokens`` / ``pos`` [B] int32 host arrays (pos -1 = idle
        slot).  ``use_kernel`` (None -> ``opts.use_paged_kernel``)
        selects the block-table-native paged flash-decode;
        ``kernel_blocks`` is its walk bound.  ``moe_decode`` (None ->
        ``opts.use_moe_decode_kernel``) selects the fused routed-expert MoE
        path.  All three join the specialization key.

        ``bucket`` (per-MoE-layer k vector) + ``k_budgets`` ([B, n_moe]
        int32) select a mixed-plan bucket step instead of ``plan``'s;
        surplus routed slots are zero-weighted exactly."""
        head, cfg = self._resolve(plan, bucket)
        uk = (self.opts.use_paged_kernel if use_kernel is None
              else bool(use_kernel))
        md = (self.opts.use_moe_decode_kernel if moe_decode is None
              else bool(moe_decode))
        if block_tables is None:            # contiguous layout: gather-free
            uk, kernel_blocks = False, None
        key = (head, "decode", int(len(tokens)), uk, kernel_blocks, md,
               self.opts.expert_dtype)
        opts = dc_replace(self.opts, use_paged_kernel=uk,
                          use_moe_decode_kernel=md)
        kb = kernel_blocks

        def step(tokens, pos, k_budgets=None):
            return models.decode_fn(self.params, cfg, tokens, pos, caches,
                                    opts=opts, block_tables=block_tables,
                                    kernel_blocks=kb, k_budgets=k_budgets,
                                    mesh=self.mesh)[0]
        values = {"tokens": tokens, "pos": pos}
        if bucket is not None:
            values["k_budgets"] = k_budgets
        return self._run(key, step, values, caches, block_tables), caches

    def chunk_prefill(self, tokens, positions, last_index, caches,
                      block_tables=None, *, plan: str = BASE_PLAN,
                      bucket: Optional[Tuple[int, ...]] = None,
                      k_budgets=None):
        """One ``[B, C]`` chunked-prefill step -> (logits [B,V], caches)."""
        head, cfg = self._resolve(plan, bucket)
        key = (head, "chunk", int(np.shape(tokens)[1]),
               self.opts.expert_dtype)
        opts = self.opts

        def step(tokens, positions, last_index, k_budgets=None):
            return models.chunk_prefill_fn(
                self.params, cfg, tokens, positions, caches,
                last_index=last_index, block_tables=block_tables,
                opts=opts, k_budgets=k_budgets, mesh=self.mesh)[0]
        values = {"tokens": tokens, "positions": positions,
                  "last_index": last_index}
        if bucket is not None:
            values["k_budgets"] = k_budgets
        return self._run(key, step, values, caches, block_tables), caches

    def whole_prefill(self, tokens, positions, caches, *,
                      plan: str = BASE_PLAN):
        """One request's whole prompt ``[1, L]`` into a 1-row contiguous
        cache -- the engine passes views of the request's slot row, written
        in place -> (logits [1,V], caches).  Eager, with no key (a
        single request's plan is always homogeneous here)."""
        return models.prefill_fn(
            self.params, self.plans[plan],
            {"tokens": tokens, "positions": positions}, caches,
            opts=self.opts, mesh=self.mesh)
