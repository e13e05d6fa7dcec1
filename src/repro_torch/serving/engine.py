"""Serving engine facade: Scheduler -> KVCache -> ModelRunner composition.

The port of ``repro.serving.engine``.  Every prompt runs through one
fixed-width chunked-prefill step by default, on either layout, and per
iteration

    admit -> one [B, chunk] chunked-prefill step -> one [B] decode step

so concurrent prefills batch together and decode advances all live slots
at once.  The default layout is the paged block-table KV pool; the other is
``cache_layout="contiguous"``, one cache row per slot, reserved for the
request's whole lifetime.  There ``prefill_chunk=0`` prefills each admitted
prompt whole instead, ``[1, L]`` at its own length (no padding: eager
PyTorch needs no graph per padded length, and the ``flash_attention``
kernel masks by index, so it must never see a pad):

    admit + whole prefill of each admitted prompt -> one [B] decode step

Under the default on-demand reservation on the paged pool
(``preemption=None`` or True) admission takes only the pages the prefill
writes, gated to leave what the ``admission`` policy reserves for the
decoding slots (``_admission_headroom``), decode grows a slot page by page,
and a dry pool preempts the last-admitted live request: its pages are
released and it re-queues PREEMPTED, to be re-prefilled (prompt +
generated-so-far) and resumed token-exactly when pages free up.
``preemption=False`` reserves prompt + max_new up front instead; nothing
is ever evicted.

With ``prefix_cache=True`` (paged, on-demand, no sliding-window ring) full
KV pages are indexed by their token chain and the request's salt
(``_salt_for``: its served plan and the expert dtype); an admission maps
the longest cached prefix into the slot's table (copy-on-write of a
boundary page it must rewrite) and prefills from the first uncached
position, and a preempted request whose whole fill is still cached
resumes straight to DECODE.

The loop is continuous and arrival-aware: ``submit(req, arrival_time=)``
puts a request on a time-ordered arrival queue, ``step`` releases due
arrivals and advances every live slot one iteration (returning the
requests that completed in it), ``drain`` steps until the system is empty
(idling the clock toward the next arrival), ``cancel`` aborts a request
wherever it is and ``pop_finished`` retires finished records mid-flight.
``serve`` wraps them for a workload, closed loop or at ``arrival_times``.
Time comes from one injected clock: the wall clock, or a ``VirtualClock``
(one tick a step) for scripted arrivals.

``serve(reqs, plan=name)`` after ``add_plan`` serves a LExI plan from the
same runner and weights, and a request's own ``plan`` serves it under that
plan whatever its batchmates run (DESIGN.md §10): a step whose live slots
share one plan runs that plan's step; a mixed step runs the bucketed-k step
for the batch's per-layer largest k, each row capped at its own plan's k
(``_plan_batch``, counted in ``stats["mixed_plan_steps"]``).  Under pool or
queue pressure, ``set_plan_ladder`` + ``degrade_under_pressure=True`` move
a non-priority request one rung down the ladder per (re-)admission, always
at the prefill boundary.

On the card every chunk and decode step replays a CUDA graph captured for
its specialization key (``serving/runner.py``); ``Engine(graphs=False)``
runs the same steps eagerly, the oracle.  ``Engine(router_lookahead=True)``
predicts each MoE layer's expert ids one layer ahead on decode steps
(numerically a no-op; the CUDA kernels ignore the hint), fixed for the
engine's life, so every graph it captures carries it.  ``submit(req,
detok=)`` / ``serve(..., detok=)`` stream incremental-detok text deltas
(``serving/detok.py``); ``serving/http.py`` puts the engine behind an HTTP
front end.  Not ported yet (ROADMAP.md): the mamba / encoder-decoder
stacks (A13).

``Engine(expert_dtype="int8" | "int4")`` quantizes the routed experts at
load (``quantize_expert_params``) and serves them through the
``moe_gmm_quant`` / ``moe_decode_quant`` kernels; plans registered with
``add_plan`` change only the per-layer k and serve from the same
quantized weights.
"""

from __future__ import annotations

import heapq
import math
import time
from dataclasses import replace
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import cache_buf_len
from repro_torch.models.common import resolve_device
from repro_torch.models.opts import DEFAULT_OPTS, ModelOpts
from repro_torch.serving.clock import Clock, WallClock
from repro_torch.serving.detok import IncrementalDetok
from repro_torch.serving.kv_cache import KVCache
from repro_torch.serving.request import Request, Result
from repro_torch.serving.runner import BASE_PLAN, ModelRunner
from repro_torch.serving.sampling import sample_per_slot
from repro_torch.serving.scheduler import DECODE, DONE, PREFILL, Scheduler, \
    Tracked, duplicate_uid_error

_CHUNKABLE_KINDS = ("attn_mlp", "attn_moe")

#: admission-gate policies for on-demand paged admission (DESIGN.md §11):
#: how many free pages an admission must leave for the slots already
#: decoding, so that a newcomer is not preempted right back out
ADMISSION_POLICIES = ("headroom", "watermark", "lookahead", "greedy")


class Engine:
    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8,
                 max_len: int = 512, prefill_pad: int = 64,
                 prefill_chunk: Optional[int] = None,
                 cache_layout: Optional[str] = None,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 use_kernel: Optional[bool] = None,
                 use_moe_decode: Optional[bool] = None,
                 expert_dtype: Optional[str] = None,
                 router_lookahead: Optional[bool] = None,
                 preemption: Optional[bool] = None,
                 prefix_cache: bool = False,
                 scheduler: str = "fifo",
                 admission: str = "headroom",
                 admission_watermark: float = 0.25,
                 truncate_prompts: bool = False,
                 degrade_under_pressure: bool = False,
                 degrade_watermark: float = 0.25,
                 eos_id: Optional[int] = None, opts: ModelOpts = DEFAULT_OPTS,
                 clock: Optional[Clock] = None, seed: int = 0, device=None,
                 graphs: bool = True):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        if any(b.kind not in _CHUNKABLE_KINDS for b in cfg.pattern()):
            raise NotImplementedError(
                f"{cfg.name}: the port serves attention + MoE/MLP stacks "
                "only (ROADMAP.md A13)")
        self.max_batch = max_batch
        self.max_len = max_len
        self.prefill_pad = prefill_pad
        # engine-wide default stop token; a Request.eos_id overrides it
        self.eos_id = eos_id
        self.truncate_prompts = truncate_prompts
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.clock = clock if clock is not None else WallClock()
        if cache_layout is None:
            cache_layout = "paged"
        if cache_layout not in ("paged", "contiguous"):
            raise ValueError(f"unknown cache layout {cache_layout!r}")
        self.contiguous = cache_layout == "contiguous"
        # prefill_chunk=0: whole-prompt [1, L] prefill into the slot row
        # (contiguous only); anything else chunks, on either layout
        self.chunked = prefill_chunk != 0
        if not self.contiguous and not self.chunked:
            raise ValueError("whole-prompt prefill (prefill_chunk=0) writes "
                             "a slot row; use cache_layout='contiguous'")
        # in-kernel paged decode and the fused decode-regime MoE path; the
        # gather / gmm paths stay the equivalence oracles when False
        self.use_kernel = (opts.use_paged_kernel if use_kernel is None
                           else bool(use_kernel))
        if self.use_kernel and cache_layout != "paged":
            raise ValueError("use_kernel=True walks block tables; it needs "
                             "cache_layout='paged'")
        self.use_moe_decode = (opts.use_moe_decode_kernel
                               if use_moe_decode is None
                               else bool(use_moe_decode))
        # on-demand page reservation + preemption (None -> on for paged);
        # False reserves prompt + max_new for the request's whole life
        if preemption is None:
            preemption = cache_layout == "paged"
        if preemption and cache_layout != "paged":
            raise ValueError("preemption manages the paged pool; it needs "
                             "cache_layout='paged'")
        self.ondemand = bool(preemption)
        if admission not in ADMISSION_POLICIES:
            raise ValueError(f"admission={admission!r}; "
                             f"want one of {ADMISSION_POLICIES}")
        if admission != "headroom" and not self.ondemand:
            raise ValueError("admission policies gate on-demand paged "
                             "admission; they need preemption=True "
                             "(whole-lifetime reservation never over-admits)")
        self.admission = admission
        self.admission_watermark = float(admission_watermark)
        # prefix caching needs the paged layout (a page is the sharing
        # unit), the on-demand discipline (whole-lifetime reservation never
        # releases pages early enough to share) and no ring wrap (a
        # sliding-window ring rewrites pages in place, so a cached page
        # would stop being the pure function of its token prefix)
        self.prefix_cache = bool(prefix_cache)
        if self.prefix_cache:
            if cache_layout != "paged":
                raise ValueError("prefix_cache shares pages; it needs "
                                 "cache_layout='paged'")
            if not self.ondemand:
                raise ValueError("prefix_cache needs the on-demand "
                                 "reservation discipline (preemption=True)")
            if cache_buf_len(cfg, max_len) < max_len:
                raise ValueError(
                    "prefix_cache cannot serve a sliding-window ring "
                    f"(cache_buf_len={cache_buf_len(cfg, max_len)} < "
                    f"max_len={max_len}): wrapped pages are rewritten in "
                    "place, so cached content would go stale")
        # cap at the ring size: a chunk wider than the window would scatter
        # two positions into one ring slot within a single write
        self.prefill_chunk = (min(prefill_chunk or prefill_pad,
                                  cache_buf_len(cfg, max_len))
                              if self.chunked else 0)
        # quantized expert tiles: quantize at load, so the engine never
        # holds both weight copies (every non-expert tensor is shared with
        # the caller's params)
        from repro_torch.models.moe import QUANT_DTYPES, \
            quantize_expert_params
        ed = opts.expert_dtype if expert_dtype is None else expert_dtype
        if ed not in ("bf16",) + QUANT_DTYPES:
            raise ValueError(f"expert_dtype={ed!r}; want 'bf16' or one of "
                             f"{QUANT_DTYPES}")
        if ed != "bf16":
            impl = opts.moe_impl or cfg.moe_impl
            if not cfg.is_moe or impl not in ("gmm", "decode"):
                raise ValueError(
                    f"expert_dtype={ed!r} is served by the gmm/decode MoE "
                    f"impls only (cfg {cfg.name!r} resolves to {impl!r})")
            params = quantize_expert_params(params, cfg, ed)
        self.expert_dtype = ed
        # router lookahead is fixed for the engine's life: every step (and
        # on the card every CUDA graph) of this engine carries it
        rl = (opts.router_lookahead if router_lookahead is None
              else bool(router_lookahead))
        if rl and any(b.kind == "mamba" for b in cfg.pattern()):
            raise ValueError("router_lookahead carries the pre-FFN hidden "
                             "across layers; mamba blocks have none")
        self.router_lookahead = rl
        opts = replace(opts, use_paged_kernel=self.use_kernel,
                       use_moe_decode_kernel=self.use_moe_decode,
                       expert_dtype=ed, router_lookahead=rl)
        self.runner = ModelRunner(cfg, params, opts=opts, graphs=graphs)
        self.plan_name = BASE_PLAN
        # pressure-adaptive plan degradation (DESIGN.md §10): an ordered
        # expensive -> cheap ladder of plan names; under pressure an
        # admission moves a non-priority request one rung down, always at
        # the prefill boundary (the salt change makes the old rung's
        # cached prefix a miss, and a live slot's cache is never touched)
        self.plan_ladder: tuple = ()
        self.degrade_under_pressure = bool(degrade_under_pressure)
        self.degrade_watermark = float(degrade_watermark)
        self.kv = KVCache(self.cfg, max_batch, max_len, layout=cache_layout,
                          page_size=page_size, num_pages=num_pages,
                          prefix_cache=self.prefix_cache, device=self.device)
        self.sched = Scheduler(max_batch, policy=scheduler, clock=self.clock)
        # time-ordered arrival queue: a request submitted for a future
        # arrival_time waits here until the clock reaches it; a heap of
        # (arrival_time, seq, Request, detok default)
        self._pending: List = []
        self._pending_seq = 0
        self._pending_uids: set = set()
        self.slot_pos = np.full(max_batch, -1, np.int32)    # next write pos
        self.slot_last = np.zeros(max_batch, np.int32)      # last sampled tok
        self.slot_budget = np.zeros(max_batch, np.int32)
        self.slot_temp = np.zeros(max_batch, np.float32)
        self.slot_topk = np.zeros(max_batch, np.int32)      # 0 = no top-k cap
        self.stats: Dict[str, float] = self._fresh_stats()

    @staticmethod
    def _fresh_stats() -> Dict[str, float]:
        # prefill_tokens counts each prompt position computed once (useful
        # work); positions re-prefilled when a preempted request resumes
        # land in recompute_tokens, and positions served from cached pages
        # in prefix_hit_tokens, so throughput() reflects useful tokens.
        # decode_s / decode_host_s: wall seconds of the decode steps, and
        # of their host part up to the step's return (before sampling
        # waits for the device)
        return {"prefill_tokens": 0, "decode_tokens": 0,
                "recompute_tokens": 0, "steps": 0, "preemptions": 0,
                "live_peak": 0, "prefix_hit_tokens": 0, "cow_copies": 0,
                "plan_degradations": 0, "mixed_plan_steps": 0,
                "decode_s": 0.0, "decode_host_s": 0.0}

    # ------------------------------------------------------------------ #
    # Plans
    # ------------------------------------------------------------------ #
    @property
    def cfg(self) -> ModelConfig:
        return self.runner.cfg_for(self.plan_name)

    def add_plan(self, name: str, plan) -> ModelConfig:
        """Register a LExI plan; weights stay shared with the base config."""
        return self.runner.add_plan(name, plan)

    def set_plan_ladder(self, names: Sequence[str]) -> None:
        """Declare the degradation ladder, most expensive rung first; every
        name must already be registered (``add_plan`` / "base")."""
        for n in names:
            if n not in self.runner.plans:
                raise ValueError(f"unknown plan {n!r} in ladder; "
                                 f"have {sorted(self.runner.plans)}")
        self.plan_ladder = tuple(names)

    def _under_pressure(self) -> bool:
        """Compute pressure (more requests queued than slots free) or
        KV-pool pressure (free pages below the watermark share)."""
        if len(self.sched.waiting) > len(self.sched.free_slots()):
            return True
        if not self.contiguous:
            total = self.kv.num_pages - 1       # minus the trash page
            return total > 0 and (self.kv.free_pages()
                                  < self.degrade_watermark * total)
        return False

    def _degraded_rung(self, t: Tracked) -> str:
        """The plan to try admitting ``t`` under: its current rung, or one
        rung cheaper when the policy is on, the request is degradable
        (priority 0, on the ladder, not at the bottom) and the system is
        under pressure.  Committed only if the allocation succeeds."""
        cur = t.served_plan
        if (not self.degrade_under_pressure or not self.plan_ladder
                or t.req.priority > 0 or cur not in self.plan_ladder):
            return cur
        i = self.plan_ladder.index(cur)
        if i + 1 >= len(self.plan_ladder) or not self._under_pressure():
            return cur
        return self.plan_ladder[i + 1]

    def _commit_plan(self, t: Tracked, served: str) -> None:
        """Record a successful admission's (possibly degraded) rung."""
        if served != t.served_plan:
            t.served_plan = served
            t.result.served_plan = served
            t.result.plan_degradations += 1
            self.stats["plan_degradations"] += 1

    def set_plan(self, name: str) -> None:
        """Switch the serving plan (between workloads only)."""
        if name != self.plan_name and not self.idle():
            raise RuntimeError("cannot switch plans with requests in flight")
        if name not in self.runner.plans:
            raise ValueError(f"unknown plan {name!r}; have "
                             f"{sorted(self.runner.plans)}")
        self.plan_name = name

    # ------------------------------------------------------------------ #
    # Submission
    # ------------------------------------------------------------------ #
    def submit(self, req: Request, *,
               arrival_time: Optional[float] = None,
               detok: Union[bool, Callable] = False) -> None:
        """Enqueue a request for admission at ``arrival_time`` (clock
        units; None = now), also while others are mid-prefill or
        mid-decode.  Validation (prompt length, KV capacity, plan name)
        happens at release and produces a rejected ``Result`` rather than
        an exception.  ``detok`` is the workload-default incremental-detok
        mode (True: ``default_decode``, or an ``ids -> text`` callable),
        applied only when the request did not opt in itself; it lands on
        the engine's ``Tracked`` record, never on the caller's ``Request``."""
        if req.uid in self._pending_uids or req.uid in self.sched._uids:
            raise duplicate_uid_error(req.uid)
        t = self.clock.now() if arrival_time is None else float(arrival_time)
        heapq.heappush(self._pending, (t, self._pending_seq, req, detok))
        self._pending_seq += 1
        self._pending_uids.add(req.uid)

    def _release_arrivals(self) -> None:
        """Move every due arrival into the scheduler (arrival order)."""
        while self._pending and self._pending[0][0] <= self.clock.now():
            t_arr, _, req, detok = heapq.heappop(self._pending)
            self._pending_uids.discard(req.uid)
            self._submit(req, t_arrival=t_arr, detok_default=detok)

    def next_arrival(self) -> Optional[float]:
        """Earliest scheduled arrival still pending (None when empty)."""
        return self._pending[0][0] if self._pending else None

    def _submit(self, req: Request, t_arrival: Optional[float] = None,
                detok_default: Union[bool, Callable] = False) -> Tracked:
        t = self.sched.submit(req, t_submit=t_arrival)
        # a per-request plan wins, else the serve / engine default
        t.plan = t.served_plan = (req.plan if req.plan is not None
                                  else self.plan_name)
        t.result.plan = t.result.served_plan = t.plan
        # likewise the request's own detok opt-in, else the workload's
        detok = req.detok if req.detok else detok_default
        if detok:
            t.detok = (IncrementalDetok(detok) if callable(detok)
                       else IncrementalDetok())
        limit = self.max_len - 1
        if t.prompt_len == 0:
            self.sched.reject(t, "rejected_empty_prompt")
        elif t.prompt_len > limit:
            if self.truncate_prompts:
                t.prompt = t.prompt[-limit:]
                t.result.truncated = True
                t.result.prompt_len = limit
            else:
                self.sched.reject(t, "rejected_prompt_too_long")
        if t.state != DONE and t.plan not in self.runner.plans:
            self.sched.reject(t, "rejected_unknown_plan")
        if (t.state != DONE and not self.contiguous
                and not self.kv.fits_ever(t.prompt_len
                                          + t.req.max_new_tokens)):
            self.sched.reject(t, "rejected_kv_capacity")
        return t

    # ------------------------------------------------------------------ #
    # Step phases
    # ------------------------------------------------------------------ #
    def _salt_for(self, served_plan: str):
        """Prefix-cache chain root key: what, beyond the tokens, changes
        the K/V a prefill writes -- the served plan (per-layer expert
        budgets) and the expert storage dtype.  A degraded resume thus
        misses the old rung's pages and recomputes under the new plan."""
        return (served_plan, self.expert_dtype)

    def _admission_headroom(self) -> int:
        """Free pages an on-demand admission must leave for the slots
        already decoding, per the ``admission`` policy: ``headroom`` one
        page a decoding slot; ``watermark`` a static share of the pool;
        ``lookahead`` the pages each decoding slot claims within the next
        ``page_size`` steps, bounded by its remaining budget; ``greedy``
        none (the thrash baseline)."""
        if self.admission == "greedy":
            return 0
        decoding = self.sched.in_state(DECODE)
        if self.admission == "headroom":
            return len(decoding)
        if self.admission == "watermark":
            total = self.kv.num_pages - 1       # minus the trash page
            return math.ceil(self.admission_watermark * total)
        need = 0                                # "lookahead"
        for t in decoding:
            have = int(self.slot_pos[t.slot]) + 1   # positions covered now
            horizon = min(self.kv.page_size,
                          max(int(self.slot_budget[t.slot]), 0))
            need += (self.kv.pages_needed(have + horizon)
                     - self.kv.pages_needed(have))
        return need

    def _admit(self) -> None:
        def can_allocate(slot: int, t: Tracked) -> bool:
            served = self._degraded_rung(t)
            if not self.ondemand:       # the whole lifetime, up front
                if not self.kv.allocate(slot, t.prompt_len
                                        + t.req.max_new_tokens):
                    return False
                self._commit_plan(t, served)
                return True
            # reserve only what this admission's prefill writes: the
            # prompt, plus generated-so-far minus the pending token on
            # resume
            gen = t.result.tokens
            fill = (np.concatenate([t.prompt, np.asarray(gen[:-1], np.int32)])
                    if gen else t.prompt)
            n = len(fill)
            shared: List[int] = []
            hit = chain = 0
            if self.prefix_cache:
                # a fresh request computes >= 1 position (its logits come
                # from the last prompt token); a resume may reuse all
                cap = n if gen else n - 1
                shared, hit, chain = self.kv.match_prefix(
                    self._salt_for(served), fill, cap)
            # gate on the private need: hit pages already live cost
            # nothing, an rc-0 LRU page or a COW copy costs one
            cow = 1 if hit % self.kv.page_size else 0
            cost = (self.kv.pages_needed(n)
                    - self.kv.live_count(shared[:len(shared) - cow]))
            if self.kv.free_pages() < cost + self._admission_headroom():
                return False
            if not self.kv.allocate(slot, n, shared=shared, keep_below=hit):
                return False
            if self.prefix_cache:
                t.hit_len = hit
                t.chain = chain
                t.hashed_pages = hit // self.kv.page_size
            self._commit_plan(t, served)
            return True

        for t in self.sched.admit(can_allocate):
            self.slot_temp[t.slot] = t.req.temperature
            self.slot_topk[t.slot] = (t.req.top_k
                                      if t.req.temperature > 0 else 0)
            gen = t.result.tokens
            if gen:     # resume: re-prefill prompt + all but the pending tok
                t.fill = np.concatenate(
                    [t.prompt, np.asarray(gen[:-1], np.int32)])
            else:
                t.fill = t.prompt
            self.slot_budget[t.slot] = t.req.max_new_tokens - len(gen)
            self.slot_pos[t.slot] = -1
            if t.hit_len:
                # mapped-in pages cover [0, hit_len): chunked prefill
                # starts at the first uncached position
                self.stats["prefix_hit_tokens"] += t.hit_len
                t.result.prefix_hit_tokens += t.hit_len
                if t.hit_len % self.kv.page_size:
                    self.stats["cow_copies"] += 1
                    t.result.cow_copies += 1
                t.consumed = t.hit_len
                if t.consumed == t.fill_len:
                    # a resume whose whole fill is still cached: straight
                    # to DECODE, nothing recomputed
                    assert t.resuming
                    t.state = DECODE
                    self.slot_pos[t.slot] = t.fill_len
                    self.slot_last[t.slot] = t.result.tokens[-1]
            if not self.chunked:
                self._whole_prefill(t)

    def _eos_of(self, t: Tracked) -> Optional[int]:
        return t.req.eos_id if t.req.eos_id is not None else self.eos_id

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        topks = (torch.from_numpy(self.slot_topk)
                 if self.slot_topk.any() else None)
        return sample_per_slot(logits, self.gen,
                               torch.from_numpy(self.slot_temp),
                               topks).cpu().numpy()

    def _first_token(self, t: Tracked, tok: int) -> None:
        """Account the prefill-sampled token; it may already terminate."""
        if t.req.max_new_tokens <= 0:
            self._finish(t, "length")
            return
        self.sched.record_token(t, tok)
        self.slot_budget[t.slot] -= 1
        eos = self._eos_of(t)
        done_eos = eos is not None and tok == eos
        if done_eos or self.slot_budget[t.slot] <= 0:
            self._finish(t, "eos" if done_eos else "length")
        else:
            t.state = DECODE
            self.slot_pos[t.slot] = t.prompt_len
            self.slot_last[t.slot] = tok

    def _finish(self, t: Tracked, reason: str) -> None:
        slot = t.slot
        self.sched.finish(t, reason)
        self.kv.release(slot)
        self.slot_pos[slot] = -1
        self.slot_topk[slot] = 0
        k = f"plan_requests:{t.served_plan}"
        self.stats[k] = self.stats.get(k, 0) + 1

    def _plan_batch(self, live: List[Tracked]):
        """-> (plan, bucket, k_budgets) for one batched model step.

        All live slots on one plan: that plan's own step, no budgets.
        Mixed plans: the bucketed-k step for the batch's per-layer max k
        (power-of-two roundup), with each slot's own per-layer budget --
        surplus routed slots are zero-weighted in ``route``, so every row
        computes what its own plan's step computes."""
        names = {t.served_plan for t in live}
        if len(names) == 1:
            return names.pop(), None, None
        ks = self.runner.plan_ks
        n_moe = len(ks[BASE_PLAN])
        maxk = tuple(max(ks[t.served_plan][l] for t in live)
                     for l in range(n_moe))
        bucket = self.runner.bucket_for(maxk)
        budgets = np.tile(np.asarray(bucket, np.int32), (self.max_batch, 1))
        for t in live:
            budgets[t.slot] = ks[t.served_plan]
        self.stats["mixed_plan_steps"] += 1
        return BASE_PLAN, bucket, budgets

    def _seq_tokens(self, t: Tracked, a: int, b: int) -> np.ndarray:
        """Token content at positions [a, b): the prompt, then generated
        tokens (position i >= prompt_len holds ``result.tokens[i - L]``)."""
        lo = t.prompt[a:b]
        if b <= t.prompt_len:
            return lo
        gen = np.asarray(t.result.tokens[max(a - t.prompt_len, 0):
                                         b - t.prompt_len], np.int32)
        return np.concatenate([lo, gen]) if len(lo) else gen

    def _register_pages(self, t: Tracked, written: int) -> None:
        """Index every newly full page of ``t``'s slot (content below
        ``written`` is committed).  A duplicate stays private (first wins
        in the index); the chain id advances either way."""
        if not self.prefix_cache:
            return
        p = self.kv.page_size
        while (t.hashed_pages + 1) * p <= written:
            j = t.hashed_pages
            page = self.kv.slot_pages(t.slot)[j]
            t.chain = self.kv.register_page(
                t.chain, self._seq_tokens(t, j * p, (j + 1) * p), page)
            t.hashed_pages += 1

    def _chunk_prefill_step(self, prefilling: List[Tracked]) -> None:
        """Advance every prefilling slot by one fixed-width chunk; fresh and
        resuming requests ride the same step (resume is recompute).  With a
        prefix hit a slot's chunks start at ``hit_len``."""
        c = self.prefill_chunk
        tokens = np.zeros((self.max_batch, c), np.int32)
        positions = np.full((self.max_batch, c), -1, np.int32)
        last_idx = np.zeros(self.max_batch, np.int32)
        sampling: List[Tracked] = []
        for t in prefilling:
            n = min(c, t.fill_len - t.consumed)
            tokens[t.slot, :n] = t.fill[t.consumed:t.consumed + n]
            positions[t.slot, :n] = np.arange(t.consumed, t.consumed + n)
            self.kv.assert_private(t.slot, t.consumed, t.consumed + n)
            t.consumed += n
            if t.resuming:
                self.stats["recompute_tokens"] += n
                t.result.recompute_tokens += n
            else:
                # a victim evicted mid-prefill re-runs positions already
                # charged as useful work: only the advance past its
                # prefill high-water mark counts as fresh
                fresh = min(n, max(0, t.consumed - t.prefill_done))
                self.stats["prefill_tokens"] += fresh
                self.stats["recompute_tokens"] += n - fresh
                t.result.recompute_tokens += n - fresh
                t.prefill_done = max(t.prefill_done, t.consumed)
            if t.consumed == t.fill_len:
                if t.resuming:
                    t.state = DECODE
                    self.slot_pos[t.slot] = t.fill_len
                    self.slot_last[t.slot] = t.result.tokens[-1]
                else:
                    last_idx[t.slot] = n - 1
                    sampling.append(t)
        plan, bucket, budgets = self._plan_batch(prefilling)
        logits, self.kv.caches = self.runner.chunk_prefill(
            tokens, positions, last_idx, self.kv.caches,
            None if self.contiguous else self.kv.block_tables(),
            plan=plan, bucket=bucket, k_budgets=budgets)
        for t in prefilling:    # chunk writes are committed: index them
            self._register_pages(t, t.consumed)
        if sampling:
            nxt = self._sample(logits)
            for t in sampling:
                self._first_token(t, int(nxt[t.slot]))

    def _whole_prefill(self, t: Tracked) -> None:
        """One prompt at its own length, ``[1, L]``, written in place into
        the request's slot row (``[1, ...]`` views of the caches); samples
        its first token."""
        dev = self.device
        plen = t.prompt_len
        tokens = torch.from_numpy(np.ascontiguousarray(t.prompt)[None]).to(dev)
        positions = torch.arange(plen, dtype=torch.int32, device=dev)[None]
        row = [{n: c[t.slot:t.slot + 1] for n, c in layer.items()}
               for layer in self.kv.caches]
        logits, _ = self.runner.whole_prefill(tokens, positions, row,
                                              plan=t.served_plan)
        self.stats["prefill_tokens"] += plen
        t.consumed = plen
        topk = (torch.tensor([t.req.top_k], dtype=torch.int32)
                if t.req.top_k and t.req.temperature > 0 else None)
        nxt = sample_per_slot(logits, self.gen,
                              torch.tensor([t.req.temperature]), topk)
        self._first_token(t, int(nxt[0]))

    def _preempt(self, t: Tracked) -> None:
        """Evict a live request: pages back to the pool, request re-queued
        PREEMPTED (its generated tokens are kept for the resume prefill)."""
        slot = t.slot
        self.sched.preempt(t)
        self.kv.release(slot)
        self.slot_pos[slot] = -1
        self.slot_budget[slot] = 0
        self.slot_temp[slot] = 0.0
        self.slot_topk[slot] = 0
        self.stats["preemptions"] += 1

    def _grow_or_preempt(self, decoding: List[Tracked]) -> List[Tracked]:
        """Every decoding slot gets the page its next position needs; a
        shortfall preempts victims last-admitted-first until it fits
        (earliest-admitted slots grow first, so the earliest live request
        is never evicted by a later one and always completes)."""
        for t in sorted(decoding, key=lambda t: t.admit_seq):
            if t.state != DECODE:           # evicted as a victim below
                continue
            while not self.kv.allocate_append(t.slot,
                                              int(self.slot_pos[t.slot]) + 1):
                live = [v for v in self.sched.slots if v is not None]
                victim = max(live, key=lambda v: v.admit_seq)
                self._preempt(victim)
                if victim is t:
                    break
        return self.sched.in_state(DECODE)

    def _decode_step(self, decoding: List[Tracked]) -> None:
        t0 = time.perf_counter()
        if self.ondemand:
            decoding = self._grow_or_preempt(decoding)
            if not decoding:
                return
        tokens = np.zeros(self.max_batch, np.int32)
        pos = np.full(self.max_batch, -1, np.int32)
        for t in decoding:
            tokens[t.slot] = self.slot_last[t.slot]
            pos[t.slot] = self.slot_pos[t.slot]
            # past the shared prefix by construction (COW at admission)
            self.kv.assert_private(t.slot, int(pos[t.slot]),
                                   int(pos[t.slot]) + 1)
        kernel_blocks = self.kv.live_blocks(pos) if self.use_kernel else None
        plan, bucket, budgets = self._plan_batch(decoding)
        logits, self.kv.caches = self.runner.decode(
            tokens, pos, self.kv.caches,
            None if self.contiguous else self.kv.block_tables(),
            plan=plan, kernel_blocks=kernel_blocks, bucket=bucket,
            k_budgets=budgets)
        t1 = time.perf_counter()
        nxt = self._sample(logits)
        self.stats["decode_host_s"] += t1 - t0
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["steps"] += 1
        for t in decoding:
            self.slot_pos[t.slot] += 1
            tok = int(nxt[t.slot])
            self.sched.record_token(t, tok)
            self.slot_last[t.slot] = tok
            self.slot_budget[t.slot] -= 1
            self.stats["decode_tokens"] += 1
            k = f"plan_decode_tokens:{t.served_plan}"
            self.stats[k] = self.stats.get(k, 0) + 1
            # register before any finish: a finishing request's pages then
            # park in the LRU, content intact, instead of the free list
            self._register_pages(t, int(self.slot_pos[t.slot]))
            eos = self._eos_of(t)
            done_eos = eos is not None and tok == eos
            done_len = (self.slot_budget[t.slot] <= 0
                        or self.slot_pos[t.slot] >= self.max_len - 1)
            if done_eos or done_len:
                self._finish(t, "eos" if done_eos else "length")

    def _abort(self, reason: str) -> None:
        """Drain every live, queued and not-yet-arrived request so a failed
        drain cannot wedge the engine."""
        for t in [x for x in self.sched.slots if x is not None]:
            self._finish(t, reason)
        for t in list(self.sched.waiting):
            self.sched.reject(t, reason)
        while self._pending:    # future arrivals reject without admission
            _, _, req, _ = heapq.heappop(self._pending)
            self._pending_uids.discard(req.uid)
            self.sched.reject(self.sched.submit(req), reason)

    def _step(self) -> None:
        self._admit()
        live = sum(t is not None for t in self.sched.slots)
        self.stats["live_peak"] = max(self.stats["live_peak"], live)
        prefilling = self.sched.in_state(PREFILL)
        if prefilling:
            self._chunk_prefill_step(prefilling)
        decoding = self.sched.in_state(DECODE)
        if decoding:
            self._decode_step(decoding)

    # ------------------------------------------------------------------ #
    # Public API
    # ------------------------------------------------------------------ #
    def idle(self) -> bool:
        """Nothing live, queued or scheduled to arrive."""
        return not self._pending and self.sched.done()

    def reset_stats(self) -> None:
        """Start a fresh workload: zero the counters and drop the previous
        workload's finished records (releasing their uid claims)."""
        if not self.idle():
            raise RuntimeError("cannot reset stats with requests in flight")
        self.stats = self._fresh_stats()
        self.sched.clear_finished()

    def pop_finished(self) -> List[Result]:
        """Retire the finished records: return their results and release
        the records and uid claims; works mid-flight (the counters are
        untouched)."""
        return self.sched.pop_finished()

    def cancel(self, uid, *, reason: str = "cancelled") -> bool:
        """Abort one request wherever it is: not yet arrived (off the
        arrival heap), queued (rejected) or live in a slot (finished, its
        pages released).  It retires as a finished record with
        ``finished_reason=reason``.  False when the uid is unknown or
        already finished."""
        for i, (t_arr, _, req, _) in enumerate(self._pending):
            if req.uid == uid:
                del self._pending[i]
                heapq.heapify(self._pending)
                self._pending_uids.discard(uid)
                self.sched.reject(self.sched.submit(req, t_submit=t_arr),
                                  reason)
                return True
        for t in list(self.sched.waiting):
            if t.req.uid == uid:
                self.sched.reject(t, reason)
                return True
        for t in self.sched.slots:
            if t is not None and t.req.uid == uid:
                self._finish(t, reason)
                return True
        return False

    def step(self) -> List[Result]:
        """One engine iteration: release due arrivals, admit, one
        chunked-prefill step, one decode step, tick the clock.  Returns the
        requests that completed this step."""
        n0 = len(self.sched.finished)
        self._release_arrivals()
        self._step()
        self.clock.on_step()
        return [t.result for t in self.sched.finished[n0:]]

    def drain(self, *, max_steps: Optional[int] = None) -> List[Result]:
        """Step until the system is empty (slots, queue and arrival heap);
        while nothing is runnable the clock idles toward the next arrival.
        ``max_steps`` bounds the loop (exceeding it aborts everything in
        flight and raises)."""
        out: List[Result] = []
        n_steps = 0
        while not self.idle():
            if max_steps is not None and n_steps >= max_steps:
                queued, live = (len(self.sched.waiting),
                                sum(t is not None for t in self.sched.slots))
                self._abort("aborted_max_steps")
                raise RuntimeError(
                    f"drain() exceeded max_steps={max_steps}: {queued} "
                    f"queued, {live} live ({self.stats['preemptions']} "
                    "preemptions so far)")
            if (self._pending and self.sched.done()
                    and self._pending[0][0] > self.clock.now()):
                self.clock.sleep_until(self._pending[0][0])
            out.extend(self.step())
            n_steps += 1
        return out

    def serve(self, requests: Sequence[Request], *,
              plan: Optional[str] = None,
              detok: Union[bool, Callable] = False,
              max_steps: Optional[int] = None,
              arrival_times: Optional[Sequence[float]] = None
              ) -> List[Result]:
        """Run a workload with continuous batching; returns all results
        sorted by uid.  Every request is submitted up front, at now
        (closed loop) or at ``now + arrival_times[i]`` (open loop, clock
        units).  ``plan=`` is this serve's default plan (omitted: the base
        config); ``detok=`` turns on incremental detokenization for every
        request that did not opt in itself (True: ``default_decode``, or
        an ``ids -> text`` callable) without touching the requests."""
        self.set_plan(plan if plan is not None else BASE_PLAN)
        uids = [r.uid for r in requests]
        if len(set(uids)) != len(uids):
            seen: set = set()
            raise duplicate_uid_error(
                next(u for u in uids if u in seen or seen.add(u)))
        if arrival_times is not None and len(arrival_times) != len(requests):
            raise ValueError(f"{len(arrival_times)} arrival_times for "
                             f"{len(requests)} requests")
        self.reset_stats()
        g0 = dict(self.runner.stats)
        ev0 = self.kv.stats.get("cache_evictions", 0)
        t0 = self.clock.now()
        for i, r in enumerate(requests):
            off = arrival_times[i] if arrival_times is not None else 0.0
            self.submit(r, arrival_time=t0 + off, detok=detok)
        self.drain(max_steps=max_steps)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats["wall_s"] = max(self.clock.now() - t0, 0.0)
        # share of prefill-source positions served from cached pages
        hit = self.stats["prefix_hit_tokens"]
        denom = (hit + self.stats["prefill_tokens"]
                 + self.stats["recompute_tokens"])
        self.stats["prefix_hit_rate"] = hit / denom if denom else 0.0
        # cached pages this serve evicted from the LRU to make room
        self.stats["cache_evictions"] = (
            self.kv.stats.get("cache_evictions", 0) - ev0)
        # this serve's CUDA graphs: captured (and their host seconds) and
        # replayed; 0 where the steps ran eagerly
        g = self.runner.stats
        self.stats.update(graphs_captured=g["graphs"] - g0["graphs"],
                          capture_s=g["capture_s"] - g0["capture_s"],
                          graph_replays=g["replays"] - g0["replays"])
        self.stats.update(self.sched.percentiles())
        return self.sched.results()

    def plan_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-plan view of the last serve's counters."""
        out: Dict[str, Dict[str, float]] = {}
        for k, v in self.stats.items():
            if k.startswith(("plan_requests:", "plan_decode_tokens:")):
                stat, name = k.split(":", 1)
                out.setdefault(name, {})[stat] = v
        return out

    def throughput(self) -> float:
        """Useful tokens (prompt + generated) per second over the last
        serve(); recompute after preemption is not counted."""
        wall = self.stats.get("wall_s", 0.0)
        tok = self.stats["prefill_tokens"] + self.stats["decode_tokens"]
        return tok / wall if wall > 0 else 0.0
