"""Request scheduler: admission policy, lifecycle, and latency accounting.

The scheduler is a pure policy object -- it never touches device arrays.
It decides *which* waiting request is admitted next (``fifo`` admits in
arrival-time order -- WAITING carries each request's arrival timestamp,
since open-loop serving feeds requests in mid-flight; ``sjf`` runs
shortest-prompt-first, which removes the head-of-line blocking a single
long prompt used to inflict on every short request queued behind it),
tracks each request through WAITING -> PREFILL -> DECODE -> DONE, fires
streaming callbacks, and accumulates per-request latency records
(time-to-first-token, decode tokens/s) that ``percentiles()`` turns into
the p50/p95 the engine reports.  All timestamps come from one injected
``Clock`` (monotonic ``perf_counter`` by default, never wall
``time.time()``; deterministic ``VirtualClock`` in tests).

Preemption (DESIGN.md §6): when the engine's KV pool runs dry it evicts a
victim through ``preempt``, which re-queues the request in a PREEMPTED
state.  Preempted requests out-rank every fresh WAITING candidate at the
next ``admit`` (their recompute cost grows with every token generated
while they sit in the queue).  Re-admission reassigns only ``admit_seq``
(the ordinal the engine's last-admitted-first victim policy sorts by):
``t_admit`` keeps the *first* admission, so ``Result.queue_delay_s``
reports real submission-to-admission queueing, and TTFT -- measured from
submission to first token -- is likewise unaffected by eviction (tokens
already streamed are never re-recorded).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.clock import Clock, WallClock
from repro_torch.serving.request import Request, Result

WAITING, PREFILL, DECODE, DONE = "waiting", "prefill", "decode", "done"
PREEMPTED = "preempted"     # evicted from its slot, queued for re-admission


def duplicate_uid_error(uid) -> ValueError:
    """Shared by Scheduler.submit and Engine.serve's batch pre-check."""
    return ValueError(
        f"duplicate request uid {uid!r}: every request in a workload needs "
        "a unique uid (results and per-request stats are keyed by it)")

#: name -> sort key over waiting requests (stable sort; ties stay FIFO).
#: fifo keys on the *arrival* time (``t_submit``): under open-loop
#: serving requests enter WAITING mid-flight, so insertion order alone
#: no longer encodes who arrived first after preemptions re-queue.
POLICIES: Dict[str, Callable] = {
    "fifo": lambda t: t.t_submit,
    "sjf": lambda t: len(t.req.prompt),
}


@dataclass
class Tracked:
    """One request's lifecycle record (scheduler-internal)."""

    req: Request
    result: Result
    #: effective prompt (may be a truncated view of ``req.prompt``)
    prompt: Optional[np.ndarray] = None
    state: str = WAITING
    slot: int = -1
    consumed: int = 0          # prefill-source tokens already prefilled
    #: positions ever charged as *useful* prefill work: a victim evicted
    #: mid-prefill re-prefills [0, prefill_done) as recompute, not fresh
    prefill_done: int = 0
    #: tokens to (re-)prefill this admission -- the prompt, or on resume
    #: the prompt + generated-so-far minus the pending last token
    fill: Optional[np.ndarray] = None
    #: admission ordinal (reassigned on re-admission); the engine preempts
    #: the live request with the highest admit_seq first
    admit_seq: int = -1
    #: prefix-cache residency state (engine-owned, reset on preemption):
    #: chain id the next full page registers under, how many leading full
    #: pages are already registered/adopted, and this admission's hit
    chain: int = 0
    hashed_pages: int = 0
    hit_len: int = 0
    #: LExI plan names (engine-resolved at submit): what the request asked
    #: for, and the rung it is currently served under -- ``served_plan``
    #: only moves *down* the engine's ladder, one rung per (re-)admission
    #: under pressure, and a change rides the prefill boundary (the salt
    #: change forces recompute; a live slot's cache is never mutated)
    plan: str = ""
    served_plan: str = ""
    #: arrival time (open-loop: when the request *entered*, which may be
    #: long before admission); the -1 sentinels mean "never happened" --
    #: 0.0 is a legitimate virtual-clock timestamp
    t_submit: float = 0.0
    t_admit: float = -1.0      # first admission (preserved on resume)
    t_first: float = -1.0      # first sampled token
    t_done: float = -1.0

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def fill_len(self) -> int:
        return len(self.fill if self.fill is not None else self.prompt)

    @property
    def resuming(self) -> bool:
        """Re-admitted after preemption with tokens already generated: the
        whole prefill is recompute, and finishing it must not sample a
        first token (the next token was sampled before eviction) or
        re-fire streaming callbacks."""
        return self.state == PREFILL and bool(self.result.tokens)


class Scheduler:
    def __init__(self, max_batch: int, policy: str = "fifo",
                 clock: Optional[Clock] = None):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; have {sorted(POLICIES)}")
        self.policy = policy
        #: all interval measurement goes through this seam (monotonic by
        #: default; tests inject VirtualClock for deterministic latency)
        self.clock = clock if clock is not None else WallClock()
        self.max_batch = max_batch
        self.waiting: List[Tracked] = []
        self.slots: List[Optional[Tracked]] = [None] * max_batch
        self.finished: List[Tracked] = []
        self._uids: set = set()     # uids claimed by any tracked request
        self._admit_counter: int = 0    # admission ordinal source

    # ------------------------------------------------------------------ #
    # Submission / admission
    # ------------------------------------------------------------------ #
    def submit(self, req: Request,
               t_submit: Optional[float] = None) -> Tracked:
        # results are keyed, sorted and stats-bucketed by uid, so a
        # duplicate would merge two requests' records nondeterministically
        # -- refuse it up front instead (records are per-workload: the
        # engine calls clear_finished() at serve() entry, releasing the
        # uid claims, so reusing uids *across* workloads stays legal)
        if req.uid in self._uids:
            raise duplicate_uid_error(req.uid)
        self._uids.add(req.uid)
        # t_submit is the request's *arrival* time: the engine passes the
        # scheduled arrival for open-loop submissions, so queueing delay
        # and TTFT measure from when the request entered the system, not
        # from whichever engine step happened to release it
        t = Tracked(req=req, result=Result(uid=req.uid,
                                           prompt_len=len(req.prompt)),
                    prompt=np.asarray(req.prompt, np.int32),
                    t_submit=(self.clock.now() if t_submit is None
                              else float(t_submit)))
        self.waiting.append(t)
        return t

    def reject(self, t: Tracked, reason: str) -> None:
        """Retire a request that holds no slot: a refusal before admission
        (e.g. over-long prompt) or an abort of a queued PREEMPTED request.
        Latency fields earned in a previous residency (first admission,
        streamed tokens) are kept, consistent with ``finish``."""
        if t in self.waiting:
            self.waiting.remove(t)
        t.state = DONE
        t.t_done = self.clock.now()
        t.result.finished_reason = reason
        self._record_latency(t)
        self.finished.append(t)

    def free_slots(self) -> List[int]:
        return [i for i, t in enumerate(self.slots) if t is None]

    def admit(self, can_allocate: Callable[[int, Tracked], bool]) -> List[Tracked]:
        """Admit waiting requests into free slots, policy order.

        ``can_allocate(slot, tracked)`` is the KV manager's gate.  A refusal
        skips the candidate rather than stopping the scan: page need depends
        on ``max_new_tokens``, which neither policy sorts by, so a later
        candidate may still fit (best-effort packing -- a request the pool
        cannot hold right now is retried every step and admitted as pages
        drain; batch workloads cannot starve it indefinitely).

        PREEMPTED requests out-rank fresh WAITING ones under either policy
        (ties stay stable, i.e. preemption order): every step they spend
        queued grows their recompute bill, while a fresh request's cost of
        waiting is just waiting.
        """
        order = sorted(self.waiting,
                       key=lambda t: (t.state != PREEMPTED,
                                      POLICIES[self.policy](t)))
        admitted: List[Tracked] = []
        for t in order:
            free = self.free_slots()
            if not free:
                break
            slot = free[0]
            if not can_allocate(slot, t):
                continue
            self.waiting.remove(t)
            t.state, t.slot = PREFILL, slot
            if t.t_admit < 0.0:         # queue_delay_s: first admission only
                t.t_admit = self.clock.now()
            t.admit_seq = self._admit_counter
            self._admit_counter += 1
            self.slots[slot] = t
            admitted.append(t)
        return admitted

    def preempt(self, t: Tracked) -> None:
        """Evict a live request from its slot and re-queue it for
        re-admission (the engine releases the KV pages and re-prefills
        prompt + generated-so-far on resume).  Lifecycle only -- victim
        *selection* is the engine's policy.
        """
        assert t.state in (PREFILL, DECODE), \
            f"cannot preempt a {t.state} request"
        if 0 <= t.slot < self.max_batch:
            self.slots[t.slot] = None
        t.state, t.slot, t.consumed, t.fill = PREEMPTED, -1, 0, None
        t.chain, t.hashed_pages, t.hit_len = 0, 0, 0
        t.result.preemptions += 1
        self.waiting.append(t)

    # ------------------------------------------------------------------ #
    # Step composition
    # ------------------------------------------------------------------ #
    def in_state(self, state: str) -> List[Tracked]:
        return [t for t in self.slots if t is not None and t.state == state]

    # ------------------------------------------------------------------ #
    # Token events
    # ------------------------------------------------------------------ #
    def record_token(self, t: Tracked, token: int) -> None:
        if not t.result.tokens:
            t.t_first = self.clock.now()
        t.result.tokens.append(token)
        if t.req.stream is not None:
            t.req.stream(t.req.uid, token)

    def _record_latency(self, t: Tracked) -> None:
        """Fill the result's latency fields from the timestamps.

        Intervals clamp at zero: the default clock is monotonic so a
        negative interval cannot arise from NTP steps anymore, but the
        seam accepts arbitrary injected clocks and a latency stat must
        never go negative regardless (regression-tested with a clock
        that steps backwards mid-serve)."""
        if t.t_admit >= 0.0:
            t.result.queue_delay_s = max(t.t_admit - t.t_submit, 0.0)
        if t.result.tokens:
            t.result.ttft_s = max(t.t_first - t.t_submit, 0.0)
            if len(t.result.tokens) > 1:
                t.result.decode_tps = ((len(t.result.tokens) - 1)
                                       / max(t.t_done - t.t_first, 1e-9))

    def finish(self, t: Tracked, reason: str) -> None:
        t.state = DONE
        t.t_done = self.clock.now()
        t.result.finished_reason = reason
        self._record_latency(t)
        if 0 <= t.slot < self.max_batch:
            self.slots[t.slot] = None
        self.finished.append(t)

    def done(self) -> bool:
        return not self.waiting and all(t is None for t in self.slots)

    def pop_finished(self) -> List[Result]:
        """Retire every finished record: return the results, release the
        records and their uid claims.  Incremental -- callable while
        other requests are live or queued -- which is what a never-idle
        open-loop server needs: ``clear_finished`` only runs at workload
        boundaries, and without per-result release ``finished`` grows
        forever and finished uids stay claimed forever."""
        out = [t.result for t in self.finished]
        for t in self.finished:
            self._uids.discard(t.req.uid)
        self.finished.clear()
        return out

    def clear_finished(self) -> None:
        """Drop per-workload records: finished requests and their uid
        claims (a long-lived engine must not accumulate every past
        prompt/result, and the next workload may reuse the uids)."""
        self.pop_finished()

    # ------------------------------------------------------------------ #
    # Latency accounting
    # ------------------------------------------------------------------ #
    def percentiles(self, over: Optional[Sequence[Tracked]] = None
                    ) -> Dict[str, float]:
        """p50/p95 time-to-first-token (s) and decode tokens/s over finished
        requests.

        NaN-free by construction: requests that never produced a token
        (rejected, prompt-only) contribute no samples at all; requests that
        finished with zero *decode* tokens (immediate EOS / budget 1 -- only
        the prefill-sampled token exists) contribute a TTFT sample but no
        decode-rate sample, since a single token spans no decode interval.
        A key is present iff at least one finite sample backs it.
        """
        recs = [t.result for t in (self.finished if over is None else over)
                if t.result.tokens]
        out: Dict[str, float] = {}
        ttft = np.array([r.ttft_s for r in recs], np.float64)
        ttft = ttft[np.isfinite(ttft)]
        if ttft.size:
            out["ttft_p50_s"] = float(np.percentile(ttft, 50))
            out["ttft_p95_s"] = float(np.percentile(ttft, 95))
        tps = np.array([r.decode_tps for r in recs], np.float64)
        tps = tps[np.isfinite(tps) & (tps > 0)]
        if tps.size:
            out["decode_tps_p50"] = float(np.percentile(tps, 50))
            out["decode_tps_p95"] = float(np.percentile(tps, 95))
        return out

    def results(self) -> List[Result]:
        return sorted((t.result for t in self.finished), key=lambda r: r.uid)
