"""Serving request / result dataclasses (shared by the whole stack)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Union

import numpy as np


@dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # [L] int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    #: sample only from the k highest-logit tokens (0 = no cap; ignored
    #: when temperature is 0 -- greedy is already the k=1 maximizer)
    top_k: int = 0
    #: per-request stop token (None = the engine's default ``eos_id``);
    #: checked per slot, so requests with different stop tokens -- or
    #: none -- share a batch
    eos_id: Optional[int] = None
    #: streaming callback, called as ``stream(uid, token)`` per new token,
    #: or as ``stream(uid, text_delta)`` when ``detok`` is set
    stream: Optional[Callable[[int, int], None]] = None
    #: LExI plan (by engine-registered name) to serve this request under;
    #: None = whatever the serve/engine default plan is.  Requests with
    #: different plans share a batch (DESIGN.md §10).
    plan: Optional[str] = None
    #: requests with priority > 0 are exempt from pressure-adaptive plan
    #: degradation (they always keep their requested plan)
    priority: int = 0
    #: opt-in incremental detokenization: ``True`` uses the default
    #: synthetic detokenizer, or pass ``ids -> text`` directly.  Streams
    #: text deltas instead of token ids and fills ``Result.text``.
    detok: Union[bool, Callable[[List[int]], str]] = False


@dataclass
class Result:
    uid: int
    tokens: List[int] = field(default_factory=list)
    prompt_len: int = 0
    finished_reason: str = ""
    truncated: bool = False             # prompt was cut to fit max_len
    ttft_s: float = 0.0                 # submission -> first token
    queue_delay_s: float = 0.0          # submission -> *first* admission
    decode_tps: float = 0.0             # decode tokens/s (after first token)
    preemptions: int = 0                # times evicted under pool pressure
    recompute_tokens: int = 0           # positions re-prefilled on resume
    prefix_hit_tokens: int = 0          # positions served from cached pages
    cow_copies: int = 0                 # boundary pages copied before write
    #: plan the request asked for (resolved against the serve default)
    plan: str = ""
    #: plan it was actually served under (== ``plan`` unless the engine's
    #: pressure-adaptive policy degraded it down the ladder)
    served_plan: str = ""
    #: times this request was moved one rung down the plan ladder
    plan_degradations: int = 0
    #: detokenized output text (filled only when detok is on for the
    #: request; always equals the concatenation of the streamed deltas)
    text: str = ""
