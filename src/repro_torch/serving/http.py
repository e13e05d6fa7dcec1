"""HTTP serving front end on the continuous engine loop (the port of
``repro.serving.http``; standard library ``http.server`` threads).

An :class:`ApiServer` wraps one :class:`~repro_torch.serving.engine.Engine`
behind three endpoints --

* ``POST /v1/completions`` -- submit a request (prompt token ids,
  ``max_new_tokens``, ``temperature``, ``top_k``, ``eos_id``, ``plan``,
  ``priority``, ``stream``).  ``stream=true`` answers with a chunked
  ``application/x-ndjson`` body: one ``{"delta": text}`` line per
  incremental-detok delta as it is generated, then a final
  ``{"done": true, "result": {...}}`` line.  ``stream=false`` blocks and
  returns the whole result as one JSON object.
* ``GET /v1/stats`` -- engine counters + per-plan breakdown + server
  gauges, sanitized finite (a mid-flight scrape must never see NaN).
* ``GET /health`` -- liveness.

Threading model: ONE background *pump* thread owns engine progress -- it
calls ``Engine.step()`` under the single engine lock whenever anything is
runnable, retires completions incrementally through ``pop_finished()``
(records and uid claims release per result), and goes quiet when it
cannot make progress: toward the next scheduled arrival through the
engine's clock (``clock.sleep_until``, capped so a fresh submission is
picked up promptly), or onto a wake event when nothing is pending at all.
Connection handler threads (``ThreadingHTTPServer``, one per connection)
take the lock only for short control actions -- submit, cancel, stats --
and otherwise wait on their request's :class:`_Completion` queue, the seam
between the pump (producer, under the lock) and the connection (consumer,
never holding it).  A control action takes the lock through
``ApiServer.control()``, which the pump lets go first before its next
step: the lock is not fair, and a pump that releases it only to take it
straight back (an eager PyTorch step holds the interpreter most of the
time) would starve a submission or a scrape for the whole of a request.

So all device work stays on the pump thread, one step at a time.  On the
card that matters twice over: the runner captures each specialization
key's CUDA graph at its first call, on the pump thread, and a capture is
invalidated by a CUDA call from any other thread while it runs; and the
stats the handlers read under the lock (``Engine.stats``,
``plan_stats()``, the scheduler's queues) are host numbers only, so a
scrape never touches the device.  A step that raises stops the pump: every
request in flight is aborted (``aborted_server_error``), waiters are
answered, and ``close()`` re-raises the error.

Disconnects: a write onto a closed connection raises; the handler maps
that to ``Engine.cancel(uid)`` under the lock, which releases the
request's slot, KV pages, and (via the pump's next retirement) its uid
claim -- an abandoned stream cannot wedge or leak the engine.
"""

from __future__ import annotations

import json
import math
import queue
import threading
from contextlib import contextmanager
from dataclasses import asdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, Result

#: request-body keys POST /v1/completions accepts (anything else is a 400:
#: a misspelled knob silently ignored would be worse than an error)
_COMPLETION_FIELDS = frozenset((
    "prompt", "max_new_tokens", "temperature", "top_k", "eos_id", "plan",
    "priority", "stream"))

_DELTA, _DONE = "delta", "done"


def _finite(x):
    """JSON-safe copy of a stats tree: non-finite floats become 0.0
    (json.dumps would otherwise emit bare NaN/Infinity, which is not
    JSON and breaks strict clients)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, float) and not math.isfinite(x):
        return 0.0
    return x


def _result_json(res: Result) -> Dict[str, Any]:
    return _finite(asdict(res))


class BadRequest(ValueError):
    """Client error: maps to a 400 with the message as the body."""


def _parse_completion(body: Any) -> Dict[str, Any]:
    """Validate a /v1/completions body into Request kwargs (sans uid)."""
    if not isinstance(body, dict):
        raise BadRequest("body must be a JSON object")
    unknown = set(body) - _COMPLETION_FIELDS
    if unknown:
        raise BadRequest(f"unknown field(s) {sorted(unknown)}; "
                         f"accepted: {sorted(_COMPLETION_FIELDS)}")
    prompt = body.get("prompt")
    if (not isinstance(prompt, list) or not prompt
            or not all(isinstance(t, int) and not isinstance(t, bool)
                       for t in prompt)):
        raise BadRequest("prompt must be a non-empty list of token ids")
    eos = body.get("eos_id")
    if eos is not None and not isinstance(eos, int):
        raise BadRequest("eos_id must be an integer or null")
    plan = body.get("plan")
    if plan is not None and not isinstance(plan, str):
        raise BadRequest("plan must be a registered plan name (string)")
    try:
        return dict(prompt=np.asarray(prompt, np.int32),
                    max_new_tokens=int(body.get("max_new_tokens", 16)),
                    temperature=float(body.get("temperature", 0.0)),
                    top_k=int(body.get("top_k", 0)),
                    eos_id=eos, plan=plan,
                    priority=int(body.get("priority", 0)))
    except (TypeError, ValueError, OverflowError) as e:
        raise BadRequest(str(e))


class _Completion:
    """Per-request queue seam between the pump thread and one connection.

    The pump (holding the engine lock) produces ``("delta", text)``
    events through the request's streaming callback and one terminal
    ``("done", Result)`` at retirement; the connection thread consumes
    them without ever touching the lock.  Queue puts never block, so
    token generation is never throttled by a slow reader -- a reader
    that went away surfaces as a failed write, not a stalled engine.
    """

    def __init__(self):
        self.events: "queue.Queue[Tuple[str, Any]]" = queue.Queue()

    def on_delta(self, uid: int, delta: str) -> None:
        self.events.put((_DELTA, delta))

    def finish(self, result: Result) -> None:
        self.events.put((_DONE, result))


class ApiServer:
    """HTTP front end over one engine: pump thread + engine lock.

    ``port=0`` binds an ephemeral port (``self.port`` has the real one).
    ``decode`` overrides the incremental detokenizer (``ids -> text``;
    default is the synthetic ``default_decode``).  Use as a context
    manager or call ``start()``/``close()`` explicitly; ``close()``
    cancels every in-flight request so the engine is handed back drained.
    """

    #: idle wait bound: also the cadence at which blocked waiters notice
    #: server shutdown (matches WallClock.MAX_SLEEP_S)
    POLL_S = 0.05

    def __init__(self, engine: Engine, *, host: str = "127.0.0.1",
                 port: int = 0, decode: Optional[Callable] = None,
                 verbose: bool = False):
        self.engine = engine
        self.decode = decode
        self.verbose = verbose
        #: THE engine lock: every touch of the engine -- step, submit,
        #: cancel, stats -- happens under it, from whichever thread
        self.lock = threading.Lock()
        #: control actions waiting for or holding the lock; the pump lets
        #: them go first before its next step
        self._controls = 0
        self._controls_cv = threading.Condition()
        self._wake = threading.Event()      # submission -> pump wakes
        self._stop = threading.Event()
        self._live: Dict[int, _Completion] = {}     # uid -> waiting conn
        self._next_uid = 0
        self._requests_total = 0
        #: the exception a step raised on the pump thread (None: none)
        self.error: Optional[BaseException] = None
        api = self

        class _BoundHandler(_Handler):
            server_api = api

        self.httpd = ThreadingHTTPServer((host, port), _BoundHandler)
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]
        self._pump_thread = threading.Thread(target=self._pump,
                                             name="engine-pump", daemon=True)
        self._http_thread = threading.Thread(target=self.httpd.serve_forever,
                                             name="http-accept", daemon=True)
        self._started = False

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ApiServer":
        self._t0 = self.engine.clock.now()
        self._pump_thread.start()
        self._http_thread.start()
        self._started = True
        return self

    def close(self) -> None:
        """Stop the pump and listener, abort anything still in flight
        (waiters get an ``aborted_server_shutdown`` result), and leave
        the engine drained: no live slots, no queued work, no claimed
        uids, every page back in the pool.  Re-raises the error a step
        raised on the pump thread, if one did."""
        self._stop.set()
        self._wake.set()
        if self._started:
            self._pump_thread.join(timeout=60)
            if self._pump_thread.is_alive():
                raise RuntimeError("the engine pump did not stop within 60 s")
        with self.lock:
            self._abort_all("aborted_server_shutdown")
        self.httpd.shutdown()
        if self._started:
            self._http_thread.join(timeout=10)
        self.httpd.server_close()
        if self.error is not None:
            raise RuntimeError("an engine step failed on the pump thread"
                               ) from self.error

    def __enter__(self) -> "ApiServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    @contextmanager
    def control(self):
        """Hold the engine lock for a short control action, ahead of the
        pump's next step."""
        with self._controls_cv:
            self._controls += 1
        try:
            with self.lock:
                yield
        finally:
            with self._controls_cv:
                self._controls -= 1
                self._controls_cv.notify_all()

    # ------------------------------------------------------------------ #
    # Pump thread
    # ------------------------------------------------------------------ #
    def _retire(self) -> None:
        """Pop finished records (releasing them + their uid claims) and
        hand each result to its waiting connection.  Lock held."""
        for res in self.engine.pop_finished():
            comp = self._live.pop(res.uid, None)
            if comp is not None:
                comp.finish(res)

    def _abort_all(self, reason: str) -> None:
        """Cancel every request still in flight and deliver the aborted
        results to their waiters.  Lock held."""
        for uid in list(self._live):
            self.engine.cancel(uid, reason=reason)
        self._retire()

    def _pump(self) -> None:
        """Drive ``Engine.step()`` on the engine's device; a step that
        raises stops the server (``_pump_loop``)."""
        dev = self.engine.device
        try:
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    self._pump_loop()
            else:
                self._pump_loop()
        except BaseException as e:      # surfaced by close(), never hidden
            self.error = e
            self._stop.set()
            with self.lock:
                self._abort_all("aborted_server_error")

    def _pump_loop(self) -> None:
        """Drive ``Engine.step()`` while anything is runnable; otherwise
        sleep -- toward the next scheduled arrival through the clock
        (never a busy spin), or on the wake event when nothing is
        pending at all (a fresh submission sets it)."""
        eng = self.engine
        while not self._stop.is_set():
            with self._controls_cv:         # control actions go first
                self._controls_cv.wait_for(lambda: not self._controls,
                                           timeout=self.POLL_S)
            with self.lock:
                self._wake.clear()
                nxt = eng.next_arrival()
                runnable = (not eng.sched.done()
                            or (nxt is not None
                                and nxt <= eng.clock.now()))
                if runnable:
                    eng.step()
                    self._retire()
                    nxt = eng.next_arrival()
            if runnable:
                continue
            if nxt is not None and not self._wake.is_set():
                # idle but an arrival is scheduled: the clock owns the
                # wait policy (wall sleeps capped at MAX_SLEEP_S, virtual
                # jumps), so the loop re-checks promptly either way
                eng.clock.sleep_until(nxt)
            else:
                self._wake.wait(self.POLL_S)

    # ------------------------------------------------------------------ #
    # Handler-facing control plane (each call takes the lock briefly)
    # ------------------------------------------------------------------ #
    def submit(self, body: Any) -> Tuple[int, _Completion, bool]:
        """Validate and submit one completion request; returns
        ``(uid, completion queue, streaming?)``.  Uids are server-
        assigned (monotonic), so concurrent clients never collide."""
        kw = _parse_completion(body)
        stream = bool(body.get("stream", False))
        comp = _Completion()
        with self.control():
            uid = self._next_uid
            self._next_uid += 1
            req = Request(uid=uid,
                          stream=comp.on_delta if stream else None,
                          detok=self.decode if self.decode is not None
                          else True, **kw)
            self._live[uid] = comp
            self.engine.submit(req)
            self._requests_total += 1
        self._wake.set()
        return uid, comp, stream

    def abort(self, uid: int, reason: str = "aborted_disconnect") -> None:
        """Cancel a request whose connection went away: release its
        slot/pages/uid immediately and stop tracking its queue."""
        with self.control():
            self._live.pop(uid, None)
            if self.engine.cancel(uid, reason=reason):
                self._retire()

    def stats(self) -> Dict[str, Any]:
        """Engine counters + per-plan view + server gauges, all finite
        host numbers (nothing here reads the device)."""
        with self.control():
            eng = self.engine
            live = sum(t is not None for t in eng.sched.slots)
            queued = len(eng.sched.waiting)
            # engine wall_s is per-serve() and never stamped on the pump
            # path; the server's natural window is its own uptime
            up = max(eng.clock.now() - getattr(self, "_t0", eng.clock.now()),
                     0.0)
            tok = eng.stats["prefill_tokens"] + eng.stats["decode_tokens"]
            payload = {
                "engine": dict(eng.stats),
                "plans": eng.plan_stats(),
                "uptime_s": up,
                "throughput_tok_per_s": tok / up if up > 0 else 0.0,
                "server": {
                    "live_requests": live,
                    "queued_requests": queued,
                    "pending_arrivals": len(eng._pending),
                    "open_completions": len(self._live),
                    "requests_total": self._requests_total,
                },
            }
        return _finite(payload)

    def stopping(self) -> bool:
        return self._stop.is_set()


class _Handler(BaseHTTPRequestHandler):
    """One instance per request (ThreadingHTTPServer: one thread per
    connection).  ``server_api`` is bound by ApiServer at construction."""

    server_api: ApiServer
    protocol_version = "HTTP/1.1"       # required for chunked streaming

    def log_message(self, fmt, *args):      # quiet by default
        if self.server_api.verbose:
            BaseHTTPRequestHandler.log_message(self, fmt, *args)

    # -------------------------------------------------------------- #
    def _json(self, code: int, obj: Any) -> None:
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _chunk(self, text: str) -> None:
        data = text.encode()
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _end_chunks(self) -> None:
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()

    # -------------------------------------------------------------- #
    def do_GET(self) -> None:
        if self.path == "/health":
            self._json(200, {"ok": True})
        elif self.path == "/v1/stats":
            self._json(200, self.server_api.stats())
        else:
            self._json(404, {"error": f"unknown path {self.path!r}"})

    def do_POST(self) -> None:
        # always drain the body first: leaving it unread desyncs the
        # keep-alive stream (the next request line would parse as junk)
        raw = self.rfile.read(int(self.headers.get("Content-Length") or 0))
        if self.path != "/v1/completions":
            self._json(404, {"error": f"unknown path {self.path!r}"})
            return
        api = self.server_api
        try:
            body = json.loads(raw or b"null")
            uid, comp, stream = api.submit(body)
        except (BadRequest, json.JSONDecodeError) as e:
            self._json(400, {"error": str(e)})
            return
        try:
            if stream:
                self._stream_completion(uid, comp)
            else:
                self._block_completion(uid, comp)
        except (BrokenPipeError, ConnectionResetError, OSError):
            # the client went away mid-response: release everything the
            # request holds (slot, pages, uid claim) right now
            api.abort(uid)

    # -------------------------------------------------------------- #
    def _next_event(self, comp: _Completion) -> Optional[Tuple[str, Any]]:
        """Wait for the request's next event, surfacing server shutdown
        as None (the pump or close() will already have delivered an
        aborted result when they cancelled us, so this is only a
        backstop)."""
        while True:
            try:
                return comp.events.get(timeout=ApiServer.POLL_S)
            except queue.Empty:
                if self.server_api.stopping() and comp.events.empty():
                    return None

    def _block_completion(self, uid: int, comp: _Completion) -> None:
        while True:
            ev = self._next_event(comp)
            if ev is None:
                self._json(503, {"error": "server shutting down",
                                 "uid": uid})
                return
            kind, payload = ev
            if kind == _DONE:       # non-streamed: deltas cannot occur
                self._json(200, _result_json(payload))
                return

    def _stream_completion(self, uid: int, comp: _Completion) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        while True:
            ev = self._next_event(comp)
            if ev is None:
                self._chunk(json.dumps({"error": "server shutting down",
                                        "uid": uid}) + "\n")
                self._end_chunks()
                return
            kind, payload = ev
            if kind == _DELTA:
                self._chunk(json.dumps({"delta": payload}) + "\n")
            else:
                self._chunk(json.dumps(
                    {"done": True, "result": _result_json(payload)}) + "\n")
                self._end_chunks()
                return
