"""The port's HTTP front end (``serving/http.py``) and incremental
detokenization (``serving/detok.py``) against the JAX reference.

* Concurrent completions -- mixed streamed and blocking, base and a
  registered ``k1`` plan, priorities 0 and 1 -- through the port's
  ``ApiServer`` over real localhost sockets equal the reference engine's
  solo ``Engine.serve(detok=True)`` oracles in tokens and text, and every
  streamed response's deltas concatenate to its text.
* A client that walks away mid-stream releases its slot, pages and uid,
  and the next completion still equals its oracle.
* ``/v1/stats`` is strict finite JSON mid-flight; ``/health``.
* Bad bodies get 400, unknown paths 404, an unknown plan a rejected
  result.
* Detok on the engine: deltas concatenate to the full detok (and equal
  the reference's text), detok off streams token ids, ``serve(detok=)``
  never mutates the caller's requests, a decode function that is not
  prefix-monotone raises.
* ``launch/api_server.py --smoke`` runs on the CPU; on the card its smoke
  runs the kernels (skipped elsewhere).

Tiny f32 OLMoE cut on ``gmm``, the reference's weights converted.  Each
JAX oracle is computed once (``oracles``) on an engine of one slot, which
blocks on each step (``_synchronous``: its CPU block table is updated in
place while an asynchronous step may still read it).
"""

import http.client
import json
import math
import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

MAX_NEW = 6
#: (prompt_len, plan, priority, stream), as the reference's HTTP test
SPECS = [(5, None, 0, True), (9, "k1", 0, False), (13, None, 1, True),
         (7, "k1", 1, True), (6, None, 0, False), (11, "k1", 0, True)]


def _synchronous(engine):
    """Block on each of the JAX engine's device steps before it goes on."""
    import jax
    for name in ("chunk_prefill", "decode"):
        fn = getattr(engine.runner, name)
        setattr(engine.runner, name,
                lambda *a, fn=fn, **kw: jax.block_until_ready(fn(*a, **kw)))
    return engine


def _prompt(n, seed, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


@pytest.fixture(scope="module")
def model():
    import jax
    from repro import models as jm
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    from repro_torch.convert import convert_params
    kw = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
              head_dim=32, num_experts=4, moe_top_k=2, moe_d_ff=64,
              vocab_size=128, vocab_pad_multiple=16, dtype="float32",
              moe_impl="gmm")
    cfg_j = jget("olmoe-1b-7b").reduced().with_(**kw)
    cfg_t = tget("olmoe-1b-7b").reduced().with_(**kw)
    pj = jax.jit(lambda k: jm.init_params(k, cfg_j))(jax.random.PRNGKey(0))
    pt = convert_params(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    return cfg_j, cfg_t, pj, pt


@pytest.fixture(scope="module")
def oracles(model):
    """The reference engine's solo serve of each of SPECS, with detok on:
    one slot, so every request runs alone -> [(tokens, text)]."""
    from repro.core import uniform_plan
    from repro.serving import Engine, Request
    cfg_j, _, pj, _ = model
    eng = _synchronous(Engine(cfg_j, pj, max_batch=1, max_len=64))
    eng.add_plan("k1", uniform_plan(cfg_j, 1))
    res = eng.serve([Request(uid=i, prompt=_prompt(n, seed=i),
                             max_new_tokens=MAX_NEW, plan=plan,
                             priority=prio)
                     for i, (n, plan, prio, _) in enumerate(SPECS)],
                    detok=True)
    return [(r.tokens, r.text) for r in res]


@pytest.fixture(scope="module")
def engine(model):
    """The port's engine every server test shares (each server hands it
    back drained)."""
    from repro_torch.core import uniform_plan
    from repro_torch.serving import Engine
    _, cfg_t, _, pt = model
    eng = Engine(cfg_t, pt, max_batch=4, max_len=256, device="cpu")
    eng.add_plan("k1", uniform_plan(cfg_t, 1))
    return eng


def _post(api, body, timeout=180):
    """One completion over a real socket; returns (status, events) where
    events is the parsed NDJSON line list (streamed) or [result]."""
    conn = http.client.HTTPConnection(api.host, api.port, timeout=timeout)
    try:
        conn.request("POST", "/v1/completions", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read().decode()
        if resp.status != 200:
            return resp.status, [json.loads(raw)]
        if isinstance(body, dict) and body.get("stream"):
            return 200, [json.loads(ln) for ln in raw.splitlines()]
        return 200, [json.loads(raw)]
    finally:
        conn.close()


def _clean(api, eng, free0):
    with api.control():
        return (not api._live and eng.sched.done() and not eng.sched._uids
                and eng.kv.free_pages() == free0)


# --------------------------------------------------------------------------- #
# HTTP layer
# --------------------------------------------------------------------------- #


def test_concurrent_streams_match_reference_solo_oracles(engine, oracles):
    from repro_torch.serving import ApiServer, default_decode
    got = [None] * len(SPECS)

    def worker(i):
        n, plan, prio, stream = SPECS[i]
        body = {"prompt": _prompt(n, seed=i).tolist(),
                "max_new_tokens": MAX_NEW, "priority": prio,
                "stream": stream}
        if plan:
            body["plan"] = plan
        got[i] = _post(api, body)

    with ApiServer(engine) as api:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(SPECS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    assert api.error is None
    for i, (n, plan, prio, stream) in enumerate(SPECS):
        status, events = got[i]
        assert status == 200, events
        final = events[-1]
        res = final["result"] if stream else final
        assert (res["tokens"], res["text"]) == oracles[i], \
            f"request {i} diverged from its solo oracle"
        assert res["served_plan"] == (plan or "base")
        assert res["finished_reason"] in ("length", "eos")
        if stream:
            assert final.get("done") is True
            assert all("delta" in ev for ev in events[:-1])
            assert "".join(ev["delta"] for ev in events[:-1]) == res["text"]
            assert res["text"] == default_decode(res["tokens"])
    # the server handed the engine back clean: no leaked records or claims
    assert engine.sched._uids == set() and engine.sched.finished == []


def test_client_disconnect_releases_pages_and_uid(engine, oracles):
    """An abandoned stream must not wedge the engine: the failed delta
    write maps to Engine.cancel, releasing the slot, its KV pages, and
    (via retirement) the uid claim; the next completion is exact."""
    from repro_torch.serving import ApiServer
    free0 = engine.kv.free_pages()
    with ApiServer(engine) as api:
        body = json.dumps({"prompt": list(range(1, 6)),
                           "max_new_tokens": 200, "stream": True}).encode()
        s = socket.create_connection((api.host, api.port), timeout=60)
        s.sendall(b"POST /v1/completions HTTP/1.1\r\n"
                  b"Host: t\r\nContent-Length: "
                  + str(len(body)).encode() + b"\r\n\r\n" + body)
        s.recv(4096)        # headers (and possibly the first deltas)
        s.close()           # walk away mid-stream
        deadline = time.monotonic() + 30
        clean = False
        while time.monotonic() < deadline and not clean:
            clean = _clean(api, engine, free0)
            time.sleep(0.02)
        assert clean, "disconnect did not release pages/uid/records"
        status, (res,) = _post(api, {"prompt": _prompt(SPECS[1][0], 1)
                                     .tolist(), "plan": "k1",
                                     "max_new_tokens": MAX_NEW})
    assert status == 200 and (res["tokens"], res["text"]) == oracles[1]
    assert engine.kv.free_pages() == free0 and engine.sched._uids == set()


def test_stats_finite_and_health_midflight(engine):
    """/v1/stats must be valid strict JSON (no NaN/Infinity) at any
    moment, including while requests are live."""
    from repro_torch.serving import ApiServer

    def no_const(name):
        raise AssertionError(f"non-finite {name} in /v1/stats")

    def check_finite(x):
        if isinstance(x, dict):
            for v in x.values():
                check_finite(v)
        elif isinstance(x, float):
            assert math.isfinite(x)

    done = threading.Event()

    def long_request():
        _post(api, {"prompt": [3, 1, 4, 1, 5], "max_new_tokens": 150,
                    "stream": True})
        done.set()

    with ApiServer(engine) as api:
        conn = http.client.HTTPConnection(api.host, api.port, timeout=60)
        conn.request("GET", "/health")
        assert json.loads(conn.getresponse().read())["ok"] is True
        t = threading.Thread(target=long_request)
        t.start()
        saw_live = False
        while not done.is_set():
            conn.request("GET", "/v1/stats")
            stats = json.loads(conn.getresponse().read(),
                               parse_constant=no_const)
            check_finite(stats)
            saw_live |= (stats["server"]["live_requests"] > 0
                         or stats["server"]["open_completions"] > 0)
            time.sleep(0.01)
        t.join(timeout=60)
        conn.request("GET", "/v1/stats")
        stats = json.loads(conn.getresponse().read(),
                           parse_constant=no_const)
        conn.close()
    assert saw_live, "never scraped stats with a request in flight"
    assert stats["server"]["open_completions"] == 0
    assert stats["engine"]["decode_tokens"] > 0
    assert stats["throughput_tok_per_s"] > 0


def test_bad_requests_rejected(engine):
    from repro_torch.serving import ApiServer
    with ApiServer(engine) as api:
        for body in ({},                                # no prompt
                     {"prompt": []},                    # empty
                     {"prompt": "abc"},                 # not ids
                     {"prompt": [1, 2], "nope": 1},     # unknown field
                     {"prompt": [1, 2], "eos_id": "x"},
                     [1, 2, 3]):                        # not an object
            status, (err,) = _post(api, body)
            assert status == 400 and "error" in err, body
        # syntactically broken JSON
        conn = http.client.HTTPConnection(api.host, api.port, timeout=60)
        for method, path, body, want in (
                ("POST", "/v1/completions", "{nope", 400),
                ("GET", "/nope", None, 404),
                ("POST", "/nope", "{nope", 404)):
            conn.request(method, path, body=body)
            resp = conn.getresponse()
            resp.read()     # drain: keep-alive needs a finished response
            assert resp.status == want, (method, path)
        conn.close()
        # semantic rejection rides the normal result path
        status, (res,) = _post(api, {"prompt": [1, 2, 3],
                                     "plan": "not-registered"})
        assert status == 200
        assert res["finished_reason"] == "rejected_unknown_plan"
    assert engine.sched._uids == set() and engine.sched.finished == []


# --------------------------------------------------------------------------- #
# Incremental detokenization on the engine
# --------------------------------------------------------------------------- #


def _detok_deltas(engine, oracles):
    """Streamed deltas concatenate to the full detok, which is the
    reference's text for the same requests."""
    from repro_torch.serving import Request, default_decode
    deltas = {0: [], 2: []}
    reqs = [Request(uid=i, prompt=_prompt(SPECS[i][0], seed=i),
                    max_new_tokens=MAX_NEW, detok=True,
                    stream=lambda uid, d: deltas[uid].append(d))
            for i in (0, 2)]
    for r in engine.serve(reqs):
        assert r.tokens, "workload generated nothing to stream"
        assert "".join(deltas[r.uid]) == default_decode(r.tokens) == r.text
        assert (r.tokens, r.text) == oracles[r.uid]


def _detok_off_streams_ids(engine, oracles):
    from repro_torch.serving import Request
    seen = []
    (r,) = engine.serve([Request(uid=0, prompt=_prompt(SPECS[0][0], 0),
                                 max_new_tokens=MAX_NEW,
                                 stream=lambda uid, tok: seen.append(tok))])
    assert seen == r.tokens == oracles[0][0]
    assert r.text == ""


def _serve_detok_never_mutates(engine, oracles):
    """serve(detok=) is a workload default stamped on the engine's record,
    not written back onto the caller's Request: a request list reused
    across serves comes back unchanged, and the second serve (no detok=)
    streams no text."""
    from repro_torch.serving import Request
    decode = lambda ids: " ".join(str(i) for i in ids) + " "    # noqa: E731
    reqs = [Request(uid=i, prompt=_prompt(SPECS[i][0], seed=i),
                    max_new_tokens=MAX_NEW) for i in (0, 4)]
    out1 = engine.serve(reqs, detok=decode)
    assert all(r.text == decode(r.tokens) for r in out1)
    assert all(r.detok is False for r in reqs)
    out2 = engine.serve(reqs)
    assert all(r.text == "" for r in out2)
    assert [r.tokens for r in out2] == [r.tokens for r in out1]


def _non_monotone_decode_raises(engine, oracles):
    from repro_torch.serving import Engine, IncrementalDetok, Request
    d = IncrementalDetok()
    assert (d.push(1), d.push(42), d.text) == ("<1>", "<42>", "<1><42>")
    bad = lambda ids: str(ids[-1])      # noqa: E731
    d = IncrementalDetok(bad)
    d.push(12)
    with pytest.raises(ValueError, match="prefix-monotone"):
        d.push(3)
    # in a serve too (on an engine of its own: the raise leaves it mid-step)
    eng = Engine(engine.runner.base_cfg, engine.runner.params, max_batch=1,
                 max_len=64, device="cpu")
    with pytest.raises(ValueError, match="prefix-monotone"):
        eng.serve([Request(uid=0, prompt=_prompt(5, 0), max_new_tokens=4,
                           detok=lambda ids: str(len(ids)))])


@pytest.mark.parametrize("case", [_detok_deltas, _detok_off_streams_ids,
                                  _serve_detok_never_mutates,
                                  _non_monotone_decode_raises],
                         ids=["deltas", "off_ids", "no_mutation",
                              "non_monotone"])
def test_incremental_detok(engine, oracles, case):
    case(engine, oracles)


# --------------------------------------------------------------------------- #
# The launcher
# --------------------------------------------------------------------------- #


def test_api_server_smoke_on_cpu(capsys):
    from repro_torch.launch.api_server import main
    assert main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                 "--smoke", "--port", "0", "--moe-impl", "gmm",
                 "--use-moe-decode", "--lexi-budget-frac", "0.5"]) == 0
    out = capsys.readouterr().out
    assert "smoke ok" in out and "smoke lexi" in out and "on cpu" in out


def test_api_server_smoke_on_card(capsys, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a GPU")
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import api_server
    from repro_torch.launch.api_server import main
    # the reduced config in bf16, the kernels' type (reduced() is f32)
    monkeypatch.setattr(api_server, "get_config", lambda name: get_config(
        name).reduced().with_(dtype="bfloat16"))
    kernels.reset_launch_counts()
    assert main(["--arch", "olmoe-1b-7b", "--smoke", "--port",
                 "0", "--moe-impl", "gmm", "--use-kernel",
                 "--use-moe-decode", "--use-moe-kernel",
                 "--router-lookahead", "--lexi-budget-frac", "0.5"]) == 0
    assert "smoke ok" in capsys.readouterr().out
    counts = kernels.launch_counts()
    assert all(counts[n] > 0 for n in ("moe_gmm", "moe_decode",
                                       "flash_decode_paged")), counts
