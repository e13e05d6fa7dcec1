"""HTTP API server launcher: the continuous engine loop behind a port, on
the card by default.

    PYTHONPATH=src python -m repro_torch.launch.api_server \
        --arch olmoe-1b-7b --port 8080 --moe-impl gmm --use-kernel \
        --use-moe-decode --use-moe-kernel --lexi-budget-frac 0.5

    # then, from any HTTP client:
    curl -s localhost:8080/health
    curl -s localhost:8080/v1/stats
    curl -s -X POST localhost:8080/v1/completions -d \
        '{"prompt": [1, 2, 3], "max_new_tokens": 8}'
    curl -sN -X POST localhost:8080/v1/completions -d \
        '{"prompt": [1, 2, 3], "max_new_tokens": 8, "stream": true,
          "plan": "lexi"}'

    # the plain PyTorch path on the CPU, at test size, as a self-check
    PYTHONPATH=src python -m repro_torch.launch.api_server \
        --arch olmoe-1b-7b --reduced --device cpu --smoke --port 0

One engine, one pump thread, many connections (``serving/http.py``).  A
LExI plan searched (``--lexi-budget-frac``, through ``core.optimize``) or
loaded (``--plan``) at startup is registered under the name ``"lexi"`` and
selectable per request with ``"plan": "lexi"`` in the completion body --
the paper's layer-adaptive budget as a per-request serving knob over one
set of weights.

The flags are the reference launcher's, plus ``--device`` and the kernel
and impl switches of ``launch/serve.py``: the port's ``ModelOpts`` keep
every kernel off by default, so a server on the card passes
``--use-kernel --use-moe-decode --use-moe-kernel`` (and ``--moe-impl
gmm`` for the dropless dispatch; the config's own impl is ``dense``).
Weights are random, drawn on the device from ``--seed``.

``--smoke`` starts the server in-process, runs one non-streamed and one
streamed completion (and one under ``"lexi"`` when a plan is registered)
plus a stats scrape through ``http.client``, verifies the streamed deltas
concatenate to the final text and equal the non-streamed tokens, shuts
down cleanly, frees the engine and its weights, and exits 0.
"""

from __future__ import annotations

import argparse
import gc
import http.client
import json

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.serving import ApiServer, Engine


def build_engine(args) -> Engine:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    impl = args.moe_impl or ("gmm" if args.expert_dtype != "bf16" else None)
    if impl is not None:
        cfg = cfg.with_(moe_impl=impl)
    params = models.init_params(cfg, args.seed, device=args.device)
    opts = models.ModelOpts(use_moe_kernel=args.use_moe_kernel,
                            use_flash=args.use_flash,
                            use_flash_decode=args.use_flash_decode)
    eng = Engine(cfg, params, max_batch=args.max_batch, max_len=args.max_len,
                 prefill_chunk=args.prefill_chunk,
                 cache_layout=args.cache_layout, num_pages=args.num_pages,
                 use_kernel=args.use_kernel or None,
                 use_moe_decode=args.use_moe_decode or None,
                 expert_dtype=args.expert_dtype,
                 router_lookahead=args.router_lookahead or None,
                 prefix_cache=args.prefix_cache, scheduler=args.scheduler,
                 admission=args.admission, opts=opts, seed=args.seed,
                 device=args.device)
    if args.plan is not None:
        from repro_torch.core import LexiPlan
        eng.add_plan("lexi", LexiPlan.load(args.plan))
    elif (args.lexi_budget_frac is not None and cfg.is_moe
          and cfg.moe_top_k > 1):
        from repro_torch.core import optimize
        n = cfg.num_moe_layers
        budget = max(n, int(round(args.lexi_budget_frac * n * cfg.moe_top_k)))
        eng.add_plan("lexi", optimize(
            params, cfg, budget, method="dp", n_iter=4, profile_batch=2,
            profile_seq=32, seed=args.seed, device=args.device,
            use_kernel=args.use_moe_kernel))
    return eng


def _smoke(api: ApiServer, vocab: int) -> dict:
    """One of everything through a real socket; raises on any mismatch.
    Returns the last ``/v1/stats`` scrape."""
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, vocab, 12).tolist()

    conn = http.client.HTTPConnection(api.host, api.port, timeout=600)
    conn.request("GET", "/health")
    assert json.loads(conn.getresponse().read())["ok"] is True

    body = json.dumps({"prompt": prompt, "max_new_tokens": 8})
    conn.request("POST", "/v1/completions", body=body)
    res = json.loads(conn.getresponse().read())
    assert res["finished_reason"] == "length" and len(res["tokens"]) == 8, res
    print(f"smoke non-streamed: uid={res['uid']} text={res['text']!r}")

    conn.request("POST", "/v1/completions",
                 body=json.dumps({"prompt": prompt, "max_new_tokens": 8,
                                  "stream": True}))
    lines = [json.loads(ln) for ln in
             conn.getresponse().read().decode().splitlines()]
    deltas = [ev["delta"] for ev in lines if "delta" in ev]
    final = lines[-1]
    assert final.get("done") and "".join(deltas) == final["result"]["text"]
    # deterministic greedy decode: the streamed run must match the
    # non-streamed one token for token
    assert final["result"]["tokens"] == res["tokens"]
    print(f"smoke streamed: {len(deltas)} deltas, "
          f"text={final['result']['text']!r}")
    n_req = 2

    if "lexi" in api.engine.runner.plans:
        conn.request("POST", "/v1/completions",
                     body=json.dumps({"prompt": prompt, "max_new_tokens": 8,
                                      "plan": "lexi"}))
        lx = json.loads(conn.getresponse().read())
        assert lx["served_plan"] == "lexi" and len(lx["tokens"]) == 8, lx
        print(f"smoke lexi: text={lx['text']!r}")
        n_req += 1

    conn.request("GET", "/v1/stats")
    stats = json.loads(conn.getresponse().read())
    assert stats["server"]["requests_total"] == n_req
    assert stats["server"]["open_completions"] == 0
    eng = stats["engine"]
    steps = max(eng["steps"], 1)
    print(f"smoke stats: decode_tokens={eng['decode_tokens']} "
          f"tput={stats['throughput_tok_per_s']:.1f} tok/s "
          f"decode_step={eng['decode_s'] / steps * 1e3:.2f}ms "
          f"host={eng['decode_host_s'] / steps * 1e3:.2f}ms")
    conn.close()
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--num-pages", type=int, default=None)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked-prefill width (0: whole-prompt prefill, "
                         "contiguous layout only)")
    ap.add_argument("--cache-layout", choices=("paged", "contiguous"),
                    default=None, help="KV layout (default: paged; "
                    "contiguous for a stack with mamba blocks, which "
                    "cannot page)")
    ap.add_argument("--use-kernel", action="store_true",
                    help="paged decode attends pages in-kernel "
                         "(flash_decode_paged / flash_decode_paged_mla)")
    ap.add_argument("--moe-impl", choices=("dense", "gmm"), default=None,
                    help="MoE dispatch (default: the config's own, dense; "
                         "gmm with --expert-dtype int8/int4)")
    ap.add_argument("--use-moe-decode", action="store_true",
                    help="decode steps run MoE through the fused "
                         "routed-expert path (gmm only)")
    ap.add_argument("--use-moe-kernel", action="store_true",
                    help="expert FFNs run the moe_ffn (dense) or moe_gmm / "
                         "moe_decode (gmm) kernels")
    ap.add_argument("--use-flash", action="store_true",
                    help="whole-prompt prefill attention through the "
                         "flash_attention kernel")
    ap.add_argument("--use-flash-decode", action="store_true",
                    help="decode attention over a contiguous view through "
                         "the flash_decode kernel")
    ap.add_argument("--router-lookahead", action="store_true",
                    help="predict each MoE layer's expert ids one layer "
                         "ahead on decode steps (a numeric no-op)")
    ap.add_argument("--expert-dtype", choices=["bf16", "int8", "int4"],
                    default="bf16")
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--scheduler", choices=["fifo", "sjf"], default="fifo")
    ap.add_argument("--admission", default="headroom")
    ap.add_argument("--lexi-budget-frac", type=float, default=None,
                    help="search a plan at startup; serve it per request "
                         "with plan=lexi")
    ap.add_argument("--plan", default=None,
                    help="path to a saved LexiPlan JSON (registered as lexi)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080,
                    help="0 binds an ephemeral port")
    ap.add_argument("--smoke", action="store_true",
                    help="start, run one streamed + one non-streamed "
                         "completion in-process, shut down, exit")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    eng = build_engine(args)
    vocab = eng.cfg.vocab_size
    try:
        with ApiServer(eng, host=args.host, port=args.port,
                       verbose=not args.smoke) as api:
            print(f"serving {eng.cfg.name} at {api.url} on {eng.device} "
                  f"(plans: {sorted(eng.runner.plans)})", flush=True)
            if args.smoke:
                _smoke(api, vocab)
                print("smoke ok")
                return 0
            try:
                while True:
                    api._http_thread.join(timeout=3600)
            except KeyboardInterrupt:
                print("\nshutting down")
        return 0
    finally:
        # the server's handler class refers back to it, a reference cycle
        # that holds the engine: collect it, so that the engine, its
        # weights and its CUDA graphs are freed before this returns
        device = eng.device
        del eng
        api = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    raise SystemExit(main())
