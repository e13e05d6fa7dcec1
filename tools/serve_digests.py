#!/usr/bin/env python3
"""Run one checkout's ``chip_smoke.py`` whole and print a digest of the
tokens of every serve it checks, on one NVIDIA GPU.

    python3 tools/serve_digests.py [--root DIR] [--out FILE]

Imports ``DIR/chip_smoke.py`` (default: this checkout), wraps its
``check_results`` (which every serve phase calls on its results) so that
each call records a sha256 over its requests' uids and tokens under the
call's tag, runs its ``main`` as ``python3 chip_smoke.py`` would (its own
lines first), and prints ``{"serve_digests": {tag: [digest, ...]}}`` last
(also written to ``--out``).  Run it on a ``git archive`` of the parent in
a gitignored directory and on this checkout in one call, and compare the
maps: equal digests mean every serve gave the same tokens.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tokens_digest(results) -> str:
    h = hashlib.sha256()
    for r in sorted(results, key=lambda r: r.uid):
        h.update(repr((r.uid, list(map(int, r.tokens)))).encode())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose chip_smoke.py runs")
    ap.add_argument("--out", default=None, help="also write the map here")
    args = ap.parse_args()
    path = os.path.join(os.path.abspath(args.root), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)
    seen = {}
    check = smoke.check_results

    def recorded(tag, results, *a, **kw):
        seen.setdefault(tag, []).append(tokens_digest(results))
        return check(tag, results, *a, **kw)
    smoke.check_results = recorded
    sys.argv = [path]
    rc = smoke.main()
    line = json.dumps({"serve_digests": seen}, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
