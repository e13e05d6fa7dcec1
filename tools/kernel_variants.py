"""Build variants of the port's kernel sources for timing.

A variant is a dict: ``source``, a path from the root of the checkout to a
body built in the kernel source's place (default: the committed source);
``edits``, pairs [old, new] of text swapped in it (each old found exactly
once); and upper-case keys, launch constants (``constexpr int NAME = ...;``
or ``constexpr bool``) replaced by the key's value.  Other keys are the
caller's and are left alone.

``build`` writes each variant beside a copy of the sources under
``build/kernels/variants/<label>/`` and runs one ``nvcc`` each, all
started together.  ``repro_torch`` is imported from whatever checkout the
caller put first on ``sys.path``.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def source(name: str, variant: dict) -> str:
    """``csrc/<name>.cu`` (or the variant's own ``source``) with the
    variant's edits and constants applied."""
    from repro_torch.kernels import _build
    path = variant.get("source")
    text = (ROOT / path if path else _build.CSRC / f"{name}.cu").read_text()
    for old, new in variant.get("edits", ()):
        if text.count(old) != 1:
            raise RuntimeError(f"{name}.cu: {old!r} is not there once")
        text = text.replace(old, new)
    for key, val in variant.items():
        if not re.fullmatch(r"[A-Z][A-Z0-9_]*", key):
            continue
        text, n = re.subn(rf"constexpr (int|bool) {key} = \w+;",
                          rf"constexpr \1 {key} = {val};", text)
        if n != 1:
            raise RuntimeError(f"{name}.cu: no constant {key}")
    return text


def build(jobs: dict) -> dict:
    """Build ``jobs`` ({label: (source name, variant)}) at once; returns
    {label: (library, ptxas lines: entry, registers, spills, wgmma)}."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR / "variants"
    procs = {}
    for label, (name, variant) in jobs.items():
        d = out / label
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(_build.CSRC, d)
        (d / f"{name}.cu").write_text(source(name, variant))
        lib = d / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
               str(d / f"{name}.cu")]
        procs[label] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for label, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        libs[label] = (ctypes.CDLL(str(lib)), [
            ln.strip() for ln in log.splitlines()
            if any(w in ln for w in ("entry function", "registers", "spill",
                                     "wgmma"))])
    return libs
