"""Import guard for the PyTorch port: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports ``jax`` or anything of the reference package
``repro``, and an entry point called without ``device=`` raises when CUDA
is absent instead of carrying on quietly on the CPU."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARD = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {src!r}); sys.path.insert(0, {root!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
assert len(names) > 30, names
# the server, detok and NAEE modules are walked like every other
for m in ("repro_torch.serving.http", "repro_torch.serving.detok",
          "repro_torch.launch.api_server", "repro_torch.core.skipping"):
    assert m in names, m
import torch
if not torch.cuda.is_available():
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    try:
        init_params(get_config("olmoe-1b-7b").reduced(), 0)
    except RuntimeError as e:
        assert "CUDA" in str(e)
    else:
        raise AssertionError("init_params ran without CUDA and device=")
print("GUARD-OK", len(names))
"""


def test_port_imports_no_jax_and_entry_points_need_a_device():
    code = GUARD.format(src=os.path.join(ROOT, "src"), root=ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "GUARD-OK" in r.stdout


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
