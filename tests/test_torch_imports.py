"""Import hygiene of the port: ``bigdl_tpu_torch`` and ``chip_smoke.py``
load neither JAX nor the reference package, neither importing them nor
running the plain versions on the CPU builds or loads a kernel, and a
kernel build that fails raises."""

import json
import os
import pkgutil
import subprocess
import sys

import pytest

import bigdl_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import torch
import bigdl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(bigdl_tpu_torch.__path__,
                                               "bigdl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from bigdl_tpu_torch.ops import _build, int8_gemm
x = torch.ones(3, 8)
int8_gemm.int8_matmul(x, torch.ones(4, 8, dtype=torch.int8), torch.ones(4),
                      mode="dynamic")
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.startswith("jaxlib") or m == "bigdl_tpu"
             or m.startswith("bigdl_tpu."))
print(json.dumps({"modules": len(names), "bad": bad,
                  "libs": sorted(_build._libs)}))
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert got["libs"] == []
    expected = len(list(pkgutil.walk_packages(bigdl_tpu_torch.__path__,
                                              "bigdl_tpu_torch.")))
    assert got["modules"] == expected >= 20


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that refuses the source raises KernelBuildError with its
    message, and leaves no library behind: there is no fallback."""
    from bigdl_tpu_torch.ops import _build
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: source refused' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(_build.KernelBuildError, match="source refused"):
        _build.load("int8_gemm")
    assert not list((tmp_path / "kernels").iterdir())
