"""The concurrency lint (graftlint GL2xx/GL3xx) over the port's threaded
modules: the serving batcher and service, the decode engine, the breaker
and the replica set with its health ledgers, the wire front end, the fault
injector and the membership ledger, the telemetry plane (registry, tracer, flight
recorder, admin server), the block prefetchers, the snapshot writer
thread, the checkpoint manager's GC pin, the preemption handler, the
summary writer, the two sanitizers (lockdep, spmdcheck) and
``PredictionService``'s request count.

The reference's own gate (``tests/test_graftlint.py``) lints
``bigdl_tpu/``; the port lies outside its default paths, so this file
holds the port's copies of the reference's threaded code to the same
rules.  The only suppressions allowed are the ones the reference makes
for the same code, with its reasons.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREADED = ["bigdl_tpu_torch/serving", "bigdl_tpu_torch/resilience",
            "bigdl_tpu_torch/telemetry", "bigdl_tpu_torch/dataset/prefetch.py",
            "bigdl_tpu_torch/checkpoint/snapshot.py",
            "bigdl_tpu_torch/checkpoint/manager.py",
            "bigdl_tpu_torch/checkpoint/preemption.py",
            "bigdl_tpu_torch/utils/summary.py",
            "bigdl_tpu_torch/utils/lockdep.py",
            "bigdl_tpu_torch/utils/spmdcheck.py",
            "bigdl_tpu_torch/optim/predictor.py",
            "bigdl_tpu_torch/frontend",
            "bigdl_tpu_torch/resilience/replica_set.py",
            "bigdl_tpu_torch/serving/decode.py"]


def _lint(*args):
    return subprocess.run(
        [sys.executable, "-m", "tools.graftlint", "--select", "GL2,GL3",
         *args, *THREADED], cwd=REPO, capture_output=True, text=True,
        timeout=300)


def _suppressions(path):
    """{rule: count} of the ``graftlint: disable=`` comments in ``path``."""
    out = {}
    if os.path.exists(path):
        for line in open(path, encoding="utf-8"):
            if "graftlint: disable=" in line:
                rule = line.split("graftlint: disable=")[1].split()[0]
                out[rule] = out.get(rule, 0) + 1
    return out


@pytest.fixture(scope="module")
def report():
    r = _lint("--json")
    return r.returncode, json.loads(r.stdout)


def test_threaded_modules_lint_clean(report):
    rc, out = report
    assert out["violations"] == [], out["violations"]
    assert out["files_scanned"] >= 14 and rc == 0


def test_only_the_references_suppressions():
    """Each port file suppresses no rule more often than its reference twin
    (the same path under ``bigdl_tpu/``) does: the port carries the
    reference's suppressions, with their reasons, for the code it copied,
    and adds none of its own."""
    seen = {}
    for path in THREADED:
        full = os.path.join(REPO, path)
        files = ([full] if full.endswith(".py") else
                 [os.path.join(d, f) for d, _, fs in os.walk(full)
                  for f in fs if f.endswith(".py")])
        for f in files:
            rel = os.path.relpath(f, REPO)
            twin = os.path.join(REPO, "bigdl_tpu",
                                rel.split(os.sep, 1)[1])
            mine = _suppressions(f)
            if mine:
                seen[rel] = mine
                ref = _suppressions(twin)
                assert all(n <= ref.get(r, 0) for r, n in mine.items()), \
                    (rel, mine, ref)
    # the batcher's liveness read, pre-start write and retry-hint depth
    # sample, the metrics' fast-path read and the prefetcher's two
    # shutdown drains
    assert seen == {"bigdl_tpu_torch/serving/batcher.py": {"GL201": 3},
                    "bigdl_tpu_torch/serving/metrics.py": {"GL201": 1},
                    "bigdl_tpu_torch/dataset/prefetch.py": {"GL203": 2}}
