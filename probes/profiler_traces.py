"""How often a torch.profiler session holds every kernel launched in it.

``chip_smoke.py`` times B1 (and the other kernels) from torch.profiler
sessions of 20 calls each (``device_ms``).  Now and then such a session's
trace holds no kernel, or fewer than half of the calls.  This probe counts,
session by session, the launches each trace holds at B1's calls at four of
Inception v1's pools (NHWC bf16, batch 256) and one of VGG's (NCHW f32,
batch 128), in four stages of one process:

- ``fresh``: the process's first sessions;
- ``nccl_alive``: with a world-1 NCCL group made and used by an
  all-reduce (the group ``DistriOptimizer`` starts when no launcher did);
- ``nccl_destroyed``: after that group is destroyed;
- ``after_cifar``: after ``chip_smoke.py``'s ``cifar`` phase at a small
  size (VGG and ResNet-20 through ``LocalOptimizer``, VGG through a world-1
  NCCL ``DistriOptimizer``, the bitwise block; its group destroyed).

Each session is taken twice in turn: as ``device_ms`` takes it, and with a
50 ms pause between the synchronize and the session's end.  Each stage
then runs ``chip_smoke.pool_row`` twice at each pool (B1 and the library
call, each through ``device_ms``) and counts the sessions it took and the
empty and short ones among them.  The script
runs the stages in one child process with ``TEARDOWN_CUPTI`` unset (the
profiler finalizes CUPTI at the end of every session) and in another with
``TEARDOWN_CUPTI=0`` (CUPTI stays attached).  Run on the card from the
repository root:

    python3 probes/profiler_traces.py

It prints a line per (variant, stage, pause) and writes every session's
counts to ``chiprun_out/profiler_traces_<TEARDOWN_CUPTI>.json``.

``python3 probes/profiler_traces.py after`` runs the pool rows alone at
three of Inception's pools in a fresh process, and after each of the
parts of ``chip_smoke.py``'s distri phase, one process each.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

POOLS = ("inception_pool1_nhwc_bf16", "inception_3a_nhwc_bf16",
         "inception_4a_nhwc_bf16", "inception_5a_nhwc_bf16",
         "vgg_pool2_nchw_f32")
CALLS = 20
SESSIONS = 6
PAUSES = (0.0, 0.05)
VARIANTS = {"teardown_default": None, "teardown_0": "0"}


def session_counts(fn, pause):
    """{kernel name: launches} in one session of CALLS calls of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cs.sentinel()
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        if pause:
            time.sleep(pause)
    return {e.key[:60]: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)
            and "spin_kernel" not in e.key}


def stage(name, operands, out):
    from bigdl_tpu_torch.ops import maxpool
    for pause in PAUSES:
        full = lost = empty = 0
        for case, (x, y, g, geo) in operands.items():
            fn = (lambda x=x, y=y, g=g, geo=geo: maxpool.launch(x, y, g,
                                                                *geo))
            fn()
            for _ in range(SESSIONS):
                counts = session_counts(fn, pause)
                ours = sum(n for k, n in counts.items()
                           if any(p in k for p in ("maxpool", "first_match",
                                                   "scatter_first")))
                want = CALLS * (1 if "nhwc" in case else 2)
                full += ours >= want
                lost += 0 < ours < want
                empty += not counts
                out.append({"stage": name, "pause": pause, "case": case,
                            "launches": ours, "want": want,
                            "counts": counts})
        print(f"{os.environ.get('TEARDOWN_CUPTI', 'unset'):>5} {name:15s} "
              f"pause {pause:.2f} s: {full} full, {lost} short, {empty} "
              f"empty of {SESSIONS * len(operands)} sessions", flush=True)
    stage_rows(name, POOLS, out)


def stage_rows(name, pools, out):
    """chip_smoke's own pool rows (B1 and the library call, each through
    device_ms) twice at each of ``pools``, counting the sessions device_ms
    takes and the empty and short ones it takes again."""
    import torch

    import chip_smoke as cs
    tally = {"sessions": 0, "empty": 0, "short": 0}
    sound = cs.device_time, cs.per_call_ms

    def device_time(prof):
        busy, kernels, ops = sound[0](prof)
        tally["sessions"] += 1
        tally["empty"] += not kernels
        return busy, kernels, ops

    def per_call_ms(kernels, calls):
        got = sound[1](kernels, calls)
        tally["short"] += not got
        return got

    cs.device_time, cs.per_call_ms = device_time, per_call_ms
    try:
        gen = torch.Generator(device="cuda").manual_seed(7)
        for case in pools:
            for _ in range(2):
                cs.pool_row(cs.pool_case(case), gen, torch.device("cuda"),
                            "")
    finally:
        cs.device_time, cs.per_call_ms = sound
    out.append({"stage": name, "pool_rows": tally})
    print(f"{os.environ.get('TEARDOWN_CUPTI', 'unset'):>5} {name:15s} "
          f"pool rows: {tally['sessions']} sessions, {tally['empty']} "
          f"empty, {tally['short']} short", flush=True)


def child() -> int:
    import torch

    import chip_smoke as cs
    from bigdl_tpu_torch.ops import _build
    for lib in _build.SOURCES:
        _build.load(lib)
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(1414)
    operands = {}
    for name in POOLS:
        _, shape, k, s, p, ceil, fmt, dtype, _ = cs.pool_case(name)
        x, y, g, pads, kk, ss = cs.pool_operands(shape, k, s, p, ceil, fmt,
                                                 dtype, "relu", gen, device)
        operands[name] = (x, y, g, (kk, ss, pads))
    out = []
    stage("fresh", operands, out)
    import torch.distributed as dist

    from bigdl_tpu_torch.parallel.mesh import init_process_group
    init_process_group("nccl")
    t = torch.ones(1 << 20, device=device)
    dist.all_reduce(t)
    torch.cuda.synchronize()
    stage("nccl_alive", operands, out)
    dist.destroy_process_group()
    stage("nccl_destroyed", operands, out)
    cs.CIFAR.update(train=128 * 24, val=1024, warmup_steps=4,
                    steps={"resnet20": 12, "vgg_distri": 12},
                    profile_at={"vgg": 10, "resnet20": 10, "vgg_distri": 6})
    cs.CIFAR["min_top1"] = -1.0
    try:
        cs.cifar_phase(0, device, cs.card_line(), {})
    except AssertionError as e:  # a short run's own checks: not the probe's
        print(f"cifar phase (small): {e}", flush=True)
        if dist.is_initialized():
            dist.destroy_process_group()
    stage("after_cifar", operands, out)
    path = ROOT / "chiprun_out" / (
        f"profiler_traces_{os.environ.get('TEARDOWN_CUPTI', 'unset')}.json")
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(out))
    return 0


AFTER = ("none", "distri_resnet_phase", "distri_vs_local_phase",
         "distri_world2_phase", "distri_resume_phase")


def after_child(phase) -> int:
    """``chip_smoke.py``'s pool rows at three of Inception's pools, twice
    each, after one phase of ``chip_smoke.py``'s distri phase (or none),
    counting empty and short sessions as :func:`stage` does."""
    import torch

    import chip_smoke as cs
    from bigdl_tpu_torch.engine import Engine
    from bigdl_tpu_torch.ops import _build
    for lib in _build.SOURCES:
        _build.load(lib)
    device = torch.device("cuda")
    if phase != "none":
        fn = getattr(cs, phase)
        args = (device,) if phase == "distri_resume_phase" else (0, device)
        fn(*args, cs.card_line(), {})
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        Engine.set_mesh(None)
    out = []
    stage_rows(f"after {phase}", ("inception_pool1_nhwc_bf16",
                                  "inception_3a_nhwc_bf16",
                                  "inception_5a_nhwc_bf16"), out)
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profiler_traces: no CUDA card", file=sys.stderr)
        return 2
    rc = 0
    if "after" in sys.argv:
        for phase in AFTER:
            rc |= subprocess.run([sys.executable, __file__, "--after",
                                  phase]).returncode
        return rc
    for name, value in VARIANTS.items():
        env = dict(os.environ)
        env.pop("TEARDOWN_CUPTI", None)
        if value is not None:
            env["TEARDOWN_CUPTI"] = value
        print(f"--- {name}", flush=True)
        rc |= subprocess.run([sys.executable, __file__, "--child"],
                             env=env).returncode
    return rc


if __name__ == "__main__":
    if "--after" in sys.argv:
        sys.exit(after_child(sys.argv[sys.argv.index("--after") + 1]))
    sys.exit(child() if "--child" in sys.argv else main())
