"""B3's grouping passes at other tile sizes and with another digit match.

Copies ``bigdl_tpu_torch/csrc/embed_bag.cu`` into ``build/probes/`` with the
keys a lane holds in a tile of passes 1 and 2 set to 2, 4 and 8 (tiles of
512, 1024 and 2048 entries: 128, 64 and 32 blocks at the census shape),
each with the equal digits of a warp found by one ballot a digit bit (as
the source has it) and by the hardware's ``__match_any_sync``, and with 8
warps instead of 4 in a block of pass 3 (its window of fine digits halved
to 512, so the 64-bit counters fit in 48 KB); builds each
with the port's nvcc flags and runs each through ``embed_bag.launch`` at
the census Wide&Deep shape (the inputs of ``chip_smoke.py``'s bag phase),
forward and table gradient: ``(perm, offsets)`` against ``row_index`` and
the output against the plain version, bitwise, then the whole call's
device time (torch.profiler) split by kernel, twice in turn.  Run on the
card from the repository root:

    python3 probes/b3_passes.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from bigdl_tpu_torch.ops import _build, embed_bag  # noqa: E402

OUT = ROOT / "build" / "probes"
ITEMS = "constexpr int ITEMS = 4;"
PEERS_HEAD = ("template <int N>\n__device__ __forceinline__ void peers("
              "const unsigned (&f)[N], unsigned (&same)[N], int bits) {\n")
PEERS_END = "}\n\n__device__ __forceinline__ int bits_below"
MATCH_BODY = """#pragma unroll
  for (int u = 0; u < N; ++u) same[u] = __match_any_sync(FULL, f[u]);
"""
FINE = "constexpr int FINE_WARPS = 4;"
WINDOW = "constexpr int FINE_WINDOW = 1024;"
VARIANTS = [(items, match, 4) for items in (2, 4, 8)
            for match in ("ballot", "match_any")] + [(4, "ballot", 8)]


def source(s: str, items: int, match: str, fine: int) -> str:
    s = s.replace(ITEMS, f"constexpr int ITEMS = {items};")
    s = s.replace(FINE, f"constexpr int FINE_WARPS = {fine};")
    s = s.replace(WINDOW, f"constexpr int FINE_WINDOW = {4096 // fine};")
    if match == "match_any":
        head = s.index(PEERS_HEAD) + len(PEERS_HEAD)
        s = s[:head] + MATCH_BODY + s[s.index(PEERS_END, head):]
    return s


def main() -> int:
    if not torch.cuda.is_available():
        print("b3_passes: no CUDA card", file=sys.stderr)
        return 2
    print(f"card: {cs.card_line()}")
    OUT.mkdir(parents=True, exist_ok=True)
    s = (_build.CSRC / "embed_bag.cu").read_text()
    if any(s.count(t) != 1 for t in (ITEMS, PEERS_HEAD, FINE, WINDOW)):
        raise SystemExit("embed_bag.cu changed: cannot set the variants")
    nvcc = _build._nvcc()
    procs = {}
    for v in VARIANTS:
        name = "_".join(map(str, v))
        src = OUT / f"embed_bag_{name}.cu"
        src.write_text(source(s, *v))
        procs[v] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o",
             str(OUT / f"libembed_bag_{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for k, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {k}:\n{out}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3141)
    rows, cols, vals, table, g = cs.bag_operands(cs.BAG_CASES[0], gen, dev)
    N, V = cs.BAG_CASES[0][1:3]
    roles = {"forward": (rows, cols, vals, table, N),
             "table_grad": (cols, rows, vals, g, V)}
    wants = {role: embed_bag.embedding_bag_coo_reference(*args)
             for role, args in roles.items()}
    tile = embed_bag.TILE
    for _ in range(2):
        for items, match, fine in VARIANTS:
            _build._libs["embed_bag"] = ctypes.CDLL(str(
                OUT / f"libembed_bag_{items}_{match}_{fine}.so"))
            embed_bag._fns.clear()
            embed_bag.TILE = 256 * items  # the plan's tile follows the source
            line = []
            for role, args in roles.items():
                cs.check_grouping(args[0], args[4], f"{role} {items} {match}")
                if not torch.equal(embed_bag.launch(*args), wants[role]):
                    raise AssertionError(f"{role} {items} {match}: not "
                                         f"bitwise equal to the plain version")
                split = []
                ms = cs.device_ms(lambda: embed_bag.launch(*args), split=split)
                parts = ", ".join(f"{p} {sum(t for n, t in split if p in n):.5f}"
                                  for p in cs.BAG_PASSES)
                line.append(f"{role} {ms:.5f} ({parts})")
            chunks = embed_bag.group_plan(65536, N).chunks
            print(f"b3 {items} keys a lane ({chunks} blocks), {match}, "
                  f"{fine} warps in pass 3: " + "; ".join(line), flush=True)
    embed_bag.TILE = tile
    return 0


if __name__ == "__main__":
    sys.exit(main())
