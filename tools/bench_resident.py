#!/usr/bin/env python3
"""Time the persistent resident MIS-2 kernel (``resident_fixed_point`` in
``src/repro_torch/kernels/csrc/minprop_ell.cu``) against variants of its
source, on the card.

    python3 tools/bench_resident.py [--variant NAME=kX=value,...] \\
        [--graphs Laplace3D_100 Elasticity3D_60] [--reps 20]

Every build (the source as it stands, and each variant: a copy with
``constexpr`` constants rewritten, as ``tools/bench_minprop.py`` makes
them) is compiled at once, one ``nvcc`` each.  On each graph every build
runs a whole ``mis2`` solve from all rows active, is held bitwise to the
default build (T, rounds, live count), and is timed between CUDA events
after an L2 flush (``chip_smoke._event_ms``), the builds in turns (default,
variants, variants reversed, default), the median of ``--reps`` launches
a turn.  Prints one JSON line per build (its kernels' registers and
spills, from ``ptxas``) and per graph, and the card's ``nvidia-smi`` name
and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "bench_resident"
GRAPHS = {"Laplace3D_100": ("laplace3d", (100,)),
          "Elasticity3D_60": ("elasticity3d", (60,))}
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import bench_minprop  # noqa: E402
from chip_smoke import _event_ms  # noqa: E402


def _build(sources: dict[str, Path]) -> dict:
    """Compile every source at once; returns name -> bound C entry."""
    from repro_torch.kernels import _build as kb
    from repro_torch.kernels.minprop_ell import ops

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [kb.nvcc_path(), *kb.NVCC_FLAGS, "-I", str(kb.CSRC), "-o",
         str(OUT / f"{name}.so"), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, src in sources.items()}
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        regs = re.findall(r"resident_fixed_point_kernelILi(\d+)ELi(\d+)ELb(\d)"
                          r"ELi(\d)E[^\n]*\n\s+(\d+) bytes stack frame, (\d+) "
                          r"bytes spill stores, (\d+) bytes spill loads\n"
                          r"[^\n]*Used (\d+) registers", log)
        print(json.dumps({"build": name, "resident_instances": [
            {"G": int(g), "C": int(c), "once": o == "1", "kind": int(k),
             "spill_stores": int(ss), "spill_loads": int(sl),
             "registers": int(r)}
            for g, c, o, k, _, ss, sl, r in regs]}), flush=True)
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).resident_fixed_point
        fn.argtypes = list(ops._SIGNATURES["resident_fixed_point"])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _bench(torch, rt, fns: dict, label: str, reps: int) -> dict:
    from repro_torch.core.hashing import PRIORITY_CODES
    from repro_torch.core.tuples import id_bits
    from repro_torch.kernels.minprop_ell.ops import MAX_BLOCKS_PER_SM

    kind, args = GRAPHS[label]
    ell = rt.Graph(getattr(rt.graphs, kind)(*args), device="cuda").ell
    v, d = ell.neighbors.shape
    nbrs = ell.neighbors.reshape(-1)
    active = torch.ones(v, dtype=torch.bool, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    state = {name: dict(
        t=torch.empty(v, dtype=torch.int32, device="cuda"),
        m=torch.empty(v, dtype=torch.int32, device="cuda"),
        h=torch.empty(v, dtype=torch.int32, device="cuda"),
        wl=torch.empty(4 * v, dtype=torch.int32, device="cuda"),
        aux=torch.empty(6 + 2 * MAX_BLOCKS_PER_SM * sms, dtype=torch.int32,
                        device="cuda")) for name in fns}

    def run(name):
        x = state[name]
        status = fns[name](
            x["t"].data_ptr(), x["m"].data_ptr(), x["h"].data_ptr(),
            active.data_ptr(), nbrs.data_ptr(), x["wl"].data_ptr(),
            x["aux"].data_ptr(), x["aux"].shape[0], v, d, id_bits(v),
            PRIORITY_CODES["xorshift_star"], 128,
            torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise SystemExit(f"{name}: CUDA error {status}")

    for name in fns:
        run(name)
    torch.cuda.synchronize()
    base = state["default"]
    bitwise = {name: torch.equal(x["t"], base["t"])
               and torch.equal(x["aux"][4:6], base["aux"][4:6])
               for name, x in state.items()}
    names = list(fns)
    order = names + names[1:][::-1] + names[:1]
    times = {name: [] for name in names}
    for name in order:
        _event_ms(torch, lambda n=name: run(n), 3)            # warm-up
        times[name].append(_event_ms(torch, lambda n=name: run(n), reps))
    return {"graph": label, "V": v, "D": d,
            "rounds": int(base["aux"][4]), "bitwise": bitwise,
            "ms": times}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=kX=value,...")
    ap.add_argument("--graphs", nargs="*", default=list(GRAPHS),
                    choices=list(GRAPHS))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_resident: no CUDA device", file=sys.stderr)
        return 1
    bench_minprop.OUT = OUT
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {"default": bench_minprop.SRC}
    sources.update(bench_minprop._variant(spec) for spec in args.variant)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    fns = _build(sources)
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)

    import repro_torch as rt

    for label in args.graphs:
        print(json.dumps(_bench(torch, rt, fns, label, args.reps)),
              flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
