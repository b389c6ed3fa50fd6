#!/usr/bin/env python3
"""Versions of the hash-pack kernel side by side on one GPU.

    python3 tools/bench_hash_pack.py [--baseline OLD.cu] [--variant NAME ...] \
        [--n 1000000] [--reps 50]

Builds ``src/repro_torch/kernels/csrc/hash_pack.cu`` as it stands
(``default``); ``--baseline``, another version of the same file (one
without the ``round_priorities`` entry offers only ``hash_pack``); and
each ``--variant NAME``, the default source with the text edit
``EDITS[NAME]`` applied.  All ``nvcc`` processes start together, into
``build/bench_hash_pack/``.

Each build's forms, one a C entry point (``hash_pack``: ids read, uint32
words, the TPU kernel's signature; ``round_priorities``: the ids 0..n-1,
nothing read, int64 words, the coloring's), are held bit for bit against
the plain-torch twins at ``--n`` ids, and timed with ``chip_smoke.py``'s timer
(the median of ``--reps`` launches, each alone between CUDA events) after
the 256 MB write flush (``ms``) and after a 256 MB read flush
(``ms_read_flush``), the builds taken in turns and then again in reverse
order.  ``floor_ms``: one launch of a 1-element torch ``add_`` timed the
same way.  ``kernel_ms`` / ``floor_kernel_ms``: the same launches traced with
``torch.profiler``, each kernel's own device time (median), without the
event pair.  Each form's bound is its bytes (ids read once, words written
once) over the memory rate, or its hashes' integer instructions over the
INT32 rate, whichever is longer (``chip_smoke.py``'s constants).  Prints
one JSON line per build (``ptxas`` registers) and per build and form, and
the card's ``nvidia-smi`` name and power limit.
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
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
SRC = CSRC / "hash_pack.cu"
OUT = ROOT / "build" / "bench_hash_pack"
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (HBM_BYTES_PER_S, INSTR_PER_HASH,  # noqa: E402
                        INT32_OPS_PER_S, _event_ms)

# named variants: text edits of the default source (designs that lost on
# the card stay here, out of the source).  scalar: every id one at a time
# in the grid-stride loop (no 16-byte steps), f(it + 1) still hoisted.
# consecutive: the coloring's form's step is 4 consecutive ids too, so
# each of its two 16-byte stores writes half of every sector it touches.
EDITS = {
    "scalar": [("const bool vector = bits % 16 == 0;",
                "const bool vector = false;")],
    "consecutive": [
        ("""      const int64_t i = (s >> 5) * kWarpStep + 2 * (s & 31);
      const int64_t j = i + kWarpStep / 2;  // the second pair""",
         """      const int64_t i = s * kStep;
      const int64_t j = i + 2;""")],
}
# the floor's kernel: the 1-element add_, not the flush's fill or sum
FLOOR_KERNEL = (lambda k: "add" in k.lower() and "reduce" not in k.lower()
                and "fill" not in k.lower())
# form (the C entry point) -> (ids read, int64 words), and its argtypes
FORMS = {"hash_pack": (True, False), "round_priorities": (False, True)}
ARGTYPES = {"hash_pack": [ctypes.c_void_p] * 3 + [
                ctypes.c_int64, ctypes.c_int, ctypes.c_void_p],
            "round_priorities": [ctypes.c_void_p] * 2 + [
                ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]}


def _edited(name: str, subs: list[tuple[str, str]]) -> Path:
    text = SRC.read_text()
    for a, b in subs:
        if a not in text:
            raise SystemExit(f"{name}: {a!r} not in {SRC}")
        text = text.replace(a, b)
    path = OUT / f"{name}.cu"
    path.write_text(text)
    return path


def _build(sources: dict[str, Path]) -> dict:
    """name -> {form: C entry point bound to that form}."""
    from repro_torch.kernels import _build as kb

    procs = {name: subprocess.Popen(
        [kb.nvcc_path(), *kb.NVCC_FLAGS, "-I", str(CSRC),
         "-o", str(OUT / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        regs = {m.group(1)[-40:]: int(m.group(2)) for m in re.finditer(
            r"entry function '(\w+)'[\s\S]*?Used (\d+) registers", log)}
        print(json.dumps({"build": name, "source": str(sources[name]),
                          "ptxas_registers": regs}), flush=True)
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        fns[name] = {}
        for form in FORMS:
            if hasattr(lib, form):
                fn = getattr(lib, form)
                fn.argtypes = ARGTYPES[form]
                fn.restype = ctypes.c_int
                fns[name][form] = fn
    return fns


def _call(torch, form: str, fn, ids, it, n: int, b: int):
    """One launch of a form; returns its output tensor."""
    reads, wide = FORMS[form]
    out = torch.empty(n, dtype=torch.int64 if wide else torch.int32,
                      device=it.device)
    stream = torch.cuda.current_stream().cuda_stream
    ins = (ids.data_ptr(),) if reads else ()
    status = fn(*ins, it.data_ptr(), out.data_ptr(), n, b, stream)
    if status != 0:
        raise RuntimeError(f"CUDA error {status}")
    return out


def _kernel_ms(torch, call, reps: int, clean: bool,
               kernel=lambda k: "hash_pack_kernel" in k) -> float | None:
    """The median device time of ``call``'s kernel over ``reps`` launches
    timed as ``_event_ms`` times them, read from a ``torch.profiler``
    trace (CUPTI): the kernel alone, without the event pair around it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _event_ms(torch, call, reps, clean=clean)
    times = sorted(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                   if e.device_type == DeviceType.CUDA and kernel(e.name))
    return times[len(times) // 2] if times else None


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--variant", action="append", default=[],
                    choices=list(EDITS))
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_hash_pack: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.tuples import id_bits
    from repro_torch.kernels.hash_priority import ref

    OUT.mkdir(parents=True, exist_ok=True)
    sources = {"default": SRC}
    if args.baseline is not None:
        sources["baseline"] = args.baseline.resolve()
    sources.update((k, _edited(k, EDITS[k])) for k in args.variant)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    fns = _build(sources)
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)

    n, dev = args.n, torch.device("cuda")
    b = id_bits(n)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    it = torch.ones(1, dtype=torch.int32, device=dev)
    want = {"hash_pack": ref.hash_pack_ref(ids, it, b),
            "round_priorities": ref.round_priorities_ref(n, it, b)}
    for name, forms in fns.items():
        for form, fn in forms.items():
            got = _call(torch, form, fn, ids, it, n, b)
            torch.cuda.synchronize()
            if not torch.equal(got, want[form]):
                raise SystemExit(f"{name} {form}: not equal to the twin")
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    runs = [(name, form) for name, forms in fns.items() for form in forms]
    times = {r: {"ms": [], "ms_read_flush": []} for r in runs}
    floor = {"write_flush": [], "read_flush": []}
    for order in (runs, runs[::-1]):
        for name, form in order:
            call = (lambda f=form, e=fns[name][form]: _call(
                torch, f, e, ids, it, n, b))
            _event_ms(torch, call, 3)                        # warm-up
            times[(name, form)]["ms"].append(_event_ms(torch, call,
                                                       args.reps))
            times[(name, form)]["ms_read_flush"].append(
                _event_ms(torch, call, args.reps, clean=True))
        floor["write_flush"].append(_event_ms(torch, lambda: one.add_(1),
                                              args.reps))
        floor["read_flush"].append(_event_ms(torch, lambda: one.add_(1),
                                             args.reps, clean=True))
    print(json.dumps({"floor_ms": floor}), flush=True)
    # the same launches under the profiler: each kernel's own device time
    for name, form in runs:
        call = (lambda f=form, e=fns[name][form]: _call(
            torch, f, e, ids, it, n, b))
        times[(name, form)].update(
            kernel_ms=_kernel_ms(torch, call, args.reps, False),
            kernel_ms_read_flush=_kernel_ms(torch, call, args.reps, True))
    print(json.dumps({"floor_kernel_ms": {
        "write_flush": _kernel_ms(torch, lambda: one.add_(1), args.reps,
                                  False, FLOOR_KERNEL),
        "read_flush": _kernel_ms(torch, lambda: one.add_(1), args.reps,
                                 True, FLOOR_KERNEL)}}), flush=True)
    for (name, form), t in times.items():
        reads, wide = FORMS[form]
        nbytes = (4 * n if reads else 0) + (8 if wide else 4) * n + 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n * INSTR_PER_HASH / INT32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(json.dumps({
            "build": name, "form": form, "n": n, **t, "bytes": nbytes,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_share": [bound_ms / x for x in t["ms"]],
            "bound_share_read_flush": [bound_ms / x
                                       for x in t["ms_read_flush"]],
            "bitwise": True}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
