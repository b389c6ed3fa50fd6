#!/usr/bin/env python3
"""Variants of the ELL SpMV kernels, side by side on one GPU.

    python3 tools/bench_spmv.py [--baseline OLD.cu] \
        [--variant NAME=kTRows=128,kTUnroll=16 ...] [--variant scalar_loads] \
        [--reps 50] [--probes]

Builds ``src/repro_torch/kernels/csrc/spmv_ell.cu`` as it stands
(``default``); each ``--variant``, a copy of it with the named
``constexpr`` constants rewritten (``NAME=kX=value,...``) or with one of
the text edits of ``EDITS`` (``NAME``); ``--baseline``, another version of
the same file with the same C entry points; and, with ``--probes``, the
``PROBES`` copies.  All ``nvcc`` processes start together, into
``build/bench_spmv/``.  Then, at the AMG solve's shapes (Laplace3D_100's A,
level-0 P and explicit R, and Elasticity3D_60's A; P from
``coarsen(method="two_phase")`` and the smoothed prolongator, as
``amg_setup`` builds level 0), holds every build but the probes against
the plain-torch twin bit for bit and times it with ``chip_smoke.py``'s
timer: the median of ``--reps`` launches, each alone between CUDA events
after a 256 MB L2 flush, the builds taken in turns and then again in
reverse order; once after a write flush and once after a read flush,
which leaves no dirty line in the L2 for the launch to write back.  The
``torch.mv`` call on the same matrix as CSR (cuSPARSE) is timed once per
shape as the yardstick.  Prints one JSON line per build (``ptxas``
registers) and per shape, and the card's ``nvidia-smi`` name and power
limit.
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
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "spmv_ell.cu"
OUT = ROOT / "build" / "bench_spmv"
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import HBM_BYTES_PER_S, _csr_of, _event_ms  # noqa: E402

# named text edits of the source, held bitwise like the default build
EDITS = {
    "scalar_loads": [("aligned && width == d", "false")],
}
# probes: spmv_ell_t with a gather replaced by a constant (wrong results,
# not checked), to show which of its reads bounds it
PROBES = {
    "probe_no_vals_gather": [("v[u] = vals[s[u]];", "v[u] = 1.0f;")],
    "probe_no_x_gather": [("xv[u] = x[s[u] / ud];", "xv[u] = 1.0f;")],
    "probe_no_gathers": [("v[u] = vals[s[u]];",       # perm still read
                          "v[u] = static_cast<float>(s[u] & 1u);"),
                         ("xv[u] = x[s[u] / ud];", "xv[u] = 1.0f;")],
}


def _edited(name: str, subs: list[tuple[str, str]]) -> Path:
    """A copy of the source with each ``(old, new)`` text replaced."""
    text = SRC.read_text()
    for a, b in subs:
        if a not in text:
            raise SystemExit(f"{name}: {a!r} not in {SRC.name}")
        text = text.replace(a, b)
    path = OUT / f"{name}.cu"
    path.write_text(text)
    return path


def _variant(spec: str) -> tuple[str, Path]:
    """``NAME`` (an ``EDITS`` entry) or ``NAME=kX=value,...``."""
    name, _, consts = spec.partition("=")
    if not consts:
        return name, _edited(name, EDITS[name])
    subs = []
    for item in consts.split(","):
        const, _, value = item.partition("=")
        m = re.search(rf"constexpr \w+ {const} = [^;]+;", SRC.read_text())
        if m is None:
            raise SystemExit(f"{name}: no constexpr {const} in {SRC.name}")
        old = m.group(0)
        subs.append((old, old[:old.index("=") + 2] + value + ";"))
    return name, _edited(name, subs)


def _build(sources: dict[str, Path]) -> dict:
    from repro_torch.kernels import _build as kb
    from repro_torch.kernels.spmv_ell import ops

    procs = {}
    for name, src in sources.items():
        cmd = [kb.nvcc_path(), *kb.NVCC_FLAGS,
               "-o", str(OUT / f"{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        print(json.dumps({"variant": name, "source": str(sources[name]),
                          "ptxas": [ln for ln in log.splitlines()
                                    if "ptxas" in ln]}), flush=True)
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        fns[name] = {}
        for fn_name, sig in ops._SIGNATURES.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(sig)
            fn.restype = ctypes.c_int
            fns[name][fn_name] = fn
    return fns


def _cases(torch, rt, rng):
    """shape -> (C entry point, ``call(fn, y)``, output rows, twin,
    library call, bytes bound, shape fields), at the solve's shapes."""
    import numpy as np
    from repro_torch.kernels.spmv_ell import ops, ref
    from repro_torch.multilevel.prolongator import (
        rect_ell, smoothed_prolongator_host)

    dev = torch.device("cuda")
    cases = {}

    def vec(n):
        return torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).to(dev)

    def forward(label, m, ncols):
        x = vec(ncols)
        rows, d = m.cols.shape
        csr = _csr_of(torch, m.cols, m.vals, m.mask, ncols)
        cases[label] = (
            "spmv_ell", lambda f, y: f(m.cols.data_ptr(), m.vals.data_ptr(),
                                       x.data_ptr(), y.data_ptr(), rows, d,
                                       torch.cuda.current_stream().cuda_stream),
            rows, lambda: ref.spmv_ref(m.cols, m.vals, x),
            lambda: torch.mv(csr, x),
            8 * rows * d + 4 * ncols + 4 * rows, {"rows": rows, "D": d})

    l100 = rt.Graph(rt.graphs.laplace3d(100), device=dev)
    forward("Laplace3D_100 A", l100.ell_matrix, l100.num_vertices)
    agg = rt.coarsen(l100, method="two_phase")
    pr, pc, pv = smoothed_prolongator_host(l100.csr_matrix, agg.labels,
                                           agg.num_aggregates, 2.0 / 3.0)
    v, nagg = l100.num_vertices, agg.num_aggregates
    p = rect_ell(pr, pc, pv.astype(np.float32), v, dev)
    r = rect_ell(pc, pr, pv.astype(np.float32), nagg, dev)
    forward("Laplace3D_100 level-0 P", p, nagg)
    forward("Laplace3D_100 level-0 R", r, v)
    t = ops.ell_transpose(p.cols, p.mask, nagg)
    xt = vec(v)
    nnz = int(t.perm.numel())
    r_csr = _csr_of(torch, r.cols, r.vals, r.mask, v)
    cases["Laplace3D_100 level-0 P^T"] = (
        "spmv_ell_t", lambda f, y: f(p.vals.data_ptr(), t.perm.data_ptr(),
                                     t.offsets.data_ptr(), xt.data_ptr(),
                                     y.data_ptr(), nagg, p.cols.shape[1],
                                     torch.cuda.current_stream().cuda_stream),
        nagg, lambda: ref.spmv_t_ref(p.vals, t.perm, t.offsets, xt, t.max_len),
        lambda: torch.mv(r_csr, xt),
        8 * nnz + 4 * (nagg + 1) + 4 * v + 4 * nagg,
        {"rows": v, "D": p.cols.shape[1], "num_out": nagg, "nnz": nnz,
         "max_len": t.max_len})
    del l100
    e60 = rt.Graph(rt.graphs.elasticity3d(60), device=dev)
    forward("Elasticity3D_60 A", e60.ell_matrix, e60.num_vertices)
    return cases


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME (an EDITS entry) or NAME=kX=value,...")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--probes", action="store_true",
                    help="also time the PROBES builds of spmv_ell_t")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_spmv: no CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {"default": SRC}
    if args.baseline is not None:
        sources["baseline"] = args.baseline.resolve()
    sources.update(_variant(spec) for spec in args.variant)
    if args.probes:
        sources.update((k, _edited(k, v)) for k, v in PROBES.items())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    fns = _build(sources)
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)

    import numpy as np
    import repro_torch as rt

    cases = _cases(torch, rt, np.random.default_rng(0))
    names = list(fns)
    for label, (fn_name, call, n_out, twin, library, nbytes, shape) in \
            cases.items():
        want = twin()
        rec = {"shape": label, **shape, "bytes": nbytes,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        times = {k: [] for k in names}
        clean = {k: [] for k in names}
        for order in (names, names[::-1]):
            for k in order:
                if k in PROBES and fn_name != "spmv_ell_t":
                    continue
                f = fns[k][fn_name]
                y = torch.empty(n_out, dtype=torch.float32, device="cuda")
                if call(f, y) != 0:
                    raise SystemExit(f"{k}: launch failed on {label}")
                y2 = torch.empty_like(y)
                call(f, y2)
                torch.cuda.synchronize()
                bits = y.view(torch.int32)
                if k not in PROBES and not (
                        torch.equal(bits, want.view(torch.int32))
                        and torch.equal(bits, y2.view(torch.int32))):
                    raise SystemExit(f"{k}: not bitwise equal on {label}")
                _event_ms(torch, lambda: call(f, y), 3)
                times[k].append(_event_ms(torch, lambda: call(f, y),
                                          args.reps))
                clean[k].append(_event_ms(torch, lambda: call(f, y),
                                          args.reps, clean=True))
        _event_ms(torch, library, 3)
        rec["library_ms"] = _event_ms(torch, library, args.reps)
        rec["library_ms_clean_flush"] = _event_ms(torch, library, args.reps,
                                                  clean=True)
        rec["ms"] = times = {k: v for k, v in times.items() if v}
        rec["ms_clean_flush"] = {k: v for k, v in clean.items() if v}
        rec["bound_share"] = {k: rec["bound_ms"] / min(v)
                              for k, v in times.items()}
        print(json.dumps(rec), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
