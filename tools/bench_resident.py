#!/usr/bin/env python3
"""Time the persistent kernels -- the resident MIS-2 fixed point
(``resident_fixed_point``) and the hybrid one (``hybrid_fixed_point``) in
``src/repro_torch/kernels/csrc/minprop_ell.cu``, the Luby coloring loop
(``luby_fixed_point``) in ``csrc/luby.cu``, the coarsening's joins
(``root_join``, ``phase2_join``, ``phase3_fixed_point``) in ``csrc/joins.cu``
-- against variants of their sources, on the card.

    python3 tools/bench_resident.py [--kernels resident hybrid luby joins] \\
        [--variant NAME=kX=value,...] \\
        [--graphs Laplace3D_100 Elasticity3D_60 Powerlaw_1M] [--reps 20]

Every build (each source as it stands, and each variant: a copy with
``constexpr`` constants rewritten, as ``tools/bench_minprop.py`` makes
them, of each selected kernel's source that declares them all; ``NAME``
alone: its named text edit of ``minprop_ell.cu``) is compiled at once, one
``nvcc`` each.  On each graph every
build of a kernel runs a whole solve from all rows active (``resident``:
the padded ELL; ``hybrid``: the hybrid layout; ``luby``: the hybrid layout
of Powerlaw_1M, the padded ELL of the others; ``joins``: each join on the
label state a two-phase (and, for the root join with its cleanup, a basic)
coarsening gives it, over the layout the coarsening takes), is held bitwise
to the
default build (T or the colors, and the rounds), and is timed between CUDA
events after an L2 flush (``chip_smoke._event_ms``), the builds in turns
(default, variants, variants reversed, default), the median of ``--reps``
launches a turn.  A variant's slab shapes and lane counts are the default
build's (its table is built once).  Prints one JSON line per build (the
persistent kernels' registers and spills, from ``ptxas``) and per kernel
and graph, and the card's ``nvidia-smi`` name and power limit.

    python3 tools/bench_resident.py --kernels resident phase3 --caps \\
        [--baseline build/parent] --graphs Laplace3D_100 Elasticity3D_60

``--caps [N ...]`` times each kernel at each cap of its loop instead:
``resident``'s ``max_iters`` (every build at each cap held bitwise to the
default build at that cap) and phase 3's ``rounds``; ``--caps`` alone
sweeps 0 up to the rounds the uncapped call runs, and one past.  The gap
between two caps is one round's cost, cap 0 the prologue's.  Each cap's
line also carries the twin's trace: the resident solve's live counts a
round (M list, undecided list), and phase 3's unlabeled rows a round per
map and heavy rows.  ``--kernels phase3`` times phase 3 through the port's
own library, with no build of its own: on one H100 every process of
``--kernels joins`` stopped with SIGFPE at its first join launch, the
parent's tree too, so phase 3's parent and change are timed by running
each tree's copy of this tool in turns.
``--baseline DIR`` adds a build of another copy of the kernel sources
(``DIR/src/repro_torch/kernels/csrc``, or ``DIR`` itself where it holds the
``.cu`` files), such as the parent commit's ``git archive`` unpacked under
the gitignored ``build/``; it is timed in the same turns as the default
build, through the same C entry points.
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
GRAPHS = {"Laplace3D_100": ("laplace3d", (100,), {}),
          "Elasticity3D_60": ("elasticity3d", (60,), {}),
          "Powerlaw_1M": ("powerlaw_graph", (1_000_000, 8.0),
                          {"exponent": 2.5, "seed": 42})}
KERNELS = ("resident", "hybrid", "luby", "joins", "phase3")
PERSISTENT = ("resident_fixed_point_kernel", "hybrid_fixed_point_kernel",
              "luby_fixed_point_kernel", "root_join_kernel",
              "phase2_join_kernel", "phase3_fixed_point_kernel")
SOURCE = {"resident": "minprop_ell", "hybrid": "minprop_ell", "luby": "luby",
          "joins": "joins"}
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import bench_minprop  # noqa: E402
from chip_smoke import JOIN_OF, _event_ms, _join_calls  # noqa: E402


def _persistent_registers(log: str) -> list:
    """``ptxas -v`` of the persistent kernels: registers and spills."""
    out = []
    for m in re.finditer(r"Function properties for (\S+)\n\s+(\d+) bytes "
                         r"stack frame, (\d+) bytes spill stores, (\d+) bytes "
                         r"spill loads\n[^\n]*Used (\d+) registers", log):
        name = m.group(1)
        kernel = next((k for k in PERSISTENT if k in name), None)
        if kernel is not None:
            out.append({"kernel": kernel, "instance": name[-40:],
                        "spill_stores": int(m.group(3)),
                        "spill_loads": int(m.group(4)),
                        "registers": int(m.group(5))})
    return out


def _build(sources: dict[str, tuple[str, Path]]) -> dict:
    """Compile every source at once; returns name -> (library, loaded)."""
    from repro_torch.kernels import _build as kb

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [kb.nvcc_path(), *kb.NVCC_FLAGS, "-I", str(kb.CSRC), "-o",
         str(OUT / f"{name}.so"), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, (_, src) in sources.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        print(json.dumps({"build": name, "source": sources[name][0],
                          "persistent": _persistent_registers(log)}),
              flush=True)
        libs[name] = (sources[name][0], ctypes.CDLL(str(OUT / f"{name}.so")))
    return libs


def _entry(lib, name: str, signature):
    fn = getattr(lib, name)
    fn.argtypes = list(signature)
    fn.restype = ctypes.c_int
    return fn


def _graph(rt, label: str):
    fn, args, kw = GRAPHS[label]
    return rt.Graph(getattr(rt.graphs, fn)(*args, **kw), device="cuda")


def _resident_runner(torch, g, lib, max_iters: int = 128):
    from repro_torch.core.hashing import PRIORITY_CODES
    from repro_torch.core.tuples import id_bits
    from repro_torch.kernels.minprop_ell import ops

    ell = g.ell
    v, d = ell.neighbors.shape
    nbrs = ell.neighbors.reshape(-1)
    active = torch.ones(v, dtype=torch.bool, device="cuda")
    fn = _entry(lib, "resident_fixed_point",
                ops._SIGNATURES["resident_fixed_point"])
    x = dict(t=torch.empty(v, dtype=torch.int32, device="cuda"),
             m=torch.empty(v, dtype=torch.int32, device="cuda"),
             h=torch.empty(v, dtype=torch.int32, device="cuda"),
             wl=torch.empty(4 * v, dtype=torch.int32, device="cuda"),
             aux=torch.empty(6 + 2 * ops.MAX_BLOCKS_PER_SM
                             * ops.card_sms("cuda"), dtype=torch.int32,
                             device="cuda"))

    def run():
        status = fn(x["t"].data_ptr(), x["m"].data_ptr(), x["h"].data_ptr(),
                    active.data_ptr(), nbrs.data_ptr(), x["wl"].data_ptr(),
                    x["aux"].data_ptr(), x["aux"].shape[0], v, d, id_bits(v),
                    PRIORITY_CODES["xorshift_star"], max_iters,
                    torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise SystemExit(f"resident_fixed_point: CUDA error {status}")
        return x["t"], x["aux"][4:6]

    return run


def _hybrid_runner(torch, g, lib):
    from repro_torch.core.hashing import PRIORITY_CODES
    from repro_torch.core.tuples import id_bits
    from repro_torch.kernels.minprop_ell import ops

    hyb = g.hybrid()
    v = hyb.num_vertices
    slabs = [(sl.rows, sl.neighbors.reshape(-1)) for sl in hyb.slices]
    spill = (hyb.spill_rows, hyb.spill_seg, hyb.spill_cols)
    table = ops._slab_table(slabs, spill[0].device)
    ns, h, e = len(slabs), spill[0].shape[0], spill[2].shape[0]
    fn = _entry(lib, "hybrid_fixed_point",
                ops._SIGNATURES["hybrid_fixed_point"])

    def empty(n, dtype=torch.int32):
        return torch.empty(n, dtype=dtype, device="cuda")

    x = dict(t=empty(v), m=empty(v), lists=empty(4 * sum(hyb.slice_num_rows)),
             scratch=empty(3 * max(h, 1)),
             aux=empty(4 + 6 * ns + 2 * ns * ops.MAX_BLOCKS_PER_SM
                       * ops.card_sms("cuda")),
             acc=empty(max(ns, 1), torch.int64))

    def run():
        status = fn(x["t"].data_ptr(), x["m"].data_ptr(), None,
                    table.data_ptr(), ns, x["lists"].data_ptr(),
                    *(s.data_ptr() for s in spill), h, e,
                    x["scratch"].data_ptr(), x["aux"].data_ptr(),
                    x["aux"].shape[0], x["acc"].data_ptr(), v, id_bits(v),
                    PRIORITY_CODES["xorshift_star"], 128,
                    torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise SystemExit(f"hybrid_fixed_point: CUDA error {status}")
        return x["t"], x["aux"][:2], x["acc"]

    return run


def _luby_runner(torch, g, lib, hybrid: bool):
    from repro_torch.core.tuples import id_bits
    from repro_torch.kernels.luby import ops as lops

    if hybrid:
        hyb = g.hybrid()
        v = hyb.num_vertices
        maps = [(sl.rows, sl.neighbors.reshape(-1), sl.mask.reshape(-1),
                 sl.num_rows, sl.width) for sl in hyb.slices]
        spill = (hyb.spill_rows, hyb.spill_seg, hyb.spill_cols)
    else:
        ell = g.ell
        v = ell.num_vertices
        maps = [(None, ell.neighbors.reshape(-1), ell.mask.reshape(-1), v,
                 ell.neighbors.shape[1])]
        spill = lops._empty_spill(ell.neighbors.device)
    table = lops._map_table(maps, spill[0].device)
    h, e = spill[0].shape[0], spill[2].shape[0]
    fn = _entry(lib, "luby_fixed_point", lops._SIGNATURES["luby_fixed_point"])

    def empty(n):
        return torch.empty(max(n, 1), dtype=torch.int32, device="cuda")

    x = dict(lists=empty(2 * sum(m[3] for m in maps)), colors=empty(2 * v),
             heavy=empty(3 * h), aux=empty(4 + 3 * len(maps)))

    def run():
        status = fn(table.data_ptr(), len(maps), x["lists"].data_ptr(),
                    *(s.data_ptr() for s in spill), h, e,
                    x["colors"].data_ptr(), x["heavy"].data_ptr(),
                    x["aux"].data_ptr(),
                    x["aux"].shape[0], v, id_bits(v), 256,
                    torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise SystemExit(f"luby_fixed_point: CUDA error {status}")
        return x["colors"][:v], x["aux"][:1]

    return run


def _join_runner(lib, name: str, args, kw):
    """One join wrapper's card path with the C entries of ``lib``."""
    from repro_torch.kernels.joins import ops as jops

    layout, rest = args[0], args[1:]
    on_card = {
        "root_join": lambda: jops._root_join_on_card(
            layout, rest[0], None, None, kw.get("cleanup_rounds", 0)),
        "phase2_join": lambda: jops._phase2_on_card(
            layout, *rest, kw["min_secondary"]),
        "phase3_fixed_point": lambda: jops._phase3_on_card(
            layout, *rest)}[name]

    def run():
        entry = jops._entry
        jops._entry = lambda n: _entry(lib, n, jops._SIGNATURES[n])
        try:
            return on_card()
        finally:
            jops._entry = entry

    return run


def _bench_joins(torch, label: str, g, libs: dict, reps: int) -> list:
    """Each join at the state a real coarsening gives it, every build."""
    import repro_torch as rt
    from repro_torch.kernels.joins import ops as jops

    calls = [c for m in ("two_phase", "basic")
             for c in _join_calls(rt, jops, g, m)
             if m == "two_phase" or c[0] == "root_join"]
    out = []
    for name, args, kw in calls:
        runs = {b: _join_runner(lib, JOIN_OF[name], args, kw)
                for b, (src, lib) in libs.items() if src == "joins"}
        out.append(_timed_builds(torch, runs, "joins:default", reps) | {
            "kernel": JOIN_OF[name], "graph": label, "kw": kw})
    return out


def _phase3_trace(layout, labels, phase) -> dict:
    """The twin's rounds of phase 3 from this state: each round's
    unlabeled rows per map, and its unlabeled heavy rows and their
    entries."""
    from repro_torch.kernels.joins import ref as jref
    from chip_smoke import _rows_in

    trace = []
    jref.phase3_fixed_point_ref(layout, labels, phase, trace=trace)
    rows = [_rows_in(layout, lab < 0) for lab in trace]
    return {"rounds": len(trace),
            "unlabeled_per_map": [r[0] for r in rows],
            "unlabeled_heavy": [r[1] for r in rows],
            "unlabeled_heavy_entries": [r[2] for r in rows]}


def _phase3_own(torch, label: str, g, reps: int, caps) -> list:
    """Phase 3 (``--kernels phase3``) at each cap through the port's own
    library, at the state a real two-phase coarsening gives it: no second
    build of ``joins.cu`` in the process (on one H100 a process that loaded
    one beside the port's stopped with SIGFPE at its first join launch, in
    the parent's tree too), so two trees are compared by running each
    tree's copy of this tool in turns.  Each line carries a checksum of the
    labels and marks for the trees to be held equal."""
    import repro_torch as rt
    from repro_torch.kernels.joins import ops as jops
    from repro_torch.kernels.joins import ref as jref

    _, args, _ = next(c for c in _join_calls(rt, jops, g, "two_phase")
                      if c[0] == "phase3_fixed_point")
    trace = _phase3_trace(*args)
    out = []
    for cap in cap_list(caps, trace["rounds"], jref.JOIN_ROUNDS) \
            if caps is not None else [jref.JOIN_ROUNDS]:
        def run(cap=cap):
            return jops._phase3_on_card(*args, rounds=cap)

        labels, phase = run()
        _event_ms(torch, run, 3)                               # warm-up
        out.append({"kernel": "phase3_fixed_point", "graph": label,
                    "cap": cap, "ms": _event_ms(torch, run, reps),
                    "checksum": [int(labels.long().sum()),
                                 int((labels.long() * 7 + phase.long())
                                     .remainder(1_000_003).sum())],
                    "trace": trace})
    return out


def cap_list(caps, rounds: int, most: int | None = None) -> list:
    """The caps to time: ``caps`` as given, or (empty) 0 up to ``rounds``
    and one past, at most ``most`` (the loop's own limit)."""
    if caps:
        return sorted(set(caps))
    top = rounds + 1 if most is None else min(rounds + 1, most)
    return list(range(top + 1))


def _timed_builds(torch, runs: dict, default: str, reps: int) -> dict:
    """Every build held bitwise to ``default`` and timed in turns."""
    results = {name: [x.clone() for x in run()] for name, run in runs.items()}
    torch.cuda.synchronize()
    base = results[default]
    bitwise = {name: all(torch.equal(x, y) for x, y in zip(r, base))
               for name, r in results.items()}
    names = list(runs)
    order = names + names[1:][::-1] + names[:1]
    times = {name: [] for name in names}
    for name in order:
        _event_ms(torch, runs[name], 3)                       # warm-up
        times[name].append(_event_ms(torch, runs[name], reps))
    return {"bitwise": bitwise, "ms": times,
            "median_ms": {n: sorted(x)[len(x) // 2] for n, x in times.items()}}


def _bench(torch, kernel: str, label: str, g, libs: dict, reps: int) -> dict:
    source = SOURCE[kernel]
    runs = {}
    for name, (src, lib) in libs.items():
        if src != source:
            continue
        if kernel == "resident":
            runs[name] = _resident_runner(torch, g, lib)
        elif kernel == "hybrid":
            runs[name] = _hybrid_runner(torch, g, lib)
        else:
            runs[name] = _luby_runner(torch, g, lib, label == "Powerlaw_1M")
    rounds = int(runs[f"{source}:default"]()[1][0])
    return {"kernel": kernel, "graph": label, "rounds": rounds,
            **_timed_builds(torch, runs, f"{source}:default", reps)}


def _resident_caps(torch, label: str, g, libs: dict, reps: int,
                   caps) -> list:
    """The resident solve at each cap of its rounds, every build, with
    the twin's live counts a round."""
    from repro_torch.core.tuples import id_bits
    from repro_torch.kernels.minprop_ell import ref

    ell = g.ell
    v = ell.num_vertices
    trace = []
    ref.resident_fixed_point_ref(
        torch.empty(v, dtype=torch.int32, device="cuda"),
        torch.empty(v, dtype=torch.int32, device="cuda"),
        torch.ones(v, dtype=torch.bool, device="cuda"),
        ell.neighbors.reshape(-1), priority="xorshift_star", b=id_bits(v),
        max_iters=128, trace=trace)
    out = []
    for cap in cap_list(caps, len(trace)):
        runs = {name: _resident_runner(torch, g, lib, cap)
                for name, (src, lib) in libs.items() if src == "minprop_ell"}
        out.append(_timed_builds(torch, runs, "minprop_ell:default", reps) | {
            "kernel": "resident", "graph": label, "cap": cap,
            "rounds": len(trace), "live_counts": [list(x) for x in trace]})
    return out


def baseline_csrc(path) -> Path:
    """The kernel sources of a baseline tree: ``path/src/repro_torch/
    kernels/csrc`` where the tree has one, else ``path`` itself; it must
    hold ``minprop_ell.cu``."""
    path = Path(path)
    tree = path / "src" / "repro_torch" / "kernels" / "csrc"
    csrc = tree if tree.is_dir() else path
    if not (csrc / "minprop_ell.cu").is_file():
        raise SystemExit(f"--baseline {path}: no minprop_ell.cu in {csrc}")
    return csrc


def default_sources(kernels, baseline=None) -> dict:
    """Build name -> (source stem, path) of each selected kernel's source
    as it stands and, with ``baseline``, of the baseline's copy."""
    trees = [("default", bench_minprop.CSRC)]
    if baseline is not None:
        trees.append(("baseline", baseline_csrc(baseline)))
    sources = {}
    for tag, csrc in trees:
        if {"resident", "hybrid"} & set(kernels):
            sources[f"minprop_ell:{tag}"] = ("minprop_ell",
                                             csrc / "minprop_ell.cu")
        if "luby" in kernels:
            sources[f"luby:{tag}"] = ("luby", csrc / "luby.cu")
        if "joins" in kernels:
            # the default a copy, as the variants are: a library built from
            # csrc/joins.cu itself, loaded beside the one the states'
            # coarsening loads from the same file, stopped the process at
            # its first launch (SIGFPE)
            sources[f"joins:{tag}"] = ("joins", csrc / "joins.cu") \
                if tag == "baseline" else ("joins", bench_minprop._edited(
                    "joins_default", csrc / "joins.cu", []))
    return sources


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", nargs="*", default=["resident"],
                    choices=KERNELS)
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=kX=value,...")
    ap.add_argument("--graphs", nargs="*",
                    default=["Laplace3D_100", "Elasticity3D_60"],
                    choices=list(GRAPHS))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--caps", nargs="*", type=int, default=None,
                    help="time at each cap of the loop (none given: 0 up "
                         "to the rounds run, and one past)")
    ap.add_argument("--baseline", default=None,
                    help="a tree (or csrc directory) whose kernel sources "
                         "are built and timed beside these")
    args = ap.parse_args(argv)
    if args.caps is not None:
        if any(c < 0 for c in args.caps):
            ap.error("--caps must be >= 0")
        if not {"resident", "phase3"} & set(args.kernels):
            ap.error("--caps times the resident kernel and phase 3: select "
                     "--kernels resident or phase3")
    return args


def main(argv=None) -> int:
    import torch

    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_resident: no CUDA device", file=sys.stderr)
        return 1
    bench_minprop.OUT = OUT
    OUT.mkdir(parents=True, exist_ok=True)
    sources = default_sources(args.kernels, args.baseline)
    defaults = [s for n, s in sources.items() if n.endswith(":default")]
    for spec in args.variant:
        consts = spec.partition("=")[2]
        names = [c.partition("=")[0] for c in consts.split(",") if consts]
        hits = 0
        for stem, src in defaults:
            text = src.read_text()
            if (all(re.search(rf"constexpr \w+ {c} = ", text) for c in names)
                    if names else src == bench_minprop.SRC):
                name, path = bench_minprop._variant(spec, src)
                sources[f"{stem}:{name}"] = (stem, path)
                hits += 1
        if not hits:
            raise SystemExit(f"{spec}: no selected kernel's source declares "
                             "all of its constants")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = _build({n.replace(":", "-"): s for n, s in sources.items()})
    libs = {n.replace("-", ":", 1): s for n, s in libs.items()}
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)

    import repro_torch as rt

    for label in args.graphs:
        g = _graph(rt, label)
        for kernel in args.kernels:
            if kernel == "resident" and label == "Powerlaw_1M":
                continue            # its padded ELL would take 120 GB
            if kernel == "joins":
                for line in _bench_joins(torch, label, g, libs, args.reps):
                    print(json.dumps(line), flush=True)
                continue
            if kernel == "phase3":
                for line in _phase3_own(torch, label, g, args.reps,
                                        args.caps):
                    print(json.dumps(line), flush=True)
                continue
            if args.caps is not None:
                if kernel == "resident":
                    for line in _resident_caps(torch, label, g, libs,
                                               args.reps, args.caps):
                        print(json.dumps(line), flush=True)
                continue
            print(json.dumps(_bench(torch, kernel, label, g, libs,
                                    args.reps)), flush=True)
        del g
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
