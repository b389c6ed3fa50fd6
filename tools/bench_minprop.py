#!/usr/bin/env python3
"""Variants of the fused MIS-2 kernels, side by side on one GPU.

    python3 tools/bench_minprop.py [--baseline OLD.cu] \
        [--variant NAME=kLaneSlots=8,kChunk=8 ...] \
        [--probes] [--reps 30] [--solve-reps 10] [--sass]

Builds ``src/repro_torch/kernels/csrc/minprop_ell.cu`` as it stands
(``default``); each ``--variant``, a copy of it with the named
``constexpr`` constants rewritten (``NAME=kX=value,...``); ``--baseline``,
another version of the same file with the same C entry points (the
refresh's scratch argument may be missing, as before the kernels hashed
each vertex once); and, with ``--probes``, the ``PROBES`` copies of the
default source and, given ``--baseline``, the ``BASELINE_PROBES`` copies
of the baseline.  All ``nvcc`` processes start together, into
``build/bench_minprop/``.

Then, on Laplace3D_100 and Elasticity3D_60, every build but the probes is
held bit for bit against the plain-torch twins and timed with
``chip_smoke.py``'s timer (the median of ``--reps`` launches, each alone
between CUDA events after a 256 MB L2 flush, the builds taken in turns and
then again in reverse order):

- at round 0 of the resident loop (every row live and undecided), the
  state ``chip_smoke.py`` times;
- over one whole resident solve: the per-round inputs of one ``mis2``
  (worklists, counts, T and M), captured once from the twins, each round's
  launch timed alone and the medians summed.

``--sass`` prints the SASS of the default build's per-vertex hash pass
(``refreshed_tuples_kernel``, xorshift64*) and of ``hash_pack_kernel``, with
their instruction counts, from ``cuobjdump -sass``.  Prints one JSON line
per build (``ptxas`` registers) and per graph, and the card's
``nvidia-smi`` name and power limit.
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
SRC = CSRC / "minprop_ell.cu"
OUT = ROOT / "build" / "bench_minprop"
GRAPHS = {"Laplace3D_100": ("laplace3d", 100),
          "Elasticity3D_60": ("elasticity3d", 60)}
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import _event_ms  # noqa: E402

# probes: the default source with one read or pass removed (wrong results,
# not checked), to show what each costs
PROBES = {
    "probe_no_hash_pass": [
        ("pre<<<grid_for(pre, v), kThreads, 0, stream>>>(t, h, it, v, b);",
         "")],
    "probe_no_gather": [("? src[nb[c]] : kOut;",
                         "? static_cast<uint32_t>(nb[c]) : kOut;")],
    "probe_no_active": [("av[c] = nb[c] >= 0 ? active[nb[c]] : 0u;",
                         "av[c] = nb[c] >= 0;")],
    "probe_decide_no_gather": [
        ("av[c] = nb[c] >= 0 ? active[nb[c]] : 0u;", "av[c] = nb[c] >= 0;"),
        ("mv[c] = nb[c] >= 0 ? m[nb[c]] : 0u;",
         "mv[c] = static_cast<uint32_t>(nb[c]);")],
}
# the same questions asked of the source before the redesign (one thread
# per row, the hash inline per neighbour slot)
BASELINE_PROBES = {
    "baseline_probe_no_hash": [
        ("refresh(t[nb], static_cast<uint32_t>(nb), kind, it, b)", "t[nb]")],
    "baseline_probe_no_gather": [
        ("refresh(t[nb], static_cast<uint32_t>(nb), kind, it, b)",
         "refresh(1u, static_cast<uint32_t>(nb), kind, it, b)")],
    "baseline_probe_no_active": [("    if (!active[nb]) continue;\n", "")],
}


def _edited(name: str, src: Path, subs: list[tuple[str, str]]) -> Path:
    """A copy of ``src`` with each ``(old, new)`` text replaced."""
    text = src.read_text()
    for a, b in subs:
        if a not in text:
            raise SystemExit(f"{name}: {a!r} not in {src}")
        text = text.replace(a, b)
    path = OUT / f"{name}.cu"
    path.write_text(text)
    return path


def _variant(spec: str) -> tuple[str, Path]:
    """``NAME=kX=value,...``: the default source with constants rewritten."""
    name, _, consts = spec.partition("=")
    subs = []
    for item in consts.split(","):
        const, _, value = item.partition("=")
        m = re.search(rf"constexpr \w+ {const} = [^;]+;", SRC.read_text())
        if m is None:
            raise SystemExit(f"{name}: no constexpr {const} in {SRC.name}")
        old = m.group(0)
        subs.append((old, old[:old.index("=") + 2] + value + ";"))
    return name, _edited(name, SRC, subs)


def _argtypes(src: Path, fn_name: str) -> tuple[list, bool]:
    """The ctypes argument types of C entry point ``fn_name`` as the source
    declares it, and whether it takes a scratch pointer."""
    m = re.search(rf"int {fn_name}\(([^)]*)\)", src.read_text())
    if m is None:
        raise SystemExit(f"{src}: no {fn_name}")
    params = [p.strip() for p in m.group(1).split(",")]
    types = [ctypes.c_void_p if "*" in p else
             ctypes.c_int64 if p.startswith("int64_t") else ctypes.c_int
             for p in params]
    return types, any(p.endswith("scratch") for p in params)


def _short(fn: str) -> str:
    """A mangled kernel name without its file's anonymous namespace."""
    return re.sub(r"^_ZN\w*?_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+", "", fn)[:60]


def _registers(log: str) -> dict:
    """``ptxas -v``: registers and spill stores of the fused passes."""
    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn and re.search("fused|refreshed_tuples", fn):
            key = _short(fn)
            out[key] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and fn and int(m.group(1)) and re.search("fused", fn):
            out[f"{_short(fn)} spills"] = int(m.group(1))
    return out


def _build(sources: dict[str, Path]) -> dict:
    from repro_torch.kernels import _build as kb

    procs = {}
    for name, src in sources.items():
        cmd = [kb.nvcc_path(), *kb.NVCC_FLAGS, "-I", str(CSRC),
               "-o", str(OUT / f"{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        print(json.dumps({"variant": name, "source": str(sources[name]),
                          "ptxas": _registers(log)}), flush=True)
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        fns[name] = {}
        for fn_name in ("fused_refresh_columns", "fused_decide"):
            sig, scratch = _argtypes(sources[name], fn_name)
            fn = getattr(lib, fn_name)
            fn.argtypes = sig
            fn.restype = ctypes.c_int
            fns[name][fn_name] = (fn, scratch)
    return fns


def _functions(tool: str, lib: Path) -> dict[str, list[str]]:
    """``cuobjdump -sass`` of a library: function -> its instructions
    (addresses and encodings dropped)."""
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name = _short(block.split("\n", 1)[0].strip())
        out[name] = [re.sub(r"^\s*/\*[0-9a-f]+\*/\s*|\s*/\*\s*0x[0-9a-f]+\s*\*/",
                            "", ln).strip()
                     for ln in block.splitlines()
                     if re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln)]
    return out


def _sass(baseline: bool) -> None:
    """The SASS of the per-vertex hash pass and of hash_pack, counted; and,
    given a baseline, whether every kernel but the fused ones compiled to
    the same instructions in both builds."""
    from repro_torch.kernels import _build as kb

    paths = kb.build_all()
    tool = str(Path(kb.nvcc_path()).parent / "cuobjdump")
    for lib, pattern in (("minprop_ell", "refreshed_tuples_kernelILi0E"),
                         ("hash_pack", "hash_pack_kernel")):
        for name, instr in _functions(tool, paths[lib]).items():
            if pattern in name:
                print(json.dumps({"sass": lib, "function": name,
                                  "instructions": len(instr)}), flush=True)
                print("\n".join(instr), flush=True)
    if baseline:
        new = _functions(tool, OUT / "default.so")
        old = _functions(tool, OUT / "baseline.so")
        others = sorted(k for k in old if "fused" not in k)
        print(json.dumps({"sass_unchanged": [k for k in others
                                             if new.get(k) == old[k]],
                          "sass_changed": [k for k in others
                                           if new.get(k) != old[k]]}),
              flush=True)


def _round0(torch, ell, id_bits):
    """The resident loop's round-0 state, as ``chip_smoke.py`` times it."""
    v, _ = ell.neighbors.shape
    dev = ell.neighbors.device
    return dict(
        t=torch.ones(v, dtype=torch.int32, device=dev),
        m=torch.full((v,), -1, dtype=torch.int32, device=dev),
        active=torch.ones(v, dtype=torch.bool, device=dev),
        wl2=torch.arange(v, dtype=torch.int32, device=dev),
        n2=torch.full((1,), v, dtype=torch.int32, device=dev),
        wl1=torch.arange(v, dtype=torch.int32, device=dev),
        n1=torch.full((1,), v, dtype=torch.int32, device=dev),
        it=torch.zeros(1, dtype=torch.int32, device=dev))


def _capture_solve(torch, ell, ref, compact, is_undecided, b: int,
                   max_rounds: int = 128) -> list[dict]:
    """Every round's inputs and outputs of one resident solve, from the
    twins (the loop of ``core.mis2.resident_ell_fixed_point``)."""
    st = _round0(torch, ell, None)
    nbrs = ell.neighbors.reshape(-1)
    kw = dict(priority="xorshift_star", b=b)
    t, m, active = st["t"], st["m"], st["active"]
    wl1, n1 = compact(active)
    wl2, n2, it = st["wl2"], st["n2"], st["it"]
    rounds = []
    for _ in range(max_rounds):
        if int(n1.item()) == 0:
            break
        rec = dict(t=t.clone(), m=m.clone(), active=active, wl1=wl1, n1=n1,
                   wl2=wl2, n2=n2, it=it.clone())
        ref.fused_refresh_columns_ref(t, m, nbrs, wl2, n2, it, **kw)
        rec["m_out"] = m.clone()
        ref.fused_decide_ref(t, m, active, nbrs, wl1, n1, it, **kw)
        rec["t_out"] = t.clone()
        rounds.append(rec)
        wl1, n1 = compact(is_undecided(t))
        wl2, n2 = compact(m != -1)
        it = it + 1
    return rounds


def _calls(torch, fns, name, ell, st, b: int):
    """(refresh, decide) launches of build ``name`` on state ``st``, each
    writing into its own working copy; returns them with the copies."""
    v, d = ell.neighbors.shape
    nbrs = ell.neighbors.reshape(-1)
    stream = torch.cuda.current_stream().cuda_stream
    m = st["m"].clone()
    t = st["t"].clone()
    m_ready = st.get("m_out", m)
    scratch = torch.empty(v, dtype=torch.int64, device=t.device)
    (fr, r_scratch), (fd, d_scratch) = (fns[name]["fused_refresh_columns"],
                                        fns[name]["fused_decide"])
    r_head = (st["t"].data_ptr(), m.data_ptr())
    d_head = (t.data_ptr(), m_ready.data_ptr(), st["active"].data_ptr())
    if r_scratch:
        r_head += (scratch.data_ptr(),)
    if d_scratch:
        d_head += (scratch.data_ptr(),)
    kind = 0                                      # xorshift_star

    def refresh():
        return fr(*r_head, nbrs.data_ptr(), st["wl2"].data_ptr(),
                  st["n2"].data_ptr(), st["it"].data_ptr(), v,
                  st["wl2"].shape[0], d, b, kind, stream)

    def decide():
        return fd(*d_head, nbrs.data_ptr(), st["wl1"].data_ptr(),
                  st["n1"].data_ptr(), st["it"].data_ptr(), v,
                  st["wl1"].shape[0], d, b, kind, stream)
    return refresh, decide, m, t


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=kX=value,...")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--solve-reps", type=int, default=10)
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--graphs", nargs="+", default=list(GRAPHS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_minprop: no CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {"default": SRC}
    if args.baseline is not None:
        sources["baseline"] = args.baseline.resolve()
    sources.update(_variant(spec) for spec in args.variant)
    probes = set()
    if args.probes:
        for k, subs in PROBES.items():
            sources[k] = _edited(k, SRC, subs)
            probes.add(k)
        if args.baseline is not None:
            for k, subs in BASELINE_PROBES.items():
                sources[k] = _edited(k, sources["baseline"], subs)
                probes.add(k)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    fns = _build(sources)
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    if args.sass:
        _sass(args.baseline is not None)

    import repro_torch as rt
    from repro_torch.core.mis2 import compact_worklist
    from repro_torch.core.tuples import id_bits, is_undecided
    from repro_torch.kernels.minprop_ell import ref

    names = list(fns)
    for label in args.graphs:
        kind, n = GRAPHS[label]
        g = rt.Graph(getattr(rt.graphs, kind)(n), device="cuda")
        ell = g.ell
        v, d = ell.neighbors.shape
        b = id_bits(v)
        rounds = _capture_solve(torch, ell, ref, compact_worklist,
                                is_undecided, b)
        # round 0 as chip_smoke.py times it: every row live, M of the
        # whole graph refreshed before the decide
        r0 = _round0(torch, ell, None)
        r0["m_out"] = rounds[0]["m_out"]
        r0["t_out"] = None
        rec = {"graph": label, "V": v, "D": d, "rounds": len(rounds),
               "live": {"refresh": [int(r["n2"].item()) for r in rounds],
                        "decide": [int(r["n1"].item()) for r in rounds]}}
        res = {k: {"round0": {"refresh": [], "decide": []},
                   "solve": {"refresh": [], "decide": []}} for k in names}
        for order in (names, names[::-1]):
            for k in order:
                checked = k in probes
                refresh, decide, m, t = _calls(torch, fns, k, ell, r0, b)
                m_in, t_in = r0["m"], r0["t"]
                for which, fn, restore in (
                        ("refresh", refresh, lambda: m.copy_(m_in)),
                        ("decide", decide, lambda: t.copy_(t_in))):
                    restore()
                    if fn() != 0:
                        raise SystemExit(f"{k}: {which} launch failed")
                    _event_ms(torch, fn, 3, restore)
                    res[k]["round0"][which].append(
                        _event_ms(torch, fn, args.reps, restore))
                per_round = {"refresh": [], "decide": []}
                for i, st in enumerate(rounds):
                    refresh, decide, m, t = _calls(torch, fns, k, ell, st, b)
                    refresh()
                    decide()
                    torch.cuda.synchronize()
                    if not checked and not (torch.equal(m, st["m_out"])
                                            and torch.equal(t, st["t_out"])):
                        raise SystemExit(f"{k}: not bitwise equal to the "
                                         f"twins at {label} round {i}")
                    for which, fn, restore in (
                            ("refresh", refresh,
                             lambda st=st, m=m: m.copy_(st["m"])),
                            ("decide", decide,
                             lambda st=st, t=t: t.copy_(st["t"]))):
                        per_round[which].append(_event_ms(
                            torch, fn, args.solve_reps, restore))
                for which, times in per_round.items():
                    res[k]["solve"][which].append(times)
        rec["ms_round0"] = {k: {w: v for w, v in r["round0"].items()}
                            for k, r in res.items()}
        rec["ms_solve"] = {k: {w: [sum(ts) for ts in v]
                               for w, v in r["solve"].items()}
                           for k, r in res.items()}
        rec["ms_solve_by_round"] = {k: {w: v[0] for w, v in r["solve"].items()}
                                    for k, r in res.items()}
        rec["bitwise"] = [k for k in names if k not in probes]
        print(json.dumps(rec), flush=True)
        del g, ell, rounds
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
