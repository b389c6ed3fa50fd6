#!/usr/bin/env python3
"""Variants of the MIS-2 round kernels, side by side on one GPU.

    python3 tools/bench_minprop.py [--baseline OLD.cu] \
        [--variant NAME=kSlabFillLanes=135168,kSlabChunk=8 ...] \
        [--probes [NAME ...]] [--reps 30] [--solve-reps 10] [--sass] \
        [--graphs Laplace3D_100 Elasticity3D_60 Powerlaw_1M]

Builds ``src/repro_torch/kernels/csrc/minprop_ell.cu`` as it stands
(``default``); each ``--variant``, a copy of it with the named
``constexpr`` constants rewritten (``NAME=kX=value,...``) or the named
text edit ``EDITS[NAME]`` applied (``NAME`` alone: ``hash_once``);
``--baseline``, another version of the same file with the same C entry
points (the fused refresh's scratch argument may be missing); and, with
``--probes``, the ``PROBES`` copies of the default
source and, given ``--baseline``, the ``BASELINE_PROBES`` copies of the
baseline (all of them, or the named ones).  All ``nvcc`` processes start
together, into ``build/bench_minprop/``.

Every build but the probes is held bit for bit against the plain-torch
twins and timed with ``chip_smoke.py``'s timer (the median of ``--reps``
launches, each alone between CUDA events after a 256 MB L2 flush, the
builds taken in turns and then again in reverse order):

- on Laplace3D_100 and Elasticity3D_60, the fused passes at round 0 of
  the resident loop (every row live and undecided, the state
  ``chip_smoke.py`` times) and over one whole resident solve: the
  per-round inputs of one ``mis2`` (worklists, counts, T and M), captured
  once from the twins, each round's launch timed alone and the medians
  summed;
- on Powerlaw_1M (``powerlaw_graph(1_000_000, 8.0, exponent=2.5,
  seed=42)``, the hybrid layout), the sliced passes on each of its four
  slabs, the same way, over the whole ``cuda_hybrid`` solve of ``mis2``
  (``Powerlaw_1M mis2``: round 0 is the state ``chip_smoke.py`` times)
  and over the phase-2 solve of ``coarsen(method="two_phase")``
  (``Powerlaw_1M phase2``, the solve with a real ``active`` mask, its
  mask recorded from a run of the port).  Each slab is timed in every form
  a build offers: the refresh hashing inline (``inline``) or, in the
  ``hash_once`` variant, reading one round's refreshed tuples (``hashed``,
  its ``refreshed_tuples`` pass timed apart as ``pass``), the decide
  gathering M and the mask (``gated``) or, where it takes a null mask, one
  word (``ungated``: M, or on the masked solve the word ``active ? M :
  IN``, whose plain-torch ``where`` is timed apart as ``mask``).  ``refresh_total`` sums a whole solve's refresh for each
  width from which the slabs read the hashed tuples (``inline``: none);
- on Laplace3D_100 and Elasticity3D_60, also the unfused passes of the
  host-driven round (``refresh_columns`` / ``decide``, one JSON line a
  graph with ``"unfused": true``): at round 0 as ``chip_smoke.py`` times
  it (every row live in a pow2 bucket), under the 256 MB write flush and
  under a 256 MB read flush (``*_read_flush``), and over every round of a
  ``cuda_compacted`` ``mis2`` and of the ``coarsen(method="two_phase",
  mis2_engine="cuda_compacted")`` MIS-2 solves, each launch's inputs
  recorded from a run of the port and each build held bit for bit against
  the twins on them.

``--sass`` prints the SASS of the default build's per-vertex hash pass
(``refreshed_tuples_kernel``, xorshift64*) and of each form of
``hash_pack_kernel``, with their instruction counts, from ``cuobjdump
-sass``; given a baseline, it
also says which of the baseline's kernels compiled to the same
instructions in the default build (whatever their names), and whether
every fused and sliced instance (``*group_kernel*``) did.  ``--variant
staged`` builds the unfused passes with a warp's rows staged in shared
memory at one lane a row (``EDITS["staged"]``; the source loads them
directly).  ``--graphs`` with no name times nothing (with ``--sass``:
the SASS check alone).  Prints one JSON line per build (``ptxas``
registers) and per graph or solve, and the card's ``nvidia-smi`` name and
power limit.
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
GRAPHS = {"Laplace3D_100": ("laplace3d", (100,), {}),
          "Elasticity3D_60": ("elasticity3d", (60,), {}),
          "Powerlaw_1M": ("powerlaw_graph", (1_000_000, 8.0),
                          {"exponent": 2.5, "seed": 42})}
ENTRIES = ("fused_refresh_columns", "fused_decide", "refreshed_tuples",
           "sliced_refresh_columns", "sliced_decide", "refresh_columns",
           "decide")
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import _event_ms  # noqa: E402

# probes: the default source with one read or pass removed (wrong results,
# not checked), to show what each costs
PROBES = {
    "probe_no_hash_pass": [
        ("pre<<<grid_for(pre, v, kThreads), kThreads, 0, stream>>>(t, h, it, "
         "v, b);", "")],
    "probe_no_gather": [("? src[nb[c]] : kOut;",
                         "? static_cast<uint32_t>(nb[c]) : kOut;")],
    "probe_no_active": [("av[c] = nb[c] >= 0 ? active[nb[c]] : 0u;",
                         "av[c] = nb[c] >= 0;")],
    "probe_decide_no_gather": [
        ("av[c] = nb[c] >= 0 ? active[nb[c]] : 0u;", "av[c] = nb[c] >= 0;"),
        ("mv[c] = nb[c] >= 0 ? m[nb[c]] : 0u;",
         "mv[c] = static_cast<uint32_t>(nb[c]);"),
        ("mv[c] = nb[c] >= 0 ? m[nb[c]] : kIn;",
         "mv[c] = static_cast<uint32_t>(nb[c]);")],
    "probe_no_slab_rows": [("return row >= 0 ? slab_rows[row] : -1;",
                            "return row;")],
}
# named variants: text edits of the default source.  hash_once: the sliced
# refresh reads one round's refreshed tuples, each vertex hashed once by a
# `refreshed_tuples` entry (the per-vertex pass of the fused refresh), when
# it is given no round (`it` null): the form the timing calls `hashed`
_SLICED_REFRESH = """    with_kind(kind, [&](auto k) {
      launch_refresh<true, false, decltype(k)::value>(
          slab_group_lanes(d, r), static_cast<const uint32_t*>(t),
"""
EDITS = {
    "hash_once": [
        (_SLICED_REFRESH, """    if (it == nullptr) {
      launch_refresh<true, true, kXorshiftStar>(
          slab_group_lanes(d, r), static_cast<const uint32_t*>(t),
          static_cast<uint32_t*>(m), static_cast<const int32_t*>(nbrs),
          static_cast<const int32_t*>(wl), static_cast<const int32_t*>(count),
          nullptr, r, w, d, b, static_cast<const int32_t*>(slab_rows),
          static_cast<cudaStream_t>(stream));
      return static_cast<int>(cudaGetLastError());
    }
""" + _SLICED_REFRESH),
        ("// `active` null: a neighbour is active where its M is not IN",
         """int refreshed_tuples(const void* t, void* h, const void* it, int64_t v,
                     int b, int kind, void* stream) {
  using namespace repro_torch;
  with_kind(kind, [&](auto k) {
    launch_refreshed_tuples<decltype(k)::value>(
        static_cast<const uint32_t*>(t), static_cast<uint32_t*>(h),
        static_cast<const uint32_t*>(it), v, b,
        static_cast<cudaStream_t>(stream));
  });
  return static_cast<int>(cudaGetLastError());
}

// `active` null: a neighbour is active where its M is not IN""")],
}
# staged: the unfused passes at one lane a row (G = 1) stage a warp's 32
# consecutive rows of the copy in shared memory (16-byte loads where
# aligned, an odd row stride) before each lane gathers its row's words, at
# kMinBlocksStaged blocks an SM (at 8 the staged instances spill)
_STAGE_HELPERS = """
// whether a pass stages its warp's rows in shared memory: a copy at G = 1
template <int Map, int G>
constexpr bool kStaged = Map == kCopy && G == 1;

// A warp's region of the shared stage: 32 rows of at most C + 1 words
template <int C>
__device__ __forceinline__ int32_t* warp_stage() {
  __shared__ __align__(16) int32_t stage[kThreads / 32][32 * (C + 1)];
  return stage[threadIdx.x >> 5];
}

// Rows base .. base + 31 of a copy, those below `live`, into the warp's
// region at the odd row stride d | 1: 16-byte loads of the span where it
// is aligned (it starts at a multiple of 32 rows), stored as they came at
// an odd d; 4-byte ones for the rest.  Returns the region once every
// lane's words are in.
template <int C>
__device__ __forceinline__ const int32_t* stage_rows(
    const int32_t* __restrict__ nbrs, int64_t base, int64_t live, int d,
    int lane) {
  int32_t* st = warp_stage<C>();
  const int64_t end = base + 32 < live ? base + 32 : live;
  const int words = end > base ? static_cast<int>(end - base) * d : 0;
  const int32_t* src = nbrs + base * d;
  const bool pad = (d & 1) == 0;
  __syncwarp();                    // the last batch's rows are read
  int k = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int4* src4 = reinterpret_cast<const int4*>(src);
    const int quads = words >> 2;
    if (pad) {
      for (int q = lane; q < quads; q += 32) {
        const int4 x = src4[q];
        const int32_t v4[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * q + e;
          st[j + j / d] = v4[e];
        }
      }
    } else {
      int4* st4 = reinterpret_cast<int4*>(st);
      for (int q = lane; q < quads; q += 32) st4[q] = src4[q];
    }
    k = quads * 4;
  }
  for (int j = k + lane; j < words; j += 32) {
    st[j + (pad ? j / d : 0)] = src[j];
  }
  __syncwarp();
  return st;
}

// load_ids of a lane's own staged row (G = 1): slots k0 .. k0 + C - 1
template <int C>
__device__ __forceinline__ void load_staged_ids(int32_t (&nb)[C],
                                                const int32_t* st, int32_t r,
                                                int k0, int lane, int d) {
  const int at = lane * (d | 1);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = k0 + c;
    nb[c] = r >= 0 && j < d ? st[at + j] : -1;
  }
}

"""
_LOAD = "        load_ids<G, C>(nb, nbrs, r, k0, sub, d);\n"
_STAGED_LOAD = """        if constexpr (kStaged<Map, G>) {
          load_staged_ids<C>(nb, st, r, k0, lane, d);
        } else {
          load_ids<G, C>(nb, nbrs, r, k0, sub, d);
        }
"""
_STAGE = """    const int32_t* st = nullptr;
    if constexpr (kStaged<Map, G>) {
      st = stage_rows<C>(nbrs, base, rows < n ? rows : n, d, lane);
    }
"""
EDITS["staged"] = [
    ("    nb[c] = r >= 0 && j < d ? nbrs[static_cast<int64_t>(r) * d + j] : -1;"
     "\n  }\n}\n",
     "    nb[c] = r >= 0 && j < d ? nbrs[static_cast<int64_t>(r) * d + j] : -1;"
     "\n  }\n}\n" + _STAGE_HELPERS),
    ("constexpr int kMinBlocksWide = 4;\n\ntemplate <int C>\n"
     "constexpr int min_blocks() {\n  return C > 8 ? kMinBlocksWide : "
     "kMinBlocks;\n}",
     "constexpr int kMinBlocksWide = 4;\nconstexpr int kMinBlocksStaged = 4;"
     "\n\ntemplate <int C, bool kStage = false>\nconstexpr int min_blocks() {"
     "\n  return kStage ? kMinBlocksStaged : C > 8 ? kMinBlocksWide : "
     "kMinBlocks;\n}"),
    ("min_blocks<C>()", "min_blocks<C, kStaged<Map, G>>()"),
    ("    uint32_t res = kOut;\n    for (int s = 0;",
     _STAGE + "    uint32_t res = kOut;\n    for (int s = 0;"),
    ("    uint32_t res = 0;\n    for (int s = 0;",
     _STAGE + "    uint32_t res = 0;\n    for (int s = 0;"),
    (_LOAD, _STAGED_LOAD)]
# the same questions asked of the source before the unfused passes were
# redesigned (one thread a slot looping over its row of the copy)
BASELINE_PROBES = {
    "baseline_probe_no_t_gather": [("const uint32_t tv = t[r[j]];",
                                    "const uint32_t tv = r[j];")],
    "baseline_probe_no_active": [("    if (!active[nb]) continue;\n", "")],
    "baseline_probe_no_m": [("const uint32_t mv = m[nb];",
                             "const uint32_t mv = static_cast<uint32_t>(nb);")],
    "baseline_probe_no_early_return": [
        ("    if (mv == kOut) {\n      out[i] = kOut;\n      return;\n    }\n"
         "    all_eq = all_eq && mv == tv;",
         "    all_eq = all_eq && mv == tv && mv != kOut;")],
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


def _variant(spec: str, src: Path = SRC) -> tuple[str, Path]:
    """``NAME=kX=value,...``: the source ``src`` with constants rewritten;
    ``NAME`` alone: the named text edit ``EDITS[NAME]`` of the default."""
    name, _, consts = spec.partition("=")
    if not consts:
        if name not in EDITS:
            raise SystemExit(f"no edit named {name!r} (EDITS: {list(EDITS)})")
        return name, _edited(name, SRC, EDITS[name])
    subs = []
    for item in consts.split(","):
        const, _, value = item.partition("=")
        m = re.search(rf"constexpr \w+ {const} = [^;]+;", src.read_text())
        if m is None:
            raise SystemExit(f"{name}: no constexpr {const} in {src.name}")
        old = m.group(0)
        subs.append((old, old[:old.index("=") + 2] + value + ";"))
    return name, _edited(name if src == SRC else f"{src.stem}_{name}", src,
                         subs)


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
    """``ptxas -v``: registers and spill stores of the round passes."""
    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn and re.search("group|fused|sliced|refreshed_tuples|"
                                  "columns_kernel|decide_kernel", fn):
            key = _short(fn)
            out[key] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and fn and int(m.group(1)) and re.search(
                "group|fused|sliced", fn):
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
        # the sliced decide takes no mask (a null `active`) where it says so
        fns[name] = {"ungated": "active == nullptr" in
                     sources[name].read_text()}
        for fn_name in ENTRIES:
            if not hasattr(lib, fn_name):
                continue
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
        bodies = {tuple(v) for v in new.values()}
        same = sorted(k for k, v in old.items() if tuple(v) in bodies)
        group = [k for k in old if "group_kernel" in k]
        print(json.dumps({"sass_same_in_default": same,
                          "sass_not_in_default": sorted(set(old) - set(same)),
                          "group_instances_unchanged": all(
                              k in same for k in group),
                          "group_instances": len(group),
                          "every_instance_unchanged": len(same) == len(old),
                          "instances": len(old)}), flush=True)


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
    twins (the rounds of ``ref.resident_fixed_point_ref``, the worklists
    compacted over ``[V]``, which gives the same lists)."""
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


def _bench_ell(torch, rt, fns, names, probes, label: str, args) -> None:
    """The fused passes on one paper graph: round 0 and a whole solve."""
    from repro_torch.core.mis2 import compact_worklist
    from repro_torch.core.tuples import id_bits, is_undecided
    from repro_torch.kernels.minprop_ell import ref

    kind, gen_args, kw = GRAPHS[label]
    g = rt.Graph(getattr(rt.graphs, kind)(*gen_args, **kw), device="cuda")
    ell = g.ell
    v, d = ell.neighbors.shape
    b = id_bits(v)
    rounds = _capture_solve(torch, ell, ref, compact_worklist, is_undecided,
                            b)
    # round 0 as chip_smoke.py times it: every row live, M of the whole
    # graph refreshed before the decide
    r0 = _round0(torch, ell, None)
    r0["m_out"] = rounds[0]["m_out"]
    r0["t_out"] = None
    rec = {"graph": label, "V": v, "D": d, "rounds": len(rounds),
           "live": {"refresh": [int(r["n2"].item()) for r in rounds],
                    "decide": [int(r["n1"].item()) for r in rounds]}}
    names = [k for k in names if "fused_decide" in fns[k]]
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
    rec["ms_round0"] = {k: dict(r["round0"]) for k, r in res.items()}
    rec["ms_solve"] = {k: {w: [sum(ts) for ts in v]
                           for w, v in r["solve"].items()}
                       for k, r in res.items()}
    rec["ms_solve_by_round"] = {k: {w: v[0] for w, v in r["solve"].items()}
                                for k, r in res.items()}
    rec["bitwise"] = [k for k in names if k not in probes]
    print(json.dumps(rec), flush=True)


def _capture_hybrid(torch, hyb, active, b: int,
                    max_rounds: int = 128) -> list[dict]:
    """Every round's inputs and outputs of one ``cuda_hybrid`` solve, from
    the twins (the loop of ``ref.hybrid_fixed_point_ref``): T and
    M at the round's start, each slab's worklists and counts, M after the
    refreshes and T after the decides.  ``active`` None: no mask."""
    from repro_torch.core.mis2 import compact_worklist
    from repro_torch.core.tuples import is_undecided
    from repro_torch.kernels.minprop_ell import ref

    v = hyb.num_vertices
    dev = hyb.spill_rows.device
    act = torch.ones(v, dtype=torch.bool, device=dev) if active is None \
        else active
    kw = dict(priority="xorshift_star", b=b)
    spill = (hyb.spill_rows, hyb.spill_seg, hyb.spill_cols)
    t = torch.where(act, 1, -1).to(torch.int32)
    m = torch.full((v,), -1, dtype=torch.int32, device=dev)
    und, live = act, torch.ones(v, dtype=torch.bool, device=dev)
    it = torch.zeros(1, dtype=torch.int32, device=dev)
    rounds = []
    for _ in range(max_rounds):
        if not bool(und.any()):
            break
        rec = dict(t=t.clone(), m=m.clone(), it=it.clone(), slabs=[])
        for sl in hyb.slices:
            wl2, n2 = compact_worklist(live[sl.rows])
            wl1, n1 = compact_worklist(und[sl.rows])
            rec["slabs"].append(dict(wl2=wl2, n2=n2, wl1=wl1, n1=n1))
        for sl, x in zip(hyb.slices, rec["slabs"]):
            ref.sliced_refresh_columns_ref(t, m, sl.rows,
                                           sl.neighbors.reshape(-1),
                                           x["wl2"], x["n2"], it, **kw)
        if hyb.num_spill_rows:
            ref.spill_refresh_columns(t, m, *spill, live, it, **kw)
        rec["m_out"] = m.clone()
        for sl, x in zip(hyb.slices, rec["slabs"]):
            ref.sliced_decide_ref(t, m, act, sl.rows, sl.neighbors.reshape(-1),
                                  x["wl1"], x["n1"], it, **kw)
        if hyb.num_spill_rows:
            ref.spill_decide(t, m, act, *spill, it, **kw)
        rec["t_out"] = t.clone()
        rec["h"] = _refreshed(torch, rec["t"], it, b)
        rec["mw"] = torch.where(act, rec["m_out"], 0).to(torch.int32)
        rounds.append(rec)
        und, live = is_undecided(t), m != -1
        it = it + 1
    return rounds


def _refreshed(torch, t, it, b: int):
    """The round's refreshed tuple of every vertex (xorshift64*), as the
    twins refresh T."""
    from repro_torch.core.hashing import PRIORITY_FNS
    from repro_torch.core.tuples import is_undecided, narrow, pack

    vids = torch.arange(t.shape[0], device=t.device)
    fresh = narrow(pack(PRIORITY_FNS["xorshift_star"](it, vids), vids, b))
    return torch.where(is_undecided(t), fresh, t)


def _phase2_mask(torch, rt, g):
    """The ``active`` mask of the phase-2 MIS-2 of ``coarsen(method=
    "two_phase")`` on ``g``, recorded from a run of the port."""
    from repro_torch.core import aggregation

    seen = []
    run = aggregation.run_mis2

    def record(gh, active, *a, **kw):
        if active is not None:
            seen.append(active.clone())
        return run(gh, active, *a, **kw)

    aggregation.run_mis2 = record
    try:
        rt.coarsen(g, method="two_phase")
    finally:
        aggregation.run_mis2 = run
    return seen[0]


def _slab_forms(fns, k: str) -> dict:
    """Which forms of the sliced passes build ``k`` offers."""
    hashed = "refreshed_tuples" in fns[k]
    return {"refresh": ["inline"] + (["hashed"] if hashed else []),
            "decide": ["gated"] + (["ungated"] if fns[k]["ungated"] else []),
            "pass": hashed}


def _slab_launch(torch, fns, k, sl, x, rec, which, form, active, b: int):
    """A launcher of build ``k``'s sliced ``which`` pass in ``form`` on slab
    ``sl`` at round ``rec`` (slab worklists ``x``), writing into a working
    copy; returns it with the copy, its expected value and its restore."""
    stream = torch.cuda.current_stream().cuda_stream
    r, w = sl.num_rows, sl.width
    nbrs = sl.neighbors.reshape(-1)
    rows = sl.rows.to(torch.int64)
    if which == "refresh":
        fn = fns[k]["sliced_refresh_columns"][0]
        src, it = (rec["t"], rec["it"]) if form == "inline" \
            else (rec["h"], None)
        out, start = rec["m"].clone(), rec["m"]
        want = start.clone()
        want[rows] = rec["m_out"][rows]
        args = (src.data_ptr(), out.data_ptr(), sl.rows.data_ptr(),
                nbrs.data_ptr(), x["wl2"].data_ptr(), x["n2"].data_ptr(),
                None if it is None else it.data_ptr(), r, r, w, b, 0, stream)
    else:
        fn = fns[k]["sliced_decide"][0]
        if form == "gated":
            mm, act = rec["m_out"], active.data_ptr()
        else:
            mm, act = rec["mw"], None
        out, start = rec["t"].clone(), rec["t"]
        want = start.clone()
        want[rows] = rec["t_out"][rows]
        args = (out.data_ptr(), mm.data_ptr(), act, sl.rows.data_ptr(),
                nbrs.data_ptr(), x["wl1"].data_ptr(), x["n1"].data_ptr(),
                rec["it"].data_ptr(), r, r, w, b, 0, stream)
    return (lambda: fn(*args)), out, want, (lambda: out.copy_(start))


def _bench_hybrid(torch, rt, fns, names, probes, args) -> None:
    """The sliced passes on every slab of Powerlaw_1M, over the ``mis2``
    solve (round 0 as ``chip_smoke.py`` times it) and the phase-2 solve of
    two-phase coarsening."""
    from repro_torch.core.tuples import id_bits

    kind, gen_args, kw = GRAPHS["Powerlaw_1M"]
    g = rt.Graph(getattr(rt.graphs, kind)(*gen_args, **kw), device="cuda")
    hyb = g.hybrid()
    v = hyb.num_vertices
    b = id_bits(v)
    names = [k for k in names if "sliced_decide" in fns[k]]
    for solve, active in (("mis2", None),
                          ("phase2", _phase2_mask(torch, rt, g))):
        rounds = _capture_hybrid(torch, hyb, active, b)
        act = torch.ones(v, dtype=torch.bool, device="cuda") \
            if active is None else active
        rec = {"graph": "Powerlaw_1M", "solve": solve, "V": v,
               "rounds": len(rounds), "widths": list(hyb.slice_widths),
               "slab_rows": list(hyb.slice_num_rows),
               "active": int(act.sum()),
               "size": int((rounds[-1]["t_out"] == 0).sum()),
               "live": {f"width {sl.width}": {
                   "refresh": [int(r["slabs"][i]["n2"]) for r in rounds],
                   "decide": [int(r["slabs"][i]["n1"]) for r in rounds]}
                   for i, sl in enumerate(hyb.slices)}}
        # res[k][form][width]: per order, per round ms; pass / mask per round
        res = {k: {} for k in names}
        r0 = {k: {} for k in names}
        for order in (names, names[::-1]):
            for k in order:
                forms = _slab_forms(fns, k)
                cases = [(wh, f) for wh in ("refresh", "decide")
                         for f in forms[wh]]
                for wh, f in cases:
                    for i, sl in enumerate(hyb.slices):
                        per_round = []
                        for j, rd in enumerate(rounds):
                            fn, out, want, restore = _slab_launch(
                                torch, fns, k, sl, rd["slabs"][i], rd, wh, f,
                                act, b)
                            if fn() != 0:
                                raise SystemExit(f"{k}: {wh} launch failed")
                            torch.cuda.synchronize()
                            if k not in probes and not torch.equal(out, want):
                                raise SystemExit(
                                    f"{k}: {wh} ({f}) not bitwise equal to "
                                    f"the twins, {solve} round {j}, width "
                                    f"{sl.width}")
                            if j == 0 and solve == "mis2":
                                _event_ms(torch, fn, 3, restore)
                                r0[k].setdefault(f"{wh}_{f}", {}).setdefault(
                                    f"width {sl.width}", []).append(
                                    _event_ms(torch, fn, args.reps, restore))
                            per_round.append(_event_ms(
                                torch, fn, args.solve_reps, restore))
                        res[k].setdefault(f"{wh}_{f}", {}).setdefault(
                            f"width {sl.width}", []).append(per_round)
                if forms["pass"]:
                    fn = fns[k]["refreshed_tuples"][0]
                    per_round = []
                    for j, rd in enumerate(rounds):
                        h = torch.empty_like(rd["t"])
                        call = (lambda rd=rd, h=h: fn(
                            rd["t"].data_ptr(), h.data_ptr(),
                            rd["it"].data_ptr(), v, b, 0,
                            torch.cuda.current_stream().cuda_stream))
                        call()
                        torch.cuda.synchronize()
                        if k not in probes and not torch.equal(h, rd["h"]):
                            raise SystemExit(f"{k}: refreshed_tuples not "
                                             f"bitwise equal, round {j}")
                        if j == 0 and solve == "mis2":
                            r0[k].setdefault("pass", []).append(
                                _event_ms(torch, call, args.reps))
                        per_round.append(_event_ms(torch, call,
                                                   args.solve_reps))
                    res[k].setdefault("pass", []).append(per_round)
        if active is not None:
            rec["ms_mask_by_round"] = [_event_ms(
                torch, lambda rd=rd: torch.where(act, rd["m_out"], 0),
                args.solve_reps) for rd in rounds]
        widths = list(hyb.slice_widths)
        sums = {}
        for k, forms in res.items():
            sums[k] = {}
            for form, by in forms.items():
                if form == "pass":
                    sums[k]["pass"] = [sum(x) for x in by]
                    continue
                sums[k][form] = {wd: [sum(x) for x in lists]
                                 for wd, lists in by.items()}
            total = {}
            for form in ("refresh_inline", "refresh_hashed", "decide_gated",
                         "decide_ungated"):
                if form in sums[k]:
                    total[form] = [sum(sums[k][form][f"width {wd}"][o]
                                       for wd in widths) for o in (0, 1)]
            if "refresh_hashed" in sums[k]:
                for lo in widths:
                    total[f"refresh_hashed_from_{lo}"] = [
                        sum(sums[k]["refresh_inline" if wd < lo
                                    else "refresh_hashed"][f"width {wd}"][o]
                            for wd in widths) + sums[k]["pass"][o]
                        for o in (0, 1)]
            sums[k]["totals"] = total
        rec["ms_solve"] = sums
        if solve == "mis2":
            rec["ms_round0"] = r0
        rec["ms_solve_by_round"] = {k: {f: (by[0] if f == "pass" else
                                            {wd: x[0] for wd, x in by.items()})
                                        for f, by in forms.items()}
                                    for k, forms in res.items()}
        rec["bitwise"] = [k for k in names if k not in probes]
        print(json.dumps(rec), flush=True)
        del rounds


def _unfused_round0(torch, ell, b: int) -> dict:
    """The host-driven round 0 as ``chip_smoke.py`` times it: every row
    live in a pow2 bucket (dead slots gathering row V-1), T after the row
    refresh, M after the column refresh, every vertex active."""
    from repro_torch.core.hashing import PRIORITY_FNS
    from repro_torch.core.tuples import narrow, pack
    from repro_torch.kernels.minprop_ell import ref

    v, _ = ell.neighbors.shape
    dev = ell.neighbors.device
    w = 1 << (v - 1).bit_length()
    rows = torch.arange(w, device=dev).clamp(max=v - 1)
    wl_nbrs = ell.neighbors[rows].contiguous()
    vids = torch.arange(v, device=dev)
    t = narrow(pack(PRIORITY_FNS["xorshift_star"](0, vids), vids, b))
    m = ref.refresh_columns_ref(t, wl_nbrs, v)[:v].contiguous()
    return dict(t=t, r_rows=wl_nbrs, r_count=v, t_rows=t[rows].contiguous(),
                m=m, active=torch.ones(v, dtype=torch.bool, device=dev),
                d_rows=wl_nbrs, d_count=v)


def _capture_unfused(torch, run) -> list[dict]:
    """The inputs of every unfused launch of ``run()`` (host-driven solves
    on the card), one record a round, with the twins' outputs on them."""
    from repro_torch.kernels.minprop_ell import ops, ref

    rounds = []
    refresh, decide = ops.refresh_columns_rows, ops.decide_rows

    def rec_refresh(t, wl_neighbors, count):
        rounds.append(dict(t=t.clone(), r_rows=wl_neighbors, r_count=count))
        return refresh(t, wl_neighbors, count)

    def rec_decide(t_rows, m, active, wl_neighbors, count):
        rounds[-1].update(t_rows=t_rows.clone(), m=m.clone(),
                          active=active.clone(), d_rows=wl_neighbors,
                          d_count=count)
        return decide(t_rows, m, active, wl_neighbors, count)

    ops.refresh_columns_rows, ops.decide_rows = rec_refresh, rec_decide
    try:
        run()
    finally:
        ops.refresh_columns_rows, ops.decide_rows = refresh, decide
    for r in rounds:
        _unfused_want(ref, r)
    return rounds


def _unfused_want(ref, r: dict) -> None:
    r["m_want"] = ref.refresh_columns_ref(r["t"], r["r_rows"], r["r_count"])
    r["t_want"] = ref.decide_ref(r["t_rows"], r["m"], r["active"],
                                 r["d_rows"], r["d_count"])


def _unfused_calls(torch, fns, k: str, r: dict):
    """(refresh, decide) launches of build ``k`` on round ``r``, each
    writing a fresh output; returns them with the outputs."""
    stream = torch.cuda.current_stream().cuda_stream
    fr, fd = fns[k]["refresh_columns"][0], fns[k]["decide"][0]
    (wr, dr), (wd, dd) = r["r_rows"].shape, r["d_rows"].shape
    m_out = torch.empty(wr, dtype=torch.int32, device="cuda")
    t_out = torch.empty(wd, dtype=torch.int32, device="cuda")

    def refresh():
        return fr(r["t"].data_ptr(), r["r_rows"].data_ptr(),
                  m_out.data_ptr(), wr, dr, r["r_count"], stream)

    def decide():
        return fd(r["t_rows"].data_ptr(), r["m"].data_ptr(),
                  r["active"].data_ptr(), r["d_rows"].data_ptr(),
                  t_out.data_ptr(), wd, dd, r["d_count"], stream)
    return refresh, decide, m_out, t_out


def _held(torch, fns, k: str, r: dict, where: str, checked: bool):
    """Build ``k``'s launches on round ``r``, run once and held bit for bit
    against the twins (unless ``checked`` is false: a probe)."""
    refresh, decide, m_out, t_out = _unfused_calls(torch, fns, k, r)
    if refresh() != 0 or decide() != 0:
        raise SystemExit(f"{k}: unfused launch failed at {where}")
    torch.cuda.synchronize()
    if checked and not (torch.equal(m_out, r["m_want"])
                        and torch.equal(t_out, r["t_want"])):
        raise SystemExit(f"{k}: unfused passes not bitwise equal to the "
                         f"twins at {where}")
    return refresh, decide


def _bench_unfused(torch, rt, fns, names, probes, label: str, args) -> None:
    """The unfused passes on one paper graph: round 0 under both flushes,
    and every round of the host-driven ``mis2`` and coarsening solves."""
    from repro_torch.core.tuples import id_bits
    from repro_torch.kernels.minprop_ell import ref

    kind, gen_args, kw = GRAPHS[label]
    g = rt.Graph(getattr(rt.graphs, kind)(*gen_args, **kw), device="cuda")
    ell = g.ell
    v, d = ell.neighbors.shape
    r0 = _unfused_round0(torch, ell, id_bits(v))
    _unfused_want(ref, r0)
    solves = {
        "mis2": _capture_unfused(
            torch, lambda: rt.mis2(g, engine="cuda_compacted")),
        "coarsen": _capture_unfused(
            torch, lambda: rt.coarsen(g, method="two_phase",
                                      mis2_engine="cuda_compacted"))}
    rec = {"graph": label, "unfused": True, "V": v, "D": d,
           "W_round0": r0["r_rows"].shape[0],
           "rounds": {s: len(rs) for s, rs in solves.items()},
           "live": {s: {"refresh": [[r["r_rows"].shape[0], r["r_count"]]
                                    for r in rs],
                        "decide": [[r["d_rows"].shape[0], r["d_count"]]
                                   for r in rs]}
                    for s, rs in solves.items()}}
    names = [k for k in names if "decide" in fns[k]]
    res = {k: {"round0": {}, **{s: {"refresh": [], "decide": []}
                                for s in solves}} for k in names}
    for order in (names, names[::-1]):
        for k in order:
            checked = k not in probes
            refresh, decide = _held(torch, fns, k, r0, "round 0", checked)
            for which, fn in (("refresh", refresh), ("decide", decide)):
                _event_ms(torch, fn, 3)
                for suffix, clean in (("", False), ("_read_flush", True)):
                    res[k]["round0"].setdefault(which + suffix, []).append(
                        _event_ms(torch, fn, args.reps, clean=clean))
            for s, rs in solves.items():
                per = {"refresh": [], "decide": []}
                for i, r in enumerate(rs):
                    refresh, decide = _held(torch, fns, k, r,
                                            f"{s} round {i}", checked)
                    per["refresh"].append(_event_ms(torch, refresh,
                                                    args.solve_reps))
                    per["decide"].append(_event_ms(torch, decide,
                                                   args.solve_reps))
                for which, times in per.items():
                    res[k][s][which].append(times)
    rec["ms_round0"] = {k: x["round0"] for k, x in res.items()}
    rec["ms_solve"] = {s: {k: {w: [sum(ts) for ts in x[s][w]]
                               for w in ("refresh", "decide")}
                           for k, x in res.items()} for s in solves}
    rec["ms_solve_by_round"] = {s: {k: {w: x[s][w][0]
                                        for w in ("refresh", "decide")}
                                    for k, x in res.items()} for s in solves}
    rec["bitwise"] = [k for k in names if k not in probes]
    print(json.dumps(rec), flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=kX=value,...")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--solve-reps", type=int, default=10)
    ap.add_argument("--probes", nargs="*", default=None,
                    help="all probes, or the named ones")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--graphs", nargs="*", default=list(GRAPHS),
                    choices=list(GRAPHS))
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
    if args.probes is not None:
        table = dict(PROBES)
        if args.baseline is not None:
            table.update(BASELINE_PROBES)
        for k in args.probes or table:
            base = sources["baseline"] if k in BASELINE_PROBES else SRC
            sources[k] = _edited(k, base, table[k])
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

    names = list(fns)
    for label in args.graphs:
        if label == "Powerlaw_1M":
            _bench_hybrid(torch, rt, fns, names, probes, args)
        else:
            _bench_ell(torch, rt, fns, names, probes, label, args)
            _bench_unfused(torch, rt, fns, names, probes, label, args)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
