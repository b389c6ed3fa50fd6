#!/usr/bin/env python3
"""The server's routing cut, measured: a group of ``engine=None`` requests
served as one batched dispatch against each request run alone, on one GPU.

    python3 tools/bench_serve_route.py [--reps 3] [--kinds mis2 coarsen color]

``repro_torch.serve.server.BATCH_MAX_ELL_BYTES`` decides which route a graph
of an ``engine=None`` group takes: at or below it (by the graph's
``ell_bytes_estimate()``) the graph joins the group's batched dispatch (the
batched kernels over its padded rows, one launch a bucket a fixed point),
past it the graph runs alone through the facade's ``engine=None`` path (the
device-resident kernels).  For each group below and each kind,
two servers serve the same requests, one with the cut set past every graph
(all batched) and one with it at 0 (all alone); each serves the group once
untimed, then ``--reps`` times on the host clock (submit to the last
result, ending in ``torch.cuda.synchronize()``; ``cache_bytes=0``, so each
rep computes).  Every response of both routes is held to its direct facade
call's digest.  Groups (``GROUPS``): distinct graphs ``laplace3d(n, n,
n - k)`` and ``elasticity3d(n, n, n - k)``, k = 0, 1, ..., from 24,000 to
1,000,000 rows a graph, and the pair Laplace3D_100 + Elasticity3D_60.
``--groups`` keeps the groups whose label contains one of the given
strings.

Prints the card's name and power limit, then one JSON line per (group,
kind) with both routes' times in ms.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _family(name: str, count: int, n: int) -> tuple[str, list]:
    """``count`` distinct graphs ``name(n, n, n - k)``, k = 0..count-1."""
    return (f"{count} x {name}({n}, {n}, {n}-k)",
            [(name, (n, n, n - k)) for k in range(count)])


GROUPS = dict([_family("laplace3d", 8, n) for n in (32, 40, 48, 64, 80)]
              + [_family("laplace3d", 2, 100)]
              + [_family("elasticity3d", 8, 20),
                 _family("elasticity3d", 4, 30),
                 _family("elasticity3d", 2, 60)])
GROUPS["Laplace3D_100 + Elasticity3D_60"] = [("laplace3d", (100,)),
                                             ("elasticity3d", (60,))]


def _serve_ms(torch, Server, ServerConfig, kind, graphs, reps):
    srv = Server(ServerConfig(max_batch=len(graphs), cache_bytes=0))

    def once():
        futs = [srv.submit(kind, g) for g in graphs]
        srv.flush()
        out = [f.result() for f in futs]
        torch.cuda.synchronize()
        return out

    results = once()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        once()
        times.append((time.perf_counter() - t0) * 1e3)
    return results, times, srv.server_stats()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--kinds", nargs="+", default=["mis2", "coarsen", "color"])
    ap.add_argument("--groups", nargs="+", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import repro_torch as rt
    from repro_torch import graphs as gen
    from repro_torch.kernels import _build
    from repro_torch.serve import Server, ServerConfig
    from repro_torch.serve import server as server_mod

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    _build.build_all()
    made = {}
    for label, spec in GROUPS.items():
        if args.groups and not any(k in label for k in args.groups):
            continue
        graphs = []
        for name, dims in spec:
            if (name, dims) not in made:
                made[(name, dims)] = getattr(gen, name)(*dims)
            graphs.append(rt.Graph(made[(name, dims)]))
        for kind in args.kinds:
            want = [getattr(rt, kind)(g).digest for g in graphs]
            rec = {"group": label, "kind": kind,
                   "rows": [g.num_vertices for g in graphs],
                   "ell_bytes_estimate": [g.ell_bytes_estimate()
                                          for g in graphs], "card": card}
            for route, cut in (("batched", 1 << 62), ("alone", 0)):
                server_mod.BATCH_MAX_ELL_BYTES = cut
                res, times, st = _serve_ms(torch, Server, ServerConfig, kind,
                                           graphs, args.reps)
                if [r.digest for r in res] != want:
                    print(f"{label} {kind} {route}: digests differ",
                          file=sys.stderr)
                    return 1
                rec[route] = {"ms": times, "median_ms":
                              statistics.median(times),
                              "engines": sorted({str(getattr(r, "engine",
                                                             None))
                                                 for r in res}),
                              "batched_graphs": st["batched_graphs"],
                              "single_dispatches": st["single_dispatches"]}
            rec["alone_over_batched"] = (rec["alone"]["median_ms"]
                                         / rec["batched"]["median_ms"])
            print(json.dumps(rec), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
