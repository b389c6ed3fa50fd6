"""Child process of ``tests/test_torch_dist.py``: one gloo world of four CPU
ranks runs the port's distributed engines over process groups of 1, 2 and 4
ranks and over a (2, 2) ``DeviceMesh``, and prints every case at once.

    PYTHONPATH=src python tests/_torch_dist_worker.py

The P = 1 group (rank 3) and the P = 2 group (ranks 0 and 1) run side by
side; the world of four and the mesh follow.  Rendezvous goes through a
file in a fresh temporary directory, so no port is taken.  Each rank writes
its cases to a JSON file there; the parent prints them as one line
``RESULT:{"P=1": [...], ...}`` (one entry per rank of the group).
"""
from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SIZES = (1000, 1022, 997)    # divisible | pow2-crossing pad | non-divisible
ENGINES = ("distributed", "distributed_single_gather")
WORLD = 4


def _graph(rt, v: int):
    if v == 1000:
        return rt.Graph(rt.graphs.laplace3d(10), device="cpu")
    return rt.Graph(rt.graphs.random_uniform_graph(v, 6.0, seed=v),
                    device="cpu")


def _digests(rt, a) -> dict:
    dd = rt.determinism_digest
    return {"digest": a.digest, "roots": dd(a.roots), "phase": dd(a.phase),
            "num_aggregates": a.num_aggregates, "iterations": a.iterations,
            "engine": a.engine}


def _mis2_case(rt, g, engine, backend, options=None) -> dict:
    from repro_torch.core import dist as core_dist

    before = core_dist.COLLECTIVE_BYTES["tuples"]
    variant = "single_gather" if engine.endswith("gather") else "two_gather"
    with rt.obs.capture() as cap:
        r = rt.mis2(g, engine=engine, backend=backend, options=options)
    return {"digest": r.digest, "iterations": r.iterations,
            "converged": r.converged, "host_syncs": r.host_syncs,
            "collectives": r.collectives,
            "counted_bytes": core_dist.COLLECTIVE_BYTES["tuples"] - before,
            "registry_bytes": cap.value("dist.collective_bytes",
                                        {"variant": variant}),
            "registry_rounds": cap.value("dist.rounds",
                                         {"variant": variant}),
            "provenance_digest": r.provenance.digest}


def _cases(rt, backend, full: bool) -> dict:
    """Every size through both engines and the coarsenings; ``full`` adds
    the adversarial ``id_bits`` case and the single-gather coarsening."""
    from repro_torch.core.hashing import PRIORITY_CODES, PRIORITY_FNS

    out = {}
    for v in SIZES:
        g = _graph(rt, v)
        case = {e: _mis2_case(rt, g, e, backend) for e in ENGINES}
        case["two_phase_distributed"] = _digests(rt, rt.coarsen(
            g, method="two_phase_distributed", backend=backend))
        case["two_phase_inner_distributed"] = _digests(rt, rt.coarsen(
            g, method="two_phase", mis2_engine="distributed",
            backend=backend))
        if full:
            case["two_phase_distributed_single"] = _digests(rt, rt.coarsen(
                g, method="two_phase_distributed",
                mis2_engine="distributed_single_gather", backend=backend))
        out[str(v)] = case
    if full:
        # V = 6 pads to 8 on four ranks: b = id_bits(6) = 3, but 4 for the
        # padded count, and these priorities order vertices 0 and 1
        # oppositely under the two widths
        PRIORITY_FNS["adversarial"] = lambda it, vids: torch.where(
            vids == 0, 8, 0).to(torch.int64)
        PRIORITY_CODES["adversarial"] = 99
        path = rt.Graph.from_coo(np.array([0, 1, 1, 2, 2, 3, 3, 4, 4, 5]),
                                 np.array([1, 0, 2, 1, 3, 2, 4, 3, 5, 4]),
                                 6, device="cpu")
        opts = rt.Mis2Options(priority="adversarial")
        out["adversarial"] = {e: _mis2_case(rt, path, e, backend, opts)
                              for e in ENGINES}
    return out


def _rank(rank: int, tmp: str) -> None:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    import repro_torch as rt
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                            world_size=WORLD, rank=rank)
    groups = {1: dist.new_group([3]), 2: dist.new_group([0, 1]),
              4: dist.group.WORLD}
    members = {1: (3,), 2: (0, 1), 4: tuple(range(WORLD))}
    results = {}
    for p in (1, 2):
        if rank in members[p]:
            results[f"P={p}"] = _cases(
                rt, rt.Backend(device="cpu", group=groups[p]), full=False)
    results["P=4"] = _cases(rt, rt.Backend(device="cpu", group=groups[4]),
                            full=True)
    mesh = init_device_mesh("cpu", (2, 2))
    be = rt.Backend(device="cpu", group=mesh)
    results["mesh(2,2)"] = {
        "group_size": be.resolve_group()[1],
        **{e: _mis2_case(rt, _graph(rt, 997), e, be) for e in ENGINES}}
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
        json.dump(results, fh)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(tmp,), nprocs=WORLD, join=True)
        per_rank = []
        for r in range(WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                per_rank.append(json.load(fh))
    out: dict = {}
    for res in per_rank:
        for key, cases in res.items():
            out.setdefault(key, []).append(cases)
    print("RESULT:" + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
