"""Device placement via MIS-2 multilevel partitioning: coarsen an
operator/communication graph with Algorithm 3 and split it over devices.

Two demos:
1. a 3D mesh operator graph split over 16 devices;
2. an MoE expert co-activation graph clustered into expert-parallel groups.

    PYTHONPATH=src python examples/torch/partition_demo.py [--n 24] [--device cpu]

The calls run on ``--device`` (default ``cuda``; ``cpu`` must be asked
for).  The placement must be deterministic across runs.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np  # noqa: E402

from repro_torch.api import Backend, Graph, partition, using_backend  # noqa: E402,E501
from repro_torch.graphs import csr_from_coo, laplace3d  # noqa: E402


def expert_coactivation_graph(num_experts=60, seed=0):
    """Synthetic expert co-activation counts (top-k routing correlations)."""
    rng = np.random.default_rng(seed)
    # block-structured affinity: experts cluster into latent groups
    groups = rng.integers(0, 8, size=num_experts)
    rows, cols = [], []
    for i in range(num_experts):
        for j in range(num_experts):
            if i != j:
                p = 0.45 if groups[i] == groups[j] else 0.04
                if rng.random() < p:
                    rows.append(i)
                    cols.append(j)
    rows, cols = np.array(rows), np.array(cols)
    all_r = np.concatenate([rows, cols, np.arange(num_experts)])
    all_c = np.concatenate([cols, rows, np.arange(num_experts)])
    return csr_from_coo(all_r, all_c, num_experts)


def _levels_shrink(res, v: int) -> bool:
    """The partition's graphs, fine to coarse, never grow."""
    sizes = [v] + [n for n, _ in res.history]
    return all(b <= a for a, b in zip(sizes, sizes[1:]))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    backend = Backend(device=args.device)
    backend.resolve_device()     # raises where the device is absent
    with using_backend(backend):
        # 1. operator graph over devices
        g = Graph(laplace3d(args.n).graph)
        mesh = partition(g, 16)
        sizes = np.bincount(mesh.parts, minlength=16)
        assert sizes.sum() == g.num_vertices and len(sizes) == 16
        assert _levels_shrink(mesh, g.num_vertices)
        print(f"mesh operator graph: V={g.num_vertices} -> 16 devices, "
              f"edge cut {mesh.edge_cut} "
              f"({100 * mesh.edge_cut / (g.num_entries // 2):.1f}% of "
              f"edges), load balance {sizes.max() / sizes.mean():.2f}")

        # 2. MoE expert clusters (qwen2-moe has 60 routed experts)
        eg = Graph(expert_coactivation_graph(60))
        res = partition(eg, 4, coarse_target=16)
        groups = np.bincount(res.parts, minlength=4)
        assert groups.sum() == 60 and _levels_shrink(res, 60)
        print(f"expert co-activation graph: 60 experts -> 4 EP groups, "
              f"cut {res.edge_cut}, groups {groups.tolist()}")

        # determinism (the paper's headline property, preserved end to end)
        res2 = partition(eg, 4, coarse_target=16)
        assert (res.parts == res2.parts).all()
        assert partition(g, 16).digest == mesh.digest
        print("placement is deterministic across runs")
    return {
        "example": "partition_demo", "n": args.n, "V": g.num_vertices,
        "mesh": [mesh.digest, mesh.edge_cut, mesh.levels],
        "mesh_part_sizes": sizes.tolist(),
        "experts": [res.digest, res.edge_cut, res.levels],
        "expert_groups": groups.tolist(),
        "provenance": {"platform": mesh.provenance.backend,
                       "engine": mesh.provenance.engine},
    }


if __name__ == "__main__":
    main()
