"""Quickstart: the ``repro_torch.api`` facade on a generated mesh problem.

    PYTHONPATH=src python examples/torch/quickstart.py [grid_size] [--device cpu]

``grid_size`` (default 32) is the Laplace3D mesh edge.  The calls run on
``--device`` (default ``cuda``: the hand-written kernels; ``cpu`` runs
their plain-torch twins and must be asked for).  Every ``mis2`` engine
must give one digest, and the batched digests the ``dense`` engine's.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np  # noqa: E402

from repro_torch.api import (  # noqa: E402
    Backend,
    Graph,
    GraphBatch,
    Mis2Options,
    coarsen,
    list_engines,
    mis2,
    mis2_batch,
    using_backend,
)
from repro_torch.api.generators import (  # noqa: E402
    laplace3d,
    random_uniform_graph,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("n", nargs="?", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n = args.n
    # every call below (and every Graph built without a device) runs on
    # the default backend installed here
    backend = Backend(device=args.device)
    backend.resolve_device()     # raises where the device is absent
    with using_backend(backend):
        # the paper's Laplace3D generator (7-point stencil), wrapped in the
        # cached-format handle: ELL/CSR conversions happen once, on first use
        graph = Graph(laplace3d(n))
        print(f"graph: V={graph.num_vertices} E={graph.num_entries}")

        # distance-2 maximal independent set (Algorithm 1)
        result = mis2(graph, options=Mis2Options(priority="xorshift_star"))
        print(f"MIS-2: size={result.size} "
              f"({100 * result.size / graph.num_vertices:.1f}% of V), "
              f"iterations={result.iterations}, "
              f"wall={result.wall_time_s * 1e3:.1f}ms")

        # portable: every engine returns the bit-identical set — one digest
        engines = list_engines("mis2")["mis2"]
        for engine in engines:
            again = mis2(graph, engine=engine)
            assert again.digest == result.digest, engine
            assert again.converged, engine
        print(f"deterministic: engines {engines} all produced digest "
              f"{result.digest}")
        print(f"format cache: {graph.conversions} (ELL built once, reused "
              f"by every engine)")

        # two-phase MIS-2 aggregation (Algorithm 3)
        agg = coarsen(graph, method="two_phase")
        sizes = np.bincount(agg.labels)
        assert agg.converged and 0 < agg.num_aggregates <= graph.num_vertices
        assert sizes.sum() == graph.num_vertices and sizes.min() >= 1
        print(f"aggregation: {agg.num_aggregates} aggregates, "
              f"coarsening ratio {agg.coarsening_ratio:.1f}, "
              f"sizes min/mean/max = {sizes.min()}/{sizes.mean():.1f}/"
              f"{sizes.max()}")

        # batched: a fleet of graphs, bucketed by shape, one fixed point
        # per bucket — per-graph digests bit-identical to the dense engine
        fleet = [Graph(laplace3d(max(2, n // 4)).graph),
                 Graph(laplace3d(max(2, n // 8)).graph),
                 Graph(random_uniform_graph(10 * n, 5.0, seed=1)),
                 Graph(random_uniform_graph(20 * n, 6.0, seed=2))]
        batch = GraphBatch(fleet)
        br = mis2_batch(batch)
        for g, r in zip(fleet, br):
            assert r.digest == mis2(g, engine="dense").digest
        print(f"batched MIS-2: {len(br)} graphs in {br.num_buckets} buckets "
              f"{batch.bucket_shapes}, {br.graphs_per_second:.0f} "
              f"graphs/sec, digests match the dense engine")
    return {
        "example": "quickstart", "n": n, "V": graph.num_vertices,
        "E": graph.num_entries,
        "mis2": [result.size, result.iterations, result.digest],
        "engines": engines,
        "coarsen": [agg.num_aggregates, agg.iterations, agg.digest],
        "aggregate_sizes": [int(sizes.min()), int(sizes.max())],
        "batch_digests": br.digests,
        "bucket_shapes": [list(s) for s in br.bucket_shapes],
        "provenance": {"platform": result.provenance.backend,
                       "engine": result.provenance.engine},
    }


if __name__ == "__main__":
    main()
