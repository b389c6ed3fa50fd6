#!/usr/bin/env python3
"""The JAX package's cluster-GS-preconditioned CG count: the anchor that
``chip_smoke.py`` holds the port's solve to (``CLUSTER_GS``).

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/reference_gs_cg.py \
        [--graph elasticity3d --n 60]

``repro.cluster_gs_setup`` with the ``host`` engine (MIS-2 by
``compacted_resident``), then ``repro.solvers.krylov.cg`` with the
symmetric GS sweep as preconditioner, tol 1e-6 and ``b =
default_rng(0).standard_normal(V)``.  Prints one JSON line: the setup's
clusters, digests and colors, the iterations, and the seconds of each
phase (most of it XLA's compile of the unrolled GS sweep).
"""
from __future__ import annotations

import argparse
import json
import time


def main() -> None:
    import jax.numpy as jnp
    import numpy as np

    import repro
    from repro.graphs import elasticity3d, laplace3d
    from repro.graphs.ops import spmv_ell
    from repro.solvers.krylov import cg

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph", choices=("elasticity3d", "laplace3d"),
                    default="elasticity3d")
    ap.add_argument("--n", type=int, default=60)
    args = ap.parse_args()
    gen = {"elasticity3d": elasticity3d, "laplace3d": laplace3d}[args.graph]
    t0 = time.perf_counter()
    g = repro.Graph(gen(args.n))
    c = repro.cluster_gs_setup(g, engine="host",
                               mis2_engine="compacted_resident")
    t1 = time.perf_counter()
    ell = g.ell_matrix
    b = jnp.asarray(np.random.default_rng(0).standard_normal(
        g.num_vertices).astype(np.float32))
    res = cg(lambda x: spmv_ell(ell, x), b,
             precond=c.preconditioner.as_precond(), tol=1e-6)
    t2 = time.perf_counter()
    print(json.dumps({
        "graph": f"{args.graph}({args.n})", "V": g.num_vertices,
        "clusters": c.num_clusters, "digest": c.digest,
        "colors": c.num_colors, "colors_digest": c.colors_digest,
        "cg_iterations": res.iterations, "converged": res.converged,
        "residual": res.residual_norm, "setup_s": t1 - t0,
        "solve_s": t2 - t1}), flush=True)


if __name__ == "__main__":
    main()
