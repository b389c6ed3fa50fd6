"""Cluster multicolor Gauss-Seidel (paper Alg. 4) vs point multicolor GS as
GMRES preconditioners — the paper's Table VI setting.

    PYTHONPATH=src python examples/torch/cluster_gs_precond.py [--n 16] [--device cpu]

The setups and the solves run on ``--device`` (default ``cuda``; ``cpu``
must be asked for).  Both GMRES runs must converge, and the cluster setup
must not have more clusters than vertices.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.api import (  # noqa: E402
    Backend,
    Graph,
    cluster_gs_setup,
    using_backend,
)
from repro_torch.graphs import laplace3d  # noqa: E402
from repro_torch.graphs.ops import spmv_ell  # noqa: E402
from repro_torch.solvers import gmres, setup_point_gs  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    out = {"example": "cluster_gs_precond", "n": args.n}
    backend = Backend(device=args.device)
    backend.resolve_device()     # raises where the device is absent
    with using_backend(backend):
        a = Graph(laplace3d(args.n))
        ell = a.ell_matrix
        b = torch.from_numpy(np.random.default_rng(0).standard_normal(
            a.num_vertices).astype(np.float32)).to(a.device)
        mv = lambda x: spmv_ell(ell, x)  # noqa: E731
        print(f"Laplace3D {args.n}^3: V={a.num_vertices}")

        setup = cluster_gs_setup(a)
        out["cluster_labels_digest"] = setup.digest
        out["provenance"] = {"platform": setup.provenance.backend,
                             "engine": setup.provenance.engine}
        for kind, pre in (("point", setup_point_gs(a)),
                          ("cluster", setup.preconditioner)):
            t0 = time.time()
            res = gmres(mv, b, precond=pre.as_precond(sweeps=1,
                                                      symmetric=True),
                        tol=1e-6, maxiter=800)
            apply_s = time.time() - t0
            assert res.converged, (kind, res.residual_norm)
            assert 0 < pre.num_clusters <= a.num_vertices
            print(f"{kind:8s} SGS: setup {pre.setup_seconds:.2f}s "
                  f"({pre.num_colors} colors over {pre.num_clusters} "
                  f"clusters), GMRES {res.iterations} iters in "
                  f"{apply_s:.2f}s, converged={res.converged}")
            out[kind] = {"iterations": res.iterations,
                         "num_colors": pre.num_colors,
                         "num_clusters": pre.num_clusters}
    return out


if __name__ == "__main__":
    main()
