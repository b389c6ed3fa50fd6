"""End-to-end driver: solve a 3D Poisson system with SA-AMG-preconditioned
CG, comparing the paper's aggregation schemes (Table V setting).

    PYTHONPATH=src python examples/torch/amg_solve.py [--n 32] [--tol 1e-10] [--device cpu]

The setup and the solves run on ``--device`` (default ``cuda``; ``cpu``
must be asked for).  Every CG run must converge, and each hierarchy's
level sizes must not grow.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.api import Backend, Graph, amg, using_backend  # noqa: E402
from repro_torch.graphs import laplace3d  # noqa: E402
from repro_torch.graphs.ops import spmv_ell  # noqa: E402
from repro_torch.solvers import cg  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--tol", type=float, default=1e-10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    out = {"example": "amg_solve", "n": args.n, "amg": {}}
    backend = Backend(device=args.device)
    backend.resolve_device()     # raises where the device is absent
    with using_backend(backend):
        a = Graph(laplace3d(args.n))
        ell = a.ell_matrix
        rng = np.random.default_rng(0)
        b = torch.from_numpy(rng.standard_normal(a.num_vertices).astype(
            np.float32)).to(a.device)
        mv = lambda x: spmv_ell(ell, x)  # noqa: E731
        print(f"Laplace3D {args.n}^3: V={a.num_vertices} nnz={a.num_entries}")

        plain = cg(mv, b, tol=args.tol, maxiter=3000)
        assert plain.converged, plain.residual_norm
        print(f"plain CG:        {plain.iterations} iterations")
        out["plain_cg_iterations"] = plain.iterations

        for agg in ("serial", "basic", "two_phase"):
            h = amg(a, aggregation=agg)
            t0 = time.time()
            res = cg(mv, b, precond=h.as_precond(), tol=args.tol,
                     maxiter=300)
            solve_s = time.time() - t0
            sizes = [v for v, _ in h.level_sizes]
            assert res.converged, (agg, res.residual_norm)
            assert all(q <= p for p, q in zip(sizes, sizes[1:])), sizes
            levels = " -> ".join(str(v) for v in sizes)
            print(f"AMG[{agg:10s}]: {res.iterations:3d} iterations "
                  f"(setup {h.wall_time_s:.2f}s of which aggregation "
                  f"{h.aggregation_seconds:.2f}s, solve {solve_s:.2f}s) "
                  f"levels {levels}")
            out["amg"][agg] = {"iterations": res.iterations,
                               "level_sizes": sizes,
                               "level_digests": h.level_digests}
    out["provenance"] = {"platform": h.provenance.backend,
                         "engine": h.provenance.engine}
    return out


if __name__ == "__main__":
    main()
