#!/usr/bin/env python
"""Execution-shape regression gates of the PyTorch/CUDA port over the
``repro_torch.obs`` registry (the port of ``tools/check_shape.py``).

Each gate runs the reference gate's own small workload under
``obs.capture()`` and asserts the *shape* of the execution by diffing
registry snapshots:

* ``resident``   a ``cuda_resident`` MIS-2 solve is exactly ONE dispatch
  (one launch of the persistent kernel) with ZERO host syncs inside the
  fixed point.  It needs the card: on the CPU the engine runs its
  plain-torch twin, which reads the live count each round, so the gate
  fails there.
* ``serve``      a warmed server keeps the request path build-free:
  distinct graphs in a warmed bucket shape dispatch with no cold shape and
  no ``nvcc`` started after the warm-up.
* ``serve_dedup``  N concurrent same-digest requests coalesce to exactly
  ONE compute, and a fault-degraded server still serves the referent
  digest with no cold shape and no ``nvcc`` after the warm-up.
* ``dist``       the distributed engine's collective bytes equal the
  analytic model: the registry delta equals
  ``collective_bytes_per_iteration(V, P) x iterations`` and the result's
  own ``collectives`` record, on the default process group (one rank when
  none is initialized).
* ``hybrid_traffic``  the ``cuda_hybrid`` solve's adjacency bytes in the
  registry equal ``hybrid_row_traffic_bytes`` and the result's record, and
  the solve is exactly ONE dispatch (one launch of the hybrid persistent
  kernel) with ZERO host syncs, as the reference's gate asks.  It needs the
  card, as ``resident`` does: on the CPU the twin reads the live count each
  round.

Usage::

    PYTHONPATH=src python tools/check_shape_torch.py [--gates resident,serve]
        [--device cuda|cpu]

Prints one PASS/FAIL line per gate; exits nonzero if any gate fails.
"""
from __future__ import annotations

import argparse
import sys
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


class GateFailure(AssertionError):
    pass


def _expect(cond: bool, msg: str) -> None:
    if not cond:
        raise GateFailure(msg)


def _backend(device: str):
    import repro_torch as rt

    return rt.Backend(device=device)


# ---------------------------------------------------------------------------
# gate: resident — 1 dispatch, 0 host syncs per solve
# ---------------------------------------------------------------------------

def gate_resident(device: str) -> str:
    import repro_torch as rt
    from repro_torch import obs
    from repro_torch.graphs.generators import random_uniform_graph
    from repro_torch.kernels.minprop_ell import ops

    if not device.startswith("cuda"):
        raise GateFailure(
            f"needs the card (--device cuda): on {device} cuda_resident runs "
            "its plain-torch twin, which reads the live count each round")
    be = _backend(device)
    g = rt.Graph(random_uniform_graph(4000, 8.0, seed=7), device=device)
    rt.mis2(g, engine="cuda_resident", backend=be)   # build the kernels
    before = ops.LAUNCHES["resident_fixed_point"]
    with obs.capture() as cap:
        r = rt.mis2(g, engine="cuda_resident", backend=be)
    launches = ops.LAUNCHES["resident_fixed_point"] - before
    _expect(r.iterations > 1, "workload too easy: need a multi-round solve")
    dispatches = cap.value("mis2.resident_dispatches")
    syncs = cap.value("mis2.host_syncs")
    _expect(dispatches == 1,
            f"resident solve took {dispatches} dispatches, want exactly 1")
    _expect(launches == 1,
            f"resident solve made {launches} kernel launches, want exactly 1")
    _expect(syncs == 0 and r.host_syncs == 0,
            f"resident solve paid {syncs} in-loop host syncs, want 0")
    return (f"1 dispatch (1 launch), 0 host syncs across {r.iterations} "
            f"rounds (engine={r.engine})")


# ---------------------------------------------------------------------------
# gate: serve — warmed buckets keep the request path build-free
# ---------------------------------------------------------------------------

def _no_runtime_builds(server, cap, what: str) -> None:
    cold = cap.value("serve.warm.runtime_compiles")
    nvcc = server.server_stats()["compiles"]["nvcc_since_warm"]
    _expect(cold == 0, f"{what} dispatched {cold} cold shapes, want 0")
    _expect(nvcc == 0, f"{what} started {nvcc} nvcc builds after the warm-up, "
            "want 0")


def gate_serve(device: str) -> str:
    import repro_torch as rt
    from repro_torch import obs
    from repro_torch.graphs.generators import random_uniform_graph
    from repro_torch.serve import Server, ServerConfig, warm_buckets_for

    graphs = [rt.Graph(random_uniform_graph(600, 6.0, seed=s), device=device)
              for s in range(4)]
    config = ServerConfig(max_batch=4, max_delay_s=0.0,
                          warm_buckets=warm_buckets_for(graphs),
                          single_fast_path=False, backend=_backend(device))
    server = Server(config)
    try:
        with obs.capture() as cap:
            futures = [server.submit("mis2", g) for g in graphs]
            server.flush()
            results = [f.result(timeout=120) for f in futures]
        _expect(all(r.converged for r in results), "serve results diverged")
        dispatches = cap.value("serve.dispatches")
        _expect(dispatches >= 1, "server never dispatched")
        _no_runtime_builds(server, cap, "the warm request path")
    finally:
        server.stop()
    return (f"{len(graphs)} graphs through warmed buckets: no cold shape, no "
            f"nvcc after the warm-up ({int(dispatches)} dispatches)")


# ---------------------------------------------------------------------------
# gate: serve_dedup — N concurrent same-digest requests: exactly 1 compute,
# and a degraded (fault-injected) server keeps the request path build-free
# ---------------------------------------------------------------------------

def gate_serve_dedup(device: str) -> str:
    import repro_torch as rt
    from repro_torch import obs
    from repro_torch.graphs.generators import random_uniform_graph
    from repro_torch.serve import (Fault, FaultPlan, RetryPolicy, Server,
                                   ServerConfig, warm_buckets_for)

    n = 8
    be = _backend(device)
    base = rt.Graph(random_uniform_graph(600, 6.0, seed=3), device=device)
    clones = [rt.Graph(base.csr, device=device) for _ in range(n)]
    warm = warm_buckets_for([base])

    # --- phase 1: N concurrent same-digest requests -> exactly 1 compute
    server = Server(ServerConfig(max_batch=n, max_delay_s=0.0,
                                 warm_buckets=warm, single_fast_path=False,
                                 backend=be))
    try:
        with obs.capture() as cap:
            futures = [server.submit("mis2", g) for g in clones]
            server.flush()
            results = [f.result(timeout=120) for f in futures]
        digests = {r.digest for r in results}
        _expect(len(digests) == 1,
                f"same-key requests returned {len(digests)} digests, want 1")
        dedup_hits = cap.value("serve.dedup_hits")
        computes = (cap.value("serve.single_dispatches")
                    + cap.value("serve.batched_graphs"))
        _expect(dedup_hits == n - 1,
                f"{n} same-digest submits coalesced {dedup_hits} joins, "
                f"want {n - 1}")
        _expect(computes == 1,
                f"{n} same-digest requests cost {computes} computes, want "
                "exactly 1")
        _no_runtime_builds(server, cap, "the dedup path")
    finally:
        server.stop()

    # --- phase 2: degraded server (seeded transient engine fault, retried)
    # still serves the correct digest with no build on the request path
    referent = rt.mis2(base, engine="dense", backend=be)
    plan = FaultPlan(seed=5, sites={
        "engine": Fault("error", count=1, transient=True)})
    server = Server(ServerConfig(max_batch=n, max_delay_s=0.0,
                                 warm_buckets=warm, single_fast_path=False,
                                 faults=plan, backend=be,
                                 retry=RetryPolicy(base_backoff_s=0.0)))
    try:
        with obs.capture() as cap:
            fut = server.submit("mis2", base)
            server.flush()
            degraded = fut.result(timeout=120)
        _expect(degraded.digest == referent.digest,
                f"degraded response digest {degraded.digest} != referent "
                f"{referent.digest}")
        retries = cap.value("serve.retries", {"site": "engine"})
        _expect(retries == 1,
                f"transient fault provoked {retries} retries, want 1")
        _no_runtime_builds(server, cap, "the degraded request path")
    finally:
        server.stop()
    return (f"{n} same-digest requests -> 1 compute ({int(dedup_hits)} "
            f"joins); degraded serve digest-correct after {int(retries)} "
            "retry, no cold shape, no nvcc")


# ---------------------------------------------------------------------------
# gate: dist — registry collective bytes == analytic model == result record
# ---------------------------------------------------------------------------

def gate_dist(device: str) -> str:
    import torch.distributed as dist

    import repro_torch as rt
    from repro_torch import obs
    from repro_torch.core.dist import collective_bytes_per_iteration
    from repro_torch.graphs.generators import random_uniform_graph

    ranks = dist.get_world_size() if dist.is_initialized() else 1
    v = 2048
    g = rt.Graph(random_uniform_graph(v, 8.0, seed=11), device=device)
    with obs.capture() as cap:
        r = rt.mis2(g, engine="distributed", backend=_backend(device))
    variant = r.collectives["variant"]
    got = cap.value("dist.collective_bytes", {"variant": variant})
    per = collective_bytes_per_iteration(v, ranks,
                                         variant == "single_gather")
    want = per["result_bytes_per_iteration"] * r.iterations
    _expect(got == want,
            f"registry recorded {got} collective bytes, analytic model says "
            f"{want} ({variant}, {ranks} ranks, {r.iterations} iterations)")
    _expect(got == r.collectives["result_bytes_total"],
            f"registry ({got}) disagrees with the result's own accounting "
            f"({r.collectives['result_bytes_total']})")
    return (f"{int(got)} bytes == analytic model == result record "
            f"({variant}, {ranks} ranks, {r.iterations} iters)")


# ---------------------------------------------------------------------------
# gate: hybrid_traffic — registry row-traffic bytes == analytic model ==
# result record, and the hybrid solve is one resident dispatch
# ---------------------------------------------------------------------------

def gate_hybrid_traffic(device: str) -> str:
    import repro_torch as rt
    from repro_torch import obs
    from repro_torch.graphs.generators import powerlaw_graph
    from repro_torch.kernels.minprop_ell import ops
    from repro_torch.kernels.minprop_ell.ops import hybrid_row_traffic_bytes

    if not device.startswith("cuda"):
        raise GateFailure(
            f"needs the card (--device cuda): on {device} cuda_hybrid runs "
            "its plain-torch twin, which reads the live count each round")
    be = _backend(device)
    g = rt.Graph(powerlaw_graph(4000, 8.0, seed=7), device=device)
    rt.mis2(g, engine="cuda_hybrid", backend=be)     # build the kernels
    before = ops.LAUNCHES["hybrid_fixed_point"]
    with obs.capture() as cap:
        r = rt.mis2(g, engine="cuda_hybrid", backend=be)
    launches = ops.LAUNCHES["hybrid_fixed_point"] - before
    _expect(r.iterations > 1, "workload too easy: need a multi-round solve")
    c = r.collectives
    _expect(c["variant"] == "hybrid", f"unexpected variant {c['variant']!r}")
    got = cap.value("mis2.hybrid_row_bytes")
    want = hybrid_row_traffic_bytes(c["slice_widths"],
                                    c["slice_rows_processed"],
                                    c["spill_entries"], c["spill_passes"])
    _expect(got == want,
            f"registry recorded {got} hybrid row bytes, analytic model says "
            f"{want} (widths={c['slice_widths']}, "
            f"spill_entries={c['spill_entries']})")
    _expect(got == c["row_bytes_total"],
            f"registry ({got}) disagrees with the result's own accounting "
            f"({c['row_bytes_total']})")
    dispatches = cap.value("mis2.resident_dispatches")
    syncs = cap.value("mis2.host_syncs")
    _expect(dispatches == 1,
            f"hybrid solve took {dispatches} dispatches, want exactly 1")
    _expect(launches == 1,
            f"hybrid solve made {launches} kernel launches, want exactly 1")
    _expect(syncs == 0 and r.host_syncs == 0,
            f"hybrid solve paid {syncs} in-loop host syncs, want 0")
    return (f"{int(got)} bytes == analytic model == result record "
            f"({len(c['slice_widths'])} slices + {c['spill_entries']} spill "
            f"entries, {r.iterations} iters), 1 dispatch (1 launch), 0 host "
            "syncs")


GATES = {
    "resident": gate_resident,
    "serve": gate_serve,
    "serve_dedup": gate_serve_dedup,
    "dist": gate_dist,
    "hybrid_traffic": gate_hybrid_traffic,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gates", default=",".join(GATES),
                    help="comma-separated subset of " + ",".join(GATES))
    ap.add_argument("--device", default="cuda",
                    help="where the workloads run (cuda, or cpu for the "
                         "plain-torch twins)")
    args = ap.parse_args(argv)
    names = [n.strip() for n in args.gates.split(",") if n.strip()]
    unknown = [n for n in names if n not in GATES]
    if unknown:
        print(f"unknown gate(s): {', '.join(unknown)}", file=sys.stderr)
        return 2
    failed = 0
    for name in names:
        try:
            detail = GATES[name](args.device)
        except GateFailure as e:
            print(f"FAIL  {name:<14} {e}")
            failed += 1
        except Exception:
            print(f"FAIL  {name:<14} crashed:")
            traceback.print_exc()
            failed += 1
        else:
            print(f"PASS  {name:<14} {detail}")
    if failed:
        print(f"{failed}/{len(names)} execution-shape gates failed")
        return 1
    print(f"all {len(names)} execution-shape gates passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
