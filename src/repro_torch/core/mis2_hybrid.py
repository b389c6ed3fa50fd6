"""Device-resident MIS-2 over the hybrid (sliced-ELL + COO spill) layout,
PyTorch port of ``repro.core.mis2_hybrid`` (the ``cuda_hybrid`` engine,
counterpart of the JAX package's ``pallas_hybrid``).

The reference's one jitted ``lax.while_loop`` is one call of
``kernels.minprop_ell.ops.hybrid_fixed_point``: on the card one cooperative
launch of a persistent kernel that runs every round -- the refresh pass
over every slab (the sliced kernels' body) and the spill's segment
reduction, then the decide pass over every slab and the spill's, then each
slab's two worklists compacted over themselves (sentinel ``R_i``) -- and
reads nothing from the host until the solve ends.  Without an ``active``
mask the slab decide reads M alone: M never holds IN, so the mask's
gather is left out.  Every vertex lies in exactly one slab or in the
spill, so the in-place writes into the global T / M are disjoint, and a
row's refresh and decide read only global state and that row's adjacency:
the final T is bit-identical to the ``dense`` and ``cuda_resident``
engines' for equal options.  On the CPU the kernel's plain-torch twin
runs the same rounds and reads the live count each round.

Traffic accounting: one device counter per slab (live worklist rows
processed, both passes), read once at the end; the spill adds two segment
sweeps a round.  ``kernels.minprop_ell.ops.hybrid_row_traffic_bytes``
turns them into bytes; the result's ``collectives`` carries all of it, in
the reference's keys, and the ``repro_torch.obs`` counter
``mis2.hybrid_row_bytes`` adds the bytes up.  ``host_syncs`` is 0 on the
card (one pull of the results after the launch, the reference's final
result pull) and the twin's reads on the CPU.
"""
from __future__ import annotations

import torch

from ..graphs.handle import as_graph
from ..kernels.minprop_ell import ops
from ..obs import metrics as _obs
from ..obs import span as _obs_span
from .mis2 import (
    Mis2Options,
    Mis2Result,
    _active_mask,
    _require_kernel_layout,
    _require_worklists,
    record_loop,
)
from .tuples import IN, id_bits

#: the ``obs`` counter of a hybrid solve's adjacency bytes (the reference's)
HYBRID_ROW_BYTES = "mis2.hybrid_row_bytes"


def hybrid_fixed_point(hyb, active: torch.Tensor | None, *, priority: str,
                       max_iters: int, b: int):
    """The compacted fixed point over ``[V]`` device state and the hybrid
    layout ``hyb``; ``active`` None: every vertex, no mask.  One call of
    ``ops.hybrid_fixed_point`` (one launch on the card).  Returns ``(T
    stored int32 [V], iterations, live count int32 [1], slab rows
    processed int64 [num_slices], host_syncs)``."""
    v = hyb.num_vertices
    dev = hyb.spill_rows.device
    t = torch.empty(v, dtype=torch.int32, device=dev)
    m = torch.empty(v, dtype=torch.int32, device=dev)
    slabs = [(sl.rows, sl.neighbors.reshape(-1)) for sl in hyb.slices]
    spill = (hyb.spill_rows, hyb.spill_seg, hyb.spill_cols)
    with _obs_span("mis2.hybrid_fixed_point", layout="hybrid", v=v) as sp:
        t, stats, acc = ops.hybrid_fixed_point(
            t, m, active, slabs, spill, priority=priority, b=b,
            max_iters=max_iters)
        iters = int(stats[0].item())        # read once, after the solve
        syncs = 0 if dev.type == "cuda" else min(iters + 1, max_iters)
        record_loop(syncs, resident=True)
        sp.annotate(iterations=iters)
    return t, iters, stats[1:2], acc, syncs


def _mis2_hybrid_impl(graph, active=None,
                      options: Mis2Options | None = None) -> Mis2Result:
    """Engine entry for ``cuda_hybrid``: works where the monolithic padded
    ELL cannot even be allocated (never touches ``graph.ell``)."""
    options = Mis2Options() if options is None else options
    _require_worklists(options, "cuda_hybrid")
    _require_kernel_layout(options, "cuda_hybrid")
    gh = as_graph(graph)
    hyb = gh.hybrid()
    v = hyb.num_vertices
    act = None if active is None else _active_mask(active, v, gh.device)
    t, iters, n1, acc, syncs = hybrid_fixed_point(
        hyb, act, priority=options.priority, max_iters=options.max_iters,
        b=id_bits(v))
    rows_processed = [int(x) for x in acc.tolist()]   # read once, at the end
    spill_passes = 2 * iters if hyb.num_spill_rows else 0
    row_bytes = ops.hybrid_row_traffic_bytes(
        hyb.slice_widths, rows_processed, hyb.num_spill_entries, spill_passes)
    _obs.counter(HYBRID_ROW_BYTES).inc(row_bytes)
    return Mis2Result(
        (t == IN).cpu().numpy(), iters, int(n1.item()) == 0, syncs,
        collectives={
            "variant": "hybrid",
            "row_bytes_total": row_bytes,
            "slice_widths": list(hyb.slice_widths),
            "slice_rows_processed": rows_processed,
            "spill_entries": hyb.num_spill_entries,
            "spill_passes": spill_passes,
        }, num_compiles=1)
