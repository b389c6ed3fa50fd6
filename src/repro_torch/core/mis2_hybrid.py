"""Device-resident MIS-2 over the hybrid (sliced-ELL + COO spill) layout,
PyTorch port of ``repro.core.mis2_hybrid`` (the ``cuda_hybrid`` engine,
counterpart of the JAX package's ``pallas_hybrid``).

The resident loop of ``core.mis2`` re-plumbed for ``graphs.hybrid``: each
round runs the refresh pass over every slab (``sliced_refresh_columns``, a
CUDA kernel on the card), then the spill refresh, then the decide pass
over every slab (``sliced_decide``), then the spill decide.  Without an
``active`` mask the slab decide reads M alone: M never holds IN, so the
mask's gather is left out (with a mask it stays: building the word
``active ? M : IN`` each round costs more than the gather it saves,
``tools/bench_minprop.py``).  Slab
worklists are compacted on the device from the global ``[V]`` live and
undecided masks (sentinel ``R_i``).  Every vertex lies in exactly one slab
or in the spill, so the in-place writes into the global T / M are
disjoint, and a row's refresh and decide read only global state and that
row's adjacency: the final T is bit-identical to the ``dense`` and
``cuda_resident`` engines' for equal options.

Traffic accounting: one device counter per slab (live worklist rows
processed, both passes), read once at the end; the spill adds two segment
sweeps a round.  ``kernels.minprop_ell.ops.hybrid_row_traffic_bytes``
turns them into bytes; the result's ``collectives`` carries all of it, in
the reference's keys, and the ``repro_torch.obs`` counter
``mis2.hybrid_row_bytes`` adds the bytes up.  The loop's only host
involvement is one read of the live count per round (``host_syncs``).
"""
from __future__ import annotations

import torch

from ..graphs.handle import as_graph
from ..kernels.minprop_ell import ops
from ..obs import metrics as _obs
from .mis2 import (
    Mis2Options,
    Mis2Result,
    _active_mask,
    _require_kernel_layout,
    _require_worklists,
    compact_worklist,
    record_loop,
)
from .tuples import IN, OUT_I32, id_bits, is_undecided

#: the ``obs`` counter of a hybrid solve's adjacency bytes (the reference's)
HYBRID_ROW_BYTES = "mis2.hybrid_row_bytes"


def hybrid_fixed_point(hyb, active: torch.Tensor | None, *, priority: str,
                       max_iters: int, b: int):
    """The compacted fixed point over ``[V]`` device state and the hybrid
    layout ``hyb``; ``active`` None: every vertex, no mask.  Returns ``(T
    stored int32 [V], iterations, live count int32 [1], slab rows
    processed int64 [num_slices], host_syncs)``."""
    v = hyb.num_vertices
    dev = hyb.spill_rows.device
    gate = active
    if active is None:
        active = torch.ones(v, dtype=torch.bool, device=dev)
    slabs = [(sl.rows, sl.neighbors.reshape(-1)) for sl in hyb.slices]
    has_spill = hyb.num_spill_rows > 0
    spill = (hyb.spill_rows, hyb.spill_seg, hyb.spill_cols)
    kw = dict(priority=priority, b=b)
    t = torch.where(active, 1, OUT_I32).to(torch.int32)
    m = torch.full((v,), OUT_I32, dtype=torch.int32, device=dev)
    und = active
    live = torch.ones(v, dtype=torch.bool, device=dev)   # round 0: every M
    n1 = active.sum(dtype=torch.int32).reshape(1)
    acc = torch.zeros(max(len(slabs), 1), dtype=torch.int64, device=dev)
    it_dev = torch.zeros(1, dtype=torch.int32, device=dev)
    it = syncs = 0
    while it < max_iters:
        syncs += 1
        if int(n1.item()) == 0:       # the one host read per round
            break
        # refresh: only M is written, every pass reads the round-start T
        for i, (rows, nbrs) in enumerate(slabs):
            wl2, n2 = compact_worklist(live[rows])
            ops.sliced_refresh_columns(t, m, rows, nbrs, wl2, n2, it_dev, **kw)
            acc[i:i + 1] += n2
        if has_spill:
            ops.spill_refresh_columns(t, m, *spill, live, it_dev, **kw)
        # decide: each pass reads and writes T only at its own rows
        for i, (rows, nbrs) in enumerate(slabs):
            wl1, n1_i = compact_worklist(und[rows])
            ops.sliced_decide(t, m, gate, rows, nbrs, wl1, n1_i, it_dev, **kw)
            acc[i:i + 1] += n1_i
        if has_spill:
            ops.spill_decide(t, m, active, *spill, it_dev, **kw)
        und = is_undecided(t)
        live = m != OUT_I32
        n1 = und.sum(dtype=torch.int32).reshape(1)
        it_dev += 1
        it += 1
    record_loop(syncs, resident=True)
    return t, it, n1, acc[:len(slabs)], syncs


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
