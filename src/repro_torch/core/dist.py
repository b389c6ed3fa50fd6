"""Distributed MIS-2 and coarsening on ``torch.distributed`` (PyTorch port of
``repro.core.dist``; the paper is single device, the vertices are
partitioned over the ranks of a process group).

Layout: the padded vertex count ``Vp`` (``V`` rounded up to a multiple of
the world size ``P`` with isolated, inactive rows) is split into ``P``
contiguous row blocks of ``R = Vp / P`` rows; rank ``r`` owns rows
``r R .. (r + 1) R - 1`` of the ELL adjacency, on its own device, with
*global* neighbour ids.  Every round all-gathers the 4-byte tuple vector T
and, for the ``two_gather`` variant, the distance-1 minima M: ``2 Vp 4``
result bytes a round, independent of ``|E|``.  The ``single_gather``
variant gathers T only and recomputes M for the whole graph from the
replicated adjacency.  :func:`collective_bytes_per_iteration` is the
analytic form of this model; the all-gather wrapper counts the bytes it
actually puts in its result buffers (:data:`COLLECTIVE_BYTES`), and a
solve's count of T and M bytes equals the model times its rounds.

A round runs on the MIS-2 kernels (``kernels.minprop_ell.ops``), which
take a block of rows given by global ids: ``sliced_refresh_columns`` over
this rank's rows into M, ``sliced_decide`` over them with the gathered
active mask; ``single_gather`` takes its whole-graph M from
``fused_refresh_columns``.  On the CPU their plain-torch twins stand in.

Determinism: priorities depend only on (round, global id) and are packed
with ``b = id_bits(V_real)`` — the *real* vertex count, never the padded
one (padded rows start OUT, so the kernels never pack their ids).  Packing
with the padded count changed the truncated priority bits whenever padding
crossed a power of two (V = 1022 on 8 ranks pads to 1024: b 10 -> 11),
which broke bit identity with the single-device engines.

Coarsening: :func:`join_adjacent_root_distributed`,
:func:`count_unagg_neighbors_distributed` and
:func:`phase3_join_distributed` each all-gather the label vector once and
run the single-device rowwise helpers of ``core.aggregation`` over this
rank's rows, then gather the rows' results, so the labels are bit-identical
to the single-device engines'.

The stop test all-reduces this rank's count of undecided active rows and
reads it on the host once a round (``mis2.host_syncs`` = rounds + 1), where
the reference's loop runs on the device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..graphs.csr import ELLGraph
from ..graphs.handle import as_graph
from ..kernels.minprop_ell import ops
from ..obs import metrics as _obs
from .mis2 import (
    Mis2Options,
    Mis2Result,
    _active_mask,
    _require_entries,
    record_loop,
)
from .tuples import IN, OUT_I32, id_bits, is_undecided

TUPLE_BYTES = 4                        # one packed §V-C tuple

#: bytes every collective of this module put in its result buffers, by
#: kind: ``tuples`` (the T and M gathers of the fixed point, which the model
#: counts), ``active`` (the loop-invariant mask, once a solve), ``result``
#: (the final T gather of a solve), ``labels`` (the coarsening's label and
#: row-result gathers) and ``flags`` (the stop test's all-reduce)
COLLECTIVE_BYTES = {"tuples": 0, "active": 0, "result": 0, "labels": 0,
                    "flags": 0}


def reset_collective_bytes() -> None:
    for k in COLLECTIVE_BYTES:
        COLLECTIVE_BYTES[k] = 0


class Comm:
    """One rank's view of the process group: ``group`` None is a group of
    one rank, where a gather is a copy and no collective runs."""

    def __init__(self, group, world_size: int, rank: int):
        self.group = group
        self.world_size = world_size
        self.rank = rank
        self.backend = None
        if group is not None:
            import torch.distributed as dist

            self.backend = str(dist.get_backend(group))

    @classmethod
    def of(cls, backend=None) -> "Comm":
        from ..api.backend import resolve_backend

        return cls(*resolve_backend(backend).resolve_group())

    def all_gather(self, out: torch.Tensor, inp: torch.Tensor,
                   kind: str) -> torch.Tensor:
        """``out`` [P * n] <- the ranks' ``inp`` [n] in rank order (``inp``
        a buffer of its own, never a slice of ``out``); counts ``out``'s
        bytes under ``kind``."""
        if self.group is None:
            out.copy_(inp)
        else:
            import torch.distributed as dist

            if self.backend == "nccl":
                dist.all_gather_into_tensor(out, inp, group=self.group)
            else:
                dist.all_gather(list(out.chunk(self.world_size)), inp,
                                group=self.group)
        COLLECTIVE_BYTES[kind] += out.numel() * out.element_size()
        return out

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """In-place sum over the ranks (the stop test's count)."""
        if self.group is not None:
            import torch.distributed as dist

            dist.all_reduce(x, group=self.group)
        COLLECTIVE_BYTES["flags"] += x.numel() * x.element_size()
        return x


# ===========================================================================
# padding and placement
# ===========================================================================

def pad_graph_for_mesh(ell: ELLGraph, num_devices: int):
    """Pad V to a multiple of ``num_devices`` with isolated, inactive rows
    (their slots hold their own id, mask off); returns ``(ELLGraph, V)``."""
    v = ell.num_vertices
    vp = ((v + num_devices - 1) // num_devices) * num_devices
    if vp == v:
        return ell, v
    dev = ell.neighbors.device
    pad = torch.arange(v, vp, dtype=ell.neighbors.dtype, device=dev)
    pad = pad[:, None].expand(vp - v, ell.width)
    nbrs = torch.cat([ell.neighbors, pad]).contiguous()
    mask = torch.cat([ell.mask, torch.zeros((vp - v, ell.width),
                                            dtype=torch.bool, device=dev)])
    return ELLGraph(nbrs, mask), v


@dataclass
class ShardedEll:
    """This rank's row block of the padded ELL on its device, with the
    padded whole (which ``single_gather`` replicates): made once by
    :func:`prepare_padded` and passed through every sharded call."""

    comm: Comm
    padded: ELLGraph          # [Vp, D] on this rank's device
    num_vertices: int         # V, the real count
    lo: int                   # this rank's first row
    rows: torch.Tensor        # int32 [R] global ids of this rank's rows

    @property
    def num_padded(self) -> int:
        return self.padded.num_vertices

    @property
    def hi(self) -> int:
        return self.lo + self.rows.shape[0]

    @property
    def neighbors(self) -> torch.Tensor:
        """int32 [R, D] global neighbour ids of this rank's rows."""
        return self.padded.neighbors[self.lo:self.hi]

    @property
    def mask(self) -> torch.Tensor:
        return self.padded.mask[self.lo:self.hi]


def prepare_padded(graph, backend=None) -> ShardedEll:
    """Pad once and keep this rank's row block on its device.

    Multi-call pipelines (the distributed coarsening: two MIS-2 fixed
    points and up to ~6 label rounds) pass the result to every sharded
    call, so the padding happens once."""
    comm = Comm.of(backend)
    ell = as_graph(graph).ell
    padded, v = pad_graph_for_mesh(ell, comm.world_size)
    r = padded.num_vertices // comm.world_size
    lo = comm.rank * r
    rows = torch.arange(lo, lo + r, dtype=torch.int32,
                        device=padded.neighbors.device)
    return ShardedEll(comm, padded, v, lo, rows)


# ===========================================================================
# collective-traffic accounting (the §V-C communication model, per round)
# ===========================================================================

def collective_bytes_per_iteration(num_vertices: int, num_devices: int,
                                   single_gather: bool = False) -> dict:
    """Analytic per-round collective volume of the sharded fixed point.

    Each round all-gathers the packed tuple vector T (``two_gather`` also
    gathers the distance-1 minima M): result bytes = Vp * 4 per gather,
    ring wire bytes per device = result * (P-1)/P.  The loop-invariant
    active-mask gather is hoisted out of the fixed point and excluded.
    """
    vp = ((num_vertices + num_devices - 1) // num_devices) * num_devices
    gathers = 1 if single_gather else 2
    result_bytes = vp * TUPLE_BYTES * gathers
    wire = result_bytes * (num_devices - 1) / max(1, num_devices)
    return {
        "gathers_per_iteration": gathers,
        "result_bytes_per_iteration": result_bytes,
        "wire_bytes_per_device_per_iteration": wire,
    }


# ===========================================================================
# distributed MIS-2 (engines 'distributed', 'distributed_single_gather')
# ===========================================================================

def _fixed_point(sh: ShardedEll, active_local: torch.Tensor, b: int,
                 priority: str, max_iters: int, single_gather: bool):
    """The sharded fixed point: returns ``(T int32 [Vp] gathered,
    iterations, host_syncs)``; ``active_local`` is bool [R]."""
    comm = sh.comm
    dev = sh.rows.device
    vp, r = sh.num_padded, sh.rows.shape[0]
    nbrs_local = sh.neighbors.reshape(-1)     # contiguous row block
    # T and M as gathered [Vp], and this rank's rows of each in a buffer of
    # their own: the all-gather's input never aliases its output
    t_local = torch.where(active_local, 1, OUT_I32).to(torch.int32)
    t_full = torch.empty(vp, dtype=torch.int32, device=dev)
    m_full = torch.full((vp,), OUT_I32, dtype=torch.int32, device=dev)
    m_local = torch.empty_like(t_local)
    # the active mask is loop-invariant: gather it once, outside the loop
    a_full = torch.empty(vp, dtype=torch.uint8, device=dev)
    comm.all_gather(a_full, active_local.to(torch.uint8), "active")
    a_full = a_full.bool()
    wl = torch.arange(r, dtype=torch.int32, device=dev)
    count = torch.full((1,), r, dtype=torch.int32, device=dev)
    if single_gather:
        nbrs_all = sh.padded.neighbors.reshape(-1)
        wl_all = torch.arange(vp, dtype=torch.int32, device=dev)
        count_all = torch.full((1,), vp, dtype=torch.int32, device=dev)
    it_dev = torch.zeros(1, dtype=torch.int32, device=dev)
    flag = torch.zeros(1, dtype=torch.int64, device=dev)
    kw = dict(priority=priority, b=b)
    it = syncs = 0
    while it < max_iters:
        flag.copy_((is_undecided(t_local) & active_local).sum())
        comm.all_reduce_sum(flag)
        syncs += 1
        # the one host read a round: the all-reduced undecided count, the
        # one the reference's sharded while_loop tests on the device
        # repro-lint: ignore[RL101] mis2.host_syncs counts it; the reference tests its psum'd count
        if int(flag.item()) == 0:
            break
        comm.all_gather(t_full, t_local, "tuples")
        if single_gather:
            ops.fused_refresh_columns(t_full, m_full, nbrs_all, wl_all,
                                      count_all, it_dev, **kw)
        else:
            ops.sliced_refresh_columns(t_full, m_full, sh.rows, nbrs_local,
                                       wl, count, it_dev, **kw)
            m_local.copy_(m_full[sh.lo:sh.hi])
            comm.all_gather(m_full, m_local, "tuples")
        ops.sliced_decide(t_full, m_full, a_full, sh.rows, nbrs_local, wl,
                          count, it_dev, **kw)
        t_local.copy_(t_full[sh.lo:sh.hi])
        it_dev += 1
        it += 1
    record_loop(syncs)
    comm.all_gather(t_full, t_local, "result")
    return t_full, it, syncs


def _mis2_distributed_impl(graph, active=None,
                           options: Mis2Options | None = None, *,
                           backend=None, single_gather: bool = False,
                           padded: ShardedEll | None = None) -> Mis2Result:
    """Sharded MIS-2 returning the core :class:`Mis2Result` on every rank —
    bit-identical to ``engine="dense"`` for any world size (equal digest,
    iterations and ``converged``).  ``result.collectives`` carries the
    reference's accounting and ``counted_result_bytes``, the T and M bytes
    this solve's gathers put in their buffers.  ``padded`` short-circuits
    the padding (see :func:`prepare_padded`)."""
    options = Mis2Options() if options is None else options
    gh = as_graph(graph)
    # the packing width comes from the graph's real count, never from the
    # padded shards (RL102)
    v = gh.num_vertices
    sh = prepare_padded(gh, backend) if padded is None else padded
    if sh.num_vertices != v:
        raise ValueError(f"padded holds a graph of {sh.num_vertices} "
                         f"vertices, the graph has {v}")
    vp, p = sh.num_padded, sh.comm.world_size
    _require_entries(sh.padded.neighbors[:v], "distributed")
    act = torch.zeros(vp, dtype=torch.bool, device=sh.rows.device)
    act[:v] = _active_mask(active, v, sh.rows.device)
    counted0 = COLLECTIVE_BYTES["tuples"]
    t_full, iterations, syncs = _fixed_point(
        sh, act[sh.lo:sh.hi].contiguous(), id_bits(v), options.priority,
        options.max_iters, single_gather)
    counted = COLLECTIVE_BYTES["tuples"] - counted0
    t = t_full[:v]
    undecided = bool((is_undecided(t) & act[:v]).any())
    per = collective_bytes_per_iteration(v, p, single_gather)
    variant = "single_gather" if single_gather else "two_gather"
    collectives = {
        "variant": variant,
        "num_devices": p,
        "iterations": iterations,
        **per,
        "result_bytes_total": per["result_bytes_per_iteration"] * iterations,
        "wire_bytes_per_device":
            per["wire_bytes_per_device_per_iteration"] * iterations,
        "counted_result_bytes": counted,
    }
    _obs.counter("dist.collective_bytes", labels={"variant": variant}).inc(
        collectives["result_bytes_total"])
    _obs.counter("dist.rounds", labels={"variant": variant}).inc(iterations)
    return Mis2Result((t == IN).cpu().numpy(), iterations, not undecided,
                      syncs, collectives=collectives)


# ===========================================================================
# distributed coarsening rounds (paper Alg. 2/3 label propagation, sharded)
# ===========================================================================

def _pad_labels(arr, vp: int, fill: int, device) -> torch.Tensor:
    out = torch.full((vp,), fill, dtype=torch.int32, device=device)
    out[:len(arr)] = torch.as_tensor(np.asarray(arr, dtype=np.int32),
                                     device=device)
    return out


def _sharded_rows(sh: ShardedEll, labels, fill: int, body) -> np.ndarray:
    """Gather the padded label vector from the row blocks, run
    ``body(labels_full)`` over this rank's rows (an int32 [R] result) and
    gather the rows' results; returns the real ``[V]`` on the host."""
    dev = sh.rows.device
    lab = _pad_labels(labels, sh.num_padded, fill, dev)
    full = torch.empty_like(lab)
    sh.comm.all_gather(full, lab[sh.lo:sh.hi].contiguous(), "labels")
    out = torch.empty_like(lab)
    sh.comm.all_gather(out, body(full).to(torch.int32).contiguous(),
                       "labels")
    return out[:sh.num_vertices].cpu().numpy()


def _padded_of(graph, backend, padded) -> ShardedEll:
    return prepare_padded(graph, backend) if padded is None else padded


def join_adjacent_root_distributed(graph, root_label, backend=None,
                                   padded: ShardedEll | None = None
                                   ) -> np.ndarray:
    """Sharded ``kernels.joins.ref.join_rows`` over the root labels: one
    label all-gather and the local rowwise min."""
    from ..kernels.joins.ref import INT32_MAX, join_rows

    sh = _padded_of(graph, backend, padded)
    return _sharded_rows(sh, root_label, INT32_MAX,
                         lambda rl: join_rows(sh.neighbors, rl))


def count_unagg_neighbors_distributed(graph, labels, backend=None,
                                      padded: ShardedEll | None = None
                                      ) -> np.ndarray:
    """Sharded ``kernels.joins.ref.count_unagg``."""
    from ..kernels.joins.ref import count_unagg

    sh = _padded_of(graph, backend, padded)
    return _sharded_rows(sh, labels, 0, lambda lab: count_unagg(
        sh.neighbors, sh.mask, sh.rows, lab))


def phase3_join_distributed(graph, labels, aggsize, backend=None,
                            padded: ShardedEll | None = None) -> np.ndarray:
    """Sharded ``kernels.joins.ref.phase3_rows`` (max-coupling leftover
    join against frozen tentative labels): label all-gather and the local
    rowwise lexicographic argmin; the aggregate sizes ride replicated."""
    from ..kernels.joins.ref import phase3_rows

    sh = _padded_of(graph, backend, padded)
    size = torch.as_tensor(np.asarray(aggsize, dtype=np.int32),
                           device=sh.rows.device)
    return _sharded_rows(sh, labels, 0, lambda lab: phase3_rows(
        sh.neighbors, sh.mask, sh.rows, lab, lab[sh.lo:sh.hi], size))
