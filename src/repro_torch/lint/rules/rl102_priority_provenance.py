"""RL102 — priority provenance: ``id_bits`` must be fed the REAL vertex
count, never a padded/bucketed size."""
from __future__ import annotations

import ast
import re
from typing import List, Set

from ..engine import Project, SourceFile, _name_chain
from ..findings import Finding
from . import Rule, register
from ._shared import LocalDataflow, iter_file_functions, short_symbol

#: provenance tokens that mean "this size includes padding" (the port's
#: padded sizes: ``ShardedEll.num_padded``, a bucket's ``rows`` and its
#: block-diagonal ``flat_neighbors``)
_PADDED_NAME_RE = re.compile(
    r"(^|[._])(vp|vp_total|padded|pad|bucket|bucketed)([._]|\d|$)|"
    r"(^|[._])padded_|_padded([._]|$)|"
    r"(^|[._])flat_neighbors\d*([._]|$)")

#: calls in the provenance chain that *produce* padded/bucketed sizes:
#: core/dist.py's mesh padding (``pad_graph_for_mesh``, ``prepare_padded``,
#: ``_pad_labels``), the host-driven engine's pow2 worklists (``_bucket``,
#: ``_pad_worklist``) and batch/container.py's pow2 buckets
#: (``bucket_shape``)
_PADDING_CALLS = re.compile(
    r"(pad_graph_for_mesh|pad_ell_graph|prepare_padded|_pad_labels|"
    r"_pad_worklist|_bucket|bucket_shape|next_pow2|pow2_bucket)\(\)$")


@register
class PriorityProvenance(Rule):
    code = "RL102"
    name = "priority-provenance"
    explain = """\
RL102 priority-provenance — id_bits() must see the real vertex count.

The packed status tuple (paper SV-C) reserves b = ceil(log2(V + 2)) low
bits for the vertex id; the remaining 32-b bits hold the priority.  The
bit width b is therefore part of the *mathematical definition* of the
total order the MIS-2 fixed point resolves — feed id_bits() a padded or
bucketed vertex count and the effective priorities change, silently
diverging from every engine that used the real count.  The reference
shipped exactly that bug once (id_bits of the device-padded count: V =
1022 on 8 devices pads to 1024, b goes 10 -> 11, a different set), and
the port's engines were written to its fix.

The port pads in three places, and each must keep b = id_bits(V_real):
core/dist.py pads the ELL to a multiple of the world size
(prepare_padded -> ShardedEll.num_padded, _pad_labels), the host-driven
compacted driver pads its worklists to powers of two (_bucket,
_pad_worklist), and batch/container.py stacks graphs into pow2 buckets
(bucket_shape, a bucket's rows, its block-diagonal flat_neighbors) whose
members each keep their own bits.

History in the port: when this analyzer first ran over the port, it
flagged core/dist.py's _mis2_distributed_impl, which took v from the
padded ShardedEll (`v, vp, p = sh.num_vertices, sh.num_padded, ...`,
then id_bits(v)): the right number, but one whose provenance sat one
tuple slot away from the padded count.  v now comes from the graph, as
the reference takes it from its ELL, and a ShardedEll passed in is
asserted to agree.  RL102 flags any id_bits() argument whose dataflow
reaches:

  * a name matching vp/vp_total/padded_*/*_padded/pad/bucket/flat_neighbors
  * a call to pad_graph_for_mesh / prepare_padded / _pad_labels /
    _pad_worklist / _bucket / bucket_shape (padding and pow2 bucketing)

Pass V_real / num_vertices / graph.num_vertices instead.  If a padded
width is genuinely intended (it never is for priorities), suppress with
`# repro-lint: ignore[RL102] <reason>`.
"""

    def check_file(self, src: SourceFile, project: Project) -> List[Finding]:
        out: List[Finding] = []
        for info in iter_file_functions(project, src):
            flow = None
            for sub in ast.walk(info.node):
                if not isinstance(sub, ast.Call):
                    continue
                chain = src.resolve(sub.func) or _name_chain(sub.func) or ""
                if chain.rpartition(".")[2] != "id_bits" or not sub.args:
                    continue
                if flow is None:
                    flow = LocalDataflow(info.node)
                evidence = self._padded_evidence(flow, sub.args[0])
                if evidence:
                    out.append(Finding(
                        rule=self.code, path=src.relpath, line=sub.lineno,
                        symbol=short_symbol(info),
                        message=(f"id_bits({ast.unparse(sub.args[0])}) "
                                 f"descends from padded/bucketed size "
                                 f"{sorted(evidence)} — the packing bit "
                                 "width must come from the REAL vertex "
                                 "count (the padded-count determinism bug)")))
        return out

    def _padded_evidence(self, flow: LocalDataflow,
                         arg: ast.AST) -> Set[str]:
        tokens = flow.origin_tokens(arg)
        bad: Set[str] = set()
        for tok in tokens:
            if tok.endswith("()"):
                if _PADDING_CALLS.search(tok):
                    bad.add(tok)
            elif _PADDED_NAME_RE.search(tok):
                bad.add(tok)
        return bad
