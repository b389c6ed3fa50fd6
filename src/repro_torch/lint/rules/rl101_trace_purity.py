"""RL101 — trace purity: no host read inside a Python loop that launches
a kernel every round."""
from __future__ import annotations

import ast
import re
from typing import List

from ..engine import FunctionInfo, Project, SourceFile, _name_chain
from ..findings import Finding
from . import Rule, register
from ._shared import (
    TorchInference,
    iter_file_functions,
    iter_own_nodes,
    iter_subtree,
    resolve_chain,
    short_symbol,
)

#: tensor methods that pull a value to the host, on any receiver
_ALWAYS_SYNC_ATTRS = {"cpu": ".cpu() copies the tensor to the host",
                      "numpy": ".numpy() materializes the tensor on the host"}
#: tensor methods that pull a value to the host, on a torch value
_SYNC_ATTRS = {"item": ".item() forces a device->host sync",
               "tolist": ".tolist() copies the tensor to the host"}
_HOST_FUNCS = {
    "numpy.asarray": "np.asarray materializes the tensor on the host",
    "numpy.array": "np.array materializes the tensor on the host",
    "numpy.copy": "np.copy materializes the tensor on the host",
}
_SYNC_CALLS = {"torch.cuda.synchronize":
               "torch.cuda.synchronize() blocks on the device"}
_CASTS = {"int", "bool", "float"}

#: the CPU twins of the kernels: a flag a round by design, never on a card
_TWIN_MODULE_RE = re.compile(r"(^|\.)kernels\.[A-Za-z_]\w*\.ref$")

#: the round counters a `for` loop of rounds iterates
_ROUND_ITERS = {"range", "itertools.count", "count"}


@register
class TracePurity(Rule):
    code = "RL101"
    name = "trace-purity"
    explain = """\
RL101 trace-purity — no host read inside a loop that launches a kernel
every round.

A Python loop of rounds — a `while` loop, or a `for` loop over a round
counter (range, itertools.count) — whose body calls a function that
reaches a kernel launch (a call into a repro_torch.kernels.<name>.ops wrapper that
counts a launch in its LAUNCHES, directly or through the call graph) runs
device work every round.  Inside such a loop — its condition or its body —
the following pull a value back to the host, so every round waits for the
card to drain and pays a copy:

  * .item() / .tolist() on a torch value; .cpu() / .numpy() on anything
  * torch.cuda.synchronize()
  * int(x) / bool(x) / float(x) where x is a torch value
  * np.asarray / np.array / np.copy of a torch value
  * a Python `if` / `while` whose test reads a torch value

A torch value is a name bound from a torch.* call, from a tensor method of
a torch value, or from a kernel wrapper call; parameters are not assumed
to be tensors, and a `for` loop over data (the buckets of a batch, the
levels of a setup, the requests of a warm-up) pulls each item's result
once and is not a loop of rounds (precision over recall).

History: the port's first MIS-2, Luby, misk and coarsening loops were
host-driven rounds: each round launched the kernels and then read a live
flag or pulled T and M back to decide whether to go on.  Each was then
replaced by one cooperative launch that reads nothing on the host until
it ends (cuda_resident, cuda_hybrid, the Luby loops, the joins, misk, the
batched loops, the streaming repair), the counterpart of the reference's
single jitted lax.while_loop.  The runtime half of this
invariant is tools/check_shape_torch.py's `resident` gate (1 launch, 0
host syncs on a golden workload) and chip_smoke.py's per-phase
`torch.cuda.set_sync_debug_mode("error")`; RL101 is the static half that
covers every loop, including ones no smoke phase runs.  The reference's
RL101 seeds from jax.jit and lax bodies, which the port has none of.

Out of scope: the CPU twins (kernels/*/ref.py), which never run when a
card is present and read a flag a round by design.

A loop that keeps a host read on purpose (the host-driven compacted
driver, the distributed engines' all-reduced flag) suppresses it with
`# repro-lint: ignore[RL101] <reason>`; the reason names the counter that
counts the read (e.g. mis2.host_syncs) and the reference behaviour it
matches.
"""

    def check_file(self, src: SourceFile, project: Project) -> List[Finding]:
        if _TWIN_MODULE_RE.search(src.module or ""):
            return []
        out: List[Finding] = []
        for info in iter_file_functions(project, src):
            inf = None
            seen = set()
            for loop in iter_own_nodes(info.node):
                if not _is_round_loop(loop) or \
                        not _launches(loop, info, project):
                    continue
                if inf is None:
                    inf = TorchInference(info, src)
                scope = [loop.test] if isinstance(loop, ast.While) else []
                scope += loop.body
                for stmt in scope:
                    for sub in iter_subtree(stmt):
                        for line, msg in self._host_reads(sub, inf, src):
                            if line not in seen:
                                seen.add(line)
                                out.append(Finding(
                                    rule=self.code, path=src.relpath,
                                    line=line, symbol=short_symbol(info),
                                    message=msg + " inside a loop that "
                                    "launches a kernel every round"))
                if isinstance(loop, ast.While) and \
                        inf.torch_reads_in(loop.test) and \
                        loop.lineno not in seen:
                    seen.add(loop.lineno)
                    out.append(Finding(
                        rule=self.code, path=src.relpath, line=loop.lineno,
                        symbol=short_symbol(info),
                        message=("Python `while` on torch value(s) "
                                 f"{sorted(inf.torch_reads_in(loop.test))} "
                                 "reads the device every round of a loop "
                                 "that launches a kernel")))
        out.sort(key=lambda f: f.line)
        return out

    def _host_reads(self, sub: ast.AST, inf: TorchInference,
                    src: SourceFile):
        if isinstance(sub, ast.Call):
            if isinstance(sub.func, ast.Attribute) and not sub.args:
                attr = sub.func.attr
                if attr in _ALWAYS_SYNC_ATTRS:
                    yield sub.lineno, _ALWAYS_SYNC_ATTRS[attr]
                elif attr in _SYNC_ATTRS and inf.is_torch(sub.func.value):
                    yield sub.lineno, _SYNC_ATTRS[attr]
            chain = resolve_chain(src, sub.func)
            if chain in _SYNC_CALLS:
                yield sub.lineno, _SYNC_CALLS[chain]
            if chain in _HOST_FUNCS and sub.args and \
                    inf.is_torch(sub.args[0]):
                yield sub.lineno, _HOST_FUNCS[chain]
            if isinstance(sub.func, ast.Name) and \
                    sub.func.id in _CASTS and len(sub.args) == 1 and \
                    inf.is_torch(sub.args[0]):
                yield sub.lineno, (f"{sub.func.id}() on a torch value "
                                   "forces a device->host sync")
        elif isinstance(sub, ast.If):
            names = inf.torch_reads_in(sub.test)
            if names:
                yield sub.lineno, (f"Python `if` on torch value(s) "
                                   f"{sorted(names)} reads the device")


def _is_round_loop(node: ast.AST) -> bool:
    """A `while` loop, or a `for` loop over a round counter (``range``,
    ``itertools.count``); a `for` over data (buckets, levels, requests)
    pulls each item's result once and is not a loop of rounds."""
    if isinstance(node, ast.While):
        return True
    if isinstance(node, (ast.For, ast.AsyncFor)) and \
            isinstance(node.iter, ast.Call):
        return (_name_chain(node.iter.func) or "") in _ROUND_ITERS
    return False


def _launches(loop: ast.AST, info: FunctionInfo, project: Project) -> bool:
    """True iff the loop's body (or a `while` test) calls a function that
    reaches a kernel launch."""
    scope = [loop.test] if isinstance(loop, ast.While) else []
    for stmt in scope + loop.body:
        for sub in iter_subtree(stmt):
            if isinstance(sub, ast.Call) and project.call_launches(info, sub):
                return True
    return False
