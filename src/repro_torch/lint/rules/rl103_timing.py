"""RL103 — timing: durations use ``time.perf_counter``, never
``time.time``."""
from __future__ import annotations

import ast
from typing import List

from ..engine import Project, SourceFile
from ..findings import Finding
from . import Rule, register
from ._shared import resolve_chain, short_symbol


@register
class Timing(Rule):
    code = "RL103"
    name = "timing"
    explain = """\
RL103 timing — time.time() is banned; the repo standard is
time.perf_counter().

time.time() is wall-clock: it is subject to NTP slew and steps, so a
duration computed from two time.time() readings can be wrong by
milliseconds — or negative.  Every duration the port reports is a
perf_counter delta: the setups' `timings` by phase, the obs spans, the
server's ServeStats windows and a repair's RepairStats, chip_smoke.py's
walls and the tools/*_torch.py and tools/bench_*.py numbers that PERF.md
quotes beside the card's CUDA-event times.  The reference standardized on
it after its serving stats were caught mixing time.monotonic in; the port
was written to that standard, and RL103 keeps it there.

RL103 flags BOTH calls to time.time() and bare references to the
time.time function object.  The bare-reference case is deliberate:
genuinely epoch-based stamps (a persisted cache entry's manifest, a
trajectory record) are still allowed, but must be written as an explicit
module-level alias carrying an inline suppression with a reason, e.g.

    _EPOCH_NOW = time.time  # repro-lint: ignore[RL103] manifest stamp is
                            # an epoch time, not a duration

so every surviving wall-clock read is self-documenting and greppable.
"""

    def check_file(self, src: SourceFile, project: Project) -> List[Finding]:
        out: List[Finding] = []
        symbols = _symbol_spans(src, project)
        for node in ast.walk(src.tree):
            if isinstance(node, (ast.Attribute, ast.Name)):
                chain = resolve_chain(src, node)
                if chain == "time.time":
                    out.append(Finding(
                        rule=self.code, path=src.relpath, line=node.lineno,
                        symbol=symbols.get(node.lineno, "<module>"),
                        message=("time.time is wall-clock — use "
                                 "time.perf_counter() for durations; for a "
                                 "deliberate epoch stamp, bind an explicit "
                                 "alias with an ignore[RL103] reason")))
        return _dedupe(out)


def _symbol_spans(src: SourceFile, project: Project) -> dict:
    """line -> enclosing function symbol (for finding identity)."""
    spans = {}
    for info in project.functions.values():
        if info.src is not src or not hasattr(info.node, "body"):
            continue
        end = getattr(info.node, "end_lineno", info.node.lineno)
        for line in range(info.node.lineno, end + 1):
            # innermost def wins: later (nested) defs overwrite
            cur = spans.get(line)
            if cur is None or len(short_symbol(info)) >= len(cur):
                spans[line] = short_symbol(info)
    return spans


def _dedupe(findings: List[Finding]) -> List[Finding]:
    seen = set()
    out = []
    for f in findings:
        k = (f.rule, f.path, f.line)
        if k not in seen:
            seen.add(k)
            out.append(f)
    return out
