"""RL105 — options aliasing: no mutable default arguments."""
from __future__ import annotations

import ast
from typing import List

from ..engine import Project, SourceFile, _name_chain
from ..findings import Finding
from . import Rule, register
from ._shared import short_symbol

#: constructor calls whose results are immutable values — safe defaults
_IMMUTABLE_CALLS = {"frozenset", "tuple", "frozendict", "MappingProxyType"}


@register
class OptionsAliasing(Rule):
    code = "RL105"
    name = "options-aliasing"
    explain = """\
RL105 options-aliasing — mutable default arguments are banned.

    def mis2(graph, options=Mis2Options()):   # RL105
        ...

Python evaluates the default ONCE, at def time: every call that omits
`options` shares the SAME object.  The first caller that mutates a field
(ablations flip `worklists`, the batched pipelines and the server copy
and adjust their options) silently reconfigures every later call in the
process.

History: the reference's seed-era signatures all defaulted to
`Mis2Options()` and its batch pipeline mutated its copy — cross-call
contamination it swept out of core/ with the None-sentinel idiom.  The
port was written to that idiom from its first slice (the facade, the
engines, the setups, the batched pipelines, serving); RL105 keeps it so:

    def mis2(graph, options=None):
        options = Mis2Options() if options is None else options

Flagged defaults: any constructor call, list/dict/set literal.  Immutable
constructors (tuple(), frozenset()) are exempt.  A frozen-dataclass
default is still flagged — freezing prevents mutation but not identity
aliasing across calls, and the None-sentinel is uniformly cheaper than
auditing frozenness.
"""

    def check_file(self, src: SourceFile, project: Project) -> List[Finding]:
        out: List[Finding] = []
        seen = set()
        for info in project.functions.values():
            if info.src is not src or not isinstance(
                    info.node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if id(info.node) in seen:
                continue
            seen.add(id(info.node))
            a = info.node.args
            defaults = list(zip(reversed(a.posonlyargs + a.args),
                                reversed(a.defaults)))
            defaults += [(p, d) for p, d in zip(a.kwonlyargs, a.kw_defaults)
                         if d is not None]
            for param, default in defaults:
                bad = self._mutable_kind(default)
                if bad:
                    out.append(Finding(
                        rule=self.code, path=src.relpath,
                        line=default.lineno, symbol=short_symbol(info),
                        message=(f"mutable default `{param.arg}="
                                 f"{ast.unparse(default)}` is evaluated "
                                 "once and shared across every call (the "
                                 "options-aliasing bug class) — use "
                                 f"`{param.arg}=None` plus "
                                 f"`{param.arg} = {bad} if {param.arg} is "
                                 "None else ...`")))
        return out

    def _mutable_kind(self, default: ast.AST) -> str:
        if isinstance(default, (ast.List, ast.Dict, ast.Set)):
            return ast.unparse(default) or "..."
        if isinstance(default, ast.Call):
            chain = _name_chain(default.func) or ""
            if chain.rpartition(".")[2] in _IMMUTABLE_CALLS:
                return ""
            return ast.unparse(default)
        return ""
