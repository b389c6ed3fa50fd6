"""RL104 — obs hygiene: metric names follow the registry scheme, labels
stay bounded."""
from __future__ import annotations

import ast
import re
from typing import List, Optional

from ..engine import Project, SourceFile, _name_chain
from ..findings import Finding
from . import Rule, register
from ._shared import resolve_chain
from .rl103_timing import _symbol_spans

#: dotted lowercase: subsystem prefix mandatory ("mis2.host_syncs",
#: "serve.cache.bytes_used") — matches every registry name
_SCHEME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)+$")
#: an f-string name is tolerated iff its static prefix pins the subsystem
_FSTRING_PREFIX_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z0-9_]+)*\.$")

_REGISTRY_METHODS = {"counter", "gauge", "histogram"}
_DIGESTY = re.compile(r"digest|hexdigest|uuid|token_hex", re.IGNORECASE)


@register
class ObsHygiene(Rule):
    code = "RL104"
    name = "obs-hygiene"
    explain = """\
RL104 obs-hygiene — the observability registry stays queryable and
bounded.

Two sub-checks, both rooted in the registry contract of repro_torch.obs
(the reference's registry, copied; the port's loops, joins, server and
setups report through it under the reference's names):

1. Metric NAMES follow the scheme `subsystem.metric[_unit]` — dotted,
   lowercase, underscore words ("mis2.host_syncs",
   "serve.cache.bytes_used").  A literal name that breaks the scheme is
   flagged at parse time; an f-string name is allowed only when its
   static prefix already pins the subsystem (f"serve.cache.{name}").
   Names outside the scheme fracture dashboards and make
   tools/check_shape_torch.py's snapshot diffs unreadable.

2. Label VALUES must be bounded: an f-string label value, or a value
   whose expression mentions digest/hexdigest/uuid, is the exact shape
   the registry's CardinalityError exists to reject at runtime — a raw
   graph digest or request id as a label value grows the registry
   without bound.  RL104 catches it before it runs; put unbounded
   identity in span attrs instead.

The reference's third sub-check (writes through the legacy stats views
HOTLOOP_STATS / SETUP_STATS) is left out: the port defines no such view
globals, so there is nothing for it to guard.  Counters are incremented
through the registry only (`_obs.counter("mis2.host_syncs").inc(n)`).
"""

    def check_file(self, src: SourceFile, project: Project) -> List[Finding]:
        out: List[Finding] = []
        symbols = _symbol_spans(src, project)

        def flag(node, msg):
            out.append(Finding(
                rule=self.code, path=src.relpath, line=node.lineno,
                symbol=symbols.get(node.lineno, "<module>"), message=msg))

        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call):
                self._check_registry_call(node, src, flag)
        return out

    # -- helpers -----------------------------------------------------------

    def _check_registry_call(self, node: ast.Call, src: SourceFile,
                             flag) -> None:
        if not (isinstance(node.func, ast.Attribute)
                and node.func.attr in _REGISTRY_METHODS):
            return
        base = resolve_chain(src, node.func.value)
        base_txt = _name_chain(node.func.value) or ""
        if "obs" not in base and base_txt not in ("_OBS", "metrics") and \
                "obs" not in base_txt:
            return
        name_arg: Optional[ast.AST] = None
        if node.args:
            name_arg = node.args[0]
        for kw in node.keywords:
            if kw.arg == "name":
                name_arg = kw.value
        if isinstance(name_arg, ast.Constant) and \
                isinstance(name_arg.value, str):
            if not _SCHEME_RE.match(name_arg.value):
                flag(name_arg,
                     f"metric name {name_arg.value!r} breaks the registry "
                     "scheme `subsystem.metric` (dotted lowercase, e.g. "
                     "'mis2.host_syncs')")
        elif isinstance(name_arg, ast.JoinedStr):
            first = name_arg.values[0] if name_arg.values else None
            prefix = first.value if isinstance(first, ast.Constant) and \
                isinstance(first.value, str) else ""
            if not _FSTRING_PREFIX_RE.match(prefix):
                flag(name_arg,
                     "f-string metric name without a scheme-conforming "
                     "static subsystem prefix — the registry cannot be "
                     "audited statically; pin the prefix "
                     "(f\"serve.cache.{...}\")")
        for kw in node.keywords:
            if kw.arg != "labels" or not isinstance(kw.value, ast.Dict):
                continue
            for key, val in zip(kw.value.keys, kw.value.values):
                kname = getattr(key, "value", "?")
                if isinstance(val, ast.JoinedStr):
                    flag(val, f"f-string label value for {kname!r} — "
                              "unbounded cardinality (the CardinalityError "
                              "class, caught at parse time); use a bounded "
                              "token or a span attr")
                else:
                    txt = ast.unparse(val)
                    if _DIGESTY.search(txt):
                        flag(val, f"label value `{txt}` for {kname!r} looks "
                                  "digest/uuid-valued — unbounded "
                                  "cardinality; put identity in span attrs, "
                                  "never in metric labels")
