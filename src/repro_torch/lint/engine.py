"""The ``repro_torch.lint`` analysis engine.

One :class:`Project` is built per run: every Python target is parsed once,
imports are resolved to qualified names, a call graph is grown over the
module-level functions, and the **launch reach** — the set of functions
that reach a kernel launch, a call into a ``repro_torch.kernels.<name>.ops``
wrapper that counts a launch in its ``LAUNCHES``, directly or transitively
— is computed by a breadth-first walk over the reversed call graph.  The
CUDA targets (``.cu`` / ``.cuh``) are read as text with their comments and
string literals blanked, tokenized, and indexed into their ``__global__``
and ``__device__`` functions.  Rules receive the project plus one
:class:`SourceFile` (or, for rules that ask for them, one
:class:`CudaSource`) at a time and emit
:class:`~repro_torch.lint.findings.Finding` values; the engine owns
suppression matching, legacy quarantine tags, and the module-level
reachability report that backs the quarantine checks.

The analyzer is deliberately *syntactic*: it never imports the code under
analysis, so it runs in seconds, needs no card and no CUDA compiler, and
can lint a file that would crash on import.  The price is
approximation — the call graph is best-effort (dynamic dispatch through
the engine registry is invisible to it), device values are inferred, not
typed, and the CUDA reader knows C++ only as far as the kernels use it.
Rules are therefore tuned for precision over recall and every rule
supports inline suppression with a mandatory reason
(``# repro-lint: ignore[RLxxx] why``, ``// repro-lint: ignore[RLxxx] why``
in a CUDA source).
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .findings import (
    Finding,
    parse_c_pragmas,
    parse_legacy_tag,
    parse_suppressions,
)

#: the package whose modules the reachability report tracks
PACKAGE = "repro_torch"

#: modules that are entry points of the port (reachability roots)
ENTRY_MODULES = tuple(f"{PACKAGE}.{m}" for m in ("api", "serve", "obs", "lint"))

#: a kernel wrapper module, ``...kernels.<name>.ops``
OPS_MODULE_RE = re.compile(r"(^|\.)kernels\.[A-Za-z_]\w*\.ops$")

#: the per-wrapper launch counter every ops module keeps
LAUNCH_COUNTER = "LAUNCHES"

CUDA_SUFFIXES = (".cu", ".cuh")


def _name_chain(node: ast.AST) -> Optional[str]:
    """``a.b.c`` -> "a.b.c"; returns None for non-trivial expressions."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclass
class FunctionInfo:
    qualname: str               # "repro_torch.core.mis2.record_loop"
    module: str                 # "repro_torch.core.mis2" (or pseudo-module)
    node: ast.AST               # FunctionDef | AsyncFunctionDef
    src: "SourceFile"
    counts_launch: bool = False  # an ops wrapper bumping LAUNCHES[...]
    calls: Set[str] = field(default_factory=set)     # resolved callees
    #: calls into ops modules that are not among the targets (by name)
    ops_calls: Set[str] = field(default_factory=set)
    local_defs: Dict[str, str] = field(default_factory=dict)


@dataclass
class SourceFile:
    path: Path
    relpath: str                # repo-relative posix string
    module: str                 # dotted module name ("repro_torch.core.mis2")
    text: str
    tree: ast.Module
    suppressions: dict          # line -> Suppression
    legacy: Optional[str]       # quarantine reason, or None
    imports: Dict[str, str] = field(default_factory=dict)  # alias -> qualified
    is_root: bool = False       # reachability seed (examples/tools/smoke)

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Resolve a Name/Attribute chain to a qualified dotted name."""
        chain = _name_chain(node)
        if chain is None:
            return None
        head, _, rest = chain.partition(".")
        base = self.imports.get(head)
        if base is None:
            # module-local symbol: qualify against this module
            base = f"{self.module}.{head}" if self.module else head
        return f"{base}.{rest}" if rest else base


def _module_name_for(path: Path, src_root: Path) -> Optional[str]:
    try:
        rel = path.resolve().relative_to(src_root.resolve())
    except ValueError:
        return None
    parts = list(rel.with_suffix("").parts)
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) if parts else None


def _collect_imports(tree: ast.Module, module: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    pkg_parts = module.split(".")[:-1] if module else []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
                if a.asname:
                    out[a.asname] = a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base_parts = pkg_parts[: len(pkg_parts) - (node.level - 1)] \
                    if node.level > 1 else list(pkg_parts)
                base = ".".join(base_parts + ([node.module] if node.module
                                              else []))
            else:
                base = node.module or ""
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = f"{base}.{a.name}" if base else a.name
    return out


# ---------------------------------------------------------------------------
# CUDA sources: tokens, templates, the function index
# ---------------------------------------------------------------------------

_C_TOKEN_RE = re.compile(r"""
    (?P<ws>[ \t\r\f\v]+|\n)
  | (?P<pp>\#[^\n]*(?:\\\n[^\n]*)*)
  | (?P<num>\.?\d(?:[eEpP][+-]|[\w.])*)
  | (?P<id>[A-Za-z_]\w*)
  | (?P<op><<=|>>=|\.\.\.|::|->|\+\+|--|<<|>>|<=|>=|==|!=|&&|\|\|
        |[-+*/%&|^]=|[-+*/%&|^!~<>=?:;,.(){}\[\]])
    """, re.VERBOSE)

#: identifiers followed by a parenthesized group that are not the name of
#: the function they decorate
_C_ATTRIBUTE_CALLS = {"__launch_bounds__", "__align__", "__attribute__",
                      "alignas", "decltype", "__declspec"}

#: tokens after a ``name<...>`` group that make it a template argument list
_TEMPLATE_FOLLOW = {"(", "{", "::", ";", ">", ">>", ")", ",", "*", "&", "&&",
                    "["}


@dataclass(frozen=True)
class CToken:
    text: str
    line: int

    @property
    def is_id(self) -> bool:
        return self.text[:1].isalpha() or self.text[:1] == "_"


def tokenize_c(code: str) -> List[CToken]:
    """Tokens of blanked C++ code (:func:`~repro_torch.lint.findings.scan_c`):
    preprocessor lines are dropped, ``name<...>`` template argument lists
    are folded away so ``<`` and ``>`` left in the stream are comparisons."""
    raw: List[CToken] = []
    line = 1
    pos = 0
    while pos < len(code):
        m = _C_TOKEN_RE.match(code, pos)
        if m is None:                          # a stray character
            pos += 1
            continue
        kind, text = m.lastgroup, m.group()
        if kind not in ("ws", "pp"):
            raw.append(CToken(text, line))
        line += text.count("\n")
        pos = m.end()
    return _fold_templates(raw)


def _template_end(toks: List[CToken], k: int) -> int:
    """Index of the ``>`` closing the ``<`` at ``k``, or -1."""
    depth = paren = 0
    for j in range(k, len(toks)):
        t = toks[j].text
        if t in ("(", "["):
            paren += 1
        elif t in (")", "]"):
            paren -= 1
            if paren < 0:
                return -1
        elif paren == 0:
            if t == "<":
                depth += 1
            elif t == ">":
                depth -= 1
            elif t == ">>":
                depth -= 2
            elif t in (";", "{", "}", "&&", "||", "?"):
                return -1
            if depth <= 0:
                return j
    return -1


def _fold_templates(toks: List[CToken]) -> List[CToken]:
    out: List[CToken] = []
    k = 0
    while k < len(toks):
        t = toks[k]
        if t.text == "<" and out and out[-1].is_id:
            end = _template_end(toks, k)
            nxt = toks[end + 1] if 0 <= end < len(toks) - 1 else None
            if end > 0 and (out[-1].text == "template" or nxt is None
                            or nxt.is_id or nxt.text in _TEMPLATE_FOLLOW):
                k = end + 1
                continue
        out.append(t)
        k += 1
    return out


def _match(toks: List[CToken], k: int) -> int:
    """Index of the bracket closing the one opening at ``k``."""
    pairs = {"(": ")", "[": "]", "{": "}"}
    opening, closing = toks[k].text, pairs[toks[k].text]
    depth = 0
    for j in range(k, len(toks)):
        t = toks[j].text
        if t == opening:
            depth += 1
        elif t == closing:
            depth -= 1
            if depth == 0:
                return j
    return len(toks) - 1


@dataclass
class CudaFunction:
    """One ``__global__`` or ``__device__`` function definition."""
    name: str
    kind: str                    # "global" | "device"
    line: int                    # the line of its __global__ / __device__
    params: List[Tuple[str, bool]]   # (name, pointer-or-struct)
    body: List[CToken]           # the tokens between its braces
    src: "CudaSource"


_SCALAR_TYPES = {
    "bool", "char", "short", "int", "long", "unsigned", "signed", "float",
    "double", "void", "auto", "size_t", "int8_t", "int16_t", "int32_t",
    "int64_t", "uint8_t", "uint16_t", "uint32_t", "uint64_t", "const",
    "volatile", "__restrict__", "constexpr", "static", "register",
}


def _params_of(toks: List[CToken]) -> List[Tuple[str, bool]]:
    groups: List[List[CToken]] = [[]]
    depth = 0
    for t in toks:
        if t.text in ("(", "[", "{"):
            depth += 1
        elif t.text in (")", "]", "}"):
            depth -= 1
        if t.text == "," and depth == 0:
            groups.append([])
        else:
            groups[-1].append(t)
    out = []
    for g in groups:
        texts = [t.text for t in g]
        for stop in ("=", "["):          # a default value, an array bound
            if stop in texts:
                texts = texts[:texts.index(stop)]
        ids = [x for x in texts if x[:1].isalpha() or x[:1] == "_"]
        if len(ids) < 2:           # `void`, or an unnamed parameter
            continue
        name = ids[-1]
        type_toks = texts[:len(texts) - 1 - texts[::-1].index(name)]
        memory = any(x in ("*", "&", "&&") for x in type_toks) or any(
            x not in _SCALAR_TYPES and (x[:1].isalpha() or x[:1] == "_")
            for x in type_toks if x != "__grid_constant__")
        out.append((name, memory))
    return out


def index_cuda_functions(toks: List[CToken], src: "CudaSource"
                         ) -> List[CudaFunction]:
    """Every ``__global__`` / ``__device__`` function *defined* in ``toks``
    (declarations and ``__device__`` variables are skipped)."""
    out: List[CudaFunction] = []
    n = len(toks)
    k = 0
    while k < n:
        q = toks[k].text
        if q not in ("__global__", "__device__"):
            k += 1
            continue
        j, name = k + 1, None
        while j < n:
            t = toks[j].text
            if t in (";", "=", "{", "[", "}"):
                break
            if toks[j].is_id and j + 1 < n and toks[j + 1].text == "(":
                if t in _C_ATTRIBUTE_CALLS:
                    j = _match(toks, j + 1) + 1
                    continue
                if t == "operator" and j + 2 < n and toks[j + 2].text == ")":
                    name, j = "operator()", j + 3
                else:
                    name, j = t, j + 1
                break
            j += 1
        if name is None or j >= n or toks[j].text != "(":
            k = j + 1
            continue
        close = _match(toks, j)
        params = _params_of(toks[j + 1:close])
        b = close + 1
        while b < n and toks[b].text not in ("{", ";", ":"):
            b += 1
        if b < n and toks[b].text == ":":          # member initializers
            b += 1
            while b < n and toks[b].text != "{":
                if toks[b].text in ("(", "{") and toks[b - 1].is_id:
                    b = _match(toks, b) + 1
                    if b < n and toks[b].text == ",":
                        b += 1
                    continue
                b += 1
        if b >= n or toks[b].text != "{":
            k = b + 1
            continue
        end = _match(toks, b)
        out.append(CudaFunction(
            name=name, kind="global" if q == "__global__" else "device",
            line=toks[k].line, params=params, body=toks[b + 1:end], src=src))
        k = end + 1
    return out


_INCLUDE_RE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


@dataclass
class CudaSource:
    path: Path
    relpath: str
    text: str                   # as written
    code: str                   # comments and string literals blanked
    suppressions: dict          # line -> Suppression
    legacy: Optional[str]
    includes: List[Path] = field(default_factory=list)
    is_target: bool = True      # False: read only as another unit's include
    functions: List[CudaFunction] = field(default_factory=list)

    @property
    def kernels(self) -> List[CudaFunction]:
        return [f for f in self.functions if f.kind == "global"]


def load_cuda(path: Path, repo_root: Path,
              is_target: bool = True) -> CudaSource:
    try:
        text = path.read_text()
    except (UnicodeDecodeError, OSError) as e:  # pragma: no cover
        raise LintError(f"cannot read {path}: {e}") from e
    code, sups, legacy = parse_c_pragmas(text)
    includes = [(path.parent / name).resolve()
                for name in _INCLUDE_RE.findall(text)]
    src = CudaSource(path=path, relpath=_relpath(path, repo_root), text=text,
                     code=code, suppressions=sups, legacy=legacy,
                     includes=includes, is_target=is_target)
    src.functions = index_cuda_functions(tokenize_c(code), src)
    return src


def _relpath(path: Path, repo_root: Path) -> str:
    try:
        return str(path.resolve().relative_to(repo_root.resolve()).as_posix())
    except ValueError:
        return str(path)


# ---------------------------------------------------------------------------
# the project
# ---------------------------------------------------------------------------

class Project:
    """Whole-target analysis context shared by every rule."""

    def __init__(self, files: List[SourceFile],
                 cuda_files: Optional[List[CudaSource]] = None):
        self.files = files
        self.cuda_files: List[CudaSource] = list(cuda_files or [])
        self._cuda_by_path = {c.path.resolve(): c for c in self.cuda_files}
        self.by_module: Dict[str, SourceFile] = {
            f.module: f for f in files if f.module}
        self.functions: Dict[str, FunctionInfo] = {}
        self._launching: Set[str] = set()
        self._index_functions()
        self._build_call_graph()
        self._propagate_launch_reach()

    # -- indexing ----------------------------------------------------------

    def _index_functions(self) -> None:
        for src in self.files:
            ops_module = bool(OPS_MODULE_RE.search(src.module or ""))
            for qual, node, parents in _walk_functions(src.tree, src.module):
                info = FunctionInfo(qualname=qual, module=src.module,
                                    node=node, src=src)
                info.counts_launch = ops_module and _bumps_launches(node)
                self.functions[qual] = info

    def _build_call_graph(self) -> None:
        for src in self.files:
            for qual, node, _ in _walk_functions(src.tree, src.module):
                info = self.functions[qual]
                info.local_defs = {
                    n.name: f"{qual}.{n.name}" for n in ast.walk(node)
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and n is not node}
                for stmt in node.body:
                    for sub in ast.walk(stmt):
                        if isinstance(sub, ast.Call):
                            self._record_call(info, sub)

    def _resolve_function(self, node, src: SourceFile,
                          local_defs: Dict[str, str]) -> Optional[str]:
        if isinstance(node, ast.Name) and node.id in local_defs:
            return local_defs[node.id]
        resolved = src.resolve(node)
        if resolved and resolved in self.functions:
            return resolved
        return None

    def _untracked_ops_call(self, src: SourceFile, call: ast.Call
                            ) -> Optional[str]:
        """The qualified name of a call into an ops module that is not
        among the targets (so its functions cannot be inspected)."""
        chain = src.resolve(call.func) or ""
        mod = chain.rpartition(".")[0]
        if OPS_MODULE_RE.search(mod) and mod not in self.by_module:
            return chain
        return None

    def _record_call(self, info: FunctionInfo, call: ast.Call) -> None:
        callee = self._resolve_function(call.func, info.src, info.local_defs)
        if callee:
            info.calls.add(callee)
        else:
            ext = self._untracked_ops_call(info.src, call)
            if ext:
                info.ops_calls.add(ext)

    # -- launch reach --------------------------------------------------------

    def _propagate_launch_reach(self) -> None:
        callers: Dict[str, Set[str]] = {}
        for qual, f in self.functions.items():
            for callee in f.calls:
                callers.setdefault(callee, set()).add(qual)
        frontier = [q for q, f in self.functions.items()
                    if f.counts_launch or f.ops_calls]
        seen: Set[str] = set()
        while frontier:
            qual = frontier.pop()
            if qual in seen:
                continue
            seen.add(qual)
            frontier.extend(c for c in callers.get(qual, ()) if c not in seen)
        self._launching = seen

    def reaches_launch(self, qualname: str) -> bool:
        """True iff the function calls a kernel wrapper that counts a
        launch, directly or through the functions it calls."""
        return qualname in self._launching

    def call_launches(self, info: FunctionInfo, call: ast.Call) -> bool:
        """True iff ``call`` (inside ``info``) reaches a kernel launch."""
        callee = self._resolve_function(call.func, info.src, info.local_defs)
        if callee is not None:
            return callee in self._launching
        return self._untracked_ops_call(info.src, call) is not None

    # -- CUDA translation units ----------------------------------------------

    def translation_unit(self, src: CudaSource) -> List[CudaSource]:
        """``src`` and every file it includes with ``#include "..."``,
        transitively (an include that is not a target is read too)."""
        unit: List[CudaSource] = []
        seen: Set[Path] = set()
        stack = [src]
        while stack:
            cur = stack.pop()
            key = cur.path.resolve()
            if key in seen:
                continue
            seen.add(key)
            unit.append(cur)
            for inc in cur.includes:
                dep = self._cuda_by_path.get(inc)
                if dep is None and inc.is_file():
                    dep = load_cuda(inc, inc.parent, is_target=False)
                    self._cuda_by_path[inc] = dep
                if dep is not None:
                    stack.append(dep)
        return unit

    def cuda_kernels(self) -> List[Tuple[str, int, str]]:
        """``(path, line, name)`` of every ``__global__`` function defined
        in a CUDA target."""
        return [(c.relpath, k.line, k.name) for c in self.cuda_files
                if c.is_target for k in c.kernels]

    # -- module reachability ----------------------------------------------

    def module_reachability(self) -> Tuple[Set[str], Set[str]]:
        """(reachable, unreachable) port modules, walked over static
        imports from the entry roots: ``repro_torch.api``, ``.serve``,
        ``.obs``, ``.lint``, every root file handed to the engine (the
        port's examples, ``tools``, ``chip_smoke.py``), and every
        non-legacy module with an ``if __name__ == "__main__"`` guard
        (directly runnable via ``python -m``)."""
        graph = self.import_graph()
        roots: Set[str] = set()
        for src in self.files:
            if src.is_root:
                roots |= graph.get(src.module, set())
            elif src.module and (src.module.startswith(ENTRY_MODULES)
                                 or src.module == PACKAGE):
                roots.add(src.module)
            elif src.module and src.legacy is None and _has_main_guard(
                    src.tree):
                roots.add(src.module)
        reachable = self.reachable_from(roots)
        tracked = {f.module for f in self.files
                   if f.module and f.module.startswith(PACKAGE)
                   and not f.is_root}
        return reachable & tracked, tracked - reachable

    def import_graph(self) -> Dict[str, Set[str]]:
        """module -> tracked modules it statically imports."""
        graph: Dict[str, Set[str]] = {}
        for src in self.files:
            deps = set()
            for alias in src.imports.values():
                mod = self._owning_module(alias)
                if mod:
                    deps.add(mod)
            graph[src.module] = deps
        return graph

    def reachable_from(self, seeds: Set[str]) -> Set[str]:
        """Transitive import closure over tracked modules; importing any
        submodule also executes every ancestor package ``__init__``."""
        graph = self.import_graph()
        reachable: Set[str] = set()
        frontier = [m for m in seeds if m in graph]
        while frontier:
            mod = frontier.pop()
            if mod in reachable:
                continue
            reachable.add(mod)
            for dep in graph.get(mod, ()):
                if dep not in reachable:
                    frontier.append(dep)
            if "." in mod:
                pkg = mod.rsplit(".", 1)[0]
                if pkg not in reachable:
                    frontier.append(pkg)
        return reachable

    def _owning_module(self, qualified: str) -> Optional[str]:
        """Longest tracked-module prefix of a qualified name, if any."""
        parts = qualified.split(".")
        for cut in range(len(parts), 0, -1):
            cand = ".".join(parts[:cut])
            if cand in self.by_module:
                return cand
        return None


def _bumps_launches(fn_node: ast.AST) -> bool:
    """True iff the function's own body does ``LAUNCHES[...] += n``."""
    for sub in ast.walk(fn_node):
        if isinstance(sub, ast.AugAssign) and isinstance(
                sub.target, ast.Subscript):
            chain = _name_chain(sub.target.value) or ""
            if chain.rpartition(".")[2] == LAUNCH_COUNTER:
                return True
    return False


def _has_main_guard(tree: ast.Module) -> bool:
    """True iff the module has a top-level ``if __name__ == "__main__"``."""
    for node in tree.body:
        if isinstance(node, ast.If) and isinstance(node.test, ast.Compare):
            names = {n.id for n in ast.walk(node.test)
                     if isinstance(n, ast.Name)}
            if "__name__" in names:
                return True
    return False


def _walk_functions(tree: ast.Module, module: str) -> Iterator[tuple]:
    """Yield (qualname, node, parent_chain) for every def in the module."""
    def rec(node, prefix, parents):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}.{child.name}" if prefix else child.name
                yield qual, child, parents
                yield from rec(child, qual, parents + [child])
            elif isinstance(child, ast.ClassDef):
                qual = f"{prefix}.{child.name}" if prefix else child.name
                yield from rec(child, qual, parents + [child])
            elif isinstance(child, (ast.If, ast.Try, ast.With)):
                # defs behind conditionals/try/with at any nesting
                yield from rec(child, prefix, parents)
    yield from rec(tree, module, [])


# ---------------------------------------------------------------------------
# engine entry points
# ---------------------------------------------------------------------------

def load_file(path: Path, repo_root: Path, src_root: Optional[Path] = None,
              is_root: bool = False) -> Optional[SourceFile]:
    try:
        text = path.read_text()
        tree = ast.parse(text, filename=str(path))
    except (SyntaxError, UnicodeDecodeError, OSError) as e:  # pragma: no cover
        raise LintError(f"cannot parse {path}: {e}") from e
    module = None
    if src_root is not None:
        module = _module_name_for(path, src_root)
    if module is None:
        module = f"<root:{path.stem}>"
    src = SourceFile(
        path=path, relpath=_relpath(path, repo_root), module=module,
        text=text, tree=tree, suppressions=parse_suppressions(text),
        legacy=parse_legacy_tag(text), is_root=is_root)
    src.imports = _collect_imports(tree, module if not is_root else "")
    return src


class LintError(RuntimeError):
    pass


def discover(targets: List[Path], repo_root: Path,
             roots: Optional[List[Path]] = None) -> Project:
    """Parse ``targets`` (files or directories: every ``.py``, ``.cu`` and
    ``.cuh`` under a directory) plus reachability ``roots`` (Python only,
    never linted) into a :class:`Project`.  The src root is inferred so
    module names come out as ``repro_torch.x.y``."""
    files: List[SourceFile] = []
    cuda: List[CudaSource] = []
    seen: Set[Path] = set()

    def src_root_for(p: Path) -> Optional[Path]:
        for parent in [p] + list(p.parents):
            if parent.name == "src":
                return parent
        return None

    def add(path: Path, is_root: bool) -> None:
        path = path.resolve()
        if path in seen or path.name.startswith("."):
            return
        seen.add(path)
        if path.suffix in CUDA_SUFFIXES:
            cuda.append(load_cuda(path, repo_root))
        else:
            files.append(load_file(path, repo_root, src_root_for(path),
                                   is_root=is_root))

    for target in targets:
        target = Path(target)
        if target.is_dir():
            for suffix in (".py",) + CUDA_SUFFIXES:
                for p in sorted(target.rglob(f"*{suffix}")):
                    add(p, is_root=False)
        elif target.suffix in (".py",) + CUDA_SUFFIXES:
            add(target, is_root=False)
        else:
            raise LintError(f"not a python or CUDA file or directory: "
                            f"{target}")
    for root in roots or []:
        root = Path(root)
        if root.is_dir():
            for p in sorted(root.glob("*.py")):
                add(p, is_root=True)
        elif root.suffix == ".py" and root.exists():
            add(root, is_root=True)
    return Project(files, cuda)


def run_rules(project: Project, rules) -> List[Finding]:
    """Run every rule over every non-root file (and every CUDA target, for
    the rules that read CUDA); attach suppressions and legacy tags.  An
    invalid suppression (missing reason) does NOT suppress — the finding
    stays live with the problem appended."""
    findings: List[Finding] = []
    sources = [(src, rule.check_file) for src in project.files
               if not src.is_root for rule in rules]
    sources += [(src, rule.check_cuda) for src in project.cuda_files
                if src.is_target for rule in rules if rule.cuda]
    for src, check in sources:
        for f in check(src, project):
            sup = src.suppressions.get(f.line)
            if sup is not None and f.rule in sup.codes:
                if sup.valid:
                    f.suppressed_by = sup
                else:
                    f.message += ("  [suppression ignored: a reason is "
                                  "mandatory after ignore[...]]")
            if src.legacy is not None:
                f.tag = "legacy"
            findings.append(f)
    findings.extend(quarantine_findings(project))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def quarantine_findings(project: Project) -> List[Finding]:
    """RL001: a legacy-quarantined module is reachable from the live entry
    points — the quarantine is violated and must be resolved explicitly."""
    out: List[Finding] = []
    reachable, _ = project.module_reachability()
    for src in project.files:
        if src.legacy is None or src.is_root:
            continue
        if src.module in reachable:
            out.append(Finding(
                rule="RL001", path=src.relpath, line=1, symbol="<module>",
                message=(f"legacy-quarantined module {src.module} is "
                         "reachable from a facade/serve/example/tool entry "
                         "point — either un-quarantine it or cut the import")))
    return out
