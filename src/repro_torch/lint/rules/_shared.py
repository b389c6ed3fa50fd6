"""Shared per-function analyses used by the RL rules.

:class:`LocalDataflow` is an intentionally approximate reaching-definition
map — straight-line, last-write-wins, control flow ignored — which is the
right fidelity for provenance questions ("does this argument descend from
a padded size?") where a false negative on a convoluted path is acceptable
and a false positive on ordinary code is not.

:class:`TorchInference` classifies the local names of one function as
torch values (tensors that may live on the card) or host values: a name
is a torch value only where it provably flows from a ``torch.*`` call, a
tensor method of a torch value, or a kernel wrapper
(``kernels.<name>.ops``).  Parameters are host values unless the body
shows otherwise — precision over recall, again.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Set, Tuple

from ..engine import (
    OPS_MODULE_RE,
    FunctionInfo,
    Project,
    SourceFile,
    _name_chain,
)

#: attribute reads that yield host values even on a tensor
STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "layout", "is_cuda",
                "requires_grad", "itemsize", "nbytes"}

#: tensor methods whose results are host values
HOST_METHODS = {"item", "tolist", "numpy", "dim", "numel", "nelement",
                "size", "stride", "data_ptr", "element_size",
                "is_contiguous", "get_device", "storage_offset",
                "is_floating_point", "untyped_storage"}

#: ``torch.*`` calls whose results are host values
HOST_TORCH_CALLS = {
    "torch.device", "torch.Size", "torch.iinfo", "torch.finfo",
    "torch.is_tensor", "torch.get_default_dtype", "torch.cuda.is_available",
    "torch.cuda.device_count", "torch.cuda.current_device",
    "torch.cuda.get_device_name", "torch.cuda.get_device_properties",
    "torch.cuda.current_stream", "torch.cuda.Event", "torch.cuda.Stream",
    "torch.cuda.synchronize", "torch.cuda.max_memory_allocated",
    "torch.cuda.memory_allocated", "torch.distributed.get_rank",
    "torch.distributed.get_world_size", "torch.distributed.is_initialized",
    "torch.no_grad", "torch.inference_mode", "torch.manual_seed",
}


def iter_file_functions(project: Project,
                        src: SourceFile) -> Iterator[FunctionInfo]:
    for info in project.functions.values():
        if info.src is src:
            yield info


def short_symbol(info: FunctionInfo) -> str:
    """Module-relative symbol for findings/baseline keys."""
    qual = info.qualname
    if info.module and qual.startswith(info.module + "."):
        qual = qual[len(info.module) + 1:]
    return qual


def resolve_chain(src: SourceFile, node: ast.AST) -> str:
    return src.resolve(node) or _name_chain(node) or ""


class LocalDataflow:
    """name -> assigned value expressions, collected over one function."""

    def __init__(self, fn_node: ast.AST):
        self.defs: Dict[str, List[ast.AST]] = {}
        body = fn_node.body if isinstance(
            fn_node, (ast.FunctionDef, ast.AsyncFunctionDef)) else [fn_node]
        for stmt in body:
            for sub in ast.walk(stmt if isinstance(stmt, ast.stmt)
                                else ast.Expr(value=stmt)):
                self._collect(sub)

    def _collect(self, node: ast.AST) -> None:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                self._bind(tgt, node.value)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            self._bind(node.target, node.value)
        elif isinstance(node, ast.AugAssign):
            self._bind(node.target, node.value)
        elif isinstance(node, ast.For):
            self._bind(node.target, node.iter)
        elif isinstance(node, (ast.NamedExpr,)):
            self._bind(node.target, node.value)

    def _bind(self, target: ast.AST, value: ast.AST) -> None:
        if isinstance(target, ast.Name):
            self.defs.setdefault(target.id, []).append(value)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, value)

    def origin_tokens(self, expr: ast.AST, depth: int = 6) -> Set[str]:
        """Every name, dotted chain, and callee name in the transitive
        provenance of ``expr`` (bounded by ``depth`` hops)."""
        tokens: Set[str] = set()
        frontier: List[Tuple[ast.AST, int]] = [(expr, depth)]
        seen_names: Set[str] = set()
        while frontier:
            node, d = frontier.pop()
            for sub in ast.walk(node):
                if isinstance(sub, ast.Name):
                    tokens.add(sub.id)
                    if d > 0 and sub.id not in seen_names:
                        seen_names.add(sub.id)
                        for value in self.defs.get(sub.id, ()):
                            frontier.append((value, d - 1))
                elif isinstance(sub, ast.Attribute):
                    chain = _name_chain(sub)
                    if chain:
                        tokens.add(chain)
                elif isinstance(sub, ast.Call):
                    chain = _name_chain(sub.func)
                    if chain:
                        tokens.add(chain + "()")
        return tokens


class TorchInference:
    """Classify the local names of one function as torch values."""

    def __init__(self, info: FunctionInfo, src: SourceFile):
        self.src = src
        self.torch: Set[str] = set()
        node = info.node
        # fixpoint over straight-line assignments (2 passes settle loops)
        for _ in range(2):
            for sub in iter_own_nodes(node):
                if isinstance(sub, ast.Assign):
                    if self.is_torch(sub.value):
                        for tgt in sub.targets:
                            self._mark(tgt)
                elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
                    if sub.value is not None and (
                            self.is_torch(sub.value)
                            or self.is_torch(sub.target)):
                        self._mark(sub.target)
                elif isinstance(sub, ast.NamedExpr):
                    if self.is_torch(sub.value):
                        self._mark(sub.target)

    def _mark(self, target: ast.AST) -> None:
        if isinstance(target, ast.Name):
            self.torch.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._mark(elt)

    def is_torch(self, expr: ast.AST) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in self.torch
        if isinstance(expr, ast.Attribute):
            if expr.attr in STATIC_ATTRS:
                return False
            return self.is_torch(expr.value)
        if isinstance(expr, ast.Subscript):
            # x.shape[0] is a host value even when x is a tensor
            if isinstance(expr.value, ast.Attribute) and \
                    expr.value.attr in STATIC_ATTRS:
                return False
            return self.is_torch(expr.value)
        if isinstance(expr, ast.Call):
            chain = resolve_chain(self.src, expr.func)
            if chain.startswith("torch.") and chain not in HOST_TORCH_CALLS:
                return True
            if OPS_MODULE_RE.search(chain.rpartition(".")[0]):
                return True
            if isinstance(expr.func, ast.Attribute):
                return expr.func.attr not in HOST_METHODS and \
                    self.is_torch(expr.func.value)
            return False
        if isinstance(expr, ast.BinOp):
            return self.is_torch(expr.left) or self.is_torch(expr.right)
        if isinstance(expr, ast.UnaryOp):
            return self.is_torch(expr.operand)
        if isinstance(expr, ast.Compare):
            return self.is_torch(expr.left) or any(
                self.is_torch(c) for c in expr.comparators)
        if isinstance(expr, ast.BoolOp):
            return any(self.is_torch(v) for v in expr.values)
        if isinstance(expr, ast.IfExp):
            return self.is_torch(expr.body) or self.is_torch(expr.orelse)
        if isinstance(expr, (ast.Tuple, ast.List)):
            return any(self.is_torch(e) for e in expr.elts)
        if isinstance(expr, ast.Starred):
            return self.is_torch(expr.value)
        return False

    def torch_reads_in(self, expr: ast.AST) -> Set[str]:
        """Torch names whose VALUE ``expr`` reads, outside is/is-not checks
        and host attributes (``x.shape``) or methods (``x.numel()``)."""
        out: Set[str] = set()

        def rec(node: ast.AST) -> None:
            if isinstance(node, ast.Compare) and all(
                    isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return                      # `x is None` guards are host-side
            if isinstance(node, ast.Attribute) and node.attr in STATIC_ATTRS:
                return
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and \
                    node.func.attr in HOST_METHODS - {"item", "tolist"}:
                return
            if isinstance(node, ast.Name) and node.id in self.torch:
                out.add(node.id)
            for child in ast.iter_child_nodes(node):
                rec(child)

        rec(expr)
        return out


def iter_own_nodes(fn_node: ast.AST) -> Iterator[ast.AST]:
    """Walk a function body without descending into nested def/class
    bodies (those are indexed and checked as their own functions).
    Lambdas stay in — they are part of the enclosing function."""
    body = fn_node.body if isinstance(
        fn_node, (ast.FunctionDef, ast.AsyncFunctionDef)) else [fn_node]
    for stmt in body:
        yield from iter_subtree(stmt)


def iter_subtree(node: ast.AST) -> Iterator[ast.AST]:
    """``node`` and its descendants, nested def/class bodies left out."""
    yield node
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
            continue
        yield from iter_subtree(child)
