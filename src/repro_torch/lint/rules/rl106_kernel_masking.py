"""RL106 — kernel masking: a CUDA kernel that touches memory must guard
the threads past its work."""
from __future__ import annotations

from typing import Dict, List, Set

from ..engine import CToken, CudaFunction, CudaSource, Project, SourceFile
from ..findings import Finding
from . import Rule, register

#: the CUDA built-ins a thread's position is read from
THREAD_BUILTINS = {"threadIdx", "blockIdx", "blockDim", "gridDim"}
#: members that read a thread's position from a cooperative group
THREAD_MEMBERS = {"thread_rank", "thread_index", "block_rank", "block_index"}

_COMPARISONS = {"<", ">", "<=", ">=", "==", "!="}
#: tokens that end an operand of a comparison at its own depth
_OPERAND_STOPS = {"&&", "||", ",", "?", ":", ";", "=", "+=", "-=", "*=",
                  "/=", "return"} | _COMPARISONS
_OPEN = {"(", "[", "{"}
_CLOSE = {")", "]", "}"}


@register
class KernelMasking(Rule):
    code = "RL106"
    name = "kernel-masking"
    cuda = True
    explain = """\
RL106 kernel-masking — a CUDA kernel must keep the threads past its work
from reading or writing.

Every kernel of the port is launched over whole blocks: a standalone pass
over ceil(n / block) blocks (or the blocks that fit on the card, striding
over the rest), a persistent cooperative kernel over the grid that fits,
striding over its n rows.  Whenever n is not a multiple of the grid's
threads, the last block holds threads past n.  Such a thread that indexes
a buffer reads or writes out of bounds on the card — while every CPU test
stays green, because on the CPU each wrapper runs its plain-torch twin
and no kernel runs at all.  For a repo whose headline claim is
bit-identity across backends that is the worst kind of bug: seen only on
the card, and there only as a wrong digest or a fault some launches
later.

RL106 reads every `__global__` function of the CUDA sources
(kernels/csrc/*.cu, and the .cuh files they include).  A kernel that
touches memory — subscripts a parameter or a member of a struct
parameter (`r.heavy[h]` of a `const __grid_constant__ Resident r`), or
passes a pointer or struct parameter to a `__device__` function — must
show a guard in its body or in a `__device__` function it calls,
transitively, within its translation unit.  A guard is a comparison in
an `if`, `for` or `while` condition, or in a ternary, one side of which
reads a thread-derived value: threadIdx / blockIdx / blockDim / gridDim,
grid.thread_rank(), a name bound from one of them, or a helper whose
return reads one (`global_tid()`, the grid-stride idiom
`for (i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride)`).
Templated bodies are checked once, as written.

The reference's RL106 checks Pallas kernel bodies for a pl.when guard or
a ragged-tail mask; the port has no Pallas kernel, so its rule reads the
CUDA sources that replaced them.  A kernel that truly needs no guard (no
tail thread can read through an index) suppresses with
`// repro-lint: ignore[RL106] <why no tail lane can read through an
index>` on its `__global__` line or the line above it.
"""

    def check_file(self, src: SourceFile, project: Project) -> List[Finding]:
        return []

    def check_cuda(self, src: CudaSource, project: Project) -> List[Finding]:
        unit = project.translation_unit(src)
        table: Dict[str, List[CudaFunction]] = {}
        for part in unit:
            for fn in part.functions:
                if fn.kind == "device":
                    table.setdefault(fn.name, []).append(fn)
        helpers = _thread_helpers(table)
        guarded: Dict[int, bool] = {}
        out: List[Finding] = []
        for kernel in src.kernels:
            if not _touches_memory(kernel, table):
                continue
            if _has_guard(kernel, table, helpers, guarded, set()):
                continue
            out.append(Finding(
                rule=self.code, path=src.relpath, line=kernel.line,
                symbol=kernel.name,
                message=("CUDA kernel indexes memory with no guard on a "
                         "thread-derived index — the threads past n in the "
                         "last block read or write out of bounds on the card "
                         "(the CPU twins never run the kernel)")))
        return out


def _refs(toks: List[CToken], k: int) -> bool:
    """True iff ``toks[k]`` names a variable (not a member after . / ->)."""
    return k == 0 or toks[k - 1].text not in (".", "->", "::")


def _calls(fn: CudaFunction, table: Dict[str, List[CudaFunction]]
           ) -> List[CudaFunction]:
    body = fn.body
    out = []
    for k in range(len(body) - 1):
        if body[k + 1].text == "(" and body[k].text in table:
            out.extend(table[body[k].text])
    return out


def _touches_memory(fn: CudaFunction,
                    table: Dict[str, List[CudaFunction]]) -> bool:
    params = {name for name, _ in fn.params}
    memory = {name for name, mem in fn.params if mem}
    body = fn.body
    n = len(body)
    for k, t in enumerate(body):
        if t.text not in params or not _refs(body, k):
            continue
        nxt = body[k + 1].text if k + 1 < n else ""
        if nxt == "[":
            return True
        if nxt in (".", "->") and k + 3 < n and body[k + 3].text in (
                "[", "("):
            if body[k + 3].text == "[" or body[k + 2].text in table:
                return True
    # a pointer or struct parameter handed to a __device__ function
    for k in range(n - 1):
        if body[k + 1].text != "(" or body[k].text not in table:
            continue
        depth = 0
        for j in range(k + 1, n):
            x = body[j].text
            if x in _OPEN:
                depth += 1
            elif x in _CLOSE:
                depth -= 1
                if depth == 0:
                    break
            elif x in memory and _refs(body, j):
                return True
    return False


def _thread_names(toks: List[CToken], helpers: Set[str]) -> Set[str]:
    """Names bound (``x = ...`` / ``T x = ...``, for-inits included) from
    a thread-derived expression, to a fixpoint."""
    names: Set[str] = set()
    binds = []
    n = len(toks)
    for k in range(1, n):
        if toks[k].text != "=" or not toks[k - 1].is_id or \
                not _refs(toks, k - 1):
            continue
        depth, j = 0, k + 1
        while j < n:
            x = toks[j].text
            if x in _OPEN:
                depth += 1
            elif x in _CLOSE:
                depth -= 1
                if depth < 0:
                    break
            elif depth == 0 and x in (";", ","):
                break
            j += 1
        binds.append((toks[k - 1].text, k + 1, j))
    changed = True
    while changed:
        changed = False
        for name, a, b in binds:
            if name not in names and _reads_thread(toks, a, b, names,
                                                   helpers):
                names.add(name)
                changed = True
    return names


def _reads_thread(toks: List[CToken], a: int, b: int, names: Set[str],
                  helpers: Set[str]) -> bool:
    for k in range(a, b):
        x = toks[k].text
        if x in THREAD_MEMBERS and k > 0 and toks[k - 1].text in (".", "->"):
            return True
        if not _refs(toks, k):
            continue
        if x in THREAD_BUILTINS or x in names:
            return True
        if x in helpers and k + 1 < len(toks) and toks[k + 1].text == "(":
            return True
    return False


def _thread_helpers(table: Dict[str, List[CudaFunction]]) -> Set[str]:
    """``__device__`` functions whose ``return`` reads a thread-derived
    value (``global_tid()``), to a fixpoint."""
    helpers: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for name, fns in table.items():
            if name in helpers:
                continue
            for fn in fns:
                body = fn.body
                local = _thread_names(body, helpers)
                for k, t in enumerate(body):
                    if t.text != "return":
                        continue
                    end = k + 1
                    while end < len(body) and body[end].text != ";":
                        end += 1
                    if _reads_thread(body, k + 1, end, local, helpers):
                        helpers.add(name)
                        changed = True
                        break
                if name in helpers:
                    break
    return helpers


def _conditions(toks: List[CToken]):
    """(start, end) token spans of every if / while / for condition and
    every ternary's condition."""
    n = len(toks)
    for k, t in enumerate(toks):
        if t.text in ("if", "while", "for"):
            j = k + 1
            if j < n and toks[j].text == "constexpr":
                j += 1
            if j >= n or toks[j].text != "(":
                continue
            depth, end = 0, j
            for end in range(j, n):
                x = toks[end].text
                if x in _OPEN:
                    depth += 1
                elif x in _CLOSE:
                    depth -= 1
                    if depth == 0:
                        break
            if t.text != "for":
                yield j + 1, end
                continue
            semis = [i for i in range(j + 1, end) if toks[i].text == ";"]
            if len(semis) == 2:
                yield semis[0] + 1, semis[1]
        elif t.text == "?":
            depth, a = 0, k
            while a > 0:
                x = toks[a - 1].text
                if x in _CLOSE:
                    depth += 1
                elif x in _OPEN:
                    if depth == 0:
                        break
                    depth -= 1
                elif depth == 0 and x in (";", ",", "=", "return", "?",
                                          ":", "{", "}"):
                    break
                a -= 1
            yield a, k


def _operand(toks: List[CToken], k: int, step: int, lo: int, hi: int):
    """The span of the operand next to the comparison at ``k``, scanning
    in ``step`` direction within [lo, hi)."""
    depth, j = 0, k + step
    while lo <= j < hi:
        x = toks[j].text
        if x in (_CLOSE if step < 0 else _OPEN):
            depth += 1
        elif x in (_OPEN if step < 0 else _CLOSE):
            if depth == 0:
                break
            depth -= 1
        elif depth == 0 and x in _OPERAND_STOPS:
            break
        j += step
    return (j + 1, k) if step < 0 else (k + 1, j)


def _own_guard(fn: CudaFunction, helpers: Set[str]) -> bool:
    toks = fn.body
    names = _thread_names(toks, helpers)
    for a, b in _conditions(toks):
        for k in range(a, b):
            if toks[k].text not in _COMPARISONS:
                continue
            for lo, hi in (_operand(toks, k, -1, a, b),
                           _operand(toks, k, 1, a, b)):
                if _reads_thread(toks, lo, hi, names, helpers):
                    return True
    return False


def _has_guard(fn: CudaFunction, table: Dict[str, List[CudaFunction]],
               helpers: Set[str], memo: Dict[int, bool],
               stack: Set[int]) -> bool:
    key = id(fn)
    if key in memo:
        return memo[key]
    if key in stack:                 # recursion: no guard found on this path
        return False
    stack.add(key)
    found = _own_guard(fn, helpers) or any(
        _has_guard(callee, table, helpers, memo, stack)
        for callee in _calls(fn, table))
    stack.discard(key)
    memo[key] = found
    return found
