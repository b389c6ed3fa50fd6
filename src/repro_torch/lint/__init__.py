"""``repro_torch.lint`` — the port's static determinism & execution-shape
analyzer.

The static half of the port's invariant set (``tools/check_shape_torch.py``
is the runtime half), a copy of the reference's ``repro.lint`` that reads
the port's Python and CUDA sources: six named rules that each encode a
bug class the port has —

* **RL101 trace-purity** — a host read (``.item()``, ``.cpu()``,
  ``int()`` of a tensor, ...) inside a Python loop that launches a kernel
  every round (the host-driven rounds the one-dispatch loops replaced).
* **RL102 priority-provenance** — ``id_bits`` fed a padded/bucketed
  vertex count (the distributed padding, the pow2 buckets).
* **RL103 timing** — ``time.time`` where durations need
  ``time.perf_counter``.
* **RL104 obs-hygiene** — metric names off the registry scheme,
  unbounded (f-string/digest) label values.
* **RL105 options-aliasing** — mutable default arguments (the shared
  ``Mis2Options()`` class).
* **RL106 kernel-masking** — ``__global__`` CUDA kernels with no guard on
  a thread-derived index (out-of-bounds tail threads the CPU tests cannot
  see, since there the plain-torch twins run).

Its modules import neither torch nor jax nor the reference package (the
``repro_torch`` package around it imports torch), and it never imports
the code it reads.

Usage::

    from repro_torch.lint import lint_paths, check
    result = check(["src/repro_torch"],
                   baseline="tools/lint_baseline_torch.json")
    result.ok          # False if any live finding / baseline problem
    result.findings    # live (unsuppressed, non-baselined) findings

CLI: ``python tools/repro_lint_torch.py --check src/repro_torch`` (see
--help).

Inline suppression (reason mandatory)::

    x = time.time  # repro-lint: ignore[RL103] epoch stamp, not a duration
    // repro-lint: ignore[RL106] one thread a launch, no index   (CUDA)

File-level quarantine for retired modules::

    # repro-lint: legacy retired driver, unreachable from the facade
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Sequence

from .baseline import Baseline, BaselineEntry, baseline_from_findings
from .engine import PACKAGE, LintError, Project, discover, run_rules
from .findings import Finding, Suppression
from .rules import all_rules, get_rule

#: reachability roots outside src/ (parsed, never linted): the port's
#: examples, the tools, and the chip smoke
DEFAULT_ROOTS = ("examples/torch", "tools", "chip_smoke.py")


@dataclass
class LintResult:
    findings: List[Finding] = field(default_factory=list)      # live
    suppressed: List[Finding] = field(default_factory=list)
    grandfathered: list = field(default_factory=list)          # (f, entry)
    legacy: List[Finding] = field(default_factory=list)
    baseline_problems: List[str] = field(default_factory=list)
    unreachable: List[str] = field(default_factory=list)       # informational
    test_only: List[str] = field(default_factory=list)         # informational
    quarantined: List[str] = field(default_factory=list)
    project: Optional[Project] = None

    @property
    def ok(self) -> bool:
        return not self.findings and not self.baseline_problems

    @property
    def cuda_files(self) -> List[str]:
        """The CUDA sources linted, repo-relative."""
        if self.project is None:
            return []
        return [c.relpath for c in self.project.cuda_files if c.is_target]

    def counts(self) -> dict:
        """``{rule: {"live", "suppressed", "baselined", "legacy"}}`` for
        every rule, zeros included."""
        groups = {"live": self.findings, "suppressed": self.suppressed,
                  "baselined": [f for f, _ in self.grandfathered],
                  "legacy": self.legacy}
        codes = {r.code for r in all_rules()} | {"RL001"} | {
            f.rule for found in groups.values() for f in found}
        out = {c: dict.fromkeys(groups, 0) for c in sorted(codes)}
        for kind, found in groups.items():
            for f in found:
                out[f.rule][kind] += 1
        return out

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "grandfathered": [
                dict(f.to_dict(), reason=e.reason)
                for f, e in self.grandfathered],
            "legacy": [f.to_dict() for f in self.legacy],
            "baseline_problems": list(self.baseline_problems),
            "counts": self.counts(),
            "cuda_files": self.cuda_files,
            "reachability": {
                "unreachable_modules": sorted(self.unreachable),
                "test_only_modules": sorted(self.test_only),
                "quarantined_modules": sorted(self.quarantined),
            },
        }


def _default_roots(repo_root: Path) -> List[Path]:
    return [repo_root / d for d in DEFAULT_ROOTS]


def lint_paths(targets: Sequence, repo_root=None,
               roots: Optional[Sequence] = None) -> List[Finding]:
    """Run every rule over ``targets``; returns ALL findings (suppressed
    and legacy-tagged included — callers filter)."""
    repo_root = Path(repo_root) if repo_root else _infer_repo_root(targets)
    if roots is None:
        roots = _default_roots(repo_root)
    project = discover([Path(t) for t in targets], repo_root,
                       [Path(r) for r in roots])
    return run_rules(project, all_rules())


def check(targets: Sequence, baseline=None, repo_root=None,
          roots: Optional[Sequence] = None) -> LintResult:
    """The CI entry point: lint, apply suppressions + baseline, classify."""
    repo_root = Path(repo_root) if repo_root else _infer_repo_root(targets)
    if roots is None:
        roots = _default_roots(repo_root)
    project = discover([Path(t) for t in targets], repo_root,
                       [Path(r) for r in roots])
    findings = run_rules(project, all_rules())

    result = LintResult(project=project)
    active: List[Finding] = []
    for f in findings:
        if f.suppressed:
            result.suppressed.append(f)
        elif f.tag == "legacy" and f.rule != "RL001":
            # findings inside quarantined files are reported, not fatal —
            # RL001 (quarantine violation) stays fatal
            result.legacy.append(f)
        else:
            active.append(f)

    bl = baseline if isinstance(baseline, Baseline) else Baseline.load(
        baseline) if baseline else Baseline()
    live, grandfathered, problems = bl.apply(active)
    result.findings = live
    result.grandfathered = grandfathered
    result.baseline_problems = problems

    reachable, unreachable = project.module_reachability()
    test_reach = project.reachable_from(_test_imports(repo_root, project))
    for src in project.files:
        if src.is_root or not src.module.startswith(PACKAGE):
            continue
        if src.legacy is not None:
            result.quarantined.append(src.module)
        elif src.module in unreachable:
            if src.module in test_reach:
                result.test_only.append(src.module)
            else:
                result.unreachable.append(src.module)
    return result


def _test_imports(repo_root: Path, project: Project) -> set:
    """Tracked modules the test suite imports (statically) — used to
    split 'unreachable' into parity/reference modules the tests consume
    vs genuinely dead code."""
    import ast as _ast
    seeds = set()
    tests = Path(repo_root) / "tests"
    if not tests.is_dir():
        return seeds
    for p in sorted(tests.glob("*.py")):
        try:
            tree = _ast.parse(p.read_text())
        except (SyntaxError, OSError):        # pragma: no cover
            continue
        for node in _ast.walk(tree):
            if isinstance(node, _ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, _ast.ImportFrom) and node.module:
                names = [node.module] + [
                    f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            for name in names:
                mod = project._owning_module(name)
                if mod:
                    seeds.add(mod)
    return seeds


def _infer_repo_root(targets: Sequence) -> Path:
    t = Path(next(iter(targets))).resolve()
    for parent in [t] + list(t.parents):
        if (parent / "ROADMAP.md").exists() or (parent / ".git").exists():
            return parent
    return Path.cwd()


__all__ = [
    "Baseline", "BaselineEntry", "Finding", "LintError", "LintResult",
    "Project", "Suppression", "all_rules", "baseline_from_findings",
    "check", "get_rule", "lint_paths",
]
