#!/usr/bin/env python
"""repro_torch.lint CLI — the static half of the port's invariant gates.

Usage::

    python tools/repro_lint_torch.py --check src/repro_torch
    python tools/repro_lint_torch.py --check src/repro_torch --format json
    python tools/repro_lint_torch.py --explain RL106
    python tools/repro_lint_torch.py --write-baseline src/repro_torch

``--check`` reads every ``.py``, ``.cu`` and ``.cuh`` file under the paths
and exits nonzero on any live finding (not suppressed inline, not in the
committed baseline ``tools/lint_baseline_torch.json``), on any baseline
problem (a stale entry that no longer fires — baselines shrink
monotonically — or an entry without a reason), or on a quarantine
violation (RL001: a ``# repro-lint: legacy`` module reachable from an
entry point: ``repro_torch.api`` / ``.serve`` / ``.obs`` / ``.lint``, the
port's examples, ``tools``, ``chip_smoke.py``).

Rules: RL101 trace-purity, RL102 priority-provenance, RL103 timing,
RL104 obs-hygiene, RL105 options-aliasing, RL106 kernel-masking (the
CUDA kernels).  ``--explain RLxxx`` prints each rule's full story.  The
text report ends with a count per rule and the CUDA sources read.

``tools/check_shape_torch.py`` is the runtime half of the same invariant
set (execution-shape gates on golden workloads).  Needs no GPU, no CUDA
compiler and no jax, and never imports the code it reads.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT / "src"))

DEFAULT_BASELINE = REPO_ROOT / "tools" / "lint_baseline_torch.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_lint_torch",
        description="the port's AST/CUDA determinism & execution-shape "
                    "analyzer")
    ap.add_argument("--check", nargs="+", metavar="PATH",
                    help="lint these files/directories; exit nonzero on "
                         "any live finding or baseline problem")
    ap.add_argument("--explain", metavar="RLxxx",
                    help="print the full docs for one rule and exit")
    ap.add_argument("--write-baseline", nargs="+", metavar="PATH",
                    help="lint and (re)write the baseline with every "
                         "current live finding (reasons stubbed FILLME — "
                         "an unedited baseline cannot pass --check)")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE),
                    help=f"baseline file (default {DEFAULT_BASELINE})")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--no-reachability", action="store_true",
                    help="skip the module-reachability report section")
    args = ap.parse_args(argv)

    from repro_torch.lint import (
        all_rules,
        baseline_from_findings,
        check,
        get_rule,
    )

    if args.explain:
        try:
            rule = get_rule(args.explain.upper())
        except KeyError:
            known = ", ".join(sorted(r.code for r in all_rules()))
            print(f"unknown rule {args.explain!r}; known: {known}",
                  file=sys.stderr)
            return 2
        print(rule.explain.rstrip())
        return 0

    targets = args.check or args.write_baseline
    if not targets:
        ap.error("one of --check, --explain, --write-baseline is required")

    result = check(targets, baseline=args.baseline, repo_root=REPO_ROOT)

    if args.write_baseline:
        bl = baseline_from_findings(result.findings)
        # keep still-firing existing entries (and their curated reasons)
        merged = {e.key: e for e in bl.entries}
        for f, entry in result.grandfathered:
            merged[entry.key] = entry
        bl.entries = [merged[k] for k in sorted(merged)]
        bl.save(args.baseline)
        kept = sum(1 for e in bl.entries if e.reason != "FILLME")
        print(f"wrote {args.baseline}: {len(bl.entries)} entries "
              f"({kept} with curated reasons, "
              f"{len(bl.entries) - kept} FILLME stubs to edit)")
        return 0

    if args.format == "json":
        print(json.dumps(result.to_dict(), indent=2))
        return 0 if result.ok else 1

    # ---- text report ----------------------------------------------------
    for f in result.findings:
        print(f.render())
    for f, entry in result.grandfathered:
        print(f"{f.render()}  [baseline: {entry.reason}]")
    for msg in result.baseline_problems:
        print(f"BASELINE: {msg}")
    if result.legacy:
        print(f"-- {len(result.legacy)} finding(s) in legacy-quarantined "
              "modules (non-fatal):")
        for f in result.legacy:
            print(f"   {f.render()}")
    if not args.no_reachability:
        print("-- reachability (entry roots: repro_torch.api / .serve / "
              ".obs / .lint / examples/torch / tools / chip_smoke.py / "
              "runnable __main__ modules):")
        print(f"   quarantined legacy modules: "
              f"{len(result.quarantined)}")
        for m in sorted(result.quarantined):
            print(f"     legacy      {m}")
        for m in sorted(result.test_only):
            print(f"     test-only   {m}  (parity/reference surface, "
                  "consumed by tests only)")
        for m in sorted(result.unreachable):
            print(f"     unreachable {m}  (no legacy tag — retire or wire "
                  "it up)")
    print("-- per rule (live / suppressed inline / baselined / legacy):")
    for code, c in result.counts().items():
        print(f"   {code}  {c['live']} / {c['suppressed']} / "
              f"{c['baselined']} / {c['legacy']}")
    cuda = result.cuda_files
    kernels = result.project.cuda_kernels() if result.project else []
    print(f"-- CUDA sources read: {len(cuda)} "
          f"({sum(p.endswith('.cu') for p in cuda)} .cu, "
          f"{sum(p.endswith('.cuh') for p in cuda)} .cuh), "
          f"{len(kernels)} __global__ kernels")
    n_sup = len(result.suppressed)
    n_bl = len(result.grandfathered)
    verdict = "clean" if result.ok else "FAILED"
    print(f"repro-lint-torch: {verdict} — {len(result.findings)} live "
          f"finding(s), {n_bl} baselined, {n_sup} suppressed inline, "
          f"{len(result.legacy)} legacy")
    return 0 if result.ok else 1


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. `--explain RLxxx | head`
        sys.exit(0)
