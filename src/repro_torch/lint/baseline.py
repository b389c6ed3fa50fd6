"""Grandfathered-finding baseline for ``repro_torch.lint``.

The committed ``tools/lint_baseline_torch.json`` lists findings that predate the
analyzer and are allowed to stay — each entry carries a mandatory human
``reason``.  Two invariants keep the baseline honest:

* **Entries must still fire.**  ``--check`` fails on a *stale* entry (one
  matching no current finding): the debt it recorded was paid, so the
  entry must be deleted — baselines shrink monotonically, never rot.
* **Reasons are mandatory.**  An entry without a non-placeholder reason
  is itself an error; ``--write-baseline`` emits ``"FILLME"`` stubs
  precisely so an unedited baseline cannot pass CI.

Identity is ``(rule, path, symbol)`` — no line numbers, so findings that
merely move inside their function keep matching.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

from .findings import Finding

_PLACEHOLDER_REASONS = {"", "fillme", "todo", "tbd"}


@dataclass
class BaselineEntry:
    rule: str
    path: str
    symbol: str
    reason: str = ""
    tag: str = ""

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.symbol)

    @property
    def reason_ok(self) -> bool:
        return self.reason.strip().lower() not in _PLACEHOLDER_REASONS

    def to_dict(self) -> dict:
        d = {"rule": self.rule, "path": self.path, "symbol": self.symbol,
             "reason": self.reason}
        if self.tag:
            d["tag"] = self.tag
        return d


@dataclass
class Baseline:
    entries: List[BaselineEntry] = field(default_factory=list)

    @classmethod
    def load(cls, path) -> "Baseline":
        path = Path(path)
        if not path.exists():
            return cls()
        data = json.loads(path.read_text())
        entries = [BaselineEntry(rule=e["rule"], path=e["path"],
                                 symbol=e.get("symbol", "<module>"),
                                 reason=e.get("reason", ""),
                                 tag=e.get("tag", ""))
                   for e in data.get("entries", [])]
        return cls(entries=entries)

    def save(self, path) -> None:
        payload = {"entries": [e.to_dict() for e in
                               sorted(self.entries, key=lambda e: e.key)]}
        Path(path).write_text(json.dumps(payload, indent=2) + "\n")

    def apply(self, findings: List[Finding]):
        """Split findings into (live, baselined) and report baseline
        problems: stale entries and entries without a real reason."""
        index: Dict[Tuple[str, str, str], BaselineEntry] = {
            e.key: e for e in self.entries}
        hit = set()
        live, grandfathered = [], []
        for f in findings:
            entry = index.get(f.key)
            if entry is not None:
                hit.add(entry.key)
                grandfathered.append((f, entry))
            else:
                live.append(f)
        problems = []
        for e in self.entries:
            if e.key not in hit:
                problems.append(
                    f"stale baseline entry {e.rule} {e.path} [{e.symbol}]: "
                    "no current finding matches — the debt was paid, delete "
                    "the entry (baselines shrink monotonically)")
            elif not e.reason_ok:
                problems.append(
                    f"baseline entry {e.rule} {e.path} [{e.symbol}] has no "
                    "reason — every grandfathered finding needs one")
        return live, grandfathered, problems


def baseline_from_findings(findings: List[Finding]) -> Baseline:
    entries: Dict[Tuple[str, str, str], BaselineEntry] = {}
    for f in findings:
        entries.setdefault(f.key, BaselineEntry(
            rule=f.rule, path=f.path, symbol=f.symbol, reason="FILLME",
            tag=f.tag))
    return Baseline(entries=list(entries.values()))
