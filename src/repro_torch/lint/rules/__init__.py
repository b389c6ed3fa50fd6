"""Rule registry for ``repro_torch.lint``.

Every rule is a class with a ``code`` (``RLxxx``), a one-line ``name``, a
long-form ``explain`` (shown by ``tools/repro_lint_torch.py --explain
RLxxx``, including the bug class the rule exists to prevent in the port),
and a ``check_file(src, project) -> list[Finding]`` method; a rule that
reads the CUDA sources sets ``cuda = True`` and implements
``check_cuda(src, project)``.  Registration is by decorator;
:func:`all_rules` returns one instance of each, sorted by code.
"""
from __future__ import annotations

from typing import Dict, List

RULES: Dict[str, type] = {}


def register(cls: type) -> type:
    if not getattr(cls, "code", None):  # pragma: no cover
        raise ValueError(f"rule {cls.__name__} has no code")
    RULES[cls.code] = cls
    return cls


class Rule:
    code: str = ""
    name: str = ""
    explain: str = ""
    cuda: bool = False          # True: also given every CUDA target

    def check_file(self, src, project) -> list:  # pragma: no cover
        raise NotImplementedError

    def check_cuda(self, src, project) -> list:  # pragma: no cover
        return []


def all_rules() -> List[Rule]:
    # importing the rule modules populates the registry
    from . import (  # noqa: F401
        rl101_trace_purity,
        rl102_priority_provenance,
        rl103_timing,
        rl104_obs_hygiene,
        rl105_options_aliasing,
        rl106_kernel_masking,
    )
    return [RULES[code]() for code in sorted(RULES)]


def get_rule(code: str) -> Rule:
    all_rules()
    if code not in RULES:
        raise KeyError(code)
    return RULES[code]()
