"""Engine registry: ``(pipeline kind, engine name) -> callable``."""
from __future__ import annotations

from typing import Callable

_ENGINES: dict[tuple[str, str], Callable] = {}


def register_engine(kind: str, name: str) -> Callable:
    """Decorator registering ``fn`` as engine ``name`` of pipeline ``kind``."""

    def deco(fn: Callable) -> Callable:
        if (kind, name) in _ENGINES:
            raise ValueError(f"engine {(kind, name)} already registered")
        _ENGINES[(kind, name)] = fn
        return fn

    return deco


def get_engine(kind: str, name: str) -> Callable:
    """Resolve an engine callable; raises with the available names listed."""
    fn = _ENGINES.get((kind, name))
    if fn is None:
        raise ValueError(f"unknown {kind!r} engine {name!r} "
                         f"(available: {', '.join(list_engines(kind)[kind])})")
    return fn


def list_engines(kind: str | None = None) -> dict[str, list[str]]:
    """Mapping kind -> sorted engine names (optionally one kind only)."""
    out: dict[str, list[str]] = {}
    for k, n in _ENGINES:
        if kind is None or k == kind:
            out.setdefault(k, []).append(n)
    for names in out.values():
        names.sort()
    return out
