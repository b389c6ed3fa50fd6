"""Engine registry: ``(pipeline kind, engine name) -> callable``.

    @register_engine("mis2", "dense", doc="masked fixed point")
    def _dense(graph, active, options, backend=None): ...

    get_engine("mis2", "dense")(graph, None, opts, backend)

``aliases`` keep other spellings routable to an engine: the reference's
(``mis2_basic`` / ``mis2_agg`` for the aggregation methods, ``pallas*``
for the MIS-2 engines whose kernels the port carries).  Lookups resolve an
alias to its canonical name; :func:`list_engines` lists canonical names
only.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable


@dataclass(frozen=True)
class EngineSpec:
    kind: str
    name: str
    fn: Callable
    doc: str = ""
    aliases: tuple = field(default_factory=tuple)


_ENGINES: dict[tuple[str, str], EngineSpec] = {}
_ALIASES: dict[tuple[str, str], str] = {}


def register_engine(kind: str, name: str, *, aliases: tuple = (),
                    doc: str = "") -> Callable:
    """Decorator registering ``fn`` as engine ``name`` of pipeline ``kind``,
    also reachable as each of ``aliases``."""

    def deco(fn: Callable) -> Callable:
        key = (kind, name)
        if key in _ENGINES:
            raise ValueError(f"engine {key} already registered")
        _ENGINES[key] = EngineSpec(kind, name, fn, doc, tuple(aliases))
        for alias in aliases:
            _ALIASES[(kind, alias)] = name
        return fn

    return deco


def _canonical(kind: str, name: str) -> str:
    return _ALIASES.get((kind, name), name)


def get_engine(kind: str, name: str) -> Callable:
    """Resolve an engine callable; raises with the available names listed."""
    spec = _ENGINES.get((kind, _canonical(kind, name)))
    if spec is None:
        avail = ", ".join(list_engines(kind).get(kind, [])) or "none"
        raise ValueError(f"unknown {kind!r} engine {name!r} "
                         f"(available: {avail})")
    return spec.fn


def get_engine_spec(kind: str, name: str) -> EngineSpec:
    get_engine(kind, name)  # raise uniformly on unknown names
    return _ENGINES[(kind, _canonical(kind, name))]


def list_engines(kind: str | None = None) -> dict[str, list[str]]:
    """Mapping kind -> sorted engine names (optionally one kind only)."""
    out: dict[str, list[str]] = {}
    for k, n in _ENGINES:
        if kind is None or k == kind:
            out.setdefault(k, []).append(n)
    for names in out.values():
        names.sort()
    return out
