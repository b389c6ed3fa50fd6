"""``repro_torch.api`` — the public surface of the port."""
from . import engines as _engines  # noqa: F401  (registers built-in engines)
from .backend import DEFAULT_MIS2_ENGINE, Backend
from .facade import coarsen, mis2
from .registry import get_engine, list_engines, register_engine
from .result import AggregationResult, Mis2Result, Result, determinism_digest

__all__ = [
    "mis2", "coarsen", "Backend", "DEFAULT_MIS2_ENGINE", "get_engine",
    "list_engines", "register_engine", "AggregationResult", "Mis2Result",
    "Result", "determinism_digest",
]
