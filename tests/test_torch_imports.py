"""Import hygiene of the port: it never pulls in jax or the JAX package, and
its entry points never fall back to the CPU on their own."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch as rt

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch.py",
    ROOT / "tools" / "bench_spmv.py", ROOT / "tools" / "bench_minprop.py",
    ROOT / "tools" / "bench_hash_pack.py",
    ROOT / "tools" / "bench_serve_route.py",
    ROOT / "tools" / "repro_lint_torch.py",
    ROOT / "tests" / "test_torch_cuda.py"]
EXAMPLES = sorted((ROOT / "examples" / "torch").glob("*.py"))
PORT_FILES += EXAMPLES
FORBIDDEN = {"jax", "jaxlib", "repro"}


def test_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch, repro_torch.kernels.minprop_ell.ops,"
            "repro_torch.kernels.spmv_ell.ops,"
            "repro_torch.kernels.hash_priority.ops,"
            "repro_torch.kernels.run_sums.ops,"
            "repro_torch.kernels.joins.ops, repro_torch.solvers,"
            "repro_torch.multilevel, repro_torch.graphs.ops,"
            "repro_torch.graphs.hybrid, repro_torch.core.mis2_hybrid,"
            "repro_torch.core.mis2, repro_torch.core.misk,"
            "repro_torch.core.partition, repro_torch.api.backend,"
            "repro_torch.batch, repro_torch.batch.pipeline, repro_torch.obs,"
            "repro_torch.core.dist, repro_torch.serve,"
            "repro_torch.lint, repro_torch.lint.engine,"
            "repro_torch.lint.rules.rl101_trace_purity,"
            "repro_torch.lint.rules.rl102_priority_provenance,"
            "repro_torch.lint.rules.rl103_timing,"
            "repro_torch.lint.rules.rl104_obs_hygiene,"
            "repro_torch.lint.rules.rl105_options_aliasing,"
            "repro_torch.lint.rules.rl106_kernel_masking;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'));"
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", EXAMPLES,
                         ids=[p.stem for p in EXAMPLES])
def test_example_import_leaves_jax_and_reference_unloaded(path):
    code = ("import importlib.util, sys;"
            f"spec = importlib.util.spec_from_file_location('ex', {str(path)!r});"
            "m = importlib.util.module_from_spec(spec);"
            "spec.loader.exec_module(m);"
            "assert callable(m.main);"
            "bad = sorted(x for x in sys.modules if x.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'));"
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_four_examples_ported():
    assert [p.stem for p in EXAMPLES] == ["amg_solve", "cluster_gs_precond",
                                          "partition_demo", "quickstart"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_import_names_jax_or_reference(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = rt.Graph(rt.graphs.laplace3d(3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.mis2(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.coarsen(g)
    for entry in (rt.color, rt.amg_setup, rt.amg, rt.cluster_gs_setup,
                  rt.misk):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.partition(g, 2)
    assert "csr_to_ell" not in g.conversions
