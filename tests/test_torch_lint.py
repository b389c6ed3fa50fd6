"""``repro_torch.lint``, the port's static analyzer: per-rule positive,
negative and suppressed cases (RL106 on CUDA sources), parity with the
reference's ``repro.lint`` on its RL102–RL105 fixtures and on the port's
own Python files, the baseline and quarantine semantics, the whole tree
(every Python and CUDA source, the 14 ``__global__`` kernels), the RL102
repair of ``core/dist.py`` and the CLI."""
from __future__ import annotations

import dataclasses
import inspect
import json
import re
import textwrap
from pathlib import Path

import pytest

import repro.lint as ref_lint
from repro_torch.lint import (
    Baseline,
    BaselineEntry,
    check,
    lint_paths,
)
from repro_torch.lint.findings import parse_c_pragmas, parse_suppressions

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch"
CSRC = SRC / "kernels" / "csrc"
BASELINE = ROOT / "tools" / "lint_baseline_torch.json"

#: the 14 ``__global__`` kernels of the CUDA sources, by file
KERNELS = {
    "hash_pack.cu": {"hash_pack_kernel"},
    "joins.cu": {"root_join_kernel", "phase2_join_kernel",
                 "phase3_fixed_point_kernel"},
    "luby.cu": {"luby_fixed_point_kernel"},
    "minprop_ell.cu": {"refreshed_tuples_kernel", "refresh_group_kernel",
                       "decide_group_kernel", "resident_fixed_point_kernel",
                       "hybrid_fixed_point_kernel"},
    "misk.cu": {"misk_fixed_point_kernel"},
    "run_sums.cu": {"run_sums_kernel"},
    "spmv_ell.cu": {"spmv_ell_kernel", "spmv_ell_t_kernel"},
}


def run_lint(tmp_path, source, name="mod.py"):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source))
    return lint_paths([p], repo_root=tmp_path, roots=[])


def of_rule(findings, rule):
    return [f for f in findings if f.rule == rule]


def live(findings):
    return [f for f in findings if not f.suppressed]


@pytest.fixture(scope="module")
def tree():
    """``check`` over the whole package, once."""
    return check([SRC], baseline=BASELINE, repo_root=ROOT)


def _port_copy(tmp_path, rel: str, text: str) -> Path:
    """``text`` written as ``src/repro_torch/<rel>`` under ``tmp_path``, so
    its module name and relative imports resolve as in the package."""
    p = tmp_path / "src" / "repro_torch" / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(text)
    return p


# ---------------------------------------------------------------------------
# RL101 trace-purity: host reads in loops that launch a kernel every round
# ---------------------------------------------------------------------------

_LAUNCHING_LOOP = """\
import torch
from repro_torch.kernels.minprop_ell import ops


def solve(t, m, nbrs, wl, count, it, max_iters):
    live = torch.ones(4, dtype=torch.bool)
    n = 0
    while n < max_iters:
        {read}
        ops.fused_refresh_columns(t, m, nbrs, wl, count, it,
                                  priority="fixed", b=3)
        live = live & (t > 0)
        n += 1
    return t
"""


@pytest.mark.parametrize("read", [
    "if not bool(live.any()):\n            break",
    "if live.sum().item() == 0:\n            break",
    "torch.cuda.synchronize()",
    "print(live.cpu())",
], ids=["bool", "item", "synchronize", "cpu"])
def test_rl101_positive_host_read_in_launching_loop(tmp_path, read):
    findings = run_lint(tmp_path, _LAUNCHING_LOOP.format(read=read))
    rl101 = of_rule(findings, "RL101")
    assert len(rl101) == 1 and rl101[0].symbol == "solve"
    assert rl101[0].line == 9 and not rl101[0].suppressed


def test_rl101_positive_through_the_call_graph(tmp_path):
    """The loop calls a helper that calls the wrapper: still a launching
    loop (the host-driven round of ``cuda_compacted``)."""
    findings = run_lint(tmp_path, """\
        import torch
        from repro_torch.kernels.spmv_ell import ops


        def _round(a, x):
            return ops.spmv(a.cols, a.vals, x)


        def sweep(a, x, sweeps):
            for _ in range(sweeps):
                x = _round(a, x)
                done = torch.isfinite(x).all()
                if bool(done):
                    break
            return x
        """)
    assert [f.line for f in of_rule(findings, "RL101")] == [13]


def test_rl101_negative_loop_without_launch(tmp_path):
    findings = run_lint(tmp_path, """\
        import torch


        def host_loop(x):
            while True:
                x = x * 2
                if bool((x > 100).any()):
                    return x
        """)
    assert not of_rule(findings, "RL101")


def test_rl101_negative_read_after_the_loop_and_data_loops(tmp_path):
    """One read after the loop, a `for` over data (one result pull per
    bucket), and reads of host values inside the loop are all fine."""
    findings = run_lint(tmp_path, """\
        import torch
        from repro_torch.kernels.minprop_ell import ops


        def solve(t, buckets, max_iters):
            it = 0
            while it < max_iters:
                ops.resident_fixed_point(t, t, t, t, priority="fixed", b=3,
                                         max_iters=1)
                if it > 3 and t.shape[0] > 2:
                    break
                it += 1
            flag = torch.zeros(1)
            out = [ops.resident_fixed_point(b, b, b, b, priority="fixed",
                                            b=3, max_iters=1).cpu()
                   for b in buckets]
            for b in buckets:
                out.append(ops.resident_fixed_point(
                    b, b, b, b, priority="fixed", b=3, max_iters=1).cpu())
            return int(flag.item()), out
        """)
    assert not of_rule(findings, "RL101")


def test_rl101_suppressed_with_reason(tmp_path):
    read = ("# repro-lint: ignore[RL101] mis2.host_syncs counts it\n"
            "        if not bool(live.any()):\n            break")
    findings = run_lint(tmp_path, _LAUNCHING_LOOP.format(read=read))
    rl101 = of_rule(findings, "RL101")
    assert rl101 and all(f.suppressed for f in rl101)
    assert rl101[0].suppressed_by.reason == "mis2.host_syncs counts it"


def test_rl101_cpu_twins_out_of_scope(tmp_path):
    text = _LAUNCHING_LOOP.format(
        read="if not bool(live.any()):\n            break")
    p = _port_copy(tmp_path, "kernels/minprop_ell/ref.py", text)
    findings = lint_paths([p], repo_root=tmp_path, roots=[])
    assert not of_rule(findings, "RL101")


def test_rl101_fires_on_a_read_put_back_into_the_distributed_loop(tmp_path):
    """A per-round ``bool(live.any())`` put back into a copy of the
    distributed engines' launching loop fires; the committed loop's one
    read stays suppressed."""
    real = (SRC / "core" / "dist.py").read_text()
    anchor = "        comm.all_gather(t_full, t_local, \"tuples\")\n"
    assert real.count(anchor) == 1
    bugged = real.replace(anchor, anchor + (
        "        live = t_local == 1\n"
        "        if not bool(live.any()):\n"
        "            break\n"))
    p = _port_copy(tmp_path, "core/dist.py", bugged)
    findings = of_rule(lint_paths([p], repo_root=tmp_path, roots=[]),
                       "RL101")
    line = bugged[:bugged.index("if not bool(live.any())")].count("\n") + 1
    assert [f.line for f in live(findings)] == [line]
    assert all(f.symbol == "_fixed_point" for f in findings)
    assert len([f for f in findings if f.suppressed]) == 1


def test_rl101_committed_reads_are_suppressed_with_counter_names(tree):
    sup = of_rule(tree.suppressed, "RL101")
    assert {(f.path.rsplit("/", 1)[-1], f.symbol) for f in sup} == {
        ("dist.py", "_fixed_point"),
        ("mis2.py", "_mis2_compacted_impl"),
        ("mis2.py", "_mis2_resident_plain_impl"),
        ("streaming.py", "StreamSession._apply_delta_impl")}
    for f in sup:
        assert re.search(r"\b(mis2\.host_syncs|serve\.repair\.\w+)\b",
                         f.suppressed_by.reason), f.render()
        assert "reference" in f.suppressed_by.reason


# ---------------------------------------------------------------------------
# RL102 priority-provenance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source, token", [
    ("def w(sh):\n    v = sh.num_padded\n    return id_bits(v)\n",
     "sh.num_padded"),
    ("def w(arr, vp, dev):\n    lab = _pad_labels(arr, vp, -1, dev)\n"
     "    return id_bits(lab.shape[0])\n", "_pad_labels()"),
    ("def w(g):\n    rows, width = bucket_shape(g)\n"
     "    return id_bits(rows)\n", "bucket_shape()"),
    ("def w(b):\n    n = b.flat_neighbors.shape[0]\n"
     "    return id_bits(n)\n", "b.flat_neighbors"),
], ids=["num_padded", "pad_labels", "bucket_shape", "flat_neighbors"])
def test_rl102_positive_port_padding(tmp_path, source, token):
    findings = run_lint(tmp_path, "from repro_torch.core.tuples import "
                        "id_bits\n\n\n" + source)
    rl102 = of_rule(findings, "RL102")
    assert len(rl102) == 1 and token in rl102[0].message


def test_rl102_negative_real_count(tmp_path):
    findings = run_lint(tmp_path, """\
        from repro_torch.core.tuples import id_bits


        def w(graph, sh):
            v = graph.num_vertices
            return id_bits(v), sh.num_padded
        """)
    assert not of_rule(findings, "RL102")


def test_rl102_suppressed(tmp_path):
    findings = run_lint(tmp_path, """\
        from repro_torch.core.tuples import id_bits


        def w(sh):
            return id_bits(sh.num_padded)  # repro-lint: ignore[RL102] test width
        """)
    rl102 = of_rule(findings, "RL102")
    assert rl102 and all(f.suppressed for f in rl102)


def _dist_text() -> str:
    real = (SRC / "core" / "dist.py").read_text()
    assert real.count("id_bits(v), options.priority") == 1
    return real


def test_rl102_fires_on_padded_id_bits_in_dist(tmp_path):
    bugged = _dist_text().replace("id_bits(v), options.priority",
                                  "id_bits(vp), options.priority")
    p = _port_copy(tmp_path, "core/dist.py", bugged)
    rl102 = of_rule(lint_paths([p], repo_root=tmp_path, roots=[]), "RL102")
    assert [f.symbol for f in rl102] == ["_mis2_distributed_impl"]
    assert "sh.num_padded" in rl102[0].message


def test_rl102_clean_on_committed_dist(tmp_path):
    p = _port_copy(tmp_path, "core/dist.py", _dist_text())
    assert not of_rule(lint_paths([p], repo_root=tmp_path, roots=[]),
                       "RL102")


def test_dist_takes_v_from_the_graph():
    """The repair: v is the graph's, and a ``padded`` of another graph is
    refused; a matching one gives the same result as no ``padded``."""
    import repro_torch as rt
    from repro_torch.core import dist as core_dist

    g = rt.Graph(rt.graphs.laplace3d(4), device="cpu")
    other = rt.Graph(rt.graphs.laplace3d(3), device="cpu")
    with pytest.raises(ValueError, match="vertices"):
        core_dist._mis2_distributed_impl(
            g, padded=core_dist.prepare_padded(other))
    a = core_dist._mis2_distributed_impl(g)
    b = core_dist._mis2_distributed_impl(
        g, padded=core_dist.prepare_padded(g))
    assert (a.in_set == b.in_set).all() and a.iterations == b.iterations


# ---------------------------------------------------------------------------
# RL103 timing, RL104 obs-hygiene, RL105 options-aliasing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule, positive, negative, suppressed", [
    ("RL103",
     "import time\n\ndef f():\n    return time.time()\n",
     "import time\n\ndef f():\n    return time.perf_counter()\n",
     "import time\n\n_NOW = time.time  # repro-lint: ignore[RL103] epoch\n"),
    ("RL104",
     "from repro_torch.obs import metrics\n\ndef f(d):\n"
     "    metrics.gauge('serve.x', labels={'g': d.hexdigest()}).set(1)\n",
     "from repro_torch.obs import metrics\n\ndef f():\n"
     "    metrics.counter('mis2.host_syncs').inc()\n",
     "from repro_torch.obs import metrics\n\ndef f():\n"
     "    metrics.counter('Bad')  # repro-lint: ignore[RL104] test name\n"),
    ("RL105",
     "class O:\n    pass\n\ndef f(o=O()):\n    return o\n",
     "class O:\n    pass\n\ndef f(o=None):\n    return O() if o is None else o\n",
     "def f(o=[]):  # repro-lint: ignore[RL105] read-only sentinel\n"
     "    return o\n"),
], ids=["RL103", "RL104", "RL105"])
def test_rules_positive_negative_suppressed(tmp_path, rule, positive,
                                            negative, suppressed):
    pos = of_rule(run_lint(tmp_path, positive, "pos.py"), rule)
    neg = of_rule(run_lint(tmp_path, negative, "neg.py"), rule)
    sup = of_rule(run_lint(tmp_path, suppressed, "sup.py"), rule)
    assert pos and not any(f.suppressed for f in pos)
    assert not neg
    assert sup and all(f.suppressed for f in sup)


def test_rl104_has_no_legacy_view_check(tmp_path):
    """The port defines no HOTLOOP_STATS / SETUP_STATS views, so the
    reference's third sub-check is left out."""
    findings = run_lint(tmp_path, """\
        from repro_torch.core.mis2 import HOTLOOP_STATS

        def record(n):
            HOTLOOP_STATS.host_syncs += n
        """)
    assert not of_rule(findings, "RL104")
    assert not re.search(r"\b(HOTLOOP_STATS|SETUP_STATS)\s*=",
                         "\n".join(p.read_text()
                                   for p in SRC.rglob("*.py")
                                   if "lint" not in p.parts))


def test_facade_calls_do_not_alias_options():
    """Two facade invocations never share one options object: every
    public facade and batched entry uses the None sentinel (or an
    immutable default), and the options themselves are frozen."""
    from repro_torch.api import facade
    from repro_torch.core.mis2 import Mis2Options

    for name, fn in inspect.getmembers(facade, inspect.isfunction):
        if name.startswith("_") or fn.__module__ != facade.__name__:
            continue
        for p in inspect.signature(fn).parameters.values():
            if p.default is inspect.Parameter.empty or p.default is None:
                continue
            assert isinstance(
                p.default, (int, float, str, bool, bytes, tuple, frozenset)
            ), (f"{name}({p.name}=...) has a shared mutable default "
                f"{p.default!r} — the options-aliasing bug class")
    with pytest.raises(dataclasses.FrozenInstanceError):
        Mis2Options().worklists = False


# ---------------------------------------------------------------------------
# RL106 kernel-masking, on CUDA sources
# ---------------------------------------------------------------------------

_UNGUARDED = """\
#include <cstdint>
__global__ void k(const float* x, float* y, int64_t n) {
  int64_t i = blockIdx.x * blockDim.x + threadIdx.x;
  y[i] = x[i];
}
"""

_GUARDED = {
    "if": """\
__global__ void k(const float* x, float* y, int64_t n) {
  int64_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i];
}
""",
    "grid_stride": """\
__global__ void k(const float* x, float* y, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
       threadIdx.x; i < n; i += stride) {
    y[i] = x[i];
  }
}
""",
    "device_helper": """\
__device__ __forceinline__ int64_t global_tid() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}
template <typename T>
__device__ __forceinline__ void copy_body(const T* x, T* y, int64_t n) {
  const int64_t i = global_tid();
  if (i >= n) return;
  y[i] = x[i];
}
template <typename T>
__global__ void k(const T* x, T* y, int64_t n) {
  copy_body<T>(x, y, n);
}
""",
    "ternary": """\
__global__ void k(const float* x, float* y, int64_t n) {
  const int64_t i = blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t j = i < n ? i : n - 1;
  y[j] = x[j];
}
""",
    "persistent_struct": """\
struct Resident { int32_t* heavy; int64_t h; };
__device__ __forceinline__ int64_t global_stride() {
  return static_cast<int64_t>(gridDim.x) * blockDim.x;
}
__global__ void k(const __grid_constant__ Resident r) {
  cg::grid_group grid = cg::this_grid();
  for (int64_t h = grid.thread_rank(); h < r.h; h += global_stride()) {
    r.heavy[h] = -1;
  }
}
""",
}


def _lint_cu(tmp_path, text, name="k.cu"):
    p = tmp_path / name
    p.write_text(text)
    return of_rule(lint_paths([p], repo_root=tmp_path, roots=[]), "RL106")


def test_rl106_positive_unguarded_kernel(tmp_path):
    rl106 = _lint_cu(tmp_path, _UNGUARDED)
    assert [(f.line, f.symbol) for f in rl106] == [(2, "k")]
    assert not rl106[0].suppressed


def test_rl106_positive_unguarded_struct_member(tmp_path):
    rl106 = _lint_cu(tmp_path, """\
struct Resident { int32_t* heavy; };
__global__ void k(const __grid_constant__ Resident r) {
  const int64_t h = blockIdx.x * 256 + threadIdx.x;
  r.heavy[h] = -1;
}
""")
    assert [f.symbol for f in rl106] == ["k"]


@pytest.mark.parametrize("kind", sorted(_GUARDED))
def test_rl106_negative_guarded(tmp_path, kind):
    assert not _lint_cu(tmp_path, _GUARDED[kind])


def test_rl106_negative_guard_in_an_included_header(tmp_path):
    (tmp_path / "body.cuh").write_text(_GUARDED["device_helper"].split(
        "template <typename T>\n__global__")[0])
    kernel = ('#include "body.cuh"\n'
              "__global__ void k(const float* x, float* y, int64_t n) {\n"
              "  copy_body<float>(x, y, n);\n}\n")
    assert not _lint_cu(tmp_path, kernel)
    (tmp_path / "body.cuh").write_text(
        "template <typename T>\n"
        "__device__ void copy_body(const T* x, T* y, int64_t n) {\n"
        "  const int64_t i = blockIdx.x * blockDim.x + threadIdx.x;\n"
        "  y[i] = x[i];\n}\n")
    assert [f.symbol for f in _lint_cu(tmp_path, kernel)] == ["k"]


def test_rl106_negative_no_memory(tmp_path):
    assert not _lint_cu(tmp_path, """\
__global__ void k(int64_t n) {
  const int64_t i = threadIdx.x;
  (void)i;
}
""")


def test_rl106_suppressed_by_reasoned_pragma(tmp_path):
    text = ("// repro-lint: ignore[RL106] a single thread; no tail lane\n"
            + _UNGUARDED.split("\n", 1)[1])
    rl106 = _lint_cu(tmp_path, text)
    assert rl106 and all(f.suppressed for f in rl106)
    trailing = _UNGUARDED.replace(
        "int64_t n) {", "int64_t n) {  // repro-lint: ignore[RL106] one lane")
    assert all(f.suppressed for f in _lint_cu(tmp_path, trailing))


def test_rl106_pragma_without_reason_or_in_a_string_does_not_count(tmp_path):
    bare = "// repro-lint: ignore[RL106]\n" + _UNGUARDED.split("\n", 1)[1]
    rl106 = _lint_cu(tmp_path, bare)
    assert rl106 and not rl106[0].suppressed
    assert "reason is mandatory" in rl106[0].message
    quoted = ('const char* s = "// repro-lint: ignore[RL106] no";\n'
              + _UNGUARDED.split("\n", 1)[1])
    assert not any(f.suppressed for f in _lint_cu(tmp_path, quoted))


def test_c_pragmas_and_blanking():
    text = ('int a; // repro-lint: ignore[RL106] trailing\n'
            '  // repro-lint: ignore[RL101,RL106] standalone\n'
            'const char* s = "/* not a comment */";\n'
            '/* block\n   comment */ int b;\n')
    code, sups, legacy = parse_c_pragmas(text)
    assert sups[1].codes == ("RL106",) and sups[1].reason == "trailing"
    assert sups[3].codes == ("RL101", "RL106")       # the guarded line
    assert "not a comment" not in code and "block" not in code
    assert code.count("\n") == text.count("\n") and "int b;" in code
    assert legacy is None
    assert parse_c_pragmas("// repro-lint: legacy retired\n")[2] == "retired"


def test_python_pragmas_indented_standalone_and_strings():
    sups = parse_suppressions(
        "def f():\n"
        "    # repro-lint: ignore[RL101] standalone reason\n"
        "    x = 1\n"
        's = "# repro-lint: ignore[RL103] not a comment"\n')
    assert sups[3].codes == ("RL101",) and sups[3].reason == \
        "standalone reason"
    assert 4 not in sups


# ---------------------------------------------------------------------------
# parity with the reference analyzer
# ---------------------------------------------------------------------------

#: the reference's RL102–RL105 fixtures (tests/test_lint.py)
_REF_FIXTURES = {
    "rl102_padded_name": """\
        from repro.core.tuples import id_bits

        def pack_width(padded_graph):
            vp_total = padded_graph.num_vertices
            return id_bits(vp_total)
        """,
    "rl102_bucketing_call": """\
        from repro.core.tuples import id_bits

        def _bucket(n):
            return 1 << (n - 1).bit_length()

        def pack_width(n):
            size = _bucket(n)
            return id_bits(size)
        """,
    "rl102_real_count": """\
        from repro.core.tuples import id_bits

        def pack_width(num_vertices):
            return id_bits(num_vertices)
        """,
    "rl103_positive": """\
        import time

        def bench():
            t0 = time.time()
            return time.time() - t0
        """,
    "rl103_perf_counter": """\
        import time

        def bench():
            t0 = time.perf_counter()
            return time.perf_counter() - t0
        """,
    "rl103_suppressed": """\
        import time

        _EPOCH_NOW = time.time  # repro-lint: ignore[RL103] epoch stamp, not a duration
        """,
    "rl103_no_reason": """\
        import time

        _EPOCH_NOW = time.time  # repro-lint: ignore[RL103]
        """,
    "rl104_bad_name_and_legacy_write": """\
        from repro.obs import metrics
        from repro.core.mis2 import HOTLOOP_STATS

        def record(n):
            metrics.counter("BadName").inc()
            HOTLOOP_STATS.host_syncs += n
        """,
    "rl104_fstring_name_and_digest_label": """\
        from repro.obs import metrics

        def record(name, digest):
            metrics.counter(f"{name}.calls").inc()
            metrics.gauge("serve.cache.entries",
                          labels={"graph": digest}).set(1)
        """,
    "rl104_scheme_names": """\
        from repro.obs import metrics

        def record(name):
            metrics.counter("mis2.host_syncs").inc(2)
            metrics.counter(f"serve.cache.{name}").inc()
            metrics.histogram("serve.batch.size_vertices").observe(4)
        """,
    "rl105_call_default": """\
        class Options:
            pass

        def solve(graph, options=Options(), sizes=[]):
            return graph, options, sizes
        """,
    "rl105_none_sentinel": """\
        class Options:
            pass

        def solve(graph, options=None):
            options = Options() if options is None else options
            return graph, options
        """,
}

_PARITY_RULES = {"RL102", "RL103", "RL104", "RL105"}


def _keyed(findings):
    # the port leaves out RL104's legacy-view sub-check (see RL104's
    # explain); the reference's findings of it are dropped here
    return sorted((f.rule, f.line, f.symbol, f.suppressed) for f in findings
                  if f.rule in _PARITY_RULES
                  and "legacy stats view" not in f.message)


@pytest.mark.parametrize("name", [*_REF_FIXTURES, "rl102_reference_dist"])
def test_parity_with_reference_on_its_fixtures(tmp_path, name):
    if name == "rl102_reference_dist":
        real = (ROOT / "src" / "repro" / "core" / "dist.py").read_text()
        text = real.replace("id_bits(num_vertices)", "id_bits(vp_total)")
        assert text != real
    else:
        text = textwrap.dedent(_REF_FIXTURES[name])
    p = tmp_path / "mod.py"
    p.write_text(text)
    ref = ref_lint.lint_paths([p], repo_root=tmp_path, roots=[])
    port = lint_paths([p], repo_root=tmp_path, roots=[])
    assert _keyed(port) == _keyed(ref)
    if name.endswith(("positive", "padded_name", "bucketing_call",
                      "call_default", "reference_dist")):
        assert _keyed(port), "a positive fixture must fire"


def test_parity_on_the_port_sources(tree):
    """After the dist.py repair both analyzers find the port's Python
    files clean."""
    ref = ref_lint.check([SRC], repo_root=ROOT)
    assert ref.ok, [f.render() for f in ref.findings]
    assert tree.ok, [f.render() for f in tree.findings]


# ---------------------------------------------------------------------------
# baseline, quarantine, the whole tree, the CLI
# ---------------------------------------------------------------------------

def _one_rl103(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text("import time\nt0 = time.time()\n")
    return p


@pytest.mark.parametrize("kind", ["grandfathered", "stale", "placeholder"])
def test_baseline_semantics(tmp_path, kind):
    p = _one_rl103(tmp_path)
    if kind == "stale":
        p.write_text("import time\nt0 = time.perf_counter()\n")
    reason = "FILLME" if kind == "placeholder" else "a reasoned entry"
    bl = Baseline(entries=[BaselineEntry(
        rule="RL103", path="mod.py", symbol="<module>", reason=reason)])
    result = check([p], baseline=bl, repo_root=tmp_path, roots=[])
    if kind == "grandfathered":
        assert result.ok and len(result.grandfathered) == 1
    else:
        assert not result.ok
        word = "stale" if kind == "stale" else "reason"
        assert any(word in m for m in result.baseline_problems)


def test_committed_baseline_is_empty():
    assert json.loads(BASELINE.read_text()) == {"entries": []}


def test_rl001_fires_when_quarantine_violated(tmp_path):
    src = tmp_path / "src" / "repro_torch"
    src.mkdir(parents=True)
    (src / "__init__.py").write_text("")
    (src / "api.py").write_text("from repro_torch.old import f\n")
    (src / "old.py").write_text(
        "# repro-lint: legacy retired\nimport time\nt0 = time.time()\n"
        "def f():\n    return 1\n")
    result = check([src], repo_root=tmp_path, roots=[])
    assert [f.rule for f in result.findings] == ["RL001"]
    assert any(f.rule == "RL103" for f in result.legacy)
    assert not result.ok
    (src / "api.py").write_text("")
    assert check([src], repo_root=tmp_path, roots=[]).ok


def test_whole_tree_is_clean_and_reads_every_source(tree):
    from repro_torch.kernels import _build

    assert tree.ok, [f.render() for f in tree.findings] + \
        tree.baseline_problems
    cuda = {Path(p).name for p in tree.cuda_files}
    assert cuda == {p.name for p in CSRC.glob("*.cu*")}
    assert {f"{n}.cu" for n in _build.sources()} <= cuda
    assert len([c for c in cuda if c.endswith(".cu")]) == 7
    assert len([c for c in cuda if c.endswith(".cuh")]) == 4
    py = {f.relpath for f in tree.project.files if not f.is_root}
    assert py == {p.relative_to(ROOT).as_posix() for p in SRC.rglob("*.py")}
    seen: dict = {}
    for path, _line, name in tree.project.cuda_kernels():
        seen.setdefault(Path(path).name, set()).add(name)
    assert seen == KERNELS
    assert sum(map(len, seen.values())) == 14
    assert not of_rule(tree.suppressed, "RL106")


def test_cli_check_explain_json(tmp_path, capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "repro_lint_torch", ROOT / "tools" / "repro_lint_torch.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)

    assert cli.main(["--explain", "RL106"]) == 0
    assert "kernel-masking" in capsys.readouterr().out
    assert cli.main(["--explain", "RL999"]) == 2
    bad = tmp_path / "k.cu"
    bad.write_text(_UNGUARDED)
    capsys.readouterr()
    assert cli.main(["--check", str(bad), "--no-reachability"]) == 1
    out = capsys.readouterr().out
    assert "RL106  1 / 0 / 0 / 0" in out and "FAILED" in out
    assert cli.main(["--check", str(bad), "--format", "json"]) == 1
    data = json.loads(capsys.readouterr().out)
    assert data["counts"]["RL106"]["live"] == 1
    assert data["cuda_files"][0].endswith("k.cu")
