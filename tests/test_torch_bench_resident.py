"""The timing tool of the persistent kernels (``tools/bench_resident.py``)
and the bounds ``chip_smoke.py`` holds them to, on the CPU: the tool's
argument handling and source resolution (no build, no card), and the
least bytes of a resident solve and of phase 3 beside the earlier designs'
count, pinned on laplace3d(8) from the twins' traces."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import bench_minprop  # noqa: E402
import bench_resident  # noqa: E402
import chip_smoke  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.core.tuples import id_bits  # noqa: E402
from repro_torch.kernels.joins import ops as join_ops  # noqa: E402
from repro_torch.kernels.joins import ref as join_ref  # noqa: E402
from repro_torch.kernels.minprop_ell import ref  # noqa: E402


@pytest.mark.parametrize("argv,caps", [
    ([], None),
    (["--caps"], []),
    (["--caps", "3", "1", "3"], [3, 1, 3]),
    (["--kernels", "phase3", "--caps", "0"], [0]),
    (["--kernels", "phase3", "--caps"], []),
])
def test_caps_argument(argv, caps):
    assert bench_resident.parse_args(argv).caps == caps


@pytest.mark.parametrize("argv", [
    ["--caps", "-1"],
    ["--kernels", "hybrid", "luby", "--caps"],
    ["--kernels", "joins", "--caps"],
    ["--kernels", "nope"],
])
def test_bad_arguments_exit(argv):
    with pytest.raises(SystemExit):
        bench_resident.parse_args(argv)


@pytest.mark.parametrize("caps,rounds,most,want", [
    ([], 10, None, list(range(12))),
    ([], 1, 4, [0, 1, 2]),
    ([], 7, 4, [0, 1, 2, 3, 4]),
    ([5, 0, 5, 2], 9, None, [0, 2, 5]),
])
def test_cap_list(caps, rounds, most, want):
    assert bench_resident.cap_list(caps, rounds, most) == want


def _tree(root: Path, nested: bool) -> Path:
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc" if nested \
        else root
    csrc.mkdir(parents=True, exist_ok=True)
    for name in ("minprop_ell.cu", "joins.cu", "luby.cu"):
        (csrc / name).write_text(f"// {name} of a baseline\n")
    return csrc


@pytest.mark.parametrize("nested", [True, False])
def test_baseline_resolves_a_tree_or_its_csrc(tmp_path, nested):
    csrc = _tree(tmp_path / "parent", nested)
    assert bench_resident.baseline_csrc(tmp_path / "parent") == csrc


def test_baseline_without_sources_exits(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="minprop_ell.cu"):
        bench_resident.baseline_csrc(tmp_path / "empty")


def test_sources_with_a_baseline(tmp_path, monkeypatch):
    monkeypatch.setattr(bench_minprop, "OUT", tmp_path / "out")
    (tmp_path / "out").mkdir()
    csrc = _tree(tmp_path / "parent", True)
    got = bench_resident.default_sources(["resident", "joins"],
                                         tmp_path / "parent")
    assert set(got) == {"minprop_ell:default", "joins:default",
                        "minprop_ell:baseline", "joins:baseline"}
    assert got["minprop_ell:default"] == ("minprop_ell", bench_minprop.SRC)
    assert got["minprop_ell:baseline"] == ("minprop_ell",
                                           csrc / "minprop_ell.cu")
    assert got["joins:baseline"] == ("joins", csrc / "joins.cu")
    # the default joins source is a copy beside the variants
    stem, path = got["joins:default"]
    assert stem == "joins" and path.parent == tmp_path / "out"
    assert path.read_text() == (bench_minprop.CSRC / "joins.cu").read_text()
    assert set(bench_resident.default_sources(["luby"])) == {"luby:default"}
    # phase 3 alone runs the port's own library: nothing to build
    assert bench_resident.default_sources(["phase3"]) == {}


def _l8():
    return rt.Graph(rt.graphs.laplace3d(8), device="cpu")


def test_resident_bounds_pinned_on_laplace3d_8():
    """The least bytes of a whole solve (no lists, no scratch; one hash an
    undecided row a round) beside the slice-17 design's count, from the
    twin's live counts."""
    ell = _l8().ell
    v, d = ell.neighbors.shape
    trace = []
    ref.resident_fixed_point_ref(
        torch.empty(v, dtype=torch.int32), torch.empty(v, dtype=torch.int32),
        torch.ones(v, dtype=torch.bool), ell.neighbors.reshape(-1),
        priority="xorshift_star", b=id_bits(v), max_iters=128, trace=trace)
    assert trace == [(512, 512), (512, 489), (373, 150), (308, 87),
                     (192, 19), (72, 4)]
    assert chip_smoke._resident_bytes(v, d, trace) == (136313, 1261)
    assert chip_smoke._resident_bytes_design(v, d, trace) == (187993, 2522)


def test_phase3_bound_pinned_on_laplace3d_8():
    """Phase 3's least bytes (each distinct label's size once a round)
    beside the slice-16 design's count (a size a slot), at the state a
    two-phase coarsening gives it; the other joins' counts unchanged."""
    with rt.api.using_backend(rt.Backend(device="cpu")):
        calls = chip_smoke._join_calls(rt, join_ops, _l8(), "two_phase")
    got = {name: chip_smoke._join_bytes(join_ref, name, args, kw)
           for name, args, kw in calls}
    assert got == {"root_join": 19456, "phase2_join": 16747,
                   "phase3_fixed_point": 10436}
    _, args, kw = calls[-1]
    assert chip_smoke._join_bytes(join_ref, "phase3_fixed_point", args, kw,
                                  design=True) == 12156
