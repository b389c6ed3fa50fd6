"""``repro_torch.api`` carries ``repro.api``'s public surface: every name
of the reference's ``__all__`` but ``default_interpret`` (the Pallas
interpret-mode switch; the port's CPU twins play its part), the
reference's engine names and aliases (equal digests, the canonical engine
in ``provenance``), ``EngineSpec`` with ``doc`` and ``aliases``, the
process default backend, and the generators."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro
import repro.api as ref_api
import repro_torch as rt
import repro_torch.api as api

from _torch_common import CPU, port_graph, ref_coarsen, ref_mis2

#: engine aliases the port registers -> (kind, canonical engine)
ALIASES = {
    ("aggregation", "mis2_agg"): "two_phase",
    ("aggregation", "mis2_basic"): "basic",
    ("mis2", "pallas"): "cuda_compacted",
    ("mis2", "pallas_resident"): "cuda_resident",
    ("mis2", "pallas_hybrid"): "cuda_hybrid",
}


def test_every_reference_name_but_default_interpret():
    missing = [n for n in ref_api.__all__
               if n != "default_interpret" and n not in api.__all__]
    assert not missing
    assert "default_interpret" not in api.__all__
    for name in api.__all__:
        assert hasattr(api, name), name


def test_top_level_version_and_api():
    assert rt.__version__ == repro.__version__
    assert rt.api is api and "api" in rt.__all__
    assert sorted(api.generators.__all__) == sorted(
        ref_api.generators.__all__)
    g = api.generators.laplace3d(4)
    assert api.Graph(g, device="cpu").digest == repro.Graph(
        ref_api.generators.laplace3d(4)).digest


@pytest.mark.parametrize("kind,alias", list(ALIASES),
                         ids=[a for _, a in ALIASES])
def test_engine_spec_aliases_and_doc(kind, alias):
    canonical = ALIASES[kind, alias]
    spec = api.get_engine_spec(kind, alias)
    assert isinstance(spec, api.EngineSpec)
    assert (spec.kind, spec.name) == (kind, canonical)
    assert alias in spec.aliases and spec.doc
    assert api.get_engine(kind, alias) is spec.fn
    assert api.get_engine_spec(kind, canonical) is spec
    assert alias not in api.list_engines(kind)[kind]
    assert canonical in api.list_engines(kind)[kind]


def test_every_engine_has_a_doc():
    for kind, names in api.list_engines().items():
        for name in names:
            assert api.get_engine_spec(kind, name).doc, (kind, name)


def test_unknown_engine_raises_with_the_names():
    with pytest.raises(ValueError, match="unknown 'mis2' engine 'nope'.*"
                                         "cuda_resident"):
        api.get_engine_spec("mis2", "nope")


@pytest.mark.parametrize("alias", ["pallas_resident", "pallas",
                                   "pallas_hybrid"])
def test_mis2_aliases_give_the_reference_digest(alias):
    g = port_graph("laplace3d(8)")
    r = api.mis2(g, engine=alias, backend=CPU)
    want = ref_mis2("laplace3d(8)")
    assert (r.size, r.iterations, r.digest) == (want.size, want.iterations,
                                                want.digest)
    canonical = ALIASES["mis2", alias]
    assert r.engine == canonical and r.provenance.engine == canonical


@pytest.mark.parametrize("alias", ["mis2_agg", "mis2_basic"])
def test_coarsen_aliases_give_the_reference_digest(alias):
    g = port_graph("laplace3d(8)")
    canonical = ALIASES["aggregation", alias]
    r = api.coarsen(g, method=alias, backend=CPU)
    want = ref_coarsen("laplace3d(8)", canonical)
    assert (r.num_aggregates, r.iterations, r.digest) == (
        want.num_aggregates, want.iterations, want.digest)
    assert r.provenance.engine == canonical
    if alias == "mis2_agg":
        assert r.num_aggregates == 82
    batched = api.coarsen_batch([g], method=alias, backend=CPU)
    assert batched.engine == f"{canonical}_batched"
    assert batched[0].digest == r.digest


def test_using_backend_is_the_default_and_restores_it():
    before = api.get_default_backend()
    assert before == api.Backend()
    with api.using_backend(CPU) as be:
        assert be is CPU and api.get_default_backend() is CPU
        g = api.Graph(api.generators.laplace3d(8))
        assert g.device == torch.device("cpu")
        r = api.mis2(g, engine="pallas_resident")
        assert r.provenance.backend == "cpu"
        assert r.digest == ref_mis2("laplace3d(8)").digest
    assert api.get_default_backend() is before
    with pytest.raises(ZeroDivisionError):
        with api.using_backend(CPU):
            1 / 0
    assert api.get_default_backend() is before


def test_set_default_backend_returns_the_old_one():
    old = api.set_default_backend(CPU)
    try:
        assert old == api.Backend()
        g = rt.Graph(rt.graphs.laplace3d(4))
        assert g.device.type == "cpu"
        assert rt.coarsen(g).provenance.backend == "cpu"
    finally:
        assert api.set_default_backend(old) is CPU
    assert api.get_default_backend() is old


def test_backend_with_and_accelerator_present():
    be = api.Backend().with_(device="cpu")
    assert be == CPU and api.Backend().device is None
    assert api.accelerator_present() == torch.cuda.is_available()


def test_without_cuda_or_cpu_default_graph_and_facade_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert api.get_default_backend() == api.Backend()
    assert not api.accelerator_present()
    g = api.Graph(api.generators.laplace3d(3))
    assert g.device == torch.device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.mis2(g, engine="pallas_resident")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.coarsen(g, method="mis2_agg")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.get_default_backend().resolve_device()
    assert "csr_to_ell" not in g.conversions


def test_result_like_protocol():
    r = api.mis2(port_graph("laplace3d(8)"), backend=CPU)
    assert isinstance(r, api.ResultLike)
    assert isinstance(r.payload, np.ndarray)
    assert not isinstance(object(), api.ResultLike)


def test_graph_helpers_on_the_api():
    csr = api.generators.laplace3d(4).graph
    g = api.as_graph(csr, device="cpu")
    assert isinstance(g, api.Graph) and api.as_graph(g) is g
    assert api.as_csr_graph(g) is g.csr
    assert api.as_ell_graph(g) is g.ell
