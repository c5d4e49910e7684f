"""The port's misc layer (xerus_tpu_torch.misc, the rest of config.py and
core/serialization.py) held against xerus_tpu's on the CPU.

The cases of tests/test_misc.py whose subject is ported (histograms, file
I/O, the seed, the ring-buffer log, coverage landmarks, numerics) run in
both packages.  ``set_seed`` draws are equal exactly; a file written by
either package is byte for byte the file the other writes (the zip
archive of a BINARY body carries the write time, so both write under one
frozen clock), and each loads the other's bit for bit."""

import logging
import math
import sys
import time

import numpy as np
import pytest

import xerus_tpu as xe
import xerus_tpu_torch as xt

SEED = 0xBAADF00D


@pytest.fixture(autouse=True, scope="module")
def _host():
    with xt.host():
        yield


# -- histograms


@pytest.mark.parametrize("pkg", [xe, xt], ids=["jax", "torch"])
def test_log_histogram_basic(pkg):
    h = pkg.LogHistogram(2.0)
    assert [h.add(x) for x in (1.5, 3.0, 3.9)] == [0, 1, 1]
    assert h.buckets == {0: 1, 1: 2} and h.total_count() == 3
    with pytest.raises(ValueError):
        h.add(-1.0)
    with pytest.raises(ValueError):
        pkg.LogHistogram(1.0)


def test_log_histogram_merge_and_io(tmp_path):
    hists = []
    for pkg in (xe, xt):
        h = pkg.LogHistogram(1.7)
        for x in [0.1, 0.5, 2.0, 30.0]:
            h.add(x)
        h2 = pkg.LogHistogram(1.7)
        h2.add(0.1)
        h += h2
        p = tmp_path / f"{pkg.__name__}.tsv"
        h.dump_to_file(str(p))
        hists.append((h, p))
    (hj, pj), (ht, pt) = hists
    assert ht.buckets == hj.buckets
    assert pt.read_bytes() == pj.read_bytes()
    back = xt.LogHistogram.read_from_file(str(pj))      # the JAX file
    assert back.buckets == hj.buckets and back.base == hj.base


# -- the seed


def test_set_seed_gives_the_jax_draws_exactly():
    for seed in (123, SEED):
        draws = []
        for pkg in (xe, xt):
            pkg.set_seed(seed)
            draws.append((pkg.Tensor.random([3, 3]).to_ndarray(),
                          pkg.Tensor.random([10, 10], n=7)._sparse,
                          pkg.Tensor.random_orthogonal([4], [3]).to_ndarray(),
                          pkg.misc.normal((2,)), pkg.misc.uniform((2,))))
        for a, b in zip(*draws):
            if isinstance(a, dict):
                assert a == b
            else:
                assert np.array_equal(a, b)
    xt.set_seed(5)
    a = xt.Tensor.random([3, 3]).to_ndarray()
    xt.set_seed(5)
    assert np.array_equal(a, xt.Tensor.random([3, 3]).to_ndarray())


# -- files


def _tensors(pkg, kind):
    pkg.set_seed(SEED)
    if kind == "dense":
        return pkg.Tensor.random([3, 4, 5])
    if kind == "scaled":
        t = pkg.Tensor.random([4, 4])
        t *= 2.5
        return t
    if kind == "computed":            # torch-held data in the port
        a = pkg.Tensor.random([4, 3])
        return pkg.contract(a, a, 1, lhs_trans=True)
    t = pkg.Tensor.random([10, 10], n=7)
    t *= -0.5
    return t


KINDS = ["dense", "scaled", "computed", "sparse"]
FORMATS = ["BINARY", "TSV"]


def _frozen_write(monkeypatch, pkg, t, path, fmt):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    pkg.save_to_file(t, str(path), getattr(pkg.FileFormat, fmt))
    monkeypatch.undo()


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("kind", KINDS)
def test_files_cross_between_the_packages(tmp_path, monkeypatch, kind, fmt):
    paths = {}
    for pkg in (xe, xt):
        paths[pkg] = tmp_path / f"{pkg.__name__}.xtpu"
        _frozen_write(monkeypatch, pkg, _tensors(pkg, kind), paths[pkg], fmt)
    assert paths[xt].read_bytes() == paths[xe].read_bytes()
    for writer, reader in ((xe, xt), (xt, xe)):
        back = reader.load_from_file(str(paths[writer]))
        orig = _tensors(writer, kind)
        assert back.dimensions == orig.dimensions
        assert back.representation.name == orig.representation.name
        assert np.array_equal(back.to_ndarray(), orig.to_ndarray())


@pytest.mark.parametrize("fmt", FORMATS)
def test_save_load_round_trip(tmp_path, fmt):
    xt.set_seed(SEED)
    t = xt.Tensor.random([3, 4, 5])
    p = str(tmp_path / "t.xtpu")
    xt.save_to_file(t, p, getattr(xt.FileFormat, fmt))
    back = xt.load_from_file(p)
    assert back.dimensions == t.dimensions
    assert np.array_equal(back.to_ndarray(), t.to_ndarray())
    assert back.frob_norm() == t.frob_norm()


@pytest.mark.parametrize("content", ["not a datafile\n",
                                     "XerusTPU Nonsense datafile\nTSV\n{}\n",
                                     "XerusTPU Tensor datafile\nXML\n{}\n"])
def test_load_rejects_garbage(tmp_path, content):
    p = tmp_path / "bad.xtpu"
    p.write_text(content)
    with pytest.raises(ValueError):
        xt.load_from_file(str(p))


def test_save_rejects_unregistered_types(tmp_path):
    with pytest.raises(TypeError):
        xt.save_to_file(object(), str(tmp_path / "x"))


# -- log, coverage, xethrow, profiling


def test_ring_buffer_log_on_error():
    class Capture(logging.Handler):
        def __init__(self):
            super().__init__()
            self.records = []

        def emit(self, record):
            self.records.append(record.getMessage())

    cap = Capture()
    h = xt.misc.enable_log_on_error(capacity=8, target=cap)
    try:
        log = xt.misc.get_logger("ALS")
        for i in range(12):
            log.debug("step %d", i)
        assert cap.records == [] and len(h.dump()) == 8
        log.error("boom")
        assert cap.records[-1] == "boom" and "step 11" in cap.records
        assert "step 3" not in cap.records
        xt.log("through the package")
        assert h.dump()[-1].getMessage() == "through the package"
    finally:
        xt.misc.get_logger().removeHandler(h)
    assert xt.misc.get_logger().name == "xerus_tpu_torch"


def test_require_coverage_landmarks(tmp_path, monkeypatch):
    cfg = sys.modules["xerus_tpu_torch.config"]   # the attribute shadows it
    from xerus_tpu_torch.misc import coverage
    monkeypatch.setattr(cfg, "_COVERAGE", True)
    saved = set(coverage._HITS)
    coverage._HITS.clear()
    try:
        cfg.require(True, "landmark")
        assert len(coverage._HITS) == 1
        assert __file__.split("/")[-1] in next(iter(coverage._HITS))
        p = tmp_path / "hits.txt"
        coverage.dump(str(p))
        total, hit, missed = coverage.report([str(p)])
        sites = coverage.scan_sites()
        assert total == len(sites) > 50 and hit == 0
        assert all("xerus_tpu_torch" in s for s in sites)
        assert any(s.split(":")[0].endswith("factorizations.py")
                   for s in sites)
    finally:
        coverage._HITS.clear()
        coverage._HITS.update(saved)


def test_require_coverage_hits_go_to_the_ports_dir(tmp_path, monkeypatch,
                                                   capsys):
    """Each process writes its hits under HITS_DIR (apart from the JAX
    package's .require_coverage/), where the report reads them."""
    from xerus_tpu_torch.misc import coverage
    monkeypatch.chdir(tmp_path)
    saved = set(coverage._HITS)
    coverage._HITS.clear()
    try:
        site = coverage.scan_sites()[0]
        coverage._HITS.add(site)
        coverage.dump_at_exit()
        files = list((tmp_path / coverage.HITS_DIR).glob("*.txt"))
        assert [f.read_text() for f in files] == [site + "\n"]
        assert coverage.main([]) == 0
        assert f"MISSED {site}" not in capsys.readouterr().out
    finally:
        coverage._HITS.clear()
        coverage._HITS.update(saved)


def test_runtime_checks_switch(monkeypatch):
    monkeypatch.setattr(xt.config, "runtime_checks", False)
    xt.require(False, "ignored while checks are off")
    monkeypatch.setattr(xt.config, "runtime_checks", True)
    with pytest.raises(ValueError, match="bad"):
        xt.require(False, "bad")


def test_xethrow():
    with pytest.raises(ValueError, match="xethrow"):
        xt.xethrow()


def test_profile_trace_writes_a_trace(tmp_path):
    from xerus_tpu_torch.misc import profile_trace
    with profile_trace(str(tmp_path / "trace")) as prof:
        a = xt.Tensor.random([16, 16])
        xt.contract(a, a, 1)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())


# -- numerics (a copy: the JAX package's oracles, run on the port)


def test_romberg_integration():
    from xerus_tpu_torch.misc import integrate
    npi = 2 * integrate(lambda x: math.sqrt(1 - x * x), -1, 1, 1e-16)
    assert abs(npi - math.pi) < 1e-13
    assert abs(integrate(lambda x: 1 - x, -1, 1, 1e-14) - 2.0) < 2e-14
    assert abs(integrate(math.cos, 0, 1, 1e-14) - math.sin(1)) < 2e-14
    step = lambda x: 1.0 if 0 < x <= 1 else 0.0
    assert abs(integrate(step, -2, 2, 1e-14, 3) - 1.0) < 2e-10
    assert abs(integrate(math.cos, 1, 0, 1e-14) + math.sin(1)) < 2e-14
    from xerus_tpu.misc import integrate as integrate_j
    assert integrate(math.exp, 0, 2, 1e-12) == integrate_j(math.exp, 0, 2,
                                                           1e-12)


def test_orthogonal_polynomial_base():
    from xerus_tpu_torch.misc import Polynomial
    weight = lambda x: abs(math.sin(x))
    base = Polynomial.build_orthogonal_base(6, weight, -1, 1)
    for i, p in enumerate(base):
        assert p.terms() == i + 1
        assert abs(p.norm(weight, -1, 1) - 1.0) < 1e-10
        for j, q in enumerate(base):
            if i != j:
                assert abs(p.scalar_product(q, weight, -1, 1)) < 1e-9
    b2 = Polynomial.build_orthogonal_base(3, lambda x: 1.0, -1, 1)[2]
    scale = b2.coefficients[2] / (1.5 / math.sqrt(2.0 / 5.0))
    assert abs(abs(scale) - 1.0) < 1e-8


def test_sequence_limit_extractors():
    from xerus_tpu_torch.misc import (RichardsonExtrapolation,
                                      ShanksTransformation)
    sh = ShanksTransformation()
    for n in range(6):
        sh.push_back(1.0 + 0.5 ** n)
    assert abs(sh.best_estimate() - 1.0) < 1e-10
    assert sh.error_approximate() < 1e-6
    assert abs(RichardsonExtrapolation.richard(3, 2.0 + 1.0 / 3,
                                               2.0 + 1.0 / 4) - 2.0) < 1e-12
    ri = RichardsonExtrapolation()
    ri.push_back(3.0)
    ri.push_back(2.5)
    assert abs(ri.best_estimate() - 2.5) < 1e-12
    ri.reset()
    with pytest.raises(ValueError):
        ri.best_estimate()


def test_find_root_bisection():
    from xerus_tpu_torch.misc import find_root_bisection
    assert abs(find_root_bisection(lambda x: x * x - 2.0, 0, 2)
               - math.sqrt(2)) < 1e-12
    with pytest.raises(ValueError):
        find_root_bisection(lambda x: x * x + 1.0, -1, 1)


def test_top_level_names():
    """The names of xerus_tpu/__init__.py:11-45 that this layer covers."""
    names = ("Tensor Representation Initialisation reshuffle approx_equal "
             "approx_entrywise_equal contract calculate_svd calculate_qr "
             "calculate_rq calculate_qc calculate_cq pseudo_inverse solve "
             "solve_least_squares entrywise_product Index indices SVD QR RQ "
             "QC CQ TensorFactorisation FileFormat save_to_file "
             "load_from_file LogHistogram set_seed log xethrow frob_norm "
             "one_norm config EPSILON set_value_dtype value_dtype "
             "host").split()
    for name in names:
        assert hasattr(xt, name), name
        assert hasattr(xe, name), name
    assert xt.TensorFactorisation is xt.indexing.Factorisation
