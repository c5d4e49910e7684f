"""The port package itself: it imports without jax, pins full-precision
matmuls, never hands out the CPU as the card (object computations run on
the card unless the caller enters ``host()``), and its chip check refuses
to run without one."""

import importlib
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import xerus_tpu_torch
# the package's ``config`` attribute is the settings object, as in
# xerus_tpu; the module is reached through the import system
config = importlib.import_module("xerus_tpu_torch.config")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, cwd=REPO, timeout=120):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *code_or_args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_imports_without_jax():
    """With jax made unimportable, the whole port imports and solves."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch, xerus_tpu_torch as xt\n"
        "from xerus_tpu_torch.examples import qtt_poisson_instance, "
        "host_poisson_residual\n"
        "from xerus_tpu_torch.convert import cores_to_torch, cores_to_df, "
        "df_to_numpy\n"
        "xs, A, b = qtt_poisson_instance(4, 2, 1)\n"
        "dev = torch.device('cpu')\n"
        "out, _, cnt = xt.ops.als_f32_df_run(cores_to_torch(xs, dev), "
        "cores_to_torch(A, dev), cores_to_torch(b, dev), cores_to_df(A, dev), "
        "cores_to_df(b, dev), 16, 2)\n"
        "assert host_poisson_residual(df_to_numpy(out), A, b) < 1e-10\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or "
        "m.startswith('xerus_tpu.') for m in sys.modules "
        "if sys.modules[m] is not None)\n"
        "print('ok')\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_rounding_imports_without_jax():
    """With jax made unimportable, the rounding modules import and round a
    small TT by every method."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch\n"
        "from xerus_tpu_torch.convert import cores_to_torch\n"
        "from xerus_tpu_torch.examples import bench_round_instance, "
        "cpu_round_sweep, host_tt_log_norm\n"
        "from xerus_tpu_torch.ops import gemm_exact, round_kernels as rk\n"
        "host = bench_round_instance(8, 2, 8, 1)\n"
        "cs = list(cores_to_torch(host, torch.device('cpu'), "
        "torch.float64))\n"
        "ref = host_tt_log_norm(cpu_round_sweep(host, 4))\n"
        "for m in ('svd', 'gram', 'subspace', 'gemm_exact'):\n"
        "    out = rk.tt_round_sweep_segmented(cs, 4, method=m)\n"
        "    got = host_tt_log_norm([c.numpy() for c in out])\n"
        "    assert abs(got - ref) < 1e-2 * abs(ref), (m, got, ref)\n"
        "out = rk._round_randomized(cs, 4, 4, qr_method='cholqr1')\n"
        "assert all(torch.isfinite(c).all() for c in out)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or "
        "m.startswith('xerus_tpu.') for m in sys.modules "
        "if sys.modules[m] is not None)\n"
        "print('ok')\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_completion_imports_without_jax():
    """With jax made unimportable, the completion modules import, evaluate
    a small TT at points and run a short adaptive ADF solve."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "from xerus_tpu_torch.algorithms import (ADFVariant, adf_cores, "
        "RankOneMeasurementSet, SinglePointMeasurementSet, "
        "find_largest_entry_cores, iht_cores)\n"
        "from xerus_tpu_torch.examples import (workload5_instance, "
        "full_grid_positions, host_full_tensor)\n"
        "from xerus_tpu_torch.ops import adf_kernels, stacking, tt_eval\n"
        "from xerus_tpu_torch.convert import cores_to_torch\n"
        "inst = workload5_instance()\n"
        "cs = list(cores_to_torch(inst.truth, torch.device('cpu'), "
        "torch.float64))\n"
        "grid = torch.from_numpy(full_grid_positions([4] * 5))\n"
        "vals = tt_eval.tt_eval_at_points(cs, grid).numpy()\n"
        "assert np.abs(vals - host_full_tensor(inst.truth)).max() < 1e-14\n"
        "assert inst.measurements.test(cs) < 1e-14\n"
        "out = adf_cores(ADFVariant(20, 1e-8, 0.9999), "
        "list(cores_to_torch(inst.start, torch.device('cpu'), "
        "torch.float64)), inst.measurements, max_ranks=inst.max_ranks, "
        "check_every='device')\n"
        "assert out.iterations == 20 and np.isfinite(out.residual)\n"
        "assert 0 <= find_largest_entry_cores(out.cores) < 4 ** 5\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or "
        "m.startswith('xerus_tpu.') for m in sys.modules "
        "if sys.modules[m] is not None)\n"
        "print('ok')\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_every_module_imports_without_jax():
    """With jax and xerus_tpu made unimportable, every module of the port
    imports, and the object layer's quick start runs under host()."""
    code = (
        "import sys; sys.modules['jax'] = None; "
        "sys.modules['xerus_tpu'] = None\n"
        "import importlib, pkgutil, xerus_tpu_torch as xt\n"
        "mods = [m.name for m in pkgutil.walk_packages(xt.__path__, "
        "'xerus_tpu_torch.')]\n"
        "for name in mods: importlib.import_module(name)\n"
        "for name in ('misc', 'core', 'indexing', 'network', 'tt', "
        "'algorithms', 'examples', 'models', 'parallel'):\n"
        "    assert any(m.split('.')[1] == name for m in mods), name\n"
        "assert 'xerus_tpu_torch.core.sparse_qr' in mods\n"
        "with xt.host():\n"
        "    A = xt.Tensor.random([8, 8]); b = xt.Tensor.random([8])\n"
        "    i, j, r1, r2 = xt.indices(4)\n"
        "    U, S, Vt, x, rec = (xt.Tensor() for _ in range(5))\n"
        "    (U(i, r1), S(r1, r2), Vt(r2, j)) << xt.SVD(A(i, j))\n"
        "    x(i) << b(j) / A(j, i)\n"
        "    rec(i, j) << U(i, r1) * S(r1, r2) * Vt(r2, j)\n"
        "    assert (rec(i, j) - A(i, j)).frob_norm() < 1e-12 * "
        "A.frob_norm()\n"
        "    x = xt.TTTensor.random([2] * 6, 4); op = "
        "xt.TTOperator.random([2] * 12, 2)\n"
        "    y = xt.TTTensor(); y(i & 0) << op(i / 2, j / 2) * x(j & 0)\n"
        "    assert xt.frob_norm(op(i / 2, j / 2) * x(j & 0) - y(i & 0)) "
        "< 1e-12 * y.frob_norm()\n"
        "    z = x.copy(); z.round_fast(2, method='gemm_exact'); "
        "w = x.copy(); w.round(2)\n"
        "    assert (z - w).frob_norm() < 1e-8 * w.frob_norm()\n"
        "    net = xt.TensorNetwork(x); assert abs(net.frob_norm() - "
        "x.frob_norm()) < 1e-12 * x.frob_norm()\n"
        "    A = xt.examples.laplace_operator([2] * 6); b = "
        "xt.TTTensor.ones([2] * 6); x = xt.TTTensor.random([2] * 6, 3)\n"
        "    assert xt.ALS_SPD(A, x, b, 1e-12) < 1e-10\n"
        "    assert xt.frob_norm(A(i / 2, j / 2) * x(j & 0) - b(i & 0)) "
        "< 1e-10 * b.frob_norm()\n"
        "    xt.set_seed(0)\n"
        "    truth, ms, x0 = xt.models.completion_problem([4] * 4, 2, 150)\n"
        "    assert xt.ADF(x0, ms) < 1e-6 and ms.test(x0) < 1e-6\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or "
        "m == 'xerus_tpu' or m.startswith('xerus_tpu.') for m in "
        "sys.modules if sys.modules[m] is not None)\n"
        "print(len(mods))\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 40


def test_no_port_file_names_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the
    JAX package."""
    root = os.path.dirname(xerus_tpu_torch.__file__)
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
        if f.endswith(".py")]
    for path in files:
        with open(path) as fh:
            for line in fh:
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    mod = words[1].split(".")[0].rstrip(",")
                    assert mod not in ("jax", "jaxlib", "xerus_tpu"), \
                        (path, line)


def _jax_package_top_level_names(package=("xerus_tpu",)):
    """The public names bound at the top of a JAX package's __init__.py
    (xerus_tpu by default), read from its source (nothing of the JAX
    package is imported)."""
    import ast
    with open(os.path.join(REPO, *package, "__init__.py")) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


# names of xerus_tpu.ops the port leaves out by design (ROADMAP Queue 1):
# the rounding's padded-scan factories and the timed loop, the Pallas
# entries (their port is tt_eval_at_points and df_matvec)
OPS_BY_DESIGN = {"make_round_sweep", "make_round_sweep_scan",
                 "make_timed_loop", "tt_eval_at_points_pallas",
                 "pallas_df_matvec"}


def test_missing_top_level_names_are_roadmaps_list():
    """The JAX package's top-level names the port lacks are exactly the
    ones ROADMAP.md lists, each under the item that brings it; the names
    this slice brings exist."""
    import re
    missing = {n for n in _jax_package_top_level_names()
               if not hasattr(xerus_tpu_torch, n)}
    with open(os.path.join(REPO, "ROADMAP.md")) as fh:
        text = fh.read()
    block = text.split("<!-- missing top-level names -->")[1]
    listed = set(re.findall(r"`([A-Za-z_][A-Za-z0-9_]*)`", block.split(
        "<!-- end -->")[0]))
    assert missing == listed
    for name in ("PerformanceData", "NoPerfData", "DataPoint", "ALSVariant",
                 "ALS", "ALS_SPD", "ALS_SPD_CG", "DMRG", "DMRG_SPD", "ASD",
                 "ASD_SPD", "SinglePointMeasurementSet",
                 "RankOneMeasurementSet", "ADFVariant", "ADF", "IHT",
                 "find_largest_entry", "UQMeasurementSet", "uq_adf", "uq_avg",
                 "uq_mc", "als_spd_mixed", "als_spd_fused", "models",
                 "examples", "EigenALSVariant", "DMRG_groundstate",
                 "ALS_groundstate", "smallest_eigenvalue", "dmrg_solve",
                 "TTTangentVector", "HOSVDRetractionI", "HOSVDRetractionII",
                 "ALSRetractionI", "ALSRetractionII",
                 "SubmanifoldRetractionI", "SubmanifoldRetractionII",
                 "ProjectiveVectorTransport", "TTRetractionI",
                 "TTRetractionII", "TTVectorTransport",
                 "SteepestDescentVariant", "SteepestDescent",
                 "GeometricCGVariant", "GeometricCG", "decomposition_als",
                 "randomTTSVD", "warmup"):
        assert hasattr(xerus_tpu_torch, name), name
    # xerus_tpu.ops and xerus_tpu.parallel: every name but the by-design
    # ones (ROADMAP Queue 1 items 11 and 9)
    ops = importlib.import_module("xerus_tpu_torch.ops")
    par = importlib.import_module("xerus_tpu_torch.parallel")
    assert {n for n in _jax_package_top_level_names(("xerus_tpu", "ops"))
            if not hasattr(ops, n)} == OPS_BY_DESIGN
    assert {n for n in _jax_package_top_level_names(
        ("xerus_tpu", "parallel")) if not hasattr(par, n)} == set()


@pytest.mark.cuda
def test_als_spd_fused_launches_k1_on_the_card():
    """xt.als_spd_fused on the d=12 rank-23 QTT Poisson system on the
    card: K1 runs three refinement residuals per df half-sweep at each of
    the 2 sites whose 1058-row local systems reach its 2^20 gate (12
    launches; at d=8 no QTT site reaches it), the same count as the
    core-level run on the same cores, whose history and solution it
    reproduces; the solution is float64 quality."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from xerus_tpu_torch.ops.df_matvec import df_matvec
    from xerus_tpu_torch.ops.mixed_precision import (als_f32_df_run,
                                                     df_split)
    xt = xerus_tpu_torch
    xt.set_seed(0xBAADF00D)
    dims = [2] * 12
    A = xt.examples.laplace_operator(dims)
    b = xt.TTTensor.ones(dims)
    x = xt.TTTensor.random(dims, 23)
    gated = sum(1 for c in x.components
                if (c.dimensions[0] * c.dimensions[1] * c.dimensions[2]) ** 2
                >= 2 ** 20)
    df_matvec.launches = 0
    sol, hist = xt.als_spd_fused(A, x, b)
    launches = df_matvec.launches
    assert gated == 2 and launches == gated * 3 * 2
    i, j = xt.indices(2)
    res = xt.frob_norm(A(i / 2, j / 2) * sol(j & 0) - b(i & 0)) \
        / b.frob_norm()
    assert res < 1e-10
    y = x.copy()
    y.move_core(0)
    f32 = [tuple(c._torch().float() for c in t.components) for t in (y, A, b)]
    df_matvec.launches = 0
    out, chist, cnt = als_f32_df_run(
        *f32, tuple(df_split(c._torch()) for c in A.components),
        tuple(df_split(c._torch()) for c in b.components), 16, 2)
    assert df_matvec.launches == launches and hist == chist[:cnt].tolist()
    ref = xt.TTTensor._make([xt.Tensor._wrap(h.double() + l.double())
                             for h, l in out])
    assert (sol - ref).frob_norm() <= 1e-12 * ref.frob_norm()


@pytest.mark.cuda
def test_als_spd_on_the_card_matches_host():
    """ALS_SPD and ALS on TT objects on the card against the same solves
    under host(): residuals within 1e-10, the same ranks, the represented
    tensors within 1e-10 in TT form."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    xt = xerus_tpu_torch

    def solve(variant):
        xt.set_seed(0xBAADF00D)
        A = xt.examples.laplace_operator([2] * 8)
        b = xt.TTTensor.ones([2] * 8)
        x = xt.TTTensor.random([2] * 8, 4)
        return variant(A, x, b, 1e-12), x

    for variant in (xt.ALS_SPD, xt.ALS):
        rc, xc = solve(variant)
        assert xc.components[0]._torch().device.type == "cuda"
        with xt.host():
            rh, xh = solve(variant)
            xc_host = xt.TTTensor._make([xt.Tensor.from_ndarray(
                c.to_ndarray()) for c in xc.components])
            assert (xc_host - xh).frob_norm() <= 1e-10 * xh.frob_norm()
        assert abs(rc - rh) <= 1e-10 and xc.ranks() == xh.ranks()


def test_object_layer_defaults():
    assert xerus_tpu_torch.config.device == torch.device("cuda")
    assert xerus_tpu_torch.value_dtype() == np.float64
    assert xerus_tpu_torch.config.value_dtype == np.float64


def test_object_computation_needs_the_card_outside_host(monkeypatch):
    """Without a card an object computation raises, and never falls back
    to the CPU; inside host() it runs there."""
    xt = xerus_tpu_torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = xt.Tensor.random([4, 4])         # building on the host is fine
    i, j, k = xt.indices(3)
    for compute in (A.frob_norm, lambda: A + A,
                    lambda: xt.calculate_svd(A, 1),
                    lambda: xt.contract(A, A, 1),
                    lambda: xt.contract(xt.Tensor.random([4, 4], n=3), A, 1),
                    lambda: xt.Tensor()(i, k) << A(i, j) * A(j, k)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compute()
    with xt.host():
        assert xt.config.device == torch.device("cpu")
        assert A.frob_norm() > 0
        C = xt.Tensor()
        C(i, k) << A(i, j) * A(j, k)
        assert C.to_torch().device.type == "cpu"
    assert xt.config.device == torch.device("cuda")
    with pytest.raises(RuntimeError):
        A.frob_norm()


def test_tt_and_network_computation_needs_the_card_outside_host(
        monkeypatch):
    """TT and network computations run on the card too: without one they
    raise outside host() and run inside it."""
    xt = xerus_tpu_torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with xt.host():
        x = xt.TTTensor.random([2] * 5, 3)
        op = xt.TTOperator.random([2] * 10, 2)
        net = xt.TensorNetwork(x)
    i, j = xt.indices(2)
    for compute in (x.frob_norm, lambda: x.copy().move_core(3),
                    lambda: x.copy().round(2),
                    lambda: x.copy().round_fast(2, method="gemm_exact"),
                    lambda: xt.apply_operator(op, x),
                    lambda: xt.frob_norm(op(i / 2, j / 2) * x(j & 0)),
                    lambda: xt.TTTensor.random([2] * 5, 3),
                    net.to_tensor, lambda: net.copy().transfer_core(0, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compute()
    with xt.host():
        assert abs(net.frob_norm() - x.frob_norm()) < 1e-12 * x.frob_norm()
        y = x.copy()
        y.round_fast(2, method="gemm_exact")
        assert y.ranks() == [2, 2, 2, 2]


@pytest.mark.parametrize("case", ["sparse x dense", "dense x sparse^T",
                                  "sparse x sparse", "pseudo_inverse"])
def test_sparse_computation_needs_the_card_outside_host(monkeypatch, case):
    """A contraction with a sparse operand raises without a card too,
    below DEVICE_SPARSE_THRESHOLD as above it; under host() it runs."""
    xt = xerus_tpu_torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    S, D = xt.Tensor.random([4, 4], n=5), xt.Tensor.random([4, 4])
    compute = {"sparse x dense": lambda: xt.contract(S, D, 1),
               "dense x sparse^T": lambda: xt.contract(D, S, 1,
                                                       rhs_trans=True),
               "sparse x sparse": lambda: xt.contract(S, S, 1),
               "pseudo_inverse": lambda: xt.pseudo_inverse(S, 1)}[case]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compute()
    with xt.host():
        assert compute().dimensions == [4, 4]


def test_precision_guard_is_applied():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
        is False
    assert torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction \
        is False


def test_cuda_device_never_returns_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        config.cuda_device()


def test_require():
    config.require(True)
    with pytest.raises(ValueError, match="bad input"):
        xerus_tpu_torch.require(False, "bad input")


def _assert_refused(proc):
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        assert '"ok"' not in line


def test_chip_smoke_fails_without_card():
    _assert_refused(_run(["chip_smoke.py"]))


def test_chip_smoke_fails_outside_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    _assert_refused(_run(["chip_smoke.py"], cwd=str(tmp_path)))
