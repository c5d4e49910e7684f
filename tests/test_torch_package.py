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
        "from xerus_tpu_torch.algorithms import (ADFVariant, IHT, "
        "RankOneMeasurementSet, SinglePointMeasurementSet, "
        "find_largest_entry)\n"
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
        "out = ADFVariant(20, 1e-8, 0.9999)(list(cores_to_torch(inst.start, "
        "torch.device('cpu'), torch.float64)), inst.measurements, "
        "max_ranks=inst.max_ranks, check_every='device')\n"
        "assert out.iterations == 20 and np.isfinite(out.residual)\n"
        "assert 0 <= find_largest_entry(out.cores) < 4 ** 5\n"
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
        "for name in ('misc', 'core', 'indexing', 'network', 'tt'):\n"
        "    assert any(m.startswith('xerus_tpu_torch.' + name + '.') "
        "for m in mods), name\n"
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
