"""The port package itself: it imports without jax, pins full-precision
matmuls, never hands out the CPU as the card, and its chip check refuses
to run without one."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

import xerus_tpu_torch
from xerus_tpu_torch import config

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
