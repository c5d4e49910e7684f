"""K1, the one-pass df matvec: the port's plain version held against the
JAX package's Pallas kernel (interpret mode off the TPU) and float64 on the
CPU; the CUDA kernel held against the plain version on the card."""

import numpy as np
import pytest
import torch

from xerus_tpu.ops import df32 as jdf
from xerus_tpu.ops.pallas_df import pallas_df_matvec
from xerus_tpu_torch.ops import df32 as tdf
from xerus_tpu_torch.ops.df_matvec import df_matvec, df_matvec_reference

CPU = torch.device("cpu")


def _rand(shape, seed):
    return np.random.Generator(np.random.PCG64(seed)).normal(size=shape)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("m,k,block_m,block_k", [(200, 300, 64, 128),
                                                 (130, 190, 64, 64)])
def test_reference_matches_pallas_kernel(m, k, block_m, block_k):
    A = _rand((m, k), 20)
    x = _rand((k,), 21)
    exact = A @ x
    oh, ol = pallas_df_matvec(*jdf.df_from_f64(A), *jdf.df_from_f64(x),
                              block_m=block_m, block_k=block_k)
    pallas = jdf.df_to_f64(np.asarray(oh), np.asarray(ol))
    port = tdf.df_to_f64(*df_matvec_reference(*tdf.df_from_f64(A, CPU),
                                              *tdf.df_from_f64(x, CPU)))
    assert _rel(pallas, exact) < 1e-12
    assert _rel(port, exact) < 1e-12
    assert _rel(port, pallas) < 1e-13


def test_wrapper_takes_plain_version_on_cpu_only():
    A = _rand((50, 70), 22)
    x = _rand((70,), 23)
    args = (*tdf.df_from_f64(A, CPU), *tdf.df_from_f64(x, CPU))
    calls0, launches0 = df_matvec.calls, df_matvec.launches
    yh, yl = df_matvec(*args)
    rh, rl = df_matvec_reference(*args)
    assert torch.equal(yh, rh) and torch.equal(yl, rl)
    assert df_matvec.calls == calls0 + 1
    assert df_matvec.launches == launches0


def test_wrapper_raises_off_cpu_without_kernel():
    """A tensor on neither the CPU nor a CUDA card has no kernel: the
    wrapper raises instead of running the plain version."""
    A = torch.empty((4, 4), device="meta")
    x = torch.empty((4,), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        df_matvec(A, A, x, x)


@pytest.mark.cuda
def test_kernel_matches_pallas_kernel_on_card():
    """The CUDA kernel on the card against the Pallas kernel (interpret
    mode) on the same inputs; both df-accurate, orders differ."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    A = _rand((200, 300), 20)
    x = _rand((300,), 21)
    oh, ol = pallas_df_matvec(*jdf.df_from_f64(A), *jdf.df_from_f64(x),
                              block_m=64, block_k=128)
    pallas = jdf.df_to_f64(np.asarray(oh), np.asarray(ol))
    dev = torch.device("cuda")
    kern = tdf.df_to_f64(*df_matvec(*tdf.df_from_f64(A, dev),
                                    *tdf.df_from_f64(x, dev)))
    assert _rel(kern, A @ x) < 1e-12
    assert _rel(kern, pallas) < 1e-13
