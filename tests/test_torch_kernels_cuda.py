"""The port's CUDA kernels held against their plain versions on the card.

Imports no jax, so the file also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Without a card every case skips (the kernels have no CPU mode)."""

import numpy as np
import pytest
import torch

from xerus_tpu_torch.ops import df32
from xerus_tpu_torch.ops.df_matvec import df_matvec, df_matvec_reference


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(1800, 1800), (1030, 997), (130, 190),
                                 (1, 1), (33, 0)])
def test_df_matvec_kernel_matches_reference(cuda, m, k):
    """Kernel and plain version both within 1e-12 of the f64 product (the
    reduction orders differ, so not bitwise)."""
    rng = np.random.Generator(np.random.PCG64(m * 7919 + k))
    A = rng.normal(size=(m, k))
    x = rng.normal(size=(k,))
    args = (*df32.df_from_f64(A, cuda), *df32.df_from_f64(x, cuda))
    launches0 = df_matvec.launches
    kern = df32.df_to_f64(*df_matvec(*args))
    torch.cuda.synchronize()
    assert df_matvec.launches == launches0 + 1
    plain = df32.df_to_f64(*df_matvec_reference(*args))
    exact = A @ x
    if k == 0:
        assert np.all(kern == 0.0)
        return
    assert _rel(kern, exact) < 1e-12
    assert _rel(plain, exact) < 1e-12


@pytest.mark.cuda
def test_df_matvec_kernel_rejects_bad_input(cuda):
    A = torch.zeros((8, 6), device=cuda)
    x = torch.zeros((6,), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        df_matvec(A[:, ::2], A[:, ::2], x[::2], x[::2])
    with pytest.raises(TypeError, match="float32"):
        df_matvec(A.double(), A.double(), x.double(), x.double())
    with pytest.raises(ValueError, match="shape"):
        df_matvec(A, A, x[:5], x[:5])
    with pytest.raises(ValueError, match="on cpu"):
        df_matvec(A, A, x.cpu(), x.cpu())
