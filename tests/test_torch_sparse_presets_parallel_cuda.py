"""The bf16 speed presets, the sparse QR's dense route and the parallel
layer on the card.

Imports no jax, so the file also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sparse_presets_parallel_cuda.py

Without a card every case skips."""

import socket

import numpy as np
import pytest
import torch

import xerus_tpu_torch as xt
from xerus_tpu_torch.ops import round_kernels as rk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["default", "high"])
def test_bf16_products_on_the_card_are_cublas_bf16_gemms(cuda, precision):
    """mm_precision on CUDA tensors runs cuBLAS bf16 GEMMs with float32
    output (counted) and agrees with the CPU plain version, whose products
    are the same exact bf16 products summed in float32, to float32
    accumulation order (1e-6 relative); torch's precision flags stay
    pinned."""
    g = torch.Generator().manual_seed(3)
    a = torch.randn(512, 384, generator=g)
    b = torch.randn(384, 256, generator=g)
    before = rk._bf16_pass.gemms
    got = rk.mm_precision(a.to(cuda), b.to(cuda), precision)
    assert rk._bf16_pass.gemms - before == (1 if precision == "default"
                                            else 3)
    assert got.dtype == torch.float32 and got.is_cuda
    want = rk.mm_precision(a, b, precision)
    assert (torch.linalg.norm(got.cpu() - want)
            <= 1e-6 * torch.linalg.norm(want))
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert (torch.backends.cuda.matmul
            .allow_bf16_reduced_precision_reduction is False)


@pytest.mark.cuda
def test_bf16_frontier_round_fast_on_the_card(cuda):
    """round_fast(speed='bf16_frontier') on a card TT runs bf16 GEMMs and
    reproduces a representable TT to its bf16 resolution, as on the
    CPU."""
    xt.set_seed(0xBAADF00D)
    a = xt.TTTensor.random([2] * 8, 3)
    want = a.to_tensor().to_ndarray()
    t = a.copy()
    before = rk._bf16_pass.gemms
    t.round_fast(6, speed="bf16_frontier")
    assert rk._bf16_pass.gemms > before
    err = np.linalg.norm(t.to_tensor().to_ndarray() - want)
    assert err < 8 * 2.0 ** -8 * np.linalg.norm(want)


@pytest.mark.cuda
def test_sparse_dense_route_on_the_card_matches_the_host(cuda):
    """The dense Heath route's QR on the card and on the host: the same
    rank and column space, reconstruction to 1e-12."""
    from xerus_tpu_torch.core import sparse_qr as sq
    assert sq.native_available()
    rng = np.random.default_rng(11)
    m, n = 256, 128
    rows = np.repeat(np.arange(m), 6)
    pos = np.unique(rows * n + rng.integers(0, n, size=rows.size))
    vals = rng.standard_normal(pos.size)
    card = sq.dense_heath_qc(pos, vals, m, n, 1e-10)
    with xt.host():
        host = sq.dense_heath_qc(pos, vals, m, n, 1e-10)
    assert card[2] == host[2]

    def dense(flat, r, c):
        out = np.zeros((r, c))
        for p, v in flat.items():
            out[p // c, p % c] = v
        return out

    Qc, Qh = dense(card[0], m, card[2]), dense(host[0], m, host[2])
    A = np.zeros((m, n))
    A[pos // n, pos % n] = vals
    assert np.linalg.norm(Qc @ dense(card[1], card[2], n) - A) \
        <= 1e-12 * np.linalg.norm(A)
    assert np.abs(Qc @ Qc.T - Qh @ Qh.T).max() < 1e-12


@pytest.mark.cuda
def test_parallel_layer_on_a_one_rank_nccl_group(cuda):
    """Every parallel entry and both mesh= arguments in a one-rank NCCL
    group on the card meet the serial oracles (examples/parallel_checks.py);
    the group is destroyed afterwards."""
    import torch.distributed as dist
    from xerus_tpu_torch.examples.parallel_checks import misses, run_checks
    from xerus_tpu_torch.parallel.mesh import process_group
    torch.cuda.set_device(0)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with process_group("nccl", f"tcp://localhost:{port}", 0, 1):
        assert dist.get_backend() == "nccl"
        res = run_checks(torch.device("cuda", torch.cuda.current_device()), 1)
    assert not dist.is_initialized()
    assert misses(res) == []
