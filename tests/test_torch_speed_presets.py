"""The port's rounding speed presets (``ops.round_kernels.SPEED_PRESETS``,
``mm_precision``, ``TTTensor.round_fast(speed=...)``) on the CPU.

The JAX package on the CPU ignores matmul precision (tests/test_tt.py's
bf16 test says so), so its CPU run of 'bf16_frontier' is 'exact'.  The
port's CPU route is the plain version of the card's arithmetic: operands
rounded to bf16, products accumulated in float32.  So the preset table is
held to the JAX package's, the bf16 products to a numpy emulation of a
bf16 pass and of bf16x3 (relative 1e-6: float32 accumulation against
float64), the truncation error on a decaying instance to the JAX
package's measured 1.1x bar against 'exact' (doc/performance.md, round-4
bf16 study), and the Gram guardrail as tests/test_tt.py pins it."""

import inspect

import numpy as np
import pytest
import torch

import xerus_tpu_torch as xt
from xerus_tpu.ops.tt_kernels import SPEED_PRESETS as JAX_PRESETS
from xerus_tpu_torch.examples.rounding import bench_round_instance
from xerus_tpu_torch.ops import round_kernels as rk

SEED = 0xBAADF00D
BF16_UNIT = 2.0 ** -8          # spacing of bf16 numbers in [1, 2)
FRONTIER_BAR = 1.1             # doc/performance.md's bar on the error


@pytest.fixture(autouse=True, scope="module")
def _host():
    with xt.host():
        yield


def test_preset_table_is_the_jax_packages():
    assert rk.SPEED_PRESETS == JAX_PRESETS
    assert xt.ops.SPEED_PRESETS is rk.SPEED_PRESETS


def test_gram_precision_guardrail(monkeypatch):
    """tests/test_tt.py::test_round_fast_bf16_frontier_preset's pin: the
    Gram never drops below 'high' where the bulk precision is lowered,
    and round_fast hands the preset to the cholqr1 sweep."""
    full = (None, "highest")
    for name, preset in rk.SPEED_PRESETS.items():
        if preset["precision"] not in full:
            assert preset["gram_precision"] in full + ("high",), name
    preset = rk.SPEED_PRESETS["bf16_frontier"]
    assert preset == {"precision": "default", "gram_precision": "high"}

    captured = {}
    orig = rk._round_randomized

    def spy(*args, **kw):
        bound = inspect.signature(orig).bind(*args, **kw)
        bound.apply_defaults()
        captured.update({k: bound.arguments[k] for k in
                         ("qr_method", "precision", "gram_precision")})
        return orig(*args, **kw)

    monkeypatch.setattr(rk, "_round_randomized", spy)
    xt.set_seed(SEED)
    a = xt.TTTensor.random([2] * 8, 3)
    a.round_fast(6, speed="bf16_frontier")
    assert captured == {"qr_method": "cholqr1", "precision": "default",
                        "gram_precision": "high"}
    # per call: torch's global precision flags stay as config pins them
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert (torch.backends.cuda.matmul
            .allow_bf16_reduced_precision_reduction is False)
    assert torch.get_float32_matmul_precision() == "highest"


def test_representable_ranks_are_reproduced():
    """tests/test_tt.py's representable-rank check: 'exact' reproduces the
    TT to the JAX test's 1e-6; 'bf16_frontier' to its bf16 products'
    resolution, one spacing per site."""
    for seed in range(3):
        xt.set_seed(SEED + seed)
        a = xt.TTTensor.random([2] * 8, 3)
        want = a.to_tensor().to_ndarray()
        for speed, bar in (("exact", 1e-6), ("bf16_frontier",
                                              8 * BF16_UNIT)):
            t = a.copy()
            t.round_fast(6, speed=speed)
            t.require_correct_format()
            err = np.linalg.norm(t.to_tensor().to_ndarray() - want)
            assert err < bar * np.linalg.norm(want), (speed, err)


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bf16 value (ties to even), as float64."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


@pytest.mark.parametrize("shape", [(64, 48, 32), (300, 17, 129)])
def test_bf16_products_match_an_emulation(shape):
    """The plain 'default' (one bf16 pass) and 'high' (bf16x3: hi*hi +
    hi*lo + lo*hi of the splits x = hi + lo) products against the same
    sums in float64 on emulated bf16 operands."""
    m, k, n = shape
    rng = np.random.default_rng(sum(shape))
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) * 1e-3).astype(np.float32)
    ah, bh = _bf16(a), _bf16(b)
    al = _bf16((a - ah).astype(np.float32))
    bl = _bf16((b - bh).astype(np.float32))
    want = {"default": ah @ bh, "high": ah @ bh + ah @ bl + al @ bh}
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    errs = {}
    for prec, ref in want.items():
        got = rk.mm_precision(ta, tb, prec)
        assert got.dtype == torch.float32
        got = got.double().numpy()
        assert np.linalg.norm(got - ref) <= 1e-6 * np.linalg.norm(ref), prec
        errs[prec] = np.linalg.norm(got - exact) / np.linalg.norm(exact)
    # one pass stays at bf16's resolution, bf16x3 near float32's
    assert 1e-4 < errs["default"] < BF16_UNIT
    assert errs["high"] < 1e-4
    np.testing.assert_array_equal(
        rk.mm_precision(ta, tb, None).numpy(), (ta @ tb).numpy())
    with pytest.raises(ValueError, match="precision"):
        rk.mm_precision(ta, tb, "fastest")


def _decaying(d, rank, damping=0.99):
    """bench.py's rounding instance with benchmarks/bf16_round_study.py's
    geometric per-bond damping (0.99 per rank slot on both sides)."""
    out = []
    for c in bench_round_instance(d, 2, rank):
        rl, _, rr = c.shape
        dl = damping ** np.arange(rl, dtype=np.float32)
        dr = damping ** np.arange(rr, dtype=np.float32)
        out.append((c * dl[:, None, None] * dr[None, None, :])
                   .astype(np.float32))
    return out


def _full(cores):
    out = np.asarray(cores[0], np.float64)
    for c in cores[1:]:
        out = np.tensordot(out, np.asarray(c, np.float64), axes=1)
    return out.reshape(-1)


def test_bf16_frontier_error_within_the_bar_on_a_decaying_instance():
    """The study's decaying construction at d=12, rank 64 -> 16: the
    frontier's relative truncation error, averaged over 8 sketches (the
    randomized method's error is an expectation over its sketch), stays
    within 1.1x of 'exact' on the same sketches; the control, the Gram at
    one bf16 pass, misses the bar (the JAX package measured 4.62x at
    rank 1024 on a TPU)."""
    host = _decaying(12, 64)
    X = _full(host)
    cores = [torch.from_numpy(c) for c in host]
    err = {}
    for name, (p, g) in {"exact": (None, None),
                         "bf16_frontier": ("default", "high"),
                         "gram_default": ("default", "default")}.items():
        errs = []
        for seed in range(8):
            out = rk._round_randomized(
                cores, 16, 8, qr_method="cholqr1", precision=p,
                gram_precision=g,
                generator=torch.Generator().manual_seed(seed))
            assert all(c.dtype == torch.float32 for c in out)
            errs.append(np.linalg.norm(X - _full(out)) / np.linalg.norm(X))
        err[name] = float(np.mean(errs))
    assert err["exact"] > 10 * BF16_UNIT       # the error is discriminable
    assert err["bf16_frontier"] <= FRONTIER_BAR * err["exact"], err
    assert err["gram_default"] > FRONTIER_BAR * err["exact"], err


def test_float64_cores_round_in_float32_at_a_lowered_precision():
    """A lowered precision runs the sweep in float32 (the JAX package's
    f32 kernel) and hands back the cores' dtype."""
    host = _decaying(8, 16)
    c32 = [torch.from_numpy(c) for c in host]
    c64 = [c.double() for c in c32]
    kw = dict(qr_method="cholqr1", precision="default",
              gram_precision="high")
    a = rk._round_randomized(c64, 8, 4, generator=torch.Generator()
                             .manual_seed(1), **kw)
    b = rk._round_randomized(c32, 8, 4, generator=torch.Generator()
                             .manual_seed(1), **kw)
    assert all(x.dtype == torch.float64 for x in a)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.double().numpy())
