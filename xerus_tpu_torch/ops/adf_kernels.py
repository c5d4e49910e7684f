"""ADF iterations at core level (single-point and rank-one measurements).

Counterpart of ``xerus_tpu/ops/adf_kernels.py``.  One ADF iteration is
the backward-stack rebuild, the residual, per-core projected-gradient
steps with slice-wise optimal step sizes, and the core moves; the JAX
package traced it into one XLA program, here the same einsums and QRs run
eagerly on the cores' device.  Index selection stays a one-hot GEMM, and
the projected gradient and the slice-wise norms stay the same one-hot GEMMs
transposed: a scatter-add (``index_add_``) would use float atomics on the
card, whose order changes from run to run, and the stagnation test, and so
the iteration count, would change with it.

The JAX ``while_loop`` solves (``adf_device_run``, ``adf_adaptive_run``)
are Python loops that read one stop flag per iteration to the host
(``round_kernels.host_bool``, which counts its reads); each iteration,
with the left re-canonicalization, the stagnation window and the stop
flag, is one replay of a captured program (``ops/programs.py``; eager on
the CPU, and on the card where the caller passes ``eager=True``).  The
adaptive run's program works at the padded ``caps`` shapes with the bond
masks as device inputs, so one capture serves every rank level.  The rank
bump of the adaptive run, outside the program, takes its Gaussian vectors
from an explicit ``torch.Generator`` on the CPU, copied to the cores'
device, where the JAX package drew them from ``jax.random``; the kicks
differ between the packages by design.  The dp-sharded run stays eager
(its all_reduces are not captured).

The dp-sharded iterations (``adf_iteration_sharded``,
``adf_multi_iteration_sharded``, ``adf_device_run(mesh=...)``; point
measurements only, as in the JAX package) split the measurement axis of
the one-hots and values over the mesh's ``dp`` axis: each rank sweeps
its block of measurements and the sums over measurements (the residual,
the projected gradient, the slice-wise step denominators) are summed
over dp with one all_reduce each, where the JAX package's GSPMD inserted
the psums.  Cores stay replicated.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F_nn

from .programs import Program, call, factory
from .round_kernels import host_bool

Cores = Tuple[torch.Tensor, ...]


def _site(onehot: torch.Tensor, core: torch.Tensor) -> torch.Tensor:
    """(M, n) x (rl, n, rr) -> (M, rl, rr) selected slices."""
    return torch.einsum("mn,anb->mab", onehot, core)


def _step_size(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """where(den > 0, num / maximum(den, 1e-300), 0) as the JAX package
    writes it: the constant is 0 in float32, and the where, not the
    constant, keeps a zero denominator from giving inf or NaN."""
    return torch.where(den > 0, num / torch.clamp_min(den, 1e-300),
                       torch.zeros_like(num))


def _backward_stacks(cores, onehots, M):
    d = len(cores)
    B = [None] * (d + 1)
    B[d] = cores[0].new_ones((M, 1))
    for k in range(d - 1, 0, -1):
        B[k] = torch.einsum("mab,mb->ma", _site(onehots[k], cores[k]),
                            B[k + 1])
    return B


def _pointwise_step(core, onehot, F, B, res, reduce=None):
    """Projected gradient of one core with slice-wise optimal steps;
    ``reduce`` sums a partial sum over measurements across ranks."""
    outer = torch.einsum("m,ma,mb->mab", res, F, B)
    grad_by_slice = torch.einsum("mn,mab->nab", onehot, outer)
    if reduce is not None:
        grad_by_slice = reduce(grad_by_slice)
    grad = grad_by_slice.permute(1, 0, 2)
    Ggath = torch.einsum("mn,nab->mab", onehot, grad_by_slice)
    val = torch.einsum("ma,mab,mb->m", F, Ggath, B)
    norms = torch.einsum("mn,m->n", onehot, val * val)
    if reduce is not None:
        norms = reduce(norms)
    PyR = torch.sum(grad_by_slice * grad_by_slice, dim=(1, 2))
    alpha = _step_size(PyR, norms)
    return core + alpha[None, :, None] * grad


def _rankone_step(core, W, F, B, res):
    """Projected gradient of one core with one global optimal step."""
    outer = torch.einsum("m,ma,mb->mab", res, F, B)
    grad = torch.einsum("mab,mn->anb", outer, W)
    val = torch.einsum("ma,mab,mb->m", F, _site(W, grad), B)
    alpha = _step_size(torch.sum(grad * grad), torch.sum(val * val))
    return core + alpha * grad


def _sweep(cores, onehots, values, rank_one, colmask=None, reduce=None):
    """One left-to-right ADF sweep; (new_cores, residual norm at its
    start).  ``colmask[k]`` re-masks the Q columns of bond k (the padded,
    rank-masked form); ``reduce`` sums the sums over measurements across
    ranks (point measurements, ``adf_iteration_sharded``)."""
    d = len(cores)
    M = values.shape[0]
    B = _backward_stacks(cores, onehots, M)
    F = cores[0].new_ones((M, 1))
    cores = list(cores)
    residual0 = values.new_zeros(())
    step = _rankone_step if rank_one else _pointwise_step
    for cp in range(d):
        pred = torch.einsum("ma,mab,mb->m", F, _site(onehots[cp], cores[cp]),
                            B[cp + 1])
        res = values - pred
        if cp == 0:
            residual0 = (torch.linalg.vector_norm(res) if reduce is None
                         else torch.sqrt(reduce(torch.sum(res * res))))
        if reduce is None:
            new_core = step(cores[cp], onehots[cp], F, B[cp + 1], res)
        else:
            new_core = _pointwise_step(cores[cp], onehots[cp], F,
                                       B[cp + 1], res, reduce)
        if cp + 1 < d:
            rl, n, rr = new_core.shape
            q, r = torch.linalg.qr(new_core.reshape(rl * n, rr))
            if colmask is not None:
                q = q * colmask[cp][None, :]
            cores[cp] = q.reshape(rl, n, q.shape[1])
            cores[cp + 1] = torch.einsum("ab,bnc->anc", r, cores[cp + 1])
            F = torch.einsum("ma,mab->mb", F, _site(onehots[cp], cores[cp]))
        else:
            cores[cp] = new_core
    return tuple(cores), residual0


def _adf_iteration(cores, onehots, values):
    """One ADF iteration on point measurements (one-hot ``onehots``);
    returns (new_cores, residual_norm_at_start)."""
    return _sweep(cores, onehots, values, rank_one=False)


def _adf_iteration_rankone(cores, Ws, values):
    """Rank-one-measurement variant: per-mode weight matrices Ws[k]
    (M, n_k) select general rank-one functionals; the step size is
    global."""
    return _sweep(cores, Ws, values, rank_one=True)


def canonicalize_left_cores(cs) -> Cores:
    """Right-to-left QR sweep moving the core to component 0 (the
    core-level ``move_core(0, keep_rank=True)``)."""
    cs = list(cs)
    for i in range(len(cs) - 1, 0, -1):
        rl, n, rr = cs[i].shape
        q, r = torch.linalg.qr(cs[i].reshape(rl, n * rr).T)
        cs[i] = q.T.reshape(q.shape[1], n, rr)
        cs[i - 1] = torch.einsum("anb,bk->ank", cs[i - 1], r.T)
    return tuple(cs)


def adf_multi_iteration(cores, onehots, values, k: int,
                        rank_one: bool = False):
    """K chained (iteration + left re-canonicalization) steps; returns
    (cores_after_K, history), history[i] the residual norm at the start
    of inner iteration i.  No host read."""
    base = _adf_iteration_rankone if rank_one else _adf_iteration
    cs = tuple(cores)
    hist = []
    for _ in range(k):
        out, res = base(cs, onehots, values)
        cs = canonicalize_left_cores(out)
        hist.append(res)
    return cs, torch.stack(hist)


@factory(32)
def make_adf_iteration(shapes_key, dtype_str: str, rank_one: bool = False
                       ) -> Program:
    """One ADF iteration as a program: (cores, onehots, values) ->
    (new_cores, residual norm at its start)."""
    return Program(_adf_iteration_rankone if rank_one else _adf_iteration,
                   "adf_iteration")


@factory(32)
def make_adf_multi_iteration(shapes_key, dtype_str: str, k: int,
                             rank_one: bool = False) -> Program:
    """``adf_multi_iteration`` as one program: (cores, onehots, values)
    -> (cores after k iterations, (k,) history)."""
    return Program(partial(adf_multi_iteration, k=k, rank_one=rank_one),
                   f"adf_multi_iteration[{k}]")


def _dp_measurements(onehots, values, mesh):
    """This rank's block of the measurement axis and the dp sum."""
    from ..parallel.mesh import Axis
    dp = Axis(mesh, "dp")
    return tuple(dp.block(o) for o in onehots), dp.block(values), dp.psum


def adf_iteration_sharded(cores, onehots, values, mesh):
    """One ADF iteration on point measurements with the measurement axis
    dp-sharded over ``mesh`` (the JAX package's
    ``make_adf_iteration_sharded``); every rank passes the same cores,
    one-hots and values and gets the same (new_cores, residual)."""
    oh, vals, reduce = _dp_measurements(onehots, values, mesh)
    return _sweep(cores, oh, vals, False, reduce=reduce)


def adf_multi_iteration_sharded(cores, onehots, values, k: int, mesh):
    """K chained (dp-sharded iteration + left re-canonicalization) steps
    (``make_adf_multi_iteration_sharded``); returns (cores, history)."""
    oh, vals, reduce = _dp_measurements(onehots, values, mesh)
    cs = tuple(cores)
    hist = []
    for _ in range(k):
        out, res = _sweep(cs, oh, vals, False, reduce=reduce)
        cs = canonicalize_left_cores(out)
        hist.append(res)
    return cs, torch.stack(hist)


def _ratio(res0, last):
    one = torch.ones_like(res0)
    return torch.minimum(res0 / torch.where(last > 0, last, one), one)


def _device_step(cores, onehots, values, res_dec, last, target, thresh,
                 rank_one: bool = False, base=None):
    """One iteration of the fixed-rank solve: (iteration + left
    re-canonicalization), the stagnation window and the stop flag.
    Returns (cores, res0, res_dec, stop); ``base`` replaces the iteration
    (the dp-sharded one)."""
    if base is None:
        base = _adf_iteration_rankone if rank_one else _adf_iteration
    new, res0 = base(cores, onehots, values)
    cs = canonicalize_left_cores(new)
    res_dec = torch.cat([_ratio(res0, last)[None], res_dec[:3]])
    stop = (res0 < target) | (torch.prod(res_dec) > thresh)
    return cs, res0, res_dec, stop


@factory(32)
def _make_device_step(shapes_key, dtype_str: str, rank_one: bool) -> Program:
    return Program(partial(_device_step, rank_one=rank_one),
                   "adf_device_step")


def adf_device_run(cores, onehots, values, target, min_decrease, res_dec0,
                   last0, remaining: int, max_iters: int,
                   rank_one: bool = False, mesh=None, eager: bool = False):
    """The fixed-rank ADF solve: (iteration + left re-canonicalization)
    until the start-of-iteration residual drops below ``target`` or the
    product of the last four clamped residual-decrease ratios exceeds
    ``min_decrease**4``, at most min(max_iters, remaining) iterations.
    ``res_dec0`` (4,) and ``last0`` carry the stagnation window in, as the
    JAX while_loop's inputs do.  Each iteration is one replay of a
    captured program (``eager``: its function, run eagerly); one host read
    per iteration.

    With ``mesh`` (point measurements) every iteration is
    ``adf_iteration_sharded``'s, run eagerly; the flag read is the same on
    every rank.

    Returns (cores, hist, count): hist[i] is the residual norm at the
    start of inner iteration i, valid for i < count."""
    dtype, dev = values.dtype, values.device
    target = torch.as_tensor(target, dtype=dtype, device=dev)
    thresh = torch.as_tensor(min_decrease, dtype=dtype, device=dev) ** 4
    res_dec = torch.as_tensor(res_dec0, dtype=dtype, device=dev)
    last = torch.as_tensor(last0, dtype=dtype, device=dev)
    onehots = tuple(onehots)
    if mesh is not None and not rank_one:
        oh, vals, reduce = _dp_measurements(onehots, values, mesh)

        def base(cs, _oh, _vals):
            return _sweep(cs, oh, vals, False, reduce=reduce)

        def step(*args):
            return _device_step(*args, base=base)
    else:
        def step(*args):
            return call(_make_device_step, args, rank_one, eager=eager)
    limit = min(int(max_iters), int(remaining))
    hist = torch.full((max_iters,), -1.0, dtype=dtype, device=dev)
    cs = tuple(cores)
    i = 0
    while i < limit:
        cs, res0, res_dec, stop = step(cs, onehots, values, res_dec, last,
                                       target, thresh)
        hist[i] = res0
        last = res0
        i += 1
        if host_bool(stop):
            break
    return cs, hist, i


@lru_cache(maxsize=32)
def make_adf_device_run(shapes_key, dtype_str: str, max_iters: int,
                        rank_one: bool = False, mesh=None):
    """``adf_device_run`` with its static arguments bound: (cores,
    onehots, values, target, min_decrease, res_dec0, last0, remaining) ->
    (cores, hist, count)."""
    return partial(adf_device_run, max_iters=max_iters, rank_one=rank_one,
                   mesh=mesh)


def _bond_masks(ranks: Sequence[int], caps: Sequence[int], device
                ) -> List[torch.Tensor]:
    """Per-bond live masks: mask[k][j] is True iff j < ranks[k] (caps are
    the padded bond sizes)."""
    return [torch.arange(c, device=device) < int(ranks[k])
            for k, c in enumerate(caps)]


def _colmasks(ranks: Sequence[int], caps: Sequence[int], device, dtype
              ) -> Tuple[torch.Tensor, ...]:
    """``_bond_masks`` in ``dtype``: the masks the Q columns are multiplied
    by."""
    return tuple(m.to(dtype) for m in _bond_masks(ranks, caps, device))


def _adf_iteration_masked(cores, onehots, values, ranks, caps, dtype,
                          rank_one: bool = False):
    """One ADF iteration at PADDED shapes with live-rank masks.

    Invariant: every core enters with exactly-zero dead bond slots
    (beyond ``ranks``).  The stacks, gradients and step sizes then stay
    exactly zero on dead slots (every contraction factors through a masked
    core); the only place junk can appear is the Q of each QR (Householder
    completes an orthonormal basis in the dead columns), so Q columns are
    re-masked after every factorization.  The matching R rows are zero
    already, so masking is an exact identity on the represented tensor."""
    colmask = _colmasks(ranks, caps, values.device, dtype)
    return _sweep(cores, onehots, values, rank_one, colmask)


def _canonicalize_left_masked(cs, ranks, caps, dtype) -> Cores:
    """Right-to-left QR sweep at padded shapes; Q columns re-masked (see
    _adf_iteration_masked)."""
    return _canonicalize_left_colmask(cs, _colmasks(ranks, caps,
                                                    cs[0].device, dtype))


def _canonicalize_left_colmask(cs, colmask) -> Cores:
    """``_canonicalize_left_masked`` with the masks given as tensors."""
    cs = list(cs)
    for i in range(len(cs) - 1, 0, -1):
        rl, n, rr = cs[i].shape
        q, r = torch.linalg.qr(cs[i].reshape(rl, n * rr).T)
        q = q * colmask[i - 1][None, :]
        cs[i] = q.T.reshape(q.shape[1], n, rr)
        cs[i - 1] = torch.einsum("anb,bk->ank", cs[i - 1], r.T)
    return tuple(cs)


def _adaptive_step(cores, onehots, values, colmask, res_dec, last, target,
                   thresh, rank_one: bool = False):
    """One iteration of the rank-adaptive solve at padded shapes: the
    masked iteration, the masked left canonicalization, the stagnation
    window and the flags.  Returns (cores, res0, res_dec, flags) with
    flags = [level stop, converged]."""
    new, res0 = _sweep(cores, onehots, values, rank_one, colmask)
    cs = _canonicalize_left_colmask(new, colmask)
    res_dec = torch.cat([_ratio(res0, last)[None], res_dec[:3]])
    converged = res0 < target
    return cs, res0, res_dec, torch.stack(
        [converged | (torch.prod(res_dec) > thresh), converged])


@factory(32)
def _make_adaptive_step(shapes_key, dtype_str: str, rank_one: bool
                        ) -> Program:
    return Program(partial(_adaptive_step, rank_one=rank_one),
                   "adf_adaptive_step")


def _bump_cores(cores, ranks, caps, gs: Sequence[torch.Tensor], scale,
                dtype):
    """Rank bump: add ``scale`` times the rank-1 TT of the Gaussian vectors
    ``gs`` (one (n_k,) vector per core), embedded block-diagonally in the
    dead pad slots.

    Per bond k the rank-1 term occupies slot ranks[k] when the bond is
    below its cap (growing it by one) and rides slot 0 when the bond is
    capped.  Each vector is normalized, so the added term has unit
    Frobenius norm before ``scale``.  Returns (cores, new ranks)."""
    d = len(cores)
    new = []
    for k, core in enumerate(cores):
        capL, n, capR = core.shape
        g = gs[k].to(device=core.device, dtype=dtype)
        g = g / (torch.linalg.vector_norm(g) + 1e-30)
        if k == 0:
            eL = core.new_ones((1,))
            g = g * scale
        else:
            slotL = ranks[k - 1] if ranks[k - 1] < caps[k - 1] else 0
            eL = F_nn.one_hot(torch.tensor(slotL), capL).to(core.device,
                                                              dtype)
        if k == d - 1:
            eR = core.new_ones((1,))
        else:
            slotR = ranks[k] if ranks[k] < caps[k] else 0
            eR = F_nn.one_hot(torch.tensor(slotR), capR).to(core.device,
                                                              dtype)
        new.append(core + eL[:, None, None] * g[None, :, None]
                   * eR[None, None, :])
    return tuple(new), [min(int(r) + 1, int(c)) for r, c in zip(ranks, caps)]


def adf_adaptive_run(cores, onehots, values, target, min_decrease,
                     ranks0: Sequence[int], last0, remaining: int,
                     max_iters: int, caps: Sequence[int], bump_scale: float,
                     generator: torch.Generator, rank_one: bool = False,
                     eager: bool = False):
    """The rank-adaptive ADF solve on cores padded to the ``caps`` rank
    vector, live ranks carried on the host.  The stagnation logic per rank
    level is ``adf_device_run``'s, with the window starting empty; when a
    level stagnates above ``target`` with ranks below ``caps``, a
    scale-``bump_scale*||x||`` rank-1 term goes into the dead pad slots
    (``_bump_cores``, vectors drawn from ``generator``), the window
    restarts and the loop goes on.  Each iteration is one replay of a
    captured program whose bond masks are device inputs, rebuilt after
    each bump, so every rank level replays the same graph (``eager``: its
    function run eagerly, the masks built from the host ranks at every
    iteration).  One host read
    per iteration, one more at each level's end while a bond is below its
    cap; the bump runs outside the program.

    Returns (cores, ranks, hist, count)."""
    dtype, dev = values.dtype, values.device
    target = torch.as_tensor(target, dtype=dtype, device=dev)
    thresh = torch.as_tensor(min_decrease, dtype=dtype, device=dev) ** 4
    last = torch.as_tensor(last0, dtype=dtype, device=dev)
    res_dec = values.new_zeros((4,))
    ranks = [int(r) for r in ranks0]
    caps = [int(c) for c in caps]
    onehots = tuple(onehots)
    limit = min(int(max_iters), int(remaining))
    hist = torch.full((max_iters,), -1.0, dtype=dtype, device=dev)
    cs = tuple(cores)
    colmask = _colmasks(ranks, caps, dev, dtype)
    i = 0
    while i < limit:
        masks = _colmasks(ranks, caps, dev, dtype) if eager else colmask
        cs, res0, res_dec, flags = call(
            _make_adaptive_step, (cs, onehots, values, masks, res_dec, last,
                                  target, thresh), rank_one, eager=eager)
        hist[i] = res0
        last = res0
        i += 1
        if not host_bool(flags[0]):
            continue
        if all(r >= c for r, c in zip(ranks, caps)) or host_bool(flags[1]):
            break
        gs = [torch.randn((c.shape[1],), generator=generator,
                          dtype=torch.float64) for c in cs]
        norm_x = torch.linalg.vector_norm(cs[0])   # left-canonical
        cs, ranks = _bump_cores(cs, ranks, caps, gs, bump_scale * norm_x,
                                dtype)
        colmask = _colmasks(ranks, caps, dev, dtype)
        res_dec = torch.zeros_like(res_dec)
    return cs, ranks, hist, i


@lru_cache(maxsize=32)
def make_adf_adaptive_run(shapes_key, dtype_str: str, max_iters: int,
                          caps: Tuple[int, ...], bump_scale: float,
                          generator: torch.Generator, rank_one: bool = False):
    """``adf_adaptive_run`` with its static arguments bound: (cores,
    onehots, values, target, min_decrease, ranks0, last0, remaining) ->
    (cores, ranks, hist, count).  The JAX factory's ``seed`` becomes the
    ``generator`` the bumps draw from."""
    return partial(adf_adaptive_run, max_iters=max_iters, caps=caps,
                   bump_scale=bump_scale, generator=generator,
                   rank_one=rank_one)


def build_onehots(positions: torch.Tensor, dims: Sequence[int], dtype
                  ) -> Tuple[torch.Tensor, ...]:
    """Per-mode one-hot matrices (M, n_k) from int64 positions (M, d), on
    the positions' device."""
    return tuple(F_nn.one_hot(positions[:, k], int(n)).to(dtype)
                 for k, n in enumerate(dims))
