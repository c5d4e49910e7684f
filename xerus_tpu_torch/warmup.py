"""Builds a problem family's hand kernels and captures its programs before
timed work.

Counterpart of ``xerus_tpu/warmup.py``, which compiles the hot whole-sweep
XLA programs of a family up front.  The port is not compiled ahead of
time either: its hand kernels are built by nvcc at their first launch
(``build.load_kernel_library``) and its programs are captured as CUDA
graphs at their third call per shape key (``ops/programs.py``:
``programs.EAGER_CALLS`` eager calls, then the capture, then replays).  A
job calls ``warmup`` at its start, so that its first timed call at the
family's shapes replays graphs of kernels already loaded.

On the card each kind's entry is called ``programs.EAGER_CALLS + 2``
times, synchronized and timed: the eager calls, the capture and one
replay, since a graph's first launch after its capture takes longer on
the device than its later ones (chip_smoke's ``warmup:`` lines time it).
After that every program the entry reaches at those shapes holds its
graph, launched once, and every kernel it launches is loaded.  The
libraries persist across processes in ``xerus_tpu_torch/_build/`` (as the
JAX package's persistent compilation cache does); the graphs live as long
as the process, or until ``programs.clear()`` gives their memory back
(``programs.held_bytes()`` says how much they hold).  Under ``host()``
each kind runs once eagerly: a program on CPU tensors is its function.

A program is keyed by its inputs' shapes, strides, dtype and device and by
its static arguments as the caller passes them, so a warmup serves only
calls that meet the same keys:

- cores are warmed as contiguous tensors (the layout ``torch.from_numpy``
  and ``convert.cores_to_torch`` give) of the ranks min(rank, n_0 ... n_i,
  n_i+1 ... n_d-1); other ranks or layouts meet other keys;
- ``als`` warms ``make_als_sweep`` as the JAX package's warmup does, and
  also ``make_als_sweep_res`` in the forms the port's ALS solves call it
  (``mixed_precision.f32_half_sweep``, the f32 half-sweeps of
  ``als_f32_df_run`` / ``als_spd_fused``, and ``als_kernels.spd_step`` of
  ``ALS_SPD``; with ``spd=False`` ``als_kernels.rev_step``): the JAX
  package's own ALS solves run its ``make_als_sweep_res``, which its
  warmup leaves cold.  A half-sweep's outputs need not have its inputs'
  strides, so each form runs as a chain lr, rl, lr, ... until a direction
  meets a key again, the chain every solve from those cores walks;
- ``df_round``'s site programs are keyed by the input's ranks and the
  ranks each site keeps; with ``eps`` > 0 those depend on the data, and a
  user's rank-deficient cores can meet keys the random cores do not;
- ``dmrg`` warms the Lanczos half-sweep at 32 iterations as the JAX
  package's warmup does (``dmrg_groundstate_scan(..., solver="lanczos",
  lobpcg_iters=32)``'s shift estimate); ``smallest_eigenvalue`` runs 24
  and its solve runs ``make_dmrg_step``, neither of which it warms;
- ``adf_iteration`` warms ``make_adf_iteration``; the ADF solves' own
  steps (``adf_device_run``) are not warmed, as in the JAX package.

Each factory keeps its latest programs up to its ``maxsize``: 64 for the
ALS sweeps, the randomized rounding and the df rounding's site programs,
32 for the apply + round and the ADF iteration, 16 for the DMRG
half-sweeps and the site-reversed ALS sweep of ``spd=False``.  Warming
more families than that evicts the oldest programs, which are captured
anew at the third call after.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .config import compute_device
from .ops import programs


def _tt_shapes(dims: Sequence[int], rank: int):
    d = len(dims)
    shapes = []
    for i in range(d):
        rl = 1 if i == 0 else min(rank, int(np.prod(dims[:i])),
                                  int(np.prod(dims[i:])))
        rr = 1 if i == d - 1 else min(rank, int(np.prod(dims[:i + 1])),
                                      int(np.prod(dims[i + 1:])))
        shapes.append((rl, dims[i], rr))
    return shapes


def als_steps(A, b, spd: bool, eager: bool = False):
    """The half-sweep forms of the "als" kind on the operator and
    right-hand side cores ``A``, ``b``, each (even, cores) -> (cores,
    ...), lr when ``even``: ``make_als_sweep`` as the JAX package's warmup
    calls it, then the port's ALS solves' calls of
    ``make_als_sweep_res`` (``eager``: the functions run eagerly)."""
    from .ops import als_kernels as ak
    from .ops import mixed_precision as mp

    def jax_form(even, cs):
        return (programs.call(ak.make_als_sweep, (cs, A, b),
                              "lr" if even else "rl", spd, eager=eager),)
    if spd:
        return [jax_form,
                lambda even, cs: mp.f32_half_sweep(cs, A, b, even, eager),
                ak.spd_step(A, b, eager=eager)]
    return [jax_form, ak.rev_step(A, b, eager=eager)]


def warmup(dims: Sequence[int], rank: int,
           target_rank: Optional[int] = None,
           dtype: str = "float32",
           op_rank: int = 0,
           rhs_rank: int = 1,
           spd: bool = True,
           num_measurements: int = 0,
           kinds: Sequence[str] = ("round", "randomized", "als"),
           oversample: int = 8) -> Dict[str, float]:
    """Build the hand kernels and capture the programs of a TT problem
    family (see the module's docstring for what is warmed).

    dims/rank describe the iterate; ``target_rank`` the rounding target
    (default rank//2); ``op_rank`` the rank of the TT operator of "als"
    and "apply_round" (default 3, the QTT Laplace rank) and "dmrg"
    (default 5); ``rhs_rank`` the right-hand side's; ``spd`` picks the ALS
    solves' SPD half-sweeps or, without, the normal equations;
    ``num_measurements`` > 0 warms the ADF iteration.  Extra kinds:
    "streaming", "apply_round", "df_round" (the double-word rounding,
    kernels K1q, K1c and K4) and "dmrg" (the Lanczos half-sweep, kernels
    K4 and K5; uniform mode dimensions only).  Data is random (numpy
    PCG64 seeded 0, as the JAX package draws it) on the compute device.
    Returns {name: seconds} under the JAX package's names: on the card
    the seconds of all the calls of that name (builds, eager runs,
    captures and first replays), on the CPU of its one call."""
    dims = [int(n) for n in dims]
    d = len(dims)
    if "dmrg" in kinds and len(set(dims)) != 1:
        raise ValueError("'dmrg' warmup needs uniform mode dimensions")
    dev = compute_device()
    card = dev.type == "cuda"
    reps = programs.EAGER_CALLS + 2 if card else 1
    target = int(target_rank) if target_rank else max(1, rank // 2)
    rng = np.random.Generator(np.random.PCG64(0))
    times: Dict[str, float] = {}

    def draw(shape):
        return rng.normal(size=shape).astype(dtype) * 0.1

    def on_dev(arrays):
        return tuple(torch.from_numpy(a).to(dev) for a in arrays)

    def sync():
        if card:
            torch.cuda.synchronize(dev)

    def timed(name, fn, *args):
        sync()
        t0 = time.perf_counter()
        out = fn(*args)
        sync()
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0
        return out

    def run(name, fn, *args):
        for _ in range(reps):
            timed(name, fn, *args)

    cores = [draw(s) for s in _tt_shapes(dims, rank)]
    x = on_dev(cores)

    if "round" in kinds:
        from .ops.round_uniform import tt_round_sweep_uniform
        for method in ("gram", "svd"):
            run(f"round_{method}", tt_round_sweep_uniform, x, target, method)
    if "randomized" in kinds:
        from .ops.round_uniform import tt_round_randomized_uniform
        run("round_randomized", tt_round_randomized_uniform, x, target,
            int(oversample))
    if "streaming" in kinds:
        from .ops.round_uniform import tt_round_streaming_uniform
        run("round_streaming", tt_round_streaming_uniform, x, target)
    if "apply_round" in kinds:
        from .ops.apply_kernels import apply_operator_rounded_cores
        a = int(op_rank) or 3
        A = on_dev([draw((1 if i == 0 else a, dims[i], dims[i],
                          1 if i == d - 1 else a)) for i in range(d)])
        run("apply_round", apply_operator_rounded_cores, A, x, target)
    if "als" in kinds:
        a = int(op_rank) or 3
        A = on_dev([draw((1 if i == 0 else a, dims[i], dims[i],
                          1 if i == d - 1 else a)) for i in range(d)])
        b = on_dev([draw(s) for s in _tt_shapes(dims, int(rhs_rank))])
        for step in als_steps(A, b, spd):
            for _ in range(reps):
                cs, seen, even = x, set(), True
                while (key := (even, programs.shapes_key(cs))) not in seen:
                    seen.add(key)
                    cs = timed("als_lr" if even else "als_rl", step, even,
                               cs)[0]
                    even = not even
    if "df_round" in kinds:
        from .ops.df_rounding import tt_round_df_from_f64
        run("df_round", tt_round_df_from_f64,
            [np.asarray(c, np.float64) for c in cores], target)
    if "dmrg" in kinds:
        from .ops import dmrg_kernels as dk
        from .ops.stacking import pad_cores
        a = int(op_rank) or 5
        stack, r = pad_cores(x)
        H = on_dev([draw((d, a, dims[0], dims[0], a))])[0]
        run("dmrg_lanczos", dk._sweep_program(int(r), "lanczos", 32),
            dk._row_major(stack), dk._row_major(H))
    if num_measurements > 0:
        from .ops.adf_kernels import build_onehots, make_adf_iteration
        M = int(num_measurements)
        P = rng.integers(0, np.array(dims), size=(M, d))
        onehots = build_onehots(torch.from_numpy(P).to(dev), dims, x[0].dtype)
        vals = on_dev([rng.normal(size=(M,)).astype(dtype)])[0]
        run("adf_iteration", programs.call, make_adf_iteration,
            (x, onehots, vals))
    return times
