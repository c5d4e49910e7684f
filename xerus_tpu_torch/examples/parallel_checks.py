"""Every entry of the parallel layer against the port's serial path.

``run_checks(device)`` runs on every rank of an initialized process group
(the SPMD contract of ``parallel/mesh.py``: every rank draws the same
inputs from ``set_seed`` and calls with them) and returns, per entry, the
parallel result, the serial result on the same inputs, their distance,
the inputs the JAX package needs to repeat the call, and the wall time of
the parallel and the serial call.  ``misses(results)`` lists the bars of
``BARS`` that a result misses.  The oracles are the JAX package's
(``tests/test_parallel.py``, ``__graft_entry__.py``): tp ALS converges
below 0.1x its start residual and within 1.25x of the serial alternating
chain, dp ADF lands within 1e-8 of the serial solve, the rounding and the
site ops match the serial tensor.

As a script it is one rank of a gloo group on the CPU, and writes its
results (a pickle) under ``--out``:

    python -m xerus_tpu_torch.examples.parallel_checks \\
        --rank R --world N --init file:///tmp/rendezvous --out DIR

(``tests/test_torch_parallel.py`` starts N of them).  On the card,
``chip_smoke.py`` calls ``run_checks`` in a one-rank NCCL group.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time
from typing import Callable, Dict

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

SEED = 0xBAADF00D

# name -> (result key, bar, "max" (value <= bar) or "min" (value >= bar))
BARS = {
    "inner": [("rel", 1e-10, "max")],
    "adf_gradient": [("abs", 1e-10, "max")],
    "als_local_solve": [("abs", 1e-8, "max")],
    "training_step": [("rel", 1e-10, "max")],
    "als_batched": [("abs", 1e-11, "max")],
    "dmrg_batched": [("energy_abs", 1e-10, "max"), ("abs", 1e-10, "max")],
    "tsqr_gram": [("rel", 1e-10, "max"), ("err_rel", 1e-8, "max")],
    "tsqr_subspace": [("err_vs_gram", 1.1, "max"),
                      ("representable_abs", 1e-9, "max")],
    "entrywise": [("rel", 1e-12, "max")],
    "add": [("rel", 1e-12, "max")],
    "tp_half_sweep": [("rel", 1e-8, "max")],
    "tp_solve": [("vs_start", 0.1, "max"), ("vs_serial", 1.25, "max"),
                 ("serial_vs_tp", 1.25, "max")],
    "adf_iteration": [("abs", 1e-12, "max"), ("residual_rel", 1e-12, "max")],
    "adf_multi": [("abs", 1e-12, "max"), ("history_rel", 1e-12, "max")],
    "adf_mesh": [("rel", 1e-8, "max"), ("rel_k5", 1e-8, "max"),
                 ("rel_device", 1e-8, "max")],
    "uq_adf_mesh": [("rel", 1e-10, "max")],
}


def misses(results: Dict[str, dict]):
    """The bars of ``BARS`` the results miss, as readable strings."""
    out = []
    for name, bars in BARS.items():
        r = results.get(name)
        if r is None:
            out.append(f"{name}: not run")
            continue
        for key, bar, kind in bars:
            v = r[key]
            ok = v <= bar if kind == "max" else v >= bar
            if not (ok and np.isfinite(v)):
                out.append(f"{name}.{key} = {v:.3e} ({kind} {bar:g})")
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn: Callable, dev):
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _full(cores) -> np.ndarray:
    out = _np(cores[0]).astype(np.float64)
    for c in cores[1:]:
        out = np.tensordot(out, _np(c).astype(np.float64), axes=1)
    return out.reshape(-1)


def _cores(tt):
    return [c._torch() for c in tt.components]


def _meshes(dev, world: int):
    """(dp mesh, tp mesh, default mesh): every rank on one axis, and the
    default (dp, tp) rule's mesh."""
    from ..parallel import default_mesh
    ranks = torch.arange(world)
    dp = DeviceMesh(dev.type, ranks.reshape(world, 1),
                    mesh_dim_names=("dp", "tp"))
    tp = DeviceMesh(dev.type, ranks.reshape(1, world),
                    mesh_dim_names=("dp", "tp"))
    return dp, tp, default_mesh(world)


def _serial_adf_gradient(cores, P, v):
    cores = [_np(c) for c in cores]
    d = len(cores)
    grad = np.zeros((1,) + cores[0].shape[1:])
    for m in range(P.shape[0]):
        B = np.ones(1)
        for k in range(d - 1, 0, -1):
            B = cores[k][:, P[m, k], :] @ B
        pred = float(cores[0][0, P[m, 0], :] @ B)
        grad[0, P[m, 0], :] += (v[m] - pred) * B
    return grad


def _serial_local_solve(x, A, b):
    from ..ops.als_kernels import _right_envs
    op_r, rhs_r = _right_envs(x, A, b)
    one3 = x[0].new_ones((1, 1, 1))
    Aloc = torch.einsum("uav,amnb,UbV->umUvnV", one3, A[0], op_r[1])
    bloc = torch.einsum("ub,bmB,UB->umU", x[0].new_ones((1, 1)), b[0],
                        rhs_r[1])
    n = bloc.numel()
    return torch.linalg.solve(Aloc.reshape(n, n), bloc.reshape(n)).reshape(
        bloc.shape)


def _serial_inner(a, b):
    env = a[0].new_ones((1, 1))
    for ca, cb in zip(a, b):
        env = torch.einsum("uv,unU,vnV->UV", env, ca, cb)
    return env[0, 0]


def _rel(a, b) -> float:
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _abs(a, b) -> float:
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.abs(a - b).max(initial=0.0))


def run_checks(dev: torch.device, world: int) -> Dict[str, dict]:
    """Run every parallel entry and its serial counterpart on this rank;
    objects compute on ``dev`` (the caller enters ``host()`` for a CPU
    group)."""
    import xerus_tpu_torch as xt
    from .. import parallel as par
    from ..algorithms.uq_adf import randvar_to_position
    from ..ops import adf_kernels as ak
    from ..ops import als_kernels, dmrg_kernels, round_uniform
    from ..ops.stacking import pad_cores
    from ..parallel import site_ops, tp_als
    mesh_dp, mesh_tp, mesh_def = _meshes(dev, world)
    res: Dict[str, dict] = {"_mesh": {
        "default_shape": tuple(mesh_def.mesh.shape),
        "names": tuple(mesh_def.mesh_dim_names),
        "placements": [repr(f(mesh_def)) for f in (
            par.measurement_sharding, par.replicated,
            lambda m: par.mesh.rank_sharding(m, 1, 3))]}}

    def entry(name, par_fn, ser_fn, **extra):
        got, t_par = _timed(par_fn, dev)
        want, t_ser = _timed(ser_fn, dev)
        res[name] = {"par_s": t_par, "ser_s": t_ser, **extra}
        return got, want

    # -- inner product, tp over the physical axis
    xt.set_seed(SEED)
    a, b = (xt.TTTensor.random([4] * 5, 3) for _ in range(2))
    ca, cb = _cores(a), _cores(b)
    got, want = entry("inner", lambda: par.sharded_tt_inner(ca, cb, mesh_tp),
                      lambda: _serial_inner(ca, cb),
                      inputs=([_np(c) for c in ca], [_np(c) for c in cb]))
    res["inner"].update(rel=abs(float(got) - float(want)) / abs(float(want)),
                        value=float(got))

    # -- ADF gradient, dp over the measurements
    rng = np.random.default_rng(SEED)
    tt = xt.TTTensor.random([3] * 4, 2)
    P = rng.integers(0, 3, size=(24, 4))
    v = rng.normal(size=(24,))
    cg = _cores(tt)
    got, want = entry("adf_gradient",
                      lambda: par.sharded_adf_gradient(cg, P, v, mesh_dp),
                      lambda: _serial_adf_gradient(cg, P, v),
                      inputs=([_np(c) for c in cg], P, v))
    res["adf_gradient"].update(abs=_abs(got, want), value=_np(got))

    # -- ALS local solve, tp over the operator rank axis
    A = xt.examples.laplace_operator([2] * 5)
    x = xt.TTTensor.random([2] * 5, 2)
    bb = xt.TTTensor.ones([2] * 5)
    xs, As, bs = _cores(x), _cores(A), _cores(bb)
    got, want = entry("als_local_solve",
                      lambda: par.sharded_als_local_solve(xs, As, bs, mesh_tp),
                      lambda: _serial_local_solve(xs, As, bs),
                      inputs=tuple([_np(c) for c in cs]
                                   for cs in (xs, As, bs)))
    res["als_local_solve"].update(abs=_abs(got, want), value=_np(got))

    # -- the combined step on the default mesh, against its parts serially
    xt.set_seed(SEED + 1)
    (grad, sol, ip), t_par = _timed(
        lambda: par.multichip_training_step(mesh_def), dev)
    xt.set_seed(SEED + 1)
    from .. import misc as _misc
    r = _misc.randomEngine
    d6 = 6
    mk = [[r.normal(size=(1 if i == 0 else 3, 2, 1 if i == d6 - 1 else 3))
           for i in range(d6)] for _ in range(2)]
    Acs = []
    for i in range(d6):
        rl, rr = (1 if i == 0 else 2), (1 if i == d6 - 1 else 2)
        Acs.append(r.normal(size=(rl, 2, 2, rr))
                   + np.eye(2)[None, :, :, None] * (3.0 if rl == rr == 1
                                                    else 0.0))
    Pm = r.integers(0, 2, size=(32, d6))
    vm = r.normal(size=(32,))
    tx = [torch.as_tensor(c, device=dev) for c in mk[0]]
    tb = [torch.as_tensor(c, device=dev) for c in mk[1]]
    tA = [torch.as_tensor(c, device=dev) for c in Acs]
    ser = (_serial_adf_gradient(tx, Pm, vm), _serial_local_solve(tx, tA, tb),
           float(_serial_inner(tx, tb)))
    res["training_step"] = {"par_s": t_par, "ser_s": float("nan"),
                            "rel": max(_rel(grad, ser[0]), _rel(sol, ser[1]),
                                       abs(ip - ser[2]) / abs(ser[2]))}

    # -- batched ALS / DMRG half-sweeps, dp over the instances
    xt.set_seed(SEED + 2)
    A6 = xt.examples.laplace_operator([2] * 6)
    A6c = _cores(A6)
    inst_x, inst_b = [], []
    for _ in range(4):
        xi = xt.TTTensor.random([2] * 6, 3)
        xi.canonicalize_left()
        inst_x.append(_cores(xi))
        inst_b.append(_cores(xt.TTTensor.random([2] * 6, 2)))
    xb = [torch.stack([inst_x[i][k] for i in range(4)]) for k in range(6)]
    bbat = [torch.stack([inst_b[i][k] for i in range(4)]) for k in range(6)]
    got, want = entry(
        "als_batched",
        lambda: par.sharded_ops.sharded_als_half_sweep_batched(
            xb, A6c, bbat, mesh_dp),
        lambda: als_kernels.als_half_sweep_batched(xb, A6c, bbat))
    res["als_batched"]["abs"] = max(_abs(g, w) for g, w in zip(got, want))

    H = xt.examples.heisenberg_mpo(6)
    A_stack = dmrg_kernels._pad_operator_stack(_cores(H))
    stacks = []
    for _ in range(4):
        xi = xt.TTTensor.random([2] * 6, 8)
        xi.move_core(0)
        xi /= xi.frob_norm()
        stacks.append(pad_cores(_cores(xi))[0])
    x_stacks = torch.stack(stacks)
    (g_out, g_e), (w_out, w_e) = entry(
        "dmrg_batched",
        lambda: par.sharded_ops.sharded_dmrg_half_sweep_batched(
            x_stacks, A_stack, 8, mesh_dp, lobpcg_iters=16),
        lambda: dmrg_kernels.dmrg_half_sweep_batched(x_stacks, A_stack, 8,
                                                     lobpcg_iters=16),
        inputs=(_np(x_stacks), _np(A_stack)))
    res["dmrg_batched"].update(energy_abs=_abs(g_e, w_e),
                               abs=_abs(g_out, w_out), energies=_np(g_e))

    # -- TSQR rounding, tp over the rank axis
    xt.set_seed(SEED + 3)
    t = xt.TTTensor.random([2] * 8, 12) + xt.TTTensor.random([2] * 8, 3)
    ct = _cores(t)
    exact = _full(ct)
    got, want = entry(
        "tsqr_gram", lambda: par.tt_round_tsqr(ct, 6, mesh_tp, axis="tp"),
        lambda: round_uniform.tt_round_sweep_uniform(ct, 6, method="gram"),
        inputs=[_np(c) for c in ct])
    e_got = np.linalg.norm(_full(got) - exact)
    e_ref = np.linalg.norm(_full(want) - exact)
    res["tsqr_gram"].update(rel=_rel(_full(got), _full(want)),
                            err_rel=abs(e_got - e_ref) / e_ref,
                            err=float(e_got), value=_full(got))
    sub, t_sub = _timed(lambda: par.tt_round_tsqr(ct, 6, mesh_tp,
                                                  method="subspace"), dev)
    t2 = xt.TTTensor.random([2] * 8, 4)
    s2 = par.tt_round_tsqr(_cores(t2), 8, mesh_tp, method="subspace")
    res["tsqr_subspace"] = {
        "par_s": t_sub, "ser_s": res["tsqr_gram"]["ser_s"],
        "err_vs_gram": float(np.linalg.norm(_full(sub) - exact)
                             / (e_got + 1e-300)),
        "representable_abs": _abs(_full(s2), _full(_cores(t2)))}

    # -- site-sharded TT arithmetic, dp over the sites
    for name, fn, dense in (
            ("entrywise", site_ops.tt_entrywise_product_sharded,
             np.multiply),
            ("add", site_ops.tt_add_sharded, np.add)):
        worst, ranks_ok, t_par = 0.0, True, 0.0
        for d in (6, 11):
            xt.set_seed(SEED + d)
            sa = xt.TTTensor.random([2] * d, 3)
            sb = xt.TTTensor.random([2] * d, 2)
            out, secs = _timed(lambda: fn(_cores(sa), _cores(sb), mesh_dp),
                               dev)
            t_par += secs
            want = dense(_full(_cores(sa)), _full(_cores(sb)))
            worst = max(worst, _abs(_full(out), want) / np.abs(want).max())
            op = (lambda p, q: p * q) if name == "entrywise" else \
                (lambda p, q: p + q)
            ranks_ok &= all(
                out[k].shape[2] == op(sa.components[k].dimensions[2],
                                      sb.components[k].dimensions[2])
                for k in range(d - 1))
        res[name] = {"par_s": t_par, "ser_s": float("nan"),
                     "rel": worst if ranks_ok else float("inf")}

    # -- tensor-parallel ALS: one half-sweep, then the whole solve
    xt.set_seed(SEED + 4)
    x6 = xt.TTTensor.random([2] * 6, 3)
    x6.canonicalize_left()
    b6 = xt.TTTensor.random([2] * 6, 2)
    cx, cb6 = _cores(x6), _cores(b6)
    got, want = entry(
        "tp_half_sweep",
        lambda: tp_als.tp_als_half_sweep(cx, A6c, cb6, mesh_tp, cg_iters=200),
        lambda: als_kernels._als_half_sweep(cx, A6c, cb6),
        inputs=([_np(c) for c in cx], [_np(c) for c in A6c],
                [_np(c) for c in cb6]))
    res["tp_half_sweep"].update(rel=_rel(_full(got), _full(want)),
                                value=_full(got))

    xt.set_seed(SEED + 5)
    x0 = xt.TTTensor.random([2] * 6, 3)
    x0.canonicalize_left()
    b1 = xt.TTTensor.ones([2] * 6)
    f32 = [[c.float() for c in _cores(o)] for o in (x0, A6, b1)]
    Ad = A6.to_tensor().to_ndarray().reshape(64, 64)
    bd = _full(f32[2])

    def rel_res(cs):
        return float(np.linalg.norm(Ad @ _full(cs) - bd) / np.linalg.norm(bd))

    def serial_chain():
        xs_, As_, bs_ = f32
        rev = False
        for _ in range(4):
            xs_ = tp_als._reverse_chain(als_kernels._als_half_sweep(
                xs_, As_, bs_))
            As_ = tp_als._reverse_chain(As_, operator=True)
            bs_ = tp_als._reverse_chain(bs_)
            rev = not rev
        return tp_als._reverse_chain(xs_) if rev else xs_

    got, want = entry(
        "tp_solve",
        lambda: tp_als.tp_als_solve(*f32, mesh_tp, num_half_sweeps=4,
                                    cg_iters=128),
        serial_chain)
    r_tp, r_ser, r0 = rel_res(got), rel_res(want), rel_res(f32[0])
    res["tp_solve"].update(residual=r_tp, serial_residual=r_ser,
                           start_residual=r0, vs_start=r_tp / r0,
                           vs_serial=(r_tp - 1e-5) / r_ser,
                           serial_vs_tp=(r_ser - 1e-5) / r_tp)

    # -- ADF iterations, dp over the measurements
    xt.set_seed(SEED + 6)
    tt5 = xt.TTTensor.random([3] * 5, 3)
    P5 = xt.misc.randomEngine.integers(0, 3, size=(48, 5))
    vals = torch.as_tensor(xt.misc.randomEngine.normal(size=(48,)),
                           device=dev)
    c5 = tuple(_cores(tt5))
    oh = ak.build_onehots(torch.as_tensor(P5, device=dev), [3] * 5,
                          c5[0].dtype)
    (g_c, g_r), (w_c, w_r) = entry(
        "adf_iteration", lambda: ak.adf_iteration_sharded(c5, oh, vals,
                                                          mesh_dp),
        lambda: ak._adf_iteration(c5, oh, vals))
    res["adf_iteration"].update(
        abs=max(_abs(g, w) for g, w in zip(g_c, w_c)),
        residual_rel=abs(float(g_r) - float(w_r)) / float(w_r))
    (g_c, g_h), (w_c, w_h) = entry(
        "adf_multi",
        lambda: ak.adf_multi_iteration_sharded(c5, oh, vals, 4, mesh_dp),
        lambda: ak.adf_multi_iteration(c5, oh, vals, 4))
    res["adf_multi"].update(abs=max(_abs(g, w) for g, w in zip(g_c, w_c)),
                            history_rel=_rel(g_h, w_h))

    # -- ADFVariant(mesh=): the serial solution within 1e-8
    xt.set_seed(3)
    truth = xt.TTTensor.random([3] * 5, 2)
    arr = truth.to_tensor().to_ndarray()
    ms = xt.SinglePointMeasurementSet()
    for p in np.random.default_rng(0).integers(0, 3, size=(200, 5)):
        ms.add([int(q) for q in p], float(arr[tuple(p)]))
    x1 = xt.TTTensor.random([3] * 5, 2)
    adf = xt.ADFVariant(25, 1e-10, 0.999)
    out = {}
    for key, kw in (("", {}), ("_k5", {"check_every": 5}),
                    ("_device", {"check_every": "device",
                                 "max_ranks": [2] * 4})):
        xa, xb_ = x1.copy(), x1.copy()
        xt.set_seed(7)
        (_, t_par) = _timed(lambda: adf(xb_, ms, mesh=mesh_dp, **kw), dev)
        xt.set_seed(7)
        (_, t_ser) = _timed(lambda: adf(xa, ms, **kw), dev)
        fa, fb = (o.to_tensor().to_ndarray() for o in (xa, xb_))
        out["rel" + key] = float(np.linalg.norm(fa - fb) / np.linalg.norm(fa))
        out["par_s" + key], out["ser_s" + key] = t_par, t_ser
        out["value" + key] = fb.reshape(-1)
    res["adf_mesh"] = out

    # -- uq_adf(mesh=): the serial run
    xt.set_seed(SEED + 7)
    dims = [4, 3, 3]
    truth = xt.TTTensor.random(dims, 2)
    truth /= truth.frob_norm()
    rng = np.random.default_rng(21)
    arr = truth.to_tensor().to_ndarray()
    rvs, sols = [], []
    for _ in range(64):
        rv = [float(rng.normal()), float(rng.normal())]
        sols.append(xt.Tensor.from_ndarray(np.einsum(
            "abc,b,c->a", arr, randvar_to_position(rv[0], 3),
            randvar_to_position(rv[1], 3))))
        rvs.append(rv)
    x0 = xt.TTTensor.random(dims, 2)
    xa, xb_ = x0.copy(), x0.copy()
    _, t_ser = _timed(lambda: xt.uq_adf(xa, rvs, sols, max_iterations=40),
                      dev)
    _, t_par = _timed(lambda: xt.uq_adf(xb_, rvs, sols, max_iterations=40,
                                        mesh=mesh_dp), dev)
    fa, fb = (o.to_tensor().to_ndarray() for o in (xa, xb_))
    res["uq_adf_mesh"] = {"par_s": t_par, "ser_s": t_ser,
                          "value": fb.reshape(-1),
                          "rel": float(np.linalg.norm(fa - fb)
                                       / np.linalg.norm(fa))}
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True,
                    help="rendezvous: file://<path> or tcp://localhost:<port>")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    # one intra-op thread per rank: N ranks share the host's cores
    torch.set_num_threads(1)
    import xerus_tpu_torch as xt
    from ..parallel.mesh import process_group
    with process_group("gloo", args.init, args.rank, args.world), xt.host():
        res = run_checks(torch.device("cpu"), args.world)
    with open(os.path.join(args.out, f"rank{args.rank}.pkl"), "wb") as fh:
        pickle.dump(res, fh)


if __name__ == "__main__":
    main()
