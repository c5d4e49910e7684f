"""The entry a user calls for each kind of ``warmup``, at a problem
family's shapes: what chip_smoke's ``phase_warmup`` and the warmup tests
call after a warmup to see that the first call replays.

``kind_entries`` returns {name: entry}; ``entry(eager)`` runs the call
(with ``eager`` its function eagerly, the plain version) and returns its
result.  The names are ``warmup``'s, but for "als": the lr and rl
half-sweeps from ``x`` in each form ``warmup`` warms (``als_steps``).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from ..ops import dmrg_kernels as dk
from ..ops import programs
from ..ops.adf_kernels import make_adf_iteration
from ..ops.apply_kernels import apply_operator_rounded_cores
from ..ops.df_rounding import tt_round_df_from_f64
from ..ops.round_uniform import (tt_round_randomized_uniform,
                                 tt_round_streaming_uniform,
                                 tt_round_sweep_uniform)
from ..ops.stacking import pad_cores
from ..warmup import als_steps


def kind_entries(kinds: Sequence[str], x, target: int, *, A=None, b=None,
                 spd: bool = True, oversample: int = 8, H=None,
                 adf=None) -> Dict[str, Callable]:
    """Entries for ``kinds`` (``warmup``'s, "adf_iteration" for the ADF
    iteration) on the cores ``x`` (contiguous, on one device) and the
    rounding target ``target``; ``A`` and ``b`` the operator and
    right-hand side cores of "als" ("apply_round" takes ``A``), ``H`` the
    (d, a, n, n, a) operator stack of "dmrg", ``adf`` (onehots, values)
    of "adf_iteration".  "df_round" rounds ``x`` as float64 host cores
    (its results as CPU tensors)."""
    x = tuple(x)
    out: Dict[str, Callable] = {}
    if "round" in kinds:
        for method in ("gram", "svd"):
            out[f"round_{method}"] = (
                lambda eager, m=method: tt_round_sweep_uniform(x, target, m))
    if "randomized" in kinds:
        out["round_randomized"] = lambda eager: tt_round_randomized_uniform(
            x, target, oversample, eager=eager)
    if "streaming" in kinds:
        out["round_streaming"] = (
            lambda eager: tt_round_streaming_uniform(x, target))
    if "apply_round" in kinds:
        out["apply_round"] = lambda eager: apply_operator_rounded_cores(
            A, x, target, eager=eager)
    if "als" in kinds:
        A, b = tuple(A), tuple(b)

        def als(eager):
            res = []
            for step in als_steps(A, b, spd, eager):
                lr = step(True, x)[0]
                res += [lr, step(False, lr)[0]]
            return res
        out["als"] = als
    if "df_round" in kinds:
        host = [c.double().cpu().numpy() for c in x]
        out["df_round"] = lambda eager: [
            torch.from_numpy(c) for c in tt_round_df_from_f64(
                host, target, device=x[0].device, eager=eager)]
    if "dmrg" in kinds:
        stack, r = pad_cores(x)
        xs, As = dk._row_major(stack), dk._row_major(H)
        out["dmrg_lanczos"] = lambda eager: programs.call(
            dk.make_dmrg_sweep, (xs, As), int(r), "lanczos", 32, eager=eager)
    if "adf_iteration" in kinds:
        onehots, values = adf
        out["adf_iteration"] = lambda eager: programs.call(
            make_adf_iteration, (x, tuple(onehots), values), eager=eager)
    return out
