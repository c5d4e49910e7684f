"""Riemannian kit: tangent vectors, retractions, vector transport.

Counterpart of ``xerus_tpu/algorithms/retractions.py``, the re-design of
include/xerus/algorithms/retractions.h and
src/xerus/algorithms/retractions.cpp:28-290.  A ``TTTangentVector`` holds
the projection of a direction onto the tangent space of the rank-r TT
manifold at ``base`` (canonicalized at core 0); per-component math runs as
torch einsums on the objects' device.
"""

from __future__ import annotations

import math
from typing import List

import torch

from ..config import compute_device, require, torch_dtype
from ..core import factorizations as fact
from ..core.tensor import Tensor
from ..tt.ttnetwork import TTTensor


def _one():
    return torch.ones((1, 1), dtype=torch_dtype(), device=compute_device())


class TTTangentVector:
    """Tangent vector at ``base`` (retractions.cpp:82-131)."""

    def __init__(self, base: TTTensor = None, direction: TTTensor = None):
        self.baseL: TTTensor = None
        self.components: List[Tensor] = []
        if base is None:
            return
        require(direction is not None, "need both base and direction")
        require(base.dimensions == direction.dimensions,
                "base/direction dimension mismatch")
        self.baseL = base.copy()
        self.baseL.move_core(0, keep_rank=True)
        self._project(direction)

    def _project(self, direction: TTTensor) -> None:
        d = self.baseL.num_components()
        U = [c._torch() for c in self.baseL.components]
        V = [c._torch() for c in direction.components]

        # left stacks: UV[i], UU[i] cover components < i
        # (retractions.cpp:89-101)
        leftUV, leftUU = [_one()], [_one()]
        for i in range(d - 1):
            leftUV.append(torch.einsum("ab,arj,brk->jk", leftUV[-1], U[i],
                                       V[i]))
            leftUU.append(torch.einsum("ab,arj,brk->jk", leftUU[-1], U[i],
                                       U[i]))
        right = _one()
        comps: List[Tensor] = [None] * d
        for i in range(d - 1, -1, -1):
            uu_inv = fact.pseudo_inverse(Tensor._wrap(leftUU[i]), 1)._torch()
            v = torch.einsum("as,sb,brj,cj->arc", uu_inv, leftUV[i], V[i],
                             right)
            if i != 0:
                # project out the base component's span (gauge condition)
                utv = torch.einsum("arj,brj->ab", v, U[i])
                v = v - torch.einsum("as,srj->arj", utv, U[i])
                right = torch.einsum("jra,krb,ab->jk", U[i], V[i], right)
            comps[i] = Tensor._wrap(v)
        self.components = comps

    # -- arithmetic (retractions.cpp:133-170) ---------------------------
    def __iadd__(self, other: "TTTangentVector") -> "TTTangentVector":
        require(len(self.components) == len(other.components),
                "length mismatch")
        for i in range(len(self.components)):
            self.components[i] += other.components[i]
        return self

    def __isub__(self, other: "TTTangentVector") -> "TTTangentVector":
        for i in range(len(self.components)):
            self.components[i] -= other.components[i]
        return self

    def __imul__(self, alpha: float) -> "TTTangentVector":
        for c in self.components:
            c *= float(alpha)
        return self

    def __mul__(self, alpha: float) -> "TTTangentVector":
        out = self.copy()
        out *= float(alpha)
        return out

    __rmul__ = __mul__

    def __add__(self, other: "TTTangentVector") -> "TTTangentVector":
        out = self.copy()
        out += other
        return out

    def copy(self) -> "TTTangentVector":
        out = TTTangentVector()
        out.baseL = self.baseL.copy()
        out.components = [c.copy() for c in self.components]
        return out

    def set_base(self, new_base: TTTensor) -> None:
        require(new_base.dimensions == self.baseL.dimensions,
                "dimension mismatch")
        self.baseL = new_base.copy()
        self.baseL.move_core(0, keep_rank=True)

    # -- metric (retractions.cpp:172-195) -------------------------------
    def scalar_product(self, other: "TTTangentVector") -> float:
        require(len(self.components) == len(other.components),
                "length mismatch")
        U = [c._torch() for c in self.baseL.components]
        left = _one()
        total = 0.0
        for i in range(len(self.components)):
            a = self.components[i]._torch()
            b = other.components[i]._torch()
            total += float(torch.einsum("xy,xrj,yrj->", left, a, b))
            if i + 1 < len(self.components):
                left = torch.einsum("xy,xrj,yrk->jk", left, U[i], U[i])
        return total

    def frob_norm(self) -> float:
        return math.sqrt(max(self.scalar_product(self), 0.0))

    # -- conversion (retractions.cpp:197-260) ---------------------------
    def _assemble(self, add_base: bool) -> TTTensor:
        """The TT of the tangent vector (or of base + tangent) by the 2x2
        block construction of change_direction_incomplete."""
        base = self.baseL
        d = base.num_components()
        if d == 1:
            result = TTTensor._make([self.components[0].copy()])
            if add_base:
                result += base
            return result
        comps: List[Tensor] = []
        for i in range(d):
            Uc = base.components[i]._torch()
            Vc = self.components[i]._torch()
            if i == 0:
                first = Uc + Vc if add_base else Vc
                block = torch.cat([Uc, first], dim=2)           # (1, n, 2rr)
            elif i < d - 1:
                top = torch.cat([Uc, Vc], dim=2)
                bottom = torch.cat([torch.zeros_like(Uc), Uc], dim=2)
                block = torch.cat([top, bottom], dim=0)         # (2rl, n, 2rr)
            else:
                block = torch.cat([Vc, Uc], dim=0)              # (2rl, n, 1)
            comps.append(Tensor._wrap(block))
        result = TTTensor._make(comps)
        result.move_core(0)
        return result

    def to_tttensor(self) -> TTTensor:
        return self._assemble(add_base=False)

    def added_to_base(self) -> TTTensor:
        return self._assemble(add_base=True)


# ---------------------------------------------------------------------------
# Retractions (retractions.cpp:30-76, 264-281).  Suffix I takes a tangent
# vector, II takes a TT change.
# ---------------------------------------------------------------------------

def HOSVDRetractionI(U: TTTensor, change: TTTangentVector) -> None:
    old_ranks = U.ranks()
    _overwrite(U, change.added_to_base())
    U.round(old_ranks)


def HOSVDRetractionII(U: TTTensor, change: TTTensor) -> None:
    old_ranks = U.ranks()
    _overwrite(U, U + change)
    U.round(old_ranks)


def _rounding_als():
    from .als import ALSVariant
    return ALSVariant(1, 2, "lapack", assume_spd=False)


def ALSRetractionI(U: TTTensor, change: TTTangentVector) -> None:
    _rounding_als()(U, change.added_to_base())


def ALSRetractionII(U: TTTensor, change: TTTensor) -> None:
    _rounding_als()(U, U + change)


def SubmanifoldRetractionI(U: TTTensor, change: TTTangentVector) -> None:
    for i in range(U.num_components()):
        U.components[i] = U.components[i] + change.components[i]
    U.canonicalized = False
    U.move_core(0, keep_rank=True)


def SubmanifoldRetractionII(U: TTTensor, change: TTTensor) -> None:
    SubmanifoldRetractionI(U, TTTangentVector(U, change))


def ProjectiveVectorTransport(new_base: TTTensor,
                              tangent: TTTangentVector) -> None:
    """Transport by re-projection at the new base
    (retractions.cpp:285-289)."""
    new_tv = TTTangentVector(new_base, tangent.to_tttensor())
    tangent.baseL = new_tv.baseL
    tangent.components = new_tv.components


def _overwrite(target: TTTensor, source: TTTensor) -> None:
    target.components = source.components
    target.canonicalized = source.canonicalized
    target.corePosition = source.corePosition
    target.dimensions = source.dimensions


class _CallableWrapper:
    """Copy-constructible callable wrapper matching the reference's Python
    binding classes (python/leastSquares.cpp:83-94): e.g.
    ``TTRetractionI(xt.ALSRetractionI)``."""

    def __init__(self, fn):
        self._fn = fn._fn if isinstance(fn, _CallableWrapper) else fn

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)


class TTRetractionI(_CallableWrapper):
    pass


class TTRetractionII(_CallableWrapper):
    pass


class TTVectorTransport(_CallableWrapper):
    pass
