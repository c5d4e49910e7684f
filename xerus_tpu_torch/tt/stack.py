"""Lazy operator-application stack: the port of ``xerus_tpu.tt.stack``.

An API-parity class for ``internal::TTStack`` (include/xerus/ttStack.h,
src/xerus/ttStack.cpp): a deferred product A_k ... A_1 x that contracts
site-by-site on demand.  Inside the DSL the same behavior is reached
automatically (tt/dsl.py applies operators eagerly per-site at assignment,
which is exactly the reference's contract-on-assignment semantics); this
class exists for users who built against the TTStack API, and to defer the
rank-multiplying contraction until after several applications are chained.
"""

from __future__ import annotations

from typing import List

from ..config import require
from .ttnetwork import TTNetwork, TTOperator, apply_operator


class TTStack:
    def __init__(self, operand: TTNetwork):
        self.operand = operand.copy()
        self.ops: List[TTOperator] = []
        self.transposed: List[bool] = []
        # mirrors cannonicalization_required / futureCorePosition (ttStack.h)
        self.cannonicalization_required = False
        self.futureCorePosition = (operand.corePosition
                                   if operand.canonicalized else 0)

    def apply(self, op: TTOperator, transposed: bool = False) -> "TTStack":
        require(op.num_components() == self.operand.num_components(),
                "operator/operand length mismatch")
        self.ops.append(op)
        self.transposed.append(transposed)
        self.cannonicalization_required = True
        return self

    def degree(self) -> int:
        return self.operand.degree()

    def ranks_upper_bound(self) -> List[int]:
        out = list(self.operand.ranks())
        for op in self.ops:
            out = [r * ro for r, ro in zip(out, op.ranks())]
        return out

    def contract(self) -> TTNetwork:
        """Exact site-wise contraction of the whole stack
        (TTStack::contract_stack, ttStack.cpp:197)."""
        result = self.operand.copy()
        for op, tr in zip(self.ops, self.transposed):
            result = apply_operator(op, result, tr)
        if self.cannonicalization_required:
            result.canonicalized = False
            result.move_core(self.futureCorePosition)
        return result

    def to_tttensor(self) -> TTNetwork:
        return self.contract()
