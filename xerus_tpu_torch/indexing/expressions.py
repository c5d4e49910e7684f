"""Lazy indexed-tensor expressions.

The port of ``xerus_tpu.indexing.expressions``, the reference's
expression-template frontend (include/xerus/indexedTensor*.h,
src/xerus/indexedTensor*.cpp): a small Python expression tree, evaluated on
assignment (``lhs << rhs``, the Python binding's operator,
src/xerus/python/indexedTensor.cpp:102-147) as a cached plan of pairwise
contractions (indexing/evaluate.py).  Operands are Tensors,
TensorNetworks and TTNetworks; an expression of TTs keeps its norm in TT
form (``Expression.frob_norm``).

Supported grammar (indexedTensorReadOnly.h:112-166):
  expr := IndexedTensor | expr * expr | expr +/- expr | scalar * expr
        | expr / scalar | b_expr / A_expr          (solve)
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import require
from .index import Index, as_index

Number = (int, float, np.integer, np.floating)


class Expression:
    """Base class providing the operator algebra."""

    def __mul__(self, other):
        if isinstance(other, Number):
            return _scaled(self, float(other))
        if isinstance(other, Expression):
            return Product.of(self, other)
        return NotImplemented

    def __rmul__(self, other):
        if isinstance(other, Number):
            return _scaled(self, float(other))
        return NotImplemented

    def __truediv__(self, other):
        if isinstance(other, Number):
            return _scaled(self, 1.0 / float(other))
        if isinstance(other, Expression):
            return SolveExpr(A=other, b=self)  # x(i) << b(j) / A(j,i)
        return NotImplemented

    # reference binding name (python/indexedTensor.cpp:119)
    __div__ = __truediv__

    def __add__(self, other):
        if isinstance(other, Expression):
            return Sum.of(self, 1.0, other, 1.0)
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, Expression):
            return Sum.of(self, 1.0, other, -1.0)
        return NotImplemented

    def __neg__(self):
        return _scaled(self, -1.0)

    # evaluation-to-value helpers -------------------------------------
    def _to_tensor(self):
        from .evaluate import evaluate_to_tensor
        return evaluate_to_tensor(self, None)

    def _try_tt(self):
        """Structured TT evaluation of this expression: a TTNetwork, or
        None where the expression is not TT-shaped.  Keeps
        frob_norm(A(..)*x(..) - b(..)) in TT form instead of densifying
        (the reference's TTStack lazy path).  Unlike the JAX package, which
        returns None on any exception and then densifies, an error raised
        while evaluating a TT-shaped expression reaches the caller: at
        d=32 the dense route would need 2^32 entries on the card."""
        from ..tt.ttnetwork import TTTensor, TTOperator
        from ..tt.dsl import _try_tt_eval
        labels = _open_label_order(self)
        if labels is None:
            return None
        for cls in (TTTensor, TTOperator):
            out = _try_tt_eval(cls, labels, self)
            if out is not None:
                return out
        return None

    def frob_norm(self) -> float:
        tt = self._try_tt()
        if tt is not None:
            return tt.frob_norm()
        if _has_tt_operand(self):
            from ..tt.dsl import tt_assign
            tt_assign.dense_fallbacks += 1
        return self._to_tensor().frob_norm()

    def __float__(self) -> float:
        t = self._to_tensor()
        require(t.degree() == 0, "cannot cast non-scalar expression to float")
        return float(t[0])

    @property
    def value(self) -> float:
        return float(self)


def _open_label_order(expr: "Expression"):
    """Open labels of an expression in appearance order, or None."""
    from .evaluate import _resolve_term, _open_labels
    if isinstance(expr, Sum):
        return _open_label_order(expr.terms[0][1])
    if isinstance(expr, IndexedTensor):
        expr = Product([expr])
    if not isinstance(expr, Product):
        return None
    terms = []
    for f in expr.factors:
        terms.extend(_resolve_term(f))
    return _open_labels(terms)


def _has_tt_operand(expr: "Expression") -> bool:
    from ..tt.ttnetwork import TTNetwork
    if isinstance(expr, IndexedTensor):
        return isinstance(expr.obj, TTNetwork)
    if isinstance(expr, Product):
        return any(_has_tt_operand(f) for f in expr.factors)
    if isinstance(expr, Sum):
        return any(_has_tt_operand(t) for _, t in expr.terms)
    if isinstance(expr, SolveExpr):
        return _has_tt_operand(expr.A) or _has_tt_operand(expr.b)
    return False


def _scaled(expr: "Expression", s: float) -> "Expression":
    if isinstance(expr, Product):
        return Product(expr.factors, expr.scalar * s)
    if isinstance(expr, Sum):
        return Sum([(c * s, t) for c, t in expr.terms])
    if isinstance(expr, SolveExpr):
        return SolveExpr(expr.A, _scaled(expr.b, s))
    return Product([expr], s)


class IndexedTensor(Expression):
    """A tensor-like object together with its index tuple.

    ``obj`` is a core Tensor, a TensorNetwork or a TTNetwork; writability
    follows the reference's IndexedTensor vs IndexedTensorReadOnly split:
    here every IndexedTensor may be an assignment target via ``<<``.
    """

    def __init__(self, obj, indices: Sequence):
        self.obj = obj
        self.indices: List[Index] = [as_index(i) for i in indices]

    # -- span resolution (indexedTensorReadOnly.cpp get_assigned_indices) --
    def resolved(self) -> Tuple[List[Tuple[int, int]], List[Optional[int]]]:
        """Returns (labels, fixed) of length degree.

        labels[m] = (value_id, k) for the k-th mode covered by that index;
        fixed[m] = fixed position or None.
        """
        degree = self.obj.degree()
        labels: List[Tuple[int, int]] = []
        fixed: List[Optional[int]] = []
        for idx in self.indices:
            span = idx.actual_span(degree)
            if idx.fixed():
                labels.append((-1, len(labels)))
                fixed.append(idx.fixed_position)
            else:
                for k in range(span):
                    labels.append((idx.value_id, k))
                    fixed.append(None)
        require(len(labels) == degree,
                f"index spans sum to {len(labels)} but object has degree {degree}")
        return labels, fixed

    # -- assignment («) ------------------------------------------------
    def __lshift__(self, rhs) -> None:
        from .evaluate import assign
        require(isinstance(rhs, (Expression, Factorisation)),
                "can only assign expressions")
        if isinstance(rhs, Factorisation):
            rhs.apply([self])
            return
        assign(self, rhs)

    def __repr__(self) -> str:
        return f"IndexedTensor({type(self.obj).__name__}, {self.indices})"


class Product(Expression):
    def __init__(self, factors: Sequence[IndexedTensor], scalar: float = 1.0):
        self.factors: List[IndexedTensor] = list(factors)
        self.scalar = float(scalar)

    @staticmethod
    def of(a: Expression, b: Expression) -> "Product":
        fa, sa = (a.factors, a.scalar) if isinstance(a, Product) else ([a], 1.0)
        fb, sb = (b.factors, b.scalar) if isinstance(b, Product) else ([b], 1.0)
        factors = [Product._materialize(f) for f in fa + fb]
        return Product(factors, sa * sb)

    @staticmethod
    def _materialize(factor: Expression) -> "IndexedTensor":
        """Sums/solves inside a product evaluate to a temporary first (the
        reference handles this through IndexedTensorMoveable temporaries)."""
        if isinstance(factor, IndexedTensor):
            return factor
        from .evaluate import _eval_expr
        from .index import Index
        tensor, labels = _eval_expr(factor, None)
        idx_objs = []
        seen = {}
        for vid, _k in labels:
            if vid not in seen:
                seen[vid] = Index(_value_id=vid)
                idx_objs.append(seen[vid])
        # rebuild index list with spans matching consecutive label runs
        spans = {}
        for vid, _k in labels:
            spans[vid] = spans.get(vid, 0) + 1
        rebuilt = [seen[vid] ** spans[vid] if spans[vid] > 1 else seen[vid]
                   for vid in seen]
        return IndexedTensor(tensor, rebuilt)


class Sum(Expression):
    def __init__(self, terms: Sequence[Tuple[float, Expression]]):
        self.terms: List[Tuple[float, Expression]] = list(terms)

    @staticmethod
    def of(a: Expression, ca: float, b: Expression, cb: float) -> "Sum":
        ta = a.terms if isinstance(a, Sum) else [(1.0, a)]
        tb = b.terms if isinstance(b, Sum) else [(1.0, b)]
        return Sum([(c * ca, t) for c, t in ta] + [(c * cb, t) for c, t in tb])


class SolveExpr(Expression):
    """b / A: the solution x of A x = b (indexedTensorReadOnly.h:163-166)."""

    def __init__(self, A: Expression, b: Expression):
        self.A = A
        self.b = b


class Factorisation:
    """Multi-output factorization target: ``(Q(i,r), R(r,j)) << QR(A(i,j))``
    (indexedTensor_tensor_factorisations.h:40-100, python binding
    factorizations.cpp:31-37 uses __rlshift__ on the tuple)."""

    kind = ""

    def __init__(self, source: IndexedTensor, max_rank: int = 0, eps: float = 0.0,
                 soft_threshold: float = 0.0):
        require(isinstance(source, IndexedTensor),
                "factorisation source must be a plain indexed tensor")
        self.source = source
        self.max_rank = max_rank
        self.eps = eps
        self.soft_threshold = soft_threshold

    def __rlshift__(self, targets) -> None:
        require(isinstance(targets, (tuple, list)),
                "factorisation targets must be a tuple of indexed tensors")
        self.apply(list(targets))

    def apply(self, targets: List[IndexedTensor]) -> None:
        from .evaluate import assign_factorisation
        assign_factorisation(self, targets)


class SVD(Factorisation):
    kind = "svd"

    def __init__(self, source, max_rank: int = 0, eps: Optional[float] = None,
                 soft_threshold: float = 0.0, maxRank: int = 0,
                 softThreshold: float = 0.0):
        # maxRank/softThreshold: reference python binding spellings
        # (factorizations.cpp SVD args) accepted as aliases
        from ..config import config
        super().__init__(source, max_rank or maxRank,
                         config.epsilon if eps is None else eps,
                         soft_threshold or softThreshold)


class QR(Factorisation):
    kind = "qr"


class RQ(Factorisation):
    kind = "rq"


class QC(Factorisation):
    kind = "qc"


class CQ(Factorisation):
    kind = "cq"
