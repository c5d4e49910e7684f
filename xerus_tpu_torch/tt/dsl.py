"""DSL assignment into TT targets: the port of ``xerus_tpu.tt.dsl``.

It replaces the reference's specialized contraction/sum/evaluation hooks and the
lazy TTStack (src/xerus/ttNetwork.cpp:889-1013, src/xerus/ttStack.cpp): when
the RHS is recognizably TT-structured (scaled TT copies, TT sums, chains of
TTOperators applied to a TT), the result is built exactly in TT form via
per-site zip contractions; anything else evaluates densely and is re-compressed
with an exact TT-SVD.  ``tt_assign.dense_fallbacks`` counts the
assignments that took the dense route, so a caller can check that a
full-width expression stayed in TT form.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .ttnetwork import TTNetwork, TTTensor, apply_operator

Label = Tuple[int, int]


def _tt_labels(it) -> Optional[List[Label]]:
    """Resolved per-mode labels if obj is a TTNetwork, else None."""
    if not isinstance(it.obj, TTNetwork):
        return None
    labels, fixed = it.resolved()
    if any(f is not None for f in fixed):
        return None
    return labels


def _halves(labels: List[Label]) -> Tuple[List[Label], List[Label]]:
    h = len(labels) // 2
    return labels[:h], labels[h:]


def tt_assign(target: TTNetwork, lhs, rhs) -> None:
    from ..indexing import evaluate as ev

    lhs_labels = ev._resolve_lhs_labels(lhs, rhs)

    result = _try_tt_eval(type(target), lhs_labels, rhs)
    if result is None:
        # dense fallback: evaluate, then exact TT-SVD (specialized_evaluation
        # fallback, ttNetwork.cpp "casting to Tensor first")
        tt_assign.dense_fallbacks += 1
        dense, _ = ev._eval_expr(rhs, lhs_labels)
        result = type(target)(dense)
    _write_tt(target, result)


tt_assign.dense_fallbacks = 0


def _write_tt(target: TTNetwork, result: TTNetwork) -> None:
    target.components = result.components
    target.canonicalized = result.canonicalized
    target.corePosition = result.corePosition
    target.dimensions = result.dimensions


def _try_tt_eval(cls, lhs_labels, rhs) -> Optional[TTNetwork]:
    from ..indexing.expressions import IndexedTensor, Product, Sum

    if isinstance(rhs, IndexedTensor):
        rhs = Product([rhs])

    if isinstance(rhs, Sum):
        acc: Optional[TTNetwork] = None
        for coeff, term in rhs.terms:
            part = _try_tt_eval(cls, lhs_labels, term)
            if part is None:
                return None
            part = part.copy() if part.components is not None else part
            part *= coeff
            if acc is None:
                acc = part
            else:
                acc += part
        return acc

    if not isinstance(rhs, Product):
        return None
    if not all(isinstance(f, IndexedTensor) for f in rhs.factors):
        return None

    factor_labels = []
    for f in rhs.factors:
        labs = _tt_labels(f)
        if labs is None:
            return None
        factor_labels.append(labs)

    scalar = rhs.scalar

    vecs = [(f, l) for f, l in zip(rhs.factors, factor_labels)
            if not f.obj.is_operator]
    ops = [(f, l) for f, l in zip(rhs.factors, factor_labels)
           if f.obj.is_operator]

    if cls is TTTensor or (not cls.is_operator):
        if len(vecs) != 1:
            return None
        current = vecs[0][0].obj.copy()
        cur_labels = list(vecs[0][1])
        remaining = list(ops)
        while remaining:
            hit = None
            for idx, (f, labs) in enumerate(remaining):
                out_h, in_h = _halves(labs)
                if in_h == cur_labels:
                    hit = (idx, False, out_h)
                    break
                if out_h == cur_labels:
                    hit = (idx, True, in_h)
                    break
            if hit is None:
                return None
            idx, transposed, new_labels = hit
            current = apply_operator(remaining[idx][0].obj, current, transposed)
            cur_labels = list(new_labels)
            del remaining[idx]
        if cur_labels != list(lhs_labels):
            return None
        if scalar != 1.0:
            current *= scalar
        return current

    # Operator target: compose a chain of TTOperators
    if vecs or not ops:
        return None
    out_target, in_target = _halves(list(lhs_labels))
    # find the bottom factor (its in-half == target in-half)
    current = None
    cur_top = None
    remaining = list(ops)
    for idx, (f, labs) in enumerate(remaining):
        o_h, i_h = _halves(labs)
        if i_h == in_target:
            current = f.obj.copy()
            cur_top = o_h
            del remaining[idx]
            break
        if o_h == in_target:
            current = f.obj.transposed()
            cur_top = i_h
            del remaining[idx]
            break
    if current is None:
        return None
    while remaining:
        hit = None
        for idx, (f, labs) in enumerate(remaining):
            o_h, i_h = _halves(labs)
            if i_h == cur_top:
                hit = (idx, False, o_h)
                break
            if o_h == cur_top:
                hit = (idx, True, i_h)
                break
        if hit is None:
            return None
        idx, transposed, new_top = hit
        current = apply_operator(remaining[idx][0].obj, current, transposed)
        cur_top = new_top
        del remaining[idx]
    if cur_top != out_target:
        return None
    if scalar != 1.0:
        current *= scalar
    return current
