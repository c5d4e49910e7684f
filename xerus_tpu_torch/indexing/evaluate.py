"""Expression evaluation: resolve -> planned pairwise contractions ->
assignment.

The port of ``xerus_tpu.indexing.evaluate`` (the reference's
src/xerus/indexedTensorWritable.cpp:60-80,
src/xerus/indexedTensor_tensor_evaluate.cpp:248,
src/xerus/tensorNetwork.cpp:1253).  At assignment the expression tree is
resolved to labelled operands, and their contraction order is planned once
per (structure, shapes) signature and cached: numpy's greedy einsum
path rule on the shapes, for any number of indices (the JAX package's
``jnp.einsum(optimize="auto")`` plans with opt_einsum, which the card's
machine lacks, and torch.einsum without it contracts left to right).  The plan runs as traces and
``torch.tensordot`` steps on the compute device.

Sparse-representation-preserving fast paths (permutations, pairwise
contractions) route through core.contract / core.reshuffle instead.
"""

from __future__ import annotations

import itertools
import math
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import require
from ..core.tensor import Representation, Tensor, reshuffle as core_reshuffle
from ..core.contract import contract as core_contract
from ..core import factorizations as fact
from .expressions import (Expression, IndexedTensor, Product, Sum, SolveExpr,
                          Factorisation)

Label = Tuple[int, int]
Plan = Tuple[Tuple[int, ...], ...]


# ---------------------------------------------------------------------------
# Planned contraction
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8192)
def contraction_plan(op_labels: Tuple[Tuple[int, ...], ...],
                     out_labels: Tuple[int, ...],
                     shapes: Tuple[Tuple[int, ...], ...]) -> Plan:
    """The pairwise order for operands with canonical int labels, in
    numpy's einsum_path form (the chosen operands leave the list, their
    product joins its end): the path ``np.einsum_path(...,
    optimize="greedy")`` takes, for any number of indices (numpy's einsum
    takes at most 52, a TT expanded into its cores at d > 17 has more).
    A step that numpy leaves to einsum whole (nothing to sum, or no pair
    within its memory and cost limits) runs as pairwise steps in order."""
    dims: Dict[int, int] = {}
    for labs, shape in zip(op_labels, shapes):
        dims.update(zip(labs, shape))
    sets = [frozenset(labs) for labs in op_labels]
    if len(sets) <= 2 or set(dims) == set(out_labels):
        path = [tuple(range(len(sets)))]
    else:
        limit = max(_size(labs, dims) for labs in op_labels + (out_labels,))
        path = _greedy_path(sets, frozenset(out_labels), dims, limit)
    plan = []
    n = len(sets)
    for step in path:
        step = list(step)
        while len(step) > 2:
            a, b = step[:2]
            plan.append((a, b))
            n -= 1
            step = [p - (p > a) - (p > b) for p in step[2:]] + [n - 1]
        plan.append(tuple(step))
        n -= len(step) - 1
    return tuple(plan)


def _size(labels, dims) -> int:
    return math.prod(dims[l] for l in labels)


def _greedy_path(sets, out, dims, limit):
    """numpy's ``_greedy_path`` (numpy/_core/einsumfunc.py) on label sets:
    contract the pair that removes the most elements, then the cheaper
    one, among pairs sharing a label whose result fits in ``limit``
    (outer products only when no such pair is left), skipping pairs that
    would cost more than contracting everything at once; candidates found
    earlier are kept, in their order, for the next step."""

    def flops(contract, removed, n_terms):
        return _size(contract, dims) * (max(1, n_terms - 1) + bool(removed))

    def find(positions, sets):
        contract = frozenset().union(*(sets[p] for p in positions))
        rest = [s for k, s in enumerate(sets) if k not in positions]
        result = contract & out.union(*rest)
        return result, rest + [result], contract - result, contract

    everything = frozenset().union(*sets)
    naive = flops(everything, everything - out, len(sets))

    def parse(positions, sets, path_cost):
        result, new_sets, removed, contract = find(positions, sets)
        new_size = _size(result, dims)
        if new_size > limit:
            return None
        removed_size = sum(_size(sets[p], dims) for p in positions) - new_size
        cost = flops(contract, removed, len(positions))
        if path_cost + cost > naive:
            return None
        return (-removed_size, cost), positions, new_sets

    known, path, path_cost = [], [], 0
    pairs = itertools.combinations(range(len(sets)), 2)
    for _ in range(len(sets) - 1):
        for pos in pairs:
            if not sets[pos[0]].isdisjoint(sets[pos[1]]):
                known.append(parse(pos, sets, path_cost))
        known = [r for r in known if r is not None]
        if not known:
            known = [parse(pos, sets, path_cost) for pos in
                     itertools.combinations(range(len(sets)), 2)]
            known = [r for r in known if r is not None]
            if not known:
                path.append(tuple(range(len(sets))))
                break
        best = min(known, key=lambda r: r[0])
        bx, by = best[1]
        moved = []
        for key, (x, y), con_sets in known:
            if x in best[1] or y in best[1]:
                continue
            con_sets = list(con_sets)
            del con_sets[by - (by > x) - (by > y)]
            del con_sets[bx - (bx > x) - (bx > y)]
            con_sets.insert(-1, best[2][-1])
            moved.append((key, (x - (x > bx) - (x > by),
                                y - (y > bx) - (y > by)), con_sets))
        known = moved
        sets = best[2]
        new = len(sets) - 1
        pairs = ((k, new) for k in range(new))
        path.append(best[1])
        path_cost += best[0][1]
    return path


def left_to_right_plan(n_operands: int) -> Plan:
    """((A B) C) D ...: the order of torch.einsum without opt_einsum."""
    if n_operands < 2:
        return ((0,),) if n_operands else ()
    return ((0, 1),) + ((0, n_operands - 2),) * (n_operands - 2)


def plan_flops(op_labels, shapes, plan: Plan) -> int:
    """Multiply-add FLOPs (2 per term) of a plan's pairwise steps."""
    dims: Dict[int, int] = {}
    for labs, shape in zip(op_labels, shapes):
        dims.update(zip(labs, shape))
    # traces first: an operand keeps the labels it carries once
    ops = [[l for l in labs if labs.count(l) == 1] for labs in op_labels]
    total = 0
    for step in plan:
        taken = [ops[i] for i in step]
        for i in sorted(step, reverse=True):
            del ops[i]
        merged = [l for labs in taken for l in labs]
        if len(step) == 2:
            total += 2 * int(np.prod([dims[l] for l in set(merged)]))
        ops.append([l for l in merged if merged.count(l) == 1])
    return total


def _trace_repeats(arr: torch.Tensor, labs: List[int]):
    """Sum over every label that one operand carries twice (a trace)."""
    while len(set(labs)) < len(labs):
        seen = {}
        for pos, l in enumerate(labs):
            if l in seen:
                a, b = seen[l], pos
                break
            seen[l] = pos
        arr = torch.diagonal(arr, 0, a, b).sum(-1)
        labs = [l for p, l in enumerate(labs) if p not in (a, b)]
    return arr, labs


def _run_plan(arrays: List[torch.Tensor], op_labels, out_labels,
              plan: Plan) -> torch.Tensor:
    """Execute a plan: traces first, then each pairwise step as one
    tensordot over the labels the two operands share (every label occurs
    at most twice, so a shared label is summed), then the permutation to
    ``out_labels``."""
    ops = [_trace_repeats(a, list(l)) for a, l in zip(arrays, op_labels)]
    for step in plan:
        taken = [ops[i] for i in step]
        for i in sorted(step, reverse=True):
            del ops[i]
        if len(taken) == 1:
            ops.append(taken[0])
            continue
        (a, la), (b, lb) = taken
        shared = [l for l in la if l in lb]
        arr = torch.tensordot(a, b, dims=([la.index(l) for l in shared],
                                          [lb.index(l) for l in shared]))
        ops.append((arr, [l for l in la if l not in shared]
                    + [l for l in lb if l not in shared]))
    (arr, labs), = ops
    if labs != list(out_labels):
        arr = arr.permute(*[labs.index(l) for l in out_labels])
    return arr


def _run_einsum(operands: List[Tuple[Tensor, Tuple[Label, ...]]],
                out_labels: Sequence[Label]) -> torch.Tensor:
    """Canonicalize labels to dense ints, plan (cached) and run."""
    mapping: Dict[Label, int] = {}

    def canon(labs):
        out = []
        for l in labs:
            if l not in mapping:
                mapping[l] = len(mapping)
            out.append(mapping[l])
        return tuple(out)

    op_labs = tuple(canon(labs) for _, labs in operands)
    out_labs = canon(tuple(out_labels))
    arrays = [t._torch(apply_factor=False) for t, _ in operands]
    shapes = tuple(tuple(a.shape) for a in arrays)
    plan = contraction_plan(op_labs, out_labs, shapes)
    return _run_plan(arrays, op_labs, out_labs, plan)


# ---------------------------------------------------------------------------
# Operand gathering
# ---------------------------------------------------------------------------

class _Term:
    """A single indexed object resolved into (Tensor operand, labels)."""

    __slots__ = ("tensor", "labels")

    def __init__(self, tensor: Tensor, labels: List[Label]):
        self.tensor = tensor
        self.labels = labels


def _resolve_term(it: IndexedTensor) -> List[_Term]:
    """Resolve one IndexedTensor into concrete (Tensor, labels) operands,
    applying fixed indices and expanding networks into their nodes."""
    labels, fixed = it.resolved()
    obj = it.obj

    if isinstance(obj, Tensor):
        t = obj
        if any(f is not None for f in fixed):
            t = t.copy()
            # fix from the last mode so positions stay valid
            for m in reversed(range(len(fixed))):
                if fixed[m] is not None:
                    t.fix_mode(m, fixed[m])
            labels = [l for l, f in zip(labels, fixed) if f is None]
        return [_Term(t, list(labels))]

    # TensorNetwork-like objects expand into their nodes; external link k of
    # the network carries the resolved outer label labels[k], internal links
    # get fresh labels shared by their two endpoints.
    if hasattr(obj, "einsum_operands"):
        require(all(f is None for f in fixed),
                "fixed indices on networks: fix the network first")
        return [_Term(t, list(ls)) for t, ls in obj.einsum_operands(labels)]

    raise TypeError(f"cannot evaluate object of type {type(obj)!r}")


def _open_labels(terms: List[_Term]) -> List[Label]:
    """Labels appearing exactly once across all operands, in appearance order."""
    counts: Dict[Label, int] = {}
    order: List[Label] = []
    for term in terms:
        for l in term.labels:
            if l not in counts:
                order.append(l)
            counts[l] = counts.get(l, 0) + 1
    return [l for l in order if counts[l] == 1]


def _label_dims(terms: List[_Term]) -> Dict[Label, int]:
    dims: Dict[Label, int] = {}
    for term in terms:
        for l, d in zip(term.labels, term.tensor.dimensions):
            if l in dims:
                require(dims[l] == d,
                        f"dimension mismatch for shared index: {dims[l]} vs {d}")
            else:
                dims[l] = d
    return dims


# ---------------------------------------------------------------------------
# Product evaluation
# ---------------------------------------------------------------------------

def _eval_product(p: Product, out_labels: Optional[List[Label]]) -> Tuple[Tensor, List[Label]]:
    terms: List[_Term] = []
    for f in p.factors:
        terms.extend(_resolve_term(f))
    opens = _open_labels(terms)
    if out_labels is None:
        out_labels = opens
    else:
        require(sorted(map(repr, opens)) == sorted(map(repr, out_labels)),
                f"LHS indices {out_labels} do not match open RHS indices {opens}")

    # validity: every non-open label must appear exactly twice (a trace or a
    # contraction); matches the reference's index rules.
    counts: Dict[Label, int] = {}
    for t in terms:
        for l in t.labels:
            counts[l] = counts.get(l, 0) + 1
    for l, c in counts.items():
        require(c <= 2, f"index used {c} > 2 times")

    dims = _label_dims(terms)
    scalar = p.scalar
    for t in terms:
        scalar *= t.tensor.factor

    result = _sparse_fast_path(terms, out_labels)
    if result is None:
        arr = _run_einsum([(t.tensor, tuple(t.labels)) for t in terms],
                          out_labels)
        result = Tensor._wrap(arr)
    result.factor *= scalar
    return result, list(out_labels)


def _sparse_fast_path(terms: List[_Term], out_labels: List[Label]) -> Optional[Tensor]:
    """Representation-preserving evaluation for permutations and pairwise
    contractions involving sparse operands (the reference's dense/sparse
    kernel dispatch, tensor.cpp:1275-1352)."""
    if not any(t.tensor.is_sparse() for t in terms):
        return None

    if len(terms) == 1:
        t = terms[0]
        if len(set(t.labels)) == len(t.labels) and sorted(map(repr, t.labels)) == sorted(map(repr, out_labels)):
            # pure permutation: shuffle[old] = new position
            shuffle = [out_labels.index(l) for l in t.labels]
            res = core_reshuffle(t.tensor, shuffle)
            res.factor = 1.0  # the caller's scalar holds the tensor's factor
            return res
        return None

    if len(terms) == 2:
        a, b = terms
        if len(set(a.labels)) != len(a.labels) or len(set(b.labels)) != len(b.labels):
            return None
        shared = [l for l in a.labels if l in b.labels]
        if not shared:
            return None
        a_open = [l for l in a.labels if l not in shared]
        b_open = [l for l in b.labels if l not in shared]
        if sorted(map(repr, out_labels)) != sorted(map(repr, a_open + b_open)):
            return None
        # reorder a: open..., shared...; b: shared..., open...
        ta, tb = a.tensor, b.tensor
        fa, fb = ta.factor, tb.factor
        a_perm_target = a_open + shared
        b_perm_target = shared + b_open
        if a.labels != a_perm_target:
            ta = core_reshuffle(ta, [a_perm_target.index(l) for l in a.labels])
        if b.labels != b_perm_target:
            tb = core_reshuffle(tb, [b_perm_target.index(l) for l in b.labels])
        ta = ta.copy(); ta.factor = 1.0
        tb = tb.copy(); tb.factor = 1.0
        res = core_contract(ta, tb, len(shared))
        res_labels = a_open + b_open
        if res_labels != out_labels:
            res = core_reshuffle(res, [out_labels.index(l) for l in res_labels])
        # caller multiplies in scalar (which contains fa*fb)
        return res
    return None


# ---------------------------------------------------------------------------
# Generic expression evaluation
# ---------------------------------------------------------------------------

def _eval_expr(expr: Expression, out_labels: Optional[List[Label]]) -> Tuple[Tensor, List[Label]]:
    if isinstance(expr, IndexedTensor):
        return _eval_product(Product([expr]), out_labels)
    if isinstance(expr, Product):
        return _eval_product(expr, out_labels)
    if isinstance(expr, Sum):
        first_coeff, first_term = expr.terms[0]
        acc, labels = _eval_expr(first_term, out_labels)
        acc = acc.copy()
        acc.factor *= first_coeff
        for coeff, term in expr.terms[1:]:
            t, _ = _eval_expr(term, labels)
            t = t.copy()
            t.factor *= coeff
            acc += t
        return acc, labels
    if isinstance(expr, SolveExpr):
        return _eval_solve(expr, out_labels)
    raise TypeError(f"cannot evaluate {type(expr)!r}")


def _eval_solve(expr: SolveExpr, x_labels: Optional[List[Label]]) -> Tuple[Tensor, List[Label]]:
    """x = b / A: solve A x = b (indexedTensor_tensor_solve.cpp)."""
    b, b_labels = _eval_expr(expr.b, None)
    # A's open labels = b's labels + x's labels
    A_t, A_labels = _eval_expr(expr.A, None)
    x_open = [l for l in A_labels if l not in b_labels]
    require(len(x_open) + len(b_labels) == len(A_labels),
            "solve: A must carry all of b's open indices")
    if x_labels is None:
        x_labels = x_open
    require(sorted(map(repr, x_labels)) == sorted(map(repr, x_open)),
            "solve: LHS indices do not match A's free indices")
    want = list(b_labels) + list(x_labels)
    if A_labels != want:
        A_t = core_reshuffle(A_t, [want.index(l) for l in A_labels])
    x = fact.solve(A_t, b)
    return x, list(x_labels)


# ---------------------------------------------------------------------------
# Assignment entry points
# ---------------------------------------------------------------------------

def assign(lhs: IndexedTensor, rhs: Expression) -> None:
    target = lhs.obj
    # Specialized targets (TTNetwork, TensorNetwork) intercept here.
    hook = getattr(target, "assign_indexed", None)
    if hook is not None:
        hook(lhs, rhs)
        return
    require(isinstance(target, Tensor), f"cannot assign to {type(target)!r}")
    # Resolve LHS labels against the RHS-implied degree: spans like i&0 need
    # the result's degree, which equals the RHS open-label count.
    lhs_labels = _resolve_lhs_labels(lhs, rhs)
    result, _ = _eval_expr(rhs, lhs_labels)
    _write_into(target, result)


def _resolve_lhs_labels(lhs: IndexedTensor, rhs: Expression) -> Optional[List[Label]]:
    """LHS labels; target dims may not yet match the result, so spans are
    resolved against the RHS open-label count when needed."""
    degree = _rhs_open_count(rhs)
    labels: List[Label] = []
    for idx in lhs.indices:
        require(not idx.fixed(), "fixed indices not supported on assignment target")
        span = idx.actual_span(degree)
        for k in range(span):
            labels.append((idx.value_id, k))
    require(len(labels) == degree,
            f"LHS spans {len(labels)} modes but RHS result has {degree}")
    return labels


def _rhs_open_count(expr: Expression) -> int:
    if isinstance(expr, (IndexedTensor, Product)):
        p = expr if isinstance(expr, Product) else Product([expr])
        terms: List[_Term] = []
        for f in p.factors:
            terms.extend(_resolve_term(f))
        return len(_open_labels(terms))
    if isinstance(expr, Sum):
        return _rhs_open_count(expr.terms[0][1])
    if isinstance(expr, SolveExpr):
        return _rhs_open_count(expr.A) - _rhs_open_count(expr.b)
    raise TypeError(str(type(expr)))


def _write_into(target: Tensor, result: Tensor) -> None:
    target.dimensions = list(result.dimensions)
    target.factor = result.factor
    target.representation = result.representation
    target._dense = result._dense
    target._sparse = dict(result._sparse) if result._sparse is not None else None


def evaluate_to_tensor(expr: Expression, out_labels) -> Tensor:
    t, _ = _eval_expr(expr, out_labels)
    return t


# ---------------------------------------------------------------------------
# Factorisation assignment: (Q(i,r), R(r,j)) << QR(A(i,j))
# ---------------------------------------------------------------------------

def assign_factorisation(f: Factorisation, targets: List[IndexedTensor]) -> None:
    src, src_labels = _eval_expr(f.source, None)

    if f.kind == "svd":
        require(len(targets) == 3, "SVD needs (U, S, Vt) targets")
    else:
        require(len(targets) == 2, f"{f.kind} needs two targets")

    # The shared "rank" index appears in consecutive targets; the split
    # position is where the first target's non-rank labels end.
    first_ids = [i.value_id for i in targets[0].indices if not i.fixed()]
    last_ids = [i.value_id for i in targets[-1].indices if not i.fixed()]
    rank_ids = set(first_ids) & set(last_ids)
    if f.kind == "svd":
        rank_ids = (set(first_ids) & {i.value_id for i in targets[1].indices}) | \
                   (set(last_ids) & {i.value_id for i in targets[1].indices})
    # labels of source covered by the first target (all but the rank index)
    first_open = [vid for vid in first_ids if vid not in rank_ids]
    # reorder src so that first_open labels come first, in target order
    src_order: List[Label] = []
    for vid in first_open:
        src_order.extend([l for l in src_labels if l[0] == vid])
    split_pos = len(src_order)
    for l in src_labels:
        if l not in src_order:
            src_order.append(l)
    if src_order != src_labels:
        src = core_reshuffle(src, [src_order.index(l) for l in src_labels])

    if f.kind == "svd":
        U, S, Vt = fact.calculate_svd(src, split_pos, f.max_rank, f.eps)
        if f.soft_threshold > 0.0:
            # shrink singular values by tau and drop the zeros
            # (reference SVD(..., softThreshold) argument,
            # indexedTensor_tensor_factorisations.h:40-100)
            s = np.diag(S.to_ndarray())
            s = np.maximum(s - f.soft_threshold, 0.0)
            keep = max(int(np.sum(s > 0)), 1)
            if f.max_rank:
                keep = min(keep, f.max_rank)
            U.resize_mode(U.degree() - 1, keep)
            Vt.resize_mode(0, keep)
            S = Tensor([keep, keep], Representation.Sparse)
            for i2 in range(keep):
                S._sparse[i2 * keep + i2] = float(s[i2])
        results = (U, S, Vt)
    elif f.kind == "qr":
        results = fact.calculate_qr(src, split_pos)
    elif f.kind == "rq":
        results = fact.calculate_rq(src, split_pos)
    elif f.kind == "qc":
        results = fact.calculate_qc(src, split_pos)
    elif f.kind == "cq":
        results = fact.calculate_cq(src, split_pos)
    else:
        raise ValueError(f"unknown factorisation {f.kind!r}")

    # Produced mode labels: lhs factor carries src_order[:split]+[rank],
    # rhs factor [rank]+src_order[split:]; middle (SVD S) is rank x rank.
    RANK = (-2, 0)
    RANK2 = (-3, 0)
    if f.kind == "svd":
        produced = [list(src_order[:split_pos]) + [RANK],
                    [RANK, RANK2],
                    [RANK2] + list(src_order[split_pos:])]
    elif f.kind in ("qr", "qc"):
        produced = [list(src_order[:split_pos]) + [RANK],
                    [RANK] + list(src_order[split_pos:])]
    else:  # rq, cq: first output keeps the lhs modes, rank is its last mode
        produced = [list(src_order[:split_pos]) + [RANK],
                    [RANK] + list(src_order[split_pos:])]

    rank_vids = list(rank_ids)
    for tgt, res, prod_labels in zip(targets, results, produced):
        _write_reordered(tgt, res, prod_labels, rank_vids)


def _write_reordered(target: IndexedTensor, result: Tensor,
                     produced_labels: List[Label], rank_vids: List[int]) -> None:
    """Reshuffle a factorisation output into the target's index order."""
    degree = result.degree()
    want: List[Label] = []
    for idx in target.indices:
        require(not idx.fixed(), "fixed indices not supported on factorisation target")
        span = idx.actual_span(degree)
        if idx.value_id in rank_vids:
            # rank indices: match any produced rank label, in order of use
            rank_labels = [l for l in produced_labels if l[0] < 0 and l not in want]
            require(span == 1, "rank index must have span one")
            want.append(rank_labels[0])
        else:
            mine = [l for l in produced_labels if l[0] == idx.value_id]
            require(len(mine) == span,
                    f"factorisation target index spans {span} but source has {len(mine)}")
            want.extend(mine)
    require(len(want) == degree, "factorisation target index spans mismatch")
    if want != produced_labels:
        result = core_reshuffle(result, [want.index(l) for l in produced_labels])
    _write_into(target.obj, result)
