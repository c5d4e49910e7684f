"""Simple numerics utilities: adaptive Romberg integration, bisection,
orthogonal-polynomial bases, sequence-limit extractors.

Re-design of include/xerus/misc/simpleNumerics.h,
src/xerus/misc/simpleNumerics.cpp:37-330 — host-side scalar helpers (the
reference uses them for UQ polynomial bases and convergence analysis);
pure Python/NumPy, no device involvement.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence

import numpy as np

from ..config import require

_EPS = 2.220446049250313e-16  # double machine epsilon


def _feval(f: Callable, xs: np.ndarray) -> np.ndarray:
    """Evaluate ``f`` on a 1-D node array.

    Tries one vectorized call first (cheap for numpy-aware callables);
    scalar-only callables (``math.cos``, branching lambdas) raise on array
    input and are mapped pointwise instead."""
    if xs.size > 1:     # size-1 arrays: float(arr) succeeds spuriously
        try:
            fx = np.asarray(f(xs), dtype=float)
            if fx.shape == xs.shape:
                return fx
        except Exception:
            pass
    return np.array([float(f(float(x))) for x in xs])


def integrate(f: Callable[[float], float], a: float, b: float,
              eps: float = _EPS, min_iter: int = 4, max_iter: int = 6,
              branch_factor: int = 7, max_recursion: int = 10,
              relative_error: bool = True) -> float:
    """Adaptive quadrature with the semantics of the reference's
    integrator (simpleNumerics.cpp:37-96): Romberg acceleration over
    trapezoid halvings, falling back to a ``branch_factor``-way interval
    split (depth-limited by ``max_recursion``) when the estimate has not
    stabilized to ``eps`` within ``max_iter`` refinements.

    Original vectorized design: each refinement evaluates all new
    midpoints as one batched ``_feval`` call, and a single rolling
    Romberg row ``row`` (``row[0]`` = current composite trapezoid,
    ``row[-1]`` = most-extrapolated estimate) replaces the reference's
    in-place iterant list."""
    require(min_iter > 1, "integrate needs min_iter > 1")
    require(branch_factor > 1, "integrate needs branch_factor > 1")
    sign = -1.0 if a > b else 1.0
    lo, hi = (a, b) if a <= b else (b, a)
    if relative_error:
        eps = max(eps, _EPS)

    width = hi - lo
    ends = _feval(f, np.array([lo, hi], dtype=float))
    trap = width * float(ends.sum()) / 2.0
    peak = max(float(np.abs(ends).max()), abs(trap))
    row = np.array([trap])
    for level in range(1, max_iter + 1):
        n_new = 1 << (level - 1)
        h = width / (2.0 * n_new)
        nodes = lo + h * (2.0 * np.arange(n_new) + 1.0)
        fx = _feval(f, nodes)
        if fx.size:
            peak = max(peak, float(np.abs(fx).max()))
        trap = 0.5 * trap + h * float(fx.sum())
        # Extend the Romberg row: each column cancels the next even
        # error order, R_new[k] = R_new[k-1] + (R_new[k-1]-R_old[k-1])/(4^k-1).
        new = np.empty(row.size + 1)
        new[0] = trap
        for k in range(1, new.size):
            new[k] = new[k - 1] + (new[k - 1] - row[k - 1]) / (4.0 ** k - 1.0)
        prev_best, row = row[-1], new
        best = float(row[-1])
        delta = abs(best - prev_best)
        err = delta / abs(prev_best) if (relative_error and prev_best != 0.0
                                         and not math.isnan(delta / prev_best)
                                         ) else delta
        if level > min_iter and err <= eps:
            return sign * best
    best = float(row[-1])
    if max_recursion == 0:
        return sign * best
    # Divide and conquer: the interval resisted smooth extrapolation
    # (kink / discontinuity); split it and integrate the parts to an
    # ABSOLUTE tolerance derived from the magnitude scale seen so far.
    scale = max(abs(best), peak)
    child_eps = (scale * eps if relative_error
                 else max(eps, math.sqrt(branch_factor) * _EPS * scale))
    cuts = lo + (width / branch_factor) * np.arange(branch_factor + 1)
    cuts[-1] = hi
    total = math.fsum(
        integrate(f, float(cuts[i]), float(cuts[i + 1]), child_eps,
                  min_iter, max_iter, branch_factor, max_recursion - 1,
                  relative_error=False)
        for i in range(branch_factor))
    return sign * total


def integrate_segmented(f: Callable[[float], float], a: float, b: float,
                        segmentation: float, eps: float = 1e-8,
                        min_iter: int = 4, max_iter: int = 6,
                        branch_factor: int = 8,
                        max_recursion: int = 10) -> float:
    """Integrate in fixed-width segments (simpleNumerics.cpp:100-110)."""
    lo, hi = min(a, b), max(a, b)
    sign = -1.0 if a > b else 1.0
    res = 0.0
    x = lo
    while x < hi:
        res += integrate(f, x, min(x + segmentation, hi), eps, min_iter,
                         max_iter, branch_factor, max_recursion)
        x += segmentation
    return sign * res


def find_root_bisection(f: Callable[[float], float], lo: float, hi: float,
                        epsilon: float = 1e-14) -> float:
    """Bisection root finder (simpleNumerics.cpp:113-145)."""
    lo, hi = min(lo, hi), max(lo, hi)
    flo, fhi = f(lo), f(hi)
    require(flo * fhi <= 0,
            "bisection requires inputs to both sides of the root")
    if flo == 0.0:
        return lo
    if fhi == 0.0:
        return hi
    while hi - lo > epsilon:
        mid = (hi + lo) / 2.0
        fmid = f(mid)
        if fmid == 0.0:
            return mid
        require(math.isfinite(fmid),
                f"invalid function value f({mid}) = {fmid} in bisection")
        if flo * fmid < 0:
            hi = mid
        else:
            flo = fmid
            lo = mid
    return (hi + lo) / 2.0


class Polynomial:
    """Monomial-basis polynomial with weighted L2 structure
    (simpleNumerics.h:54-86, .cpp:147-252).  ``coefficients[i]`` is the
    coefficient of x^i."""

    def __init__(self, coefficients: Sequence[float] = ()):  # noqa: D401
        self.coefficients: List[float] = [float(c) for c in coefficients]

    def terms(self) -> int:
        return len(self.coefficients)

    def _resized(self, n: int) -> None:
        while len(self.coefficients) < n:
            self.coefficients.append(0.0)

    def __iadd__(self, rhs: "Polynomial") -> "Polynomial":
        self._resized(rhs.terms())
        for i, c in enumerate(rhs.coefficients):
            self.coefficients[i] += c
        return self

    def __isub__(self, rhs: "Polynomial") -> "Polynomial":
        self._resized(rhs.terms())
        for i, c in enumerate(rhs.coefficients):
            self.coefficients[i] -= c
        return self

    def __imul__(self, rhs: float) -> "Polynomial":
        self.coefficients = [c * rhs for c in self.coefficients]
        return self

    def __itruediv__(self, rhs: float) -> "Polynomial":
        self.coefficients = [c / rhs for c in self.coefficients]
        return self

    def __mul__(self, rhs):
        if isinstance(rhs, Polynomial):
            out = [0.0] * (self.terms() + rhs.terms() - 1)
            for i, ci in enumerate(self.coefficients):
                for j, cj in enumerate(rhs.coefficients):
                    out[i + j] += ci * cj
            return Polynomial(out)
        return Polynomial([c * rhs for c in self.coefficients])

    __rmul__ = __mul__

    def __call__(self, x: float) -> float:
        result = 0.0
        for c in reversed(self.coefficients):
            result = result * x + c
        return result

    def scalar_product(self, rhs: "Polynomial",
                       weight: Callable[[float], float],
                       min_x: float, max_x: float) -> float:
        return integrate(lambda x: self(x) * rhs(x) * weight(x),
                         min_x, max_x, 1e-10)

    def norm(self, weight: Callable[[float], float],
             min_x: float, max_x: float) -> float:
        return math.sqrt(self.scalar_product(self, weight, min_x, max_x))

    def orthogonolize(self, ortho_base: Sequence["Polynomial"],
                      weight: Callable[[float], float],
                      min_x: float, max_x: float) -> "Polynomial":
        """Orthogonalize against an (already orthonormal) basis, in place
        (the reference's spelling, simpleNumerics.cpp:232)."""
        for b in ortho_base:
            self -= b * self.scalar_product(b, weight, min_x, max_x)
        self /= self.norm(weight, min_x, max_x)
        return self

    orthogonalize = orthogonolize   # sane spelling alias

    @staticmethod
    def build_orthogonal_base(n: int, weight: Callable[[float], float],
                              min_x: float, max_x: float
                              ) -> List["Polynomial"]:
        """n orthonormal polynomials w.r.t. the weighted L2 product
        (simpleNumerics.cpp:244-252; used by the reference's UQ Hermite
        bases)."""
        base: List[Polynomial] = []
        while len(base) < n:
            nxt = Polynomial([0.0] * len(base) + [1.0])  # x^len(base)
            nxt.orthogonolize(base, weight, min_x, max_x)
            base.append(nxt)
        return base


class ShanksTransformation:
    """Sequence-limit extraction via the Shanks/Aitken process
    (simpleNumerics.h:105-123, .cpp:257-295)."""

    def __init__(self):
        self.values: List[float] = []

    @staticmethod
    def shanks(x1: float, x2: float, x3: float) -> float:
        den = x1 - 2 * x2 + x3
        if abs(den) < _EPS * max(x1, x2, x3):
            return x2
        return (x1 * x3 - x2 * x2) / den

    def push_back(self, val: float) -> None:
        self.values.append(float(val))
        i = len(self.values) - 1
        while i >= 2:
            self.values[i - 2] = self.shanks(
                self.values[i - 2], self.values[i - 1], self.values[i])
            i -= 2

    def best_estimate(self) -> float:
        require(bool(self.values),
                "tried to extract limit of empty sequence")
        return self.values[(len(self.values) - 1) % 2]

    def error_approximate(self) -> float:
        i = (len(self.values) - 1) % 2
        if i + 1 >= len(self.values):
            return 1.0
        return abs(self.values[i] - self.values[i + 1])

    def reset(self) -> None:
        self.values.clear()


class RichardsonExtrapolation:
    """Sequence-limit extraction via Richardson extrapolation
    (simpleNumerics.h:128-146, .cpp:305-330)."""

    def __init__(self):
        self.values: List[float] = []

    @staticmethod
    def richard(n: int, x1: float, x2: float) -> float:
        return (n + 1) * x2 - n * x1

    def push_back(self, val: float) -> None:
        self.values.append(float(val))
        for i in range(len(self.values) - 1, 0, -1):
            self.values[i - 1] = self.richard(i - 1, self.values[i - 1],
                                              self.values[i])

    def best_estimate(self) -> float:
        require(bool(self.values),
                "tried to extract limit of empty sequence")
        return self.values[0]

    def error_approximate(self) -> float:
        if len(self.values) < 2:
            return 1.0
        return abs(self.values[0] - self.values[1])

    def reset(self) -> None:
        self.values.clear()
