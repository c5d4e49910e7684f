"""Measurement sets for tensor completion.

Counterpart of ``xerus_tpu/algorithms/measurements.py``.  Positions and
values live on the host as numpy arrays, as in the JAX package; the
positions reach a device once per set and device (a cached copy, validated
against the mode sizes on the host first, so an index out of range raises
before anything reaches the card).  A ``TTTensor`` (or a list of (rl, n,
rr) torch cores) is evaluated at the positions by
``ops.tt_eval.tt_eval_at_points``: kernel K3 on the card, its plain version
on the CPU, at every M; a ``Tensor`` is indexed on its device.

Random positions and weights come from the library's random engine
(``misc.randomEngine``) unless a ``np.random.Generator`` is given, and are
drawn in the JAX package's order, so one seed gives the same set in both
packages.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import misc as _misc
from ..config import require
from ..core.tensor import Tensor
from ..ops.tt_eval import tt_eval_at_points
from ..tt.ttnetwork import TTNetwork

VALUE_DTYPE = np.float64


def _is_cores(solution) -> bool:
    return (isinstance(solution, (list, tuple)) and len(solution) > 0
            and all(isinstance(c, torch.Tensor) and c.dim() == 3
                    for c in solution))


def _as_cores(solution):
    """A TTTensor's component tensors (on the compute device), or the
    list of cores itself; None for anything else."""
    if isinstance(solution, TTNetwork):
        require(not solution.is_operator, "cannot measure a TTOperator")
        return [c._torch() for c in solution.components]
    return list(solution) if _is_cores(solution) else None


def _dims_or_solution(dimensions_or_solution):
    """(mode sizes, the solution to measure or None) of the argument of
    ``random``: a list of sizes, or a TT / Tensor whose sizes are used."""
    if isinstance(dimensions_or_solution, (list, tuple)) and not _is_cores(
            dimensions_or_solution):
        return [int(d) for d in dimensions_or_solution], None
    sol = dimensions_or_solution
    if _is_cores(sol):
        return [int(c.shape[1]) for c in sol], sol
    return list(sol.dimensions), sol


def _rel_error(vals: np.ndarray, ref: np.ndarray) -> float:
    return float(np.linalg.norm(vals - ref) / (np.linalg.norm(ref) or 1.0))


class SinglePointMeasurementSet:
    """Point measurements: positions (M, d) int64 + values (M,) float64."""

    def __init__(self):
        self._positions = np.zeros((0, 0), dtype=np.int64)
        self.measuredValues = np.zeros((0,), dtype=VALUE_DTYPE)
        self._on_device: Dict[torch.device, torch.Tensor] = {}

    @property
    def positions(self) -> np.ndarray:
        return self._positions

    @positions.setter
    def positions(self, value) -> None:
        self._positions = np.asarray(value, dtype=np.int64)
        self._on_device = {}

    # -- construction ---------------------------------------------------
    @classmethod
    def from_arrays(cls, positions, values=None) -> "SinglePointMeasurementSet":
        """A set holding ``positions`` (M, d) and ``values`` (M,), e.g. the
        JAX package's ``ms.positions`` and ``ms.measuredValues``."""
        out = cls()
        out.positions = np.array(positions, dtype=np.int64)
        out.measuredValues = (np.zeros(out.size(), VALUE_DTYPE)
                              if values is None
                              else np.array(values, dtype=VALUE_DTYPE))
        require(out.measuredValues.shape == (out.size(),),
                "need one value per position")
        return out

    @classmethod
    def random(cls, num: int, dimensions_or_solution,
               callback: Optional[Callable] = None,
               rng: Optional[np.random.Generator] = None
               ) -> "SinglePointMeasurementSet":
        """``num`` distinct random positions in a list of mode sizes
        (measured on ``callback`` when one is given), or in the sizes of
        a TT, cores or Tensor, which is then measured."""
        out = cls()
        dims, solution = _dims_or_solution(dimensions_or_solution)
        out.create_random_positions(num, dims, rng)
        if solution is not None:
            out.measure(solution)
        elif callback is not None:
            out.measure(callback)
        return out

    def create_random_positions(self, num: int, dimensions: Sequence[int],
                                rng: Optional[np.random.Generator] = None
                                ) -> None:
        """Rejection-sample ``num`` distinct positions, one
        ``rng.integers`` draw per mode in mode order (the library's random
        engine when ``rng`` is None), then sort them."""
        rng = _misc.randomEngine if rng is None else rng
        dims = [int(d) for d in dimensions]
        require(num <= int(np.prod(np.array(dims, dtype=np.int64))),
                "more measurements than entries")
        seen = set()
        rows = []
        while len(rows) < num:
            cand = tuple(int(rng.integers(0, d)) for d in dims)
            if cand not in seen:
                seen.add(cand)
                rows.append(cand)
        self.positions = np.array(rows, dtype=np.int64).reshape(num, len(dims))
        self.measuredValues = np.zeros(num, dtype=VALUE_DTYPE)
        self.sort(positions_only=True)

    # -- information ----------------------------------------------------
    def size(self) -> int:
        return self._positions.shape[0]

    def degree(self) -> int:
        return self._positions.shape[1]

    def frob_norm(self) -> float:
        return float(np.linalg.norm(self.measuredValues))

    def add(self, position: Sequence[int], value: float) -> None:
        pos = np.asarray(position, dtype=np.int64)[None, :]
        if self._positions.size == 0:
            self.positions = pos
            self.measuredValues = np.array([value], dtype=VALUE_DTYPE)
        else:
            self.positions = np.vstack([self._positions, pos])
            self.measuredValues = np.append(self.measuredValues, value)

    def sort(self, positions_only: bool = False) -> None:
        """Lexicographic order of the positions (values follow unless
        ``positions_only``)."""
        if self.size() == 0:
            return
        order = np.lexsort(self._positions.T[::-1])
        self.positions = self._positions[order]
        if not positions_only:
            self.measuredValues = self.measuredValues[order]

    # -- per-measurement accessors --------------------------------------
    def get_position(self, i: int) -> List[int]:
        return [int(p) for p in self._positions[i]]

    def set_position(self, i: int, position: Sequence[int]) -> None:
        self._positions[i] = np.asarray(position, dtype=np.int64)
        self._on_device = {}

    def get_measuredValue(self, i: int) -> float:
        return float(self.measuredValues[i])

    def set_measuredValue(self, i: int, value: float) -> None:
        self.measuredValues[i] = value

    # -- the device copy ------------------------------------------------
    def positions_on(self, device, dims: Sequence[int]) -> torch.Tensor:
        """The positions as a contiguous (M, d) int64 tensor on ``device``,
        copied once per set and device; raises ValueError if a position
        lies outside ``dims``."""
        device = torch.device(device)
        require(self.degree() == len(dims),
                f"positions have degree {self.degree()}, the TT {len(dims)}")
        if self.size():
            lo = self._positions.min(axis=0)
            hi = self._positions.max(axis=0)
            require(bool(np.all(lo >= 0) and np.all(hi < np.asarray(dims))),
                    f"positions out of range for mode sizes {list(dims)}")
        if device not in self._on_device:
            self._on_device[device] = torch.from_numpy(
                np.ascontiguousarray(self._positions)).to(device)
        return self._on_device[device]

    # -- measuring ------------------------------------------------------
    def measure(self, solution) -> None:
        self.measuredValues = self._eval(solution)

    def _eval(self, solution) -> np.ndarray:
        cores = _as_cores(solution)
        if cores is not None:
            dims = [c.shape[1] for c in cores]
            vals = tt_eval_at_points(cores,
                                     self.positions_on(cores[0].device, dims))
            return vals.to("cpu", torch.float64).numpy()
        if isinstance(solution, Tensor):
            arr = solution._torch()
            P = self.positions_on(arr.device, list(arr.shape))
            idx = tuple(P[:, k] for k in range(self.degree()))
            return arr[idx].to("cpu", torch.float64).numpy()
        if isinstance(solution, (np.ndarray, torch.Tensor)):
            arr = np.asarray(solution.cpu() if isinstance(solution, torch.Tensor)
                             else solution)
            idx = tuple(self._positions[:, k] for k in range(self.degree()))
            return np.asarray(arr[idx], dtype=VALUE_DTYPE)
        if callable(solution):
            return np.array([solution(list(p)) for p in self._positions],
                            dtype=VALUE_DTYPE)
        raise TypeError(f"cannot measure {type(solution)!r}")

    def test(self, solution) -> float:
        """Relative l2 error of ``solution`` at the positions against the
        stored values."""
        return _rel_error(self._eval(solution), self.measuredValues)


class RankOneMeasurementSet:
    """Rank-one measurements <w_1 x .. x w_d, X>: ``positions[k]`` is the
    (M, n_k) float64 weight matrix of mode k."""

    def __init__(self):
        self._positions: List[np.ndarray] = []
        self.measuredValues = np.zeros((0,), dtype=VALUE_DTYPE)
        self._on_device: Dict[tuple, List[torch.Tensor]] = {}

    @property
    def positions(self) -> List[np.ndarray]:
        return self._positions

    @positions.setter
    def positions(self, value) -> None:
        self._positions = [np.asarray(w, dtype=VALUE_DTYPE) for w in value]
        self._on_device = {}

    @classmethod
    def from_arrays(cls, positions: Sequence, values=None
                    ) -> "RankOneMeasurementSet":
        out = cls()
        out.positions = [np.array(w, dtype=VALUE_DTYPE) for w in positions]
        M = out._positions[0].shape[0] if out._positions else 0
        out.measuredValues = (np.zeros(M, VALUE_DTYPE) if values is None
                              else np.array(values, dtype=VALUE_DTYPE))
        require(out.measuredValues.shape == (M,),
                "need one value per measurement")
        return out

    @classmethod
    def random(cls, num: int, dimensions_or_solution,
               callback: Optional[Callable] = None,
               rng: Optional[np.random.Generator] = None
               ) -> "RankOneMeasurementSet":
        """As ``SinglePointMeasurementSet.random``, with Gaussian weight
        vectors."""
        out = cls()
        dims, solution = _dims_or_solution(dimensions_or_solution)
        out.create_random_positions(num, dims, rng)
        if solution is not None:
            out.measure(solution)
        elif callback is not None:
            out.measure(callback)
        return out

    @classmethod
    def from_single_point(cls, sp: SinglePointMeasurementSet,
                          dimensions: Sequence[int]) -> "RankOneMeasurementSet":
        """One-hot weight vectors of the point measurements."""
        M = sp.size()
        ws = []
        for k, d in enumerate(dimensions):
            W = np.zeros((M, int(d)), dtype=VALUE_DTYPE)
            W[np.arange(M), sp.positions[:, k]] = 1.0
            ws.append(W)
        return cls.from_arrays(ws, sp.measuredValues.copy())

    def create_random_positions(self, num: int, dimensions: Sequence[int],
                                rng: Optional[np.random.Generator] = None
                                ) -> None:
        """Gaussian weights, one (num, n_k) draw per mode in mode order
        (the library's random engine when ``rng`` is None), then
        normalized."""
        rng = _misc.randomEngine if rng is None else rng
        self.positions = [np.asarray(rng.normal(size=(num, int(d))),
                                     dtype=VALUE_DTYPE) for d in dimensions]
        self.measuredValues = np.zeros(num, dtype=VALUE_DTYPE)
        self.normalize()

    def size(self) -> int:
        return self.measuredValues.shape[0]

    def degree(self) -> int:
        return len(self._positions)

    def frob_norm(self) -> float:
        return float(np.linalg.norm(self.measuredValues))

    def add(self, position: Sequence, value: float) -> None:
        vecs = [np.asarray(p, dtype=VALUE_DTYPE) for p in position]
        if not self._positions:
            self.positions = [v[None, :] for v in vecs]
            self.measuredValues = np.array([value], dtype=VALUE_DTYPE)
        else:
            self.positions = [np.vstack([P, v[None, :]])
                              for P, v in zip(self._positions, vecs)]
            self.measuredValues = np.append(self.measuredValues, value)

    def normalize(self) -> None:
        """Unit-normalize every weight vector and rescale the values by the
        same factors, so the measurement equations still hold."""
        ws = list(self._positions)
        for k in range(len(ws)):
            norms = np.linalg.norm(ws[k], axis=1, keepdims=True)
            norms[norms == 0] = 1.0
            ws[k] = ws[k] / norms
            if self.measuredValues.size:
                self.measuredValues = self.measuredValues / norms[:, 0]
        self.positions = ws

    def sort(self, positions_only: bool = False) -> None:
        """Lexicographic over each measurement's concatenated weights."""
        if self.size() == 0 or not self._positions:
            return
        key = np.hstack(self._positions)
        order = np.lexsort(key.T[::-1])
        self.positions = [W[order] for W in self._positions]
        if not positions_only:
            self.measuredValues = self.measuredValues[order]

    def get_position(self, i: int) -> List[np.ndarray]:
        return [W[i].copy() for W in self._positions]

    def set_position(self, i: int, position: Sequence) -> None:
        require(len(position) == self.degree(),
                "need one weight vector per mode")
        for k, p in enumerate(position):
            self._positions[k][i] = np.asarray(p, dtype=VALUE_DTYPE)
        self._on_device = {}

    def get_measuredValue(self, i: int) -> float:
        return float(self.measuredValues[i])

    def set_measuredValue(self, i: int, value: float) -> None:
        self.measuredValues[i] = value

    def weights_on(self, device, dtype=torch.float64) -> List[torch.Tensor]:
        """The weight matrices on ``device`` in ``dtype``, copied once per
        set, device and dtype."""
        key = (torch.device(device), dtype)
        if key not in self._on_device:
            self._on_device[key] = [torch.from_numpy(W).to(key[0], dtype)
                                    for W in self._positions]
        return self._on_device[key]

    def measure(self, solution) -> None:
        self.measuredValues = self._eval(solution)

    def _eval(self, solution) -> np.ndarray:
        cores = _as_cores(solution)
        if cores is not None:
            ws = self.weights_on(cores[0].device, cores[0].dtype)
            F = cores[0].new_ones((self.size(), 1))
            for C, W in zip(cores, ws):
                F = torch.einsum("ma,anb,mn->mb", F, C, W)
            return F[:, 0].to("cpu", torch.float64).numpy()
        if isinstance(solution, (Tensor, np.ndarray, torch.Tensor)):
            if isinstance(solution, Tensor):
                out = solution._torch()
            else:
                out = torch.as_tensor(np.asarray(
                    solution.cpu() if isinstance(solution, torch.Tensor)
                    else solution), dtype=torch.float64)
            out = out.expand((self.size(),) + tuple(out.shape))
            for W in self.weights_on(out.device, out.dtype):
                out = torch.einsum("mn...,mn->m...", out, W)
            return out.to("cpu", torch.float64).numpy()
        if callable(solution):
            return np.array(
                [solution([W[i] for W in self._positions])
                 for i in range(self.size())], dtype=VALUE_DTYPE)
        raise TypeError(f"cannot measure {type(solution)!r}")

    def test(self, solution) -> float:
        return _rel_error(self._eval(solution), self.measuredValues)
