"""Measurement sets for tensor completion, at core level.

Counterpart of ``xerus_tpu/algorithms/measurements.py``.  A TT is a list
of (rl, n, rr) torch cores on one device; there is no ``TTTensor`` object
yet.  Positions and values live on the host as numpy arrays, as in the
JAX package; the positions reach a device once per set and device (a
cached copy, validated against the mode sizes on the host first, so an
index out of range raises before anything reaches the card).  A TT is
evaluated at the positions by ``ops.tt_eval.tt_eval_at_points``: kernel
K3 on the card, its plain version on the CPU, at every M.

Random positions and weights come from an explicit ``np.random.Generator``
and are drawn in the JAX package's order, so one seed gives the same set
in both packages.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..config import require
from ..ops.tt_eval import tt_eval_at_points

VALUE_DTYPE = np.float64


def _is_cores(solution) -> bool:
    return (isinstance(solution, (list, tuple)) and len(solution) > 0
            and all(isinstance(c, torch.Tensor) and c.dim() == 3
                    for c in solution))


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
    def random(cls, num: int, dimensions: Sequence[int],
               rng: np.random.Generator,
               solution=None) -> "SinglePointMeasurementSet":
        """``num`` distinct random positions; measured on ``solution``
        (cores, dense array or callback) when one is given."""
        out = cls()
        out.create_random_positions(num, dimensions, rng)
        if solution is not None:
            out.measure(solution)
        return out

    def create_random_positions(self, num: int, dimensions: Sequence[int],
                                rng: np.random.Generator) -> None:
        """Rejection-sample ``num`` distinct positions, one
        ``rng.integers`` draw per mode in mode order, then sort them."""
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
        if _is_cores(solution):
            dims = [c.shape[1] for c in solution]
            vals = tt_eval_at_points(
                list(solution), self.positions_on(solution[0].device, dims))
            return vals.to("cpu", torch.float64).numpy()
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
    def random(cls, num: int, dimensions: Sequence[int],
               rng: np.random.Generator,
               solution=None) -> "RankOneMeasurementSet":
        out = cls()
        out.create_random_positions(num, dimensions, rng)
        if solution is not None:
            out.measure(solution)
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
                                rng: np.random.Generator) -> None:
        """Gaussian weights, one (num, n_k) draw per mode in mode order,
        then normalized."""
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
        if _is_cores(solution):
            ws = self.weights_on(solution[0].device, solution[0].dtype)
            F = solution[0].new_ones((self.size(), 1))
            for C, W in zip(solution, ws):
                F = torch.einsum("ma,anb,mn->mb", F, C, W)
            return F[:, 0].to("cpu", torch.float64).numpy()
        if isinstance(solution, (np.ndarray, torch.Tensor)):
            out = torch.as_tensor(np.asarray(
                solution.cpu() if isinstance(solution, torch.Tensor)
                else solution), dtype=torch.float64)
            out = out.expand((self.size(),) + tuple(out.shape))
            for W in self.weights_on("cpu"):
                out = torch.einsum("mn...,mn->m...", out, W)
            return out.numpy()
        if callable(solution):
            return np.array(
                [solution([W[i] for W in self._positions])
                 for i in range(self.size())], dtype=VALUE_DTYPE)
        raise TypeError(f"cannot measure {type(solution)!r}")

    def test(self, solution) -> float:
        return _rel_error(self._eval(solution), self.measuredValues)
