"""Dense + sparse Tensor with a lazy scalar factor.

The port of ``xerus_tpu.core.tensor``, the reference's ``xerus::Tensor``
(include/xerus/tensor.h:70-1074, src/xerus/tensor.cpp).

* Data lives in either a host numpy buffer (mutation-heavy construction
  paths: element writes, ``modify_entries``) or a ``torch.Tensor`` (after
  any computation), which computations put on ``config.device``: the card
  unless the caller entered ``host()``.  Promotion between the two is lazy,
  so a build-then-compute workflow never ping-pongs host<->device.
* A torch tensor held by a Tensor is never written in place, so copies
  share it as the JAX package's copies share immutable ``jax.Array``s;
  numpy buffers are copied on Tensor copy, and an element write on
  torch-held data first takes a private host copy.  ``from_torch`` copies
  its argument and ``to_torch`` returns a tensor of the caller's own, so
  no caller's tensor is ever one a Tensor holds.
* The sparse representation is a ``{linear_position: value}`` dict (same
  semantics as the reference's ``std::map<size_t,double>``,
  tensor.h:120-123); device-side sparse contractions matricize to COO and
  run gather/segment-sum steps (see core/contract.py).
"""

from __future__ import annotations

import enum
import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import config, compute_device, require, torch_dtype
from .. import misc as _misc


class Representation(enum.Enum):
    Dense = 0
    Sparse = 1


class Initialisation(enum.Enum):
    Nothing = 0
    Zero = 1


def _prod(dims: Iterable[int]) -> int:
    out = 1
    for d in dims:
        out *= int(d)
    return out


class Tensor:
    """Dense or sparse tensor with a global scaling factor (tensor.h:70)."""

    # Auto dense<->sparse switch heuristic (tensor.h:72).
    # Kept as a class attribute for API parity; reads config by default.
    sparsityFactor = 4

    __array_priority__ = 100  # numpy defers to our operators

    def __init__(self, dimensions: Sequence[int] = (),
                 representation: Representation = Representation.Sparse,
                 init: Initialisation = Initialisation.Zero,
                 data=None):
        if isinstance(dimensions, (int, np.integer)):
            # degree ctor: a 1x...x1 zero tensor of the given degree
            # (tensor.h:145-150; python binding `xerus.Tensor(3)`)
            dimensions = [1] * int(dimensions)
        elif isinstance(dimensions, Tensor):
            src = dimensions.copy()  # copy ctor (python binding `Tensor(A)`)
            self.dimensions = src.dimensions
            self.factor = src.factor
            self.representation = src.representation
            # .copy() duplicated any mutable (numpy) dense buffer, so a
            # later __setitem__ on the copy cannot write through
            self._dense = src._dense
            self._sparse = src._sparse
            return
        elif hasattr(dimensions, "to_tensor"):
            # cast ctor: contract a TensorNetwork/TTNetwork to a single
            # tensor (python binding `xerus.Tensor(ttA)`; tensorNetwork.h
            # conversion operator)
            src = dimensions.to_tensor()
            self.dimensions = list(src.dimensions)
            self.factor = src.factor
            self.representation = src.representation
            self._dense = src._dense
            self._sparse = (dict(src._sparse)
                            if src._sparse is not None else None)
            return
        self.dimensions: List[int] = [int(d) for d in dimensions]
        self.factor: float = 1.0
        self.representation = representation
        self._dense = None            # np.ndarray | torch.Tensor | None
        self._sparse: Optional[Dict[int, float]] = None
        if data is not None:
            arr = np.asarray(data, dtype=config.value_dtype)
            require(arr.size == self.size, "data size does not match dimensions")
            self._dense = arr.reshape(self.dimensions)
            self.representation = Representation.Dense
        elif representation is Representation.Dense:
            self._dense = np.zeros(self.dimensions, dtype=config.value_dtype)
        else:
            self._sparse = {}

    # ------------------------------------------------------------------
    # Constructors (tensor.h:212-352)
    # ------------------------------------------------------------------
    @classmethod
    def from_function(cls, dimensions: Sequence[int], fn: Callable) -> "Tensor":
        """Dense tensor filled by ``fn``.

        ``fn`` may take 0 args, 1 arg (linear position) or 1 tuple arg
        (multi-index), mirroring the three lambda ctors (tensor.h:163-202).
        """
        t = cls(dimensions, Representation.Dense, Initialisation.Nothing)
        size = t.size
        flat = np.empty(size, dtype=config.value_dtype)
        import inspect
        nparams = len(inspect.signature(fn).parameters)
        if nparams == 0:
            for i in range(size):
                flat[i] = fn()
        elif nparams == 1:
            # decide by probing: multi-index fns take a tuple/list
            try:
                probe = fn(0)
                takes_linear = True
            except Exception:
                takes_linear = False
                probe = None
            if takes_linear:
                flat[0] = probe
                for i in range(1, size):
                    flat[i] = fn(i)
            else:
                dims = t.dimensions
                for i in range(size):
                    flat[i] = fn(cls.position_to_multiIndex(i, dims))
        else:
            dims = t.dimensions
            for i in range(size):
                flat[i] = fn(*cls.position_to_multiIndex(i, dims))
        t._dense = flat.reshape(t.dimensions)
        return t

    @classmethod
    def from_ndarray(cls, array) -> "Tensor":
        arr = np.asarray(array, dtype=config.value_dtype)
        t = cls(arr.shape, Representation.Dense, Initialisation.Nothing)
        t._dense = arr.copy()
        return t

    @classmethod
    def from_torch(cls, array: torch.Tensor) -> "Tensor":
        """A dense Tensor holding a copy of ``array``, on its device: later
        writes to ``array`` do not reach the Tensor."""
        return cls._wrap(array.detach().to(dtype=torch_dtype(), copy=True))

    @classmethod
    def _wrap(cls, array: torch.Tensor) -> "Tensor":
        """Hold ``array`` itself (no copy when it has the value dtype): for
        results the object layer computed, which nothing writes in place."""
        t = cls.__new__(cls)
        t.dimensions = [int(d) for d in array.shape]
        t.factor = 1.0
        t.representation = Representation.Dense
        t._dense = array.to(dtype=torch_dtype())
        t._sparse = None
        return t

    @classmethod
    def random(cls, dimensions: Sequence[int], n: Optional[int] = None,
               generator=None) -> "Tensor":
        """Dense normal-random tensor; with ``n`` given, sparse with n entries
        (tensor.h:212-330)."""
        rng = generator if generator is not None else _misc.randomEngine
        if n is None:
            t = cls(dimensions, Representation.Dense, Initialisation.Nothing)
            t._dense = rng.normal(size=tuple(t.dimensions)).astype(config.value_dtype)
            return t
        t = cls(dimensions, Representation.Sparse)
        require(n <= t.size, "cannot place more non-zeros than entries")
        while len(t._sparse) < n:
            pos = int(rng.integers(0, t.size))
            if pos not in t._sparse:
                t._sparse[pos] = float(rng.normal())
        return t

    @classmethod
    def random_orthogonal(cls, dims1: Sequence[int], dims2: Sequence[int],
                          generator=None) -> "Tensor":
        """Haar-random orthogonal matrix reshaped to dims1 + dims2
        (tensor.h:246-300; built here via QR of a Gaussian with sign fix)."""
        rng = generator if generator is not None else _misc.randomEngine
        m, n = _prod(dims1), _prod(dims2)
        big, small = max(m, n), min(m, n)
        g = rng.normal(size=(big, small)).astype(config.value_dtype)
        q, r = np.linalg.qr(g)
        q = q * np.sign(np.diag(r))[None, :]
        if m < n:
            q = q.T
        t = cls(list(dims1) + list(dims2), Representation.Dense, Initialisation.Nothing)
        t._dense = np.ascontiguousarray(q.reshape(list(dims1) + list(dims2)))
        return t

    @classmethod
    def ones(cls, dimensions: Sequence[int]) -> "Tensor":
        t = cls(dimensions, Representation.Dense, Initialisation.Nothing)
        t._dense = np.ones(t.dimensions, dtype=config.value_dtype)
        return t

    @classmethod
    def identity(cls, dimensions: Sequence[int]) -> "Tensor":
        """Identity operator: first half of modes x second half (tensor.h:305)."""
        dims = [int(d) for d in dimensions]
        require(len(dims) % 2 == 0, "identity requires even degree")
        half = len(dims) // 2
        require(dims[:half] == dims[half:], "identity requires dims[i]==dims[d/2+i]")
        m = _prod(dims[:half])
        t = cls(dims, Representation.Sparse)
        for i in range(m):
            t._sparse[i * m + i] = 1.0
        return t

    @classmethod
    def kronecker(cls, dimensions: Sequence[int]) -> "Tensor":
        """Entry is 1 iff all indices equal (tensor.h:313)."""
        dims = [int(d) for d in dimensions]
        t = cls(dims, Representation.Sparse)
        if not dims:
            t._sparse[0] = 1.0
            return t
        for i in range(min(dims)):
            t._sparse[cls.multiIndex_to_position([i] * len(dims), dims)] = 1.0
        return t

    @classmethod
    def dirac(cls, dimensions: Sequence[int], position) -> "Tensor":
        dims = [int(d) for d in dimensions]
        t = cls(dims, Representation.Sparse)
        if isinstance(position, (list, tuple, np.ndarray)):
            pos = cls.multiIndex_to_position(position, dims)
        else:
            pos = int(position)
        require(pos < t.size, "dirac position out of range")
        t._sparse[pos] = 1.0
        return t

    # ------------------------------------------------------------------
    # Information (tensor.h:388-445)
    # ------------------------------------------------------------------
    @property
    def size(self) -> int:
        return _prod(self.dimensions)

    def degree(self) -> int:
        return len(self.dimensions)

    @property
    def order(self) -> int:
        return len(self.dimensions)

    def has_factor(self) -> bool:
        return self.factor != 1.0

    def is_dense(self) -> bool:
        return self.representation is Representation.Dense

    def is_sparse(self) -> bool:
        return self.representation is Representation.Sparse

    def sparsity(self) -> int:
        if self.is_sparse():
            return len(self._sparse)
        return self.size

    def count_non_zero_entries(self, eps: Optional[float] = None) -> int:
        eps = float(np.finfo(config.value_dtype).eps) if eps is None else eps
        if self.is_sparse():
            f = abs(self.factor)
            return sum(1 for v in self._sparse.values() if abs(v) * f > eps)
        arr = self._dense_host()
        return int(np.sum(np.abs(arr * self.factor) > eps))

    def all_entries_valid(self) -> bool:
        if self.is_sparse():
            return all(math.isfinite(v) for v in self._sparse.values())
        return bool(np.all(np.isfinite(self._dense_host())))

    def reorder_cost(self) -> int:
        return self.sparsity()

    def frob_norm(self) -> float:
        if self.is_sparse():
            return abs(self.factor) * math.sqrt(
                sum(v * v for v in self._sparse.values()))
        return float(torch.linalg.vector_norm(self._torch()))

    def one_norm(self) -> float:
        if self.is_sparse():
            return abs(self.factor) * sum(abs(v) for v in self._sparse.values())
        return float(self._torch().abs().sum())

    # ------------------------------------------------------------------
    # Data access helpers
    # ------------------------------------------------------------------
    def _dense_host(self) -> np.ndarray:
        """Host numpy view of the dense data (factor NOT applied)."""
        require(self.is_dense(), "dense data requested from sparse tensor")
        if isinstance(self._dense, np.ndarray):
            return self._dense
        return self._dense.detach().cpu().numpy()

    def _make_host_mutable(self) -> np.ndarray:
        """Ensure dense data is a private, mutable numpy buffer (a copy of
        torch-held data, which other Tensors may share)."""
        self.use_dense_representation()
        if not isinstance(self._dense, np.ndarray):
            self._dense = np.array(self._dense.detach().cpu().numpy())
        return self._dense

    def to_torch(self, apply_factor: bool = True) -> torch.Tensor:
        """The data on the compute device (``config.device``: the card
        unless ``host()`` was entered; raises RuntimeError without one),
        factor folded in, as a tensor of the caller's own: writing it
        changes no Tensor."""
        out = self._torch(apply_factor)
        if self.is_dense() and out.data_ptr() == self._dense.data_ptr():
            out = out.clone()
        return out

    def _torch(self, apply_factor: bool = True) -> torch.Tensor:
        """``to_torch`` without the copy: the compute view the object layer
        reads, which may be the held buffer itself and is never written.
        A host buffer is promoted: copied to the device once and held there
        (an element write takes a private host copy again), so repeated
        computations do not upload it again and never alias it."""
        dev, dt = compute_device(), torch_dtype()
        if self.is_sparse():
            out = torch.tensor(self._sparse_to_dense_np(), dtype=dt,
                               device=dev)
        elif isinstance(self._dense, np.ndarray):
            self._dense = out = torch.tensor(self._dense, dtype=dt,
                                             device=dev)
        else:
            out = self._dense.to(device=dev, dtype=dt)
        if apply_factor and self.factor != 1.0:
            out = out * self.factor
        return out.reshape(self.dimensions)

    def to_ndarray(self) -> np.ndarray:
        if self.is_sparse():
            arr = self._sparse_to_dense_np()
        else:
            arr = self._dense_host()
        out = np.array(arr, dtype=config.value_dtype)
        if self.factor != 1.0:
            out = out * self.factor
        return out.reshape(self.dimensions)

    def _sparse_to_dense_np(self) -> np.ndarray:
        flat = np.zeros(self.size, dtype=config.value_dtype)
        if self._sparse:
            idx = np.fromiter(self._sparse.keys(), dtype=np.int64, count=len(self._sparse))
            val = np.fromiter(self._sparse.values(), dtype=config.value_dtype,
                              count=len(self._sparse))
            flat[idx] = val
        return flat.reshape(self.dimensions) if self.dimensions else flat.reshape(())

    def sparse_coo(self) -> Tuple[np.ndarray, np.ndarray]:
        """(linear_positions[int64], values) with factor NOT applied."""
        require(self.is_sparse(), "coo requested from dense tensor")
        n = len(self._sparse)
        pos = np.fromiter(self._sparse.keys(), dtype=np.int64, count=n)
        val = np.fromiter(self._sparse.values(), dtype=config.value_dtype, count=n)
        order = np.argsort(pos, kind="stable")
        return pos[order], val[order]

    # ------------------------------------------------------------------
    # Arithmetic
    # ------------------------------------------------------------------
    def _check_same_dims(self, other: "Tensor") -> None:
        require(self.dimensions == other.dimensions,
                f"dimension mismatch {self.dimensions} vs {other.dimensions}")

    def __iadd__(self, other: "Tensor") -> "Tensor":
        return self._plus_minus_equal(other, +1.0)

    def __isub__(self, other: "Tensor") -> "Tensor":
        return self._plus_minus_equal(other, -1.0)

    def _plus_minus_equal(self, other: "Tensor", sign: float) -> "Tensor":
        self._check_same_dims(other)
        if self.is_sparse() and other.is_sparse():
            f = sign * other.factor / self.factor if self.factor != 0 else None
            if self.factor == 0.0:
                # degenerate zero factor: re-normalize
                self.apply_factor()
                f = sign * other.factor
            for k, v in other._sparse.items():
                self._sparse[k] = self._sparse.get(k, 0.0) + f * v
            return self
        a = self._torch()
        b = other._torch()
        self._dense = a + sign * b
        self._sparse = None
        self.representation = Representation.Dense
        self.factor = 1.0
        return self

    def __add__(self, other: "Tensor") -> "Tensor":
        out = self.copy()
        out += other
        return out

    def __sub__(self, other: "Tensor") -> "Tensor":
        out = self.copy()
        out -= other
        return out

    def __imul__(self, factor: float) -> "Tensor":
        self.factor *= float(factor)
        return self

    def __itruediv__(self, divisor: float) -> "Tensor":
        self.factor /= float(divisor)
        return self

    def __mul__(self, factor) -> "Tensor":
        if isinstance(factor, (int, float, np.floating, np.integer)):
            out = self.copy()
            out.factor *= float(factor)
            return out
        return NotImplemented

    __rmul__ = __mul__

    def __truediv__(self, divisor) -> "Tensor":
        if isinstance(divisor, (int, float, np.floating, np.integer)):
            out = self.copy()
            out.factor /= float(divisor)
            return out
        return NotImplemented

    def __neg__(self) -> "Tensor":
        out = self.copy()
        out.factor = -out.factor
        return out

    def copy(self) -> "Tensor":
        out = Tensor.__new__(Tensor)
        out.dimensions = list(self.dimensions)
        out.factor = self.factor
        out.representation = self.representation
        # torch tensors are never written in place -> share
        out._dense = (self._dense.copy() if isinstance(self._dense, np.ndarray)
                      else self._dense)
        out._sparse = dict(self._sparse) if self._sparse is not None else None
        return out

    def _dense_copy(self) -> "Tensor":
        out = self.copy()
        out.use_dense_representation()
        return out

    def _sparse_copy(self) -> "Tensor":
        out = self.copy()
        out.use_sparse_representation()
        return out

    # public binding names (python/tensor.cpp dense_copy/sparse_copy)
    dense_copy = _dense_copy
    sparse_copy = _sparse_copy

    def ensure_own_data_no_copy(self) -> None:
        """No-op: held torch tensors are never written in place
        (tensor.h:843 semantics)."""

    # ------------------------------------------------------------------
    # Element access (tensor.h:485-520)
    # ------------------------------------------------------------------
    def _linear_pos(self, key) -> int:
        if isinstance(key, (list, tuple, np.ndarray)):
            return self.multiIndex_to_position(key, self.dimensions)
        pos = int(key)
        require(0 <= pos < max(self.size, 1), f"position {pos} out of range")
        return pos

    def __getitem__(self, key) -> float:
        pos = self._linear_pos(key)
        if self.is_sparse():
            return self.factor * self._sparse.get(pos, 0.0)
        if isinstance(self._dense, np.ndarray):
            return float(self.factor * self._dense.reshape(-1)[pos])
        # one element to the host, without a copy of a non-contiguous view
        mi = self.position_to_multiIndex(pos, self.dimensions)
        return float(self.factor * float(self._dense[mi]))

    def __setitem__(self, key, value: float) -> None:
        pos = self._linear_pos(key)
        if self.is_sparse():
            if self.factor != 1.0:
                self.apply_factor()
            self._sparse[pos] = float(value)
            return
        if self.factor != 1.0:
            self.apply_factor()
        arr = self._make_host_mutable()
        arr.reshape(-1)[pos] = float(value)

    def at(self, pos: int) -> float:
        return self[pos]

    def cat(self, pos: int) -> float:
        return self[pos]

    # ------------------------------------------------------------------
    # Modifiers (tensor.h:666-815)
    # ------------------------------------------------------------------
    def reset(self, dimensions: Sequence[int] = (),
              representation: Optional[Representation] = None,
              init: Initialisation = Initialisation.Zero,
              data=None) -> None:
        rep = representation if representation is not None else self.representation
        self.__init__(dimensions, rep, init, data=data)

    def reinterpret_dimensions(self, new_dimensions: Sequence[int]) -> None:
        new_dims = [int(d) for d in new_dimensions]
        require(_prod(new_dims) == self.size,
                f"reinterpret size mismatch {new_dims} vs {self.dimensions}")
        if self.is_dense():
            self._dense = self._dense.reshape(new_dims)
        self.dimensions = new_dims

    def resize_mode(self, mode: int, new_dim: int, cut_pos: Optional[int] = None) -> None:
        """Grow (insert zero slates before cut_pos) or shrink (remove slates
        ending at cut_pos) one mode (tensor.h:727, tensor.cpp resize_mode)."""
        old_dim = self.dimensions[mode]
        new_dim = int(new_dim)
        cut_pos = old_dim if cut_pos is None else min(int(cut_pos), old_dim)
        if new_dim == old_dim:
            return
        if self.is_sparse():
            if self.factor != 1.0:
                self.apply_factor()
            stride_after = _prod(self.dimensions[mode + 1:])
            new_data: Dict[int, float] = {}
            if new_dim > old_dim:
                shift = new_dim - old_dim
                for pos, v in self._sparse.items():
                    idx = (pos // stride_after) % old_dim
                    rest_hi = pos // (stride_after * old_dim)
                    rest_lo = pos % stride_after
                    nidx = idx if idx < cut_pos else idx + shift
                    new_data[(rest_hi * new_dim + nidx) * stride_after + rest_lo] = v
            else:
                removed = old_dim - new_dim
                lo = cut_pos - removed
                for pos, v in self._sparse.items():
                    idx = (pos // stride_after) % old_dim
                    if lo <= idx < cut_pos:
                        continue
                    nidx = idx if idx < lo else idx - removed
                    rest_hi = pos // (stride_after * old_dim)
                    rest_lo = pos % stride_after
                    new_data[(rest_hi * new_dim + nidx) * stride_after + rest_lo] = v
            self._sparse = new_data
        else:
            arr = self.to_ndarray()
            self.factor = 1.0
            if new_dim > old_dim:
                pad_shape = list(arr.shape)
                pad_shape[mode] = new_dim - old_dim
                arr = np.concatenate(
                    [np.take(arr, range(0, cut_pos), axis=mode),
                     np.zeros(pad_shape, dtype=arr.dtype),
                     np.take(arr, range(cut_pos, old_dim), axis=mode)], axis=mode)
            else:
                removed = old_dim - new_dim
                keep = list(range(0, cut_pos - removed)) + list(range(cut_pos, old_dim))
                arr = np.take(arr, keep, axis=mode)
            self._dense = np.ascontiguousarray(arr)
        self.dimensions[mode] = new_dim

    def fix_mode(self, mode: int, slate: int) -> None:
        """Fix one mode to a value, reducing order by one (tensor.h:736)."""
        require(0 <= mode < self.degree(), "fix_mode: invalid mode")
        require(0 <= slate < self.dimensions[mode], "fix_mode: invalid slate")
        if self.is_sparse():
            stride_after = _prod(self.dimensions[mode + 1:])
            dim = self.dimensions[mode]
            new_data = {}
            for pos, v in self._sparse.items():
                idx = (pos // stride_after) % dim
                if idx != slate:
                    continue
                rest_hi = pos // (stride_after * dim)
                rest_lo = pos % stride_after
                new_data[rest_hi * stride_after + rest_lo] = v
            self._sparse = new_data
        elif isinstance(self._dense, np.ndarray):
            self._dense = np.ascontiguousarray(np.take(self._dense, slate,
                                                       axis=mode))
        else:
            self._dense = self._dense.select(mode, slate).contiguous()
        del self.dimensions[mode]

    def remove_slate(self, mode: int, pos: int) -> None:
        self.resize_mode(mode, self.dimensions[mode] - 1, pos + 1)

    def perform_trace(self, first_mode: int, second_mode: int) -> None:
        require(first_mode != second_mode, "trace requires distinct modes")
        require(self.dimensions[first_mode] == self.dimensions[second_mode],
                "trace requires equal dimensions")
        a, b = sorted((first_mode, second_mode))
        # the diagonal goes last, the remaining modes keep their order
        out = torch.diagonal(self._torch(), 0, a, b).sum(-1)
        new_dims = [d for i, d in enumerate(self.dimensions) if i not in (a, b)]
        self.dimensions = new_dims
        self.factor = 1.0
        self._dense = out
        self._sparse = None
        self.representation = Representation.Dense

    def modify_diagonal_entries(self, fn: Callable) -> None:
        require(self.degree() == 2, "modify_diagonal_entries defined for matrices")
        self.apply_factor()
        arr = self._make_host_mutable()
        import inspect
        nargs = len(inspect.signature(fn).parameters)
        for i in range(min(self.dimensions)):
            arr[i, i] = fn(arr[i, i]) if nargs == 1 else fn(arr[i, i], i)

    def modify_entries(self, fn: Callable) -> None:
        self.apply_factor()
        arr = self._make_host_mutable().reshape(-1)
        import inspect
        nargs = len(inspect.signature(fn).parameters)
        if nargs == 1:
            for i in range(arr.size):
                arr[i] = fn(arr[i])
        else:
            dims = self.dimensions
            for i in range(arr.size):
                arr[i] = fn(arr[i], i if nargs == 2 else
                            self.position_to_multiIndex(i, dims))

    def offset_add(self, other: "Tensor", offsets: Sequence[int]) -> None:
        """Add ``other`` into this tensor at the given per-mode offsets
        (tensor.h:793)."""
        require(other.degree() == self.degree(), "offset_add degree mismatch")
        self.apply_factor()
        arr = self._make_host_mutable()
        sl = tuple(slice(o, o + d) for o, d in zip(offsets, other.dimensions))
        arr[sl] += other.to_ndarray()

    def use_dense_representation(self) -> None:
        if self.is_dense():
            return
        self._dense = self._sparse_to_dense_np()
        self._sparse = None
        self.representation = Representation.Dense

    def use_dense_representation_if_desirable(self) -> None:
        if self.is_sparse() and self.sparsity() * Tensor.sparsityFactor >= self.size:
            self.use_dense_representation()

    def use_sparse_representation(self, eps: Optional[float] = None) -> None:
        if self.is_sparse():
            return
        eps = float(np.finfo(config.value_dtype).eps) if eps is None else eps
        arr = self._dense_host().reshape(-1)
        nz = np.nonzero(np.abs(arr) > eps / abs(self.factor) if self.factor != 0
                        else np.abs(arr) > eps)[0]
        self._sparse = {int(i): float(arr[i]) for i in nz}
        self._dense = None
        self.representation = Representation.Sparse

    def apply_factor(self) -> None:
        if self.factor == 1.0:
            return
        if self.is_sparse():
            f = self.factor
            for k in self._sparse:
                self._sparse[k] *= f
        else:
            self._dense = self._dense * self.factor
        self.factor = 1.0

    def ensure_own_data(self) -> None:
        """No-op: numpy buffers are copied on copy(), torch tensors shared
        and never written in place."""

    def ensure_own_data_and_apply_factor(self) -> None:
        self.apply_factor()

    # ------------------------------------------------------------------
    # Indexing hook: T(i, j, ...) -> IndexedTensor (tensor.h:612-658)
    # ------------------------------------------------------------------
    def __call__(self, *indices):
        from ..indexing.expressions import IndexedTensor
        return IndexedTensor(self, list(indices))

    # ------------------------------------------------------------------
    # Auxiliary (tensor.h:1040-1046)
    # ------------------------------------------------------------------
    @staticmethod
    def multiIndex_to_position(multi_index, dimensions) -> int:
        require(len(multi_index) == len(dimensions), "multi-index order mismatch")
        pos = 0
        for idx, dim in zip(multi_index, dimensions):
            idx = int(idx)
            require(0 <= idx < dim, f"index {idx} out of range for dim {dim}")
            pos = pos * int(dim) + idx
        return pos

    @staticmethod
    def position_to_multiIndex(position: int, dimensions) -> Tuple[int, ...]:
        out = []
        for dim in reversed(dimensions):
            out.append(position % dim)
            position //= dim
        return tuple(reversed(out))

    def __float__(self) -> float:
        require(self.degree() == 0 or self.size == 1,
                "cannot cast non-scalar Tensor to float")
        return float(self[0])

    def __repr__(self) -> str:
        return f"Tensor(dims={self.dimensions}, rep={self.representation.name}, factor={self.factor})"

    def to_string(self) -> str:
        return np.array2string(self.to_ndarray(), precision=6)

    # the reference's Python __str__ prints the entries (python/tensor.cpp)
    __str__ = to_string


# ---------------------------------------------------------------------------
# Free functions (tensor.h:860-1031)
# ---------------------------------------------------------------------------

def reshuffle(base: Tensor, shuffle: Sequence[int]) -> Tensor:
    """``out[perm(idx)] = base[idx]``: shuffle[k] is the *new* position of old
    mode k (tensor.h:60-65).  Note this is the inverse convention of
    np.transpose's axes argument."""
    shuffle = [int(s) for s in shuffle]
    require(len(shuffle) == base.degree(), "reshuffle order mismatch")
    inverse = [0] * len(shuffle)
    for old_pos, new_pos in enumerate(shuffle):
        inverse[new_pos] = old_pos
    if base.is_sparse():
        out = Tensor([base.dimensions[i] for i in inverse], Representation.Sparse)
        out.factor = base.factor
        old_dims = base.dimensions
        for pos, v in base._sparse.items():
            mi = Tensor.position_to_multiIndex(pos, old_dims)
            new_mi = [mi[i] for i in inverse]
            out._sparse[Tensor.multiIndex_to_position(new_mi, out.dimensions)] = v
        return out
    arr = base._torch(apply_factor=False)
    out = Tensor._wrap(arr.permute(*inverse).contiguous())
    out.factor = base.factor
    return out


def entrywise_product(a: Tensor, b: Tensor) -> Tensor:
    require(a.dimensions == b.dimensions, "entrywise product dimension mismatch")
    if a.is_sparse() or b.is_sparse():
        s, o = (a, b) if a.is_sparse() else (b, a)
        out = Tensor(s.dimensions, Representation.Sparse)
        f = s.factor * o.factor
        if o.is_sparse():
            for k, v in s._sparse.items():
                if k in o._sparse:
                    out._sparse[k] = v * o._sparse[k]
        else:
            oarr = o._dense_host().reshape(-1)
            for k, v in s._sparse.items():
                out._sparse[k] = v * float(oarr[k])
        out.factor = f
        return out
    return Tensor._wrap(a._torch() * b._torch())


def approx_equal(a: Tensor, b: Tensor, eps: Optional[float] = None) -> bool:
    """Relative frobenius-norm comparison (tensor.h:1031)."""
    eps = config.epsilon if eps is None else eps
    diff = a - b
    denom = (a.frob_norm() + b.frob_norm()) / 2.0
    if denom == 0.0:
        return diff.frob_norm() <= eps
    return diff.frob_norm() / denom <= eps


def approx_entrywise_equal(a: Tensor, b, eps: Optional[float] = None) -> bool:
    eps = config.epsilon if eps is None else eps
    av = a.to_ndarray().reshape(-1)
    if isinstance(b, Tensor):
        require(a.dimensions == b.dimensions, "entrywise compare dimension mismatch")
        bv = b.to_ndarray().reshape(-1)
    else:
        bv = np.asarray(b, dtype=config.value_dtype).reshape(-1)
        require(bv.size == av.size, "entrywise compare size mismatch")
    denom = np.abs(av) + np.abs(bv)
    diff = np.abs(av - bv)
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = np.where(denom > 0, diff / denom, 0.0)
    return bool(np.all(rel <= eps))
