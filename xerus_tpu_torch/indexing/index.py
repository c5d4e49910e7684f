"""Named indices with span modifiers.

The port of ``xerus_tpu.indexing.index``, the reference's ``xerus::Index``
(include/xerus/index.h:43-168, src/xerus/index.cpp).  An ``Index`` owns a unique id; span modifiers return
copies:

* ``i ^ d`` / ``i ** d`` — span d modes,
* ``i & d``             — span (degree - d) modes of the indexed object,
* ``i / n``             — span degree/n modes.

Plain Python ints inside a call ``T(2, i)`` act as FIXED indices
(index.h:82-91).
"""

from __future__ import annotations

import itertools
from typing import List, Optional

_id_counter = itertools.count(1)


class Index:
    __slots__ = ("value_id", "span", "inverse_span", "fractional_span", "fixed_position")

    def __init__(self, _value_id: Optional[int] = None, _span: int = 1,
                 _inverse: bool = False, _fractional: bool = False,
                 _fixed: Optional[int] = None):
        self.value_id = next(_id_counter) if _value_id is None else _value_id
        self.span = _span
        self.inverse_span = _inverse
        self.fractional_span = _fractional
        self.fixed_position = _fixed

    # -- span modifiers --------------------------------------------------
    def __xor__(self, span: int) -> "Index":
        return Index(self.value_id, int(span))

    def __pow__(self, span: int) -> "Index":
        return Index(self.value_id, int(span))

    def __and__(self, span: int) -> "Index":
        return Index(self.value_id, int(span), _inverse=True)

    def __truediv__(self, denom: int) -> "Index":
        return Index(self.value_id, int(denom), _fractional=True)

    # reference binding name (python/indexedTensor.cpp:36, a py2-era
    # protocol slot exposed as a plain method there)
    __div__ = __truediv__

    # -- queries ---------------------------------------------------------
    def fixed(self) -> bool:
        return self.fixed_position is not None

    def actual_span(self, degree: int) -> int:
        """Span this index represents in an object of the given order
        (index.cpp set_span)."""
        if self.fixed():
            return 1
        if self.inverse_span:
            if degree < self.span:
                raise ValueError(f"inverse span {self.span} exceeds degree {degree}")
            return degree - self.span
        if self.fractional_span:
            if degree % self.span != 0:
                raise ValueError(f"degree {degree} not divisible by {self.span}")
            return degree // self.span
        return self.span

    def __eq__(self, other) -> bool:
        if not isinstance(other, Index):
            return NotImplemented
        if self.fixed() or other.fixed():
            return False  # fixed indices are never equal (index.h:160)
        return self.value_id == other.value_id

    def __hash__(self) -> int:
        return hash(self.value_id)

    def __repr__(self) -> str:
        if self.fixed():
            return f"Index(fixed={self.fixed_position})"
        mod = "&" if self.inverse_span else ("/" if self.fractional_span else "^")
        return f"Index(id={self.value_id}{mod}{self.span})"


def indices(n: int = 1) -> List[Index]:
    """Create n fresh indices (python.cpp:42 helper)."""
    return [Index() for _ in range(n)]


def as_index(obj) -> Index:
    if isinstance(obj, Index):
        return obj
    if isinstance(obj, (int,)):
        return Index(_fixed=int(obj))
    raise TypeError(f"cannot use {obj!r} as an index")
