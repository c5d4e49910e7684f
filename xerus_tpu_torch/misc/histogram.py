"""Log-bucketed histogram (reference: include/xerus/misc/histogram.h,
src/xerus/misc/histogram.cpp:25-106; used by benchmark.cxx:231-263)."""

from __future__ import annotations

import math
from typing import Dict


class LogHistogram:
    """Histogram with buckets [base^i, base^(i+1))."""

    def __init__(self, base: float) -> None:
        if base <= 1.0:
            raise ValueError("base must be > 1")
        self.base = float(base)
        self.buckets: Dict[int, int] = {}

    def add(self, x: float, count: int = 1) -> int:
        if x <= 0 or not math.isfinite(x):
            raise ValueError(f"cannot add non-positive/non-finite value {x}")
        bucket = int(math.floor(math.log(x) / math.log(self.base)))
        self.buckets[bucket] = self.buckets.get(bucket, 0) + count
        return bucket

    def __iadd__(self, other: "LogHistogram") -> "LogHistogram":
        if abs(other.base - self.base) > 1e-12:
            raise ValueError("histogram bases differ")
        for k, v in other.buckets.items():
            self.buckets[k] = self.buckets.get(k, 0) + v
        return self

    def total_count(self) -> int:
        return sum(self.buckets.values())

    def dump_to_file(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(f"# xerus_tpu LogHistogram base {self.base}\n")
            for k in sorted(self.buckets):
                f.write(f"{self.base ** k}\t{self.buckets[k]}\n")

    @classmethod
    def read_from_file(cls, path: str) -> "LogHistogram":
        with open(path) as f:
            header = f.readline().split()
            base = float(header[-1])
            hist = cls(base)
            for line in f:
                if not line.strip():
                    continue
                val, cnt = line.split("\t")
                hist.add(float(val) * math.sqrt(base), int(cnt))
        return hist
