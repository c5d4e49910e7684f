"""Global random engine.

The reference keeps a thread-local ``std::mt19937_64 randomEngine`` seeded
deterministically for tests (src/xerus/misc/random.cpp:29-31, test.cpp:90-96).
``randomEngine`` here is a stable proxy delegating to a reseedable numpy
Generator, so references imported elsewhere survive ``set_seed``.  Host-side
randomness builds concrete arrays that then move to the device; the engine
and its draws are those of ``xerus_tpu.misc.random``, so one ``set_seed``
gives the same tensors in both packages.
"""

from __future__ import annotations

import numpy as np

_DEFAULT_SEED = 0xBAADF00D


class _EngineProxy:
    def __init__(self, seed: int):
        self._gen = np.random.Generator(np.random.PCG64(seed))

    def reseed(self, seed: int) -> None:
        self._gen = np.random.Generator(np.random.PCG64(seed))

    def __getattr__(self, name):
        return getattr(self._gen, name)


randomEngine = _EngineProxy(_DEFAULT_SEED)


def set_seed(seed: int) -> None:
    randomEngine.reseed(seed)


def normal(shape=(), mean: float = 0.0, std: float = 1.0) -> np.ndarray:
    return randomEngine.normal(mean, std, size=shape)


def uniform(shape=(), low: float = 0.0, high: float = 1.0) -> np.ndarray:
    return randomEngine.uniform(low, high, size=shape)
