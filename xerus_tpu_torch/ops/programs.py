"""Captured programs: the port's counterpart of the JAX package's compiled
sweeps, solves and iterations (``jit_f32`` + ``lru_cache`` of the ``make_*``
factories, ``xerus_tpu/ops/tt_kernels.py:25``).

A ``Program`` wraps a function of tensors (nested tuples and lists of
them; every static argument is bound before).  On CPU tensors it runs the
function eagerly: the caller asked for the CPU.  On the card:

- its first ``EAGER_CALLS`` calls run the function eagerly, so a solve
  that calls each of its programs no more often than that (the one-shot
  Poisson solve) costs what the eager solve costs: a capture takes longer
  on the host than several eager runs of the same function;
- the next call is the port's compile: the inputs are copied into static
  buffers of the same shapes, strides and dtypes, the function runs once
  eagerly on a side stream (the warm-up, a real run whose result is
  returned), then it is captured into a ``torch.cuda.CUDAGraph`` with a
  private memory pool, under ``torch.cuda.set_sync_debug_mode("error")``,
  so a hidden host read in the region raises at capture instead of
  slipping into a wrong graph;
- every later call copies the inputs into the static buffers and replays
  the graph.  The copies in and out go by ``torch._foreach_copy_``, one
  multi-tensor launch for the dense tensors of a dtype: the card waits
  while the host launches them, so one launch a tensor would add the
  host's launch time to every replay.

Outputs are never views of the graph's memory: each call returns fresh
tensors (copies of the static outputs with their strides), which the next
replay does not touch.  A capture or replay that fails raises; nothing
reruns the eager function in its place.

A captured program holds its private pool (``pool_bytes``) for as long as
it lives, and each factory (``factory``) keeps up to its ``maxsize``
programs: ``held_bytes()`` is what the live programs hold, and ``clear()``
drops every cached program and gives its memory back.

Host-side counters move during a capture although nothing runs then.
Each module registers its counters where it defines them (``counter``):
the helper records their deltas over a capture, puts them back, and adds
the deltas on each replay, so a launch counter counts what ran; a counter
registered with ``moves=False`` (the host reads) must not move inside a
region at all.  ``Program`` keeps ``eager_runs``, ``captures`` and
``replays`` totals on the class and per program.
"""

from __future__ import annotations

import ctypes
import time
import weakref
from functools import lru_cache
from typing import Dict, List, Tuple

import torch

# eager calls of a program on the card before it is captured
EAGER_CALLS = 2

# (owner, attribute) -> may it move inside a captured region; in the order
# of registration
_COUNTERS: Dict[Tuple[object, str], bool] = {}


def counter(owner, attr: str, moves: bool = True) -> None:
    """Register the integer counter ``owner.attr``: with ``moves`` each
    replay adds what the captured run added to it; without, a capture that
    moves it raises."""
    _COUNTERS[(owner, attr)] = moves


def counter_name(c: Tuple[object, str]) -> str:
    return f"{c[0].__name__}.{c[1]}"


def counter_values() -> Dict[str, int]:
    """Every registered counter's value, by ``counter_name``."""
    return {counter_name(c): getattr(*c) for c in _COUNTERS}


def add_counts(deltas: Dict[Tuple[object, str], int]) -> None:
    """Add ``deltas`` (counter -> count) to the counters."""
    for (owner, attr), v in deltas.items():
        setattr(owner, attr, getattr(owner, attr) + v)


def record_counts(fn, *args):
    """Run ``fn(*args)`` and put every registered counter back as it was.
    Returns (result, deltas): the counts the run added, by counter,
    non-zero ones only.  Raises if a counter registered with
    ``moves=False`` moved."""
    before = {c: getattr(*c) for c in _COUNTERS}
    try:
        out = fn(*args)
    finally:
        deltas = {c: getattr(*c) - v for c, v in before.items()
                  if getattr(*c) != v}
        for c, v in before.items():
            setattr(*c, v)
    fixed = {counter_name(c): n for c, n in deltas.items()
             if not _COUNTERS[c]}
    if fixed:
        raise RuntimeError(f"{fixed} moved inside a captured region")
    return out, deltas


# every factory of programs, for clear()
_FACTORIES: List = []


def factory(maxsize: int):
    """``lru_cache(maxsize)`` for a function that makes programs; ``clear()``
    empties it."""
    def wrap(fn):
        cached = lru_cache(maxsize=maxsize)(fn)
        _FACTORIES.append(cached)
        return cached
    return wrap


def clear() -> None:
    """Drop every factory's cached programs (graphs, static buffers and
    private pools) and give the card memory they held back to the device.
    A program still referenced elsewhere keeps its own."""
    for f in _FACTORIES:
        f.cache_clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# captured programs still alive, for held_bytes()
_LIVE: "weakref.WeakSet[Program]" = weakref.WeakSet()


def held_bytes() -> int:
    """The private pools' bytes of the captured programs still alive."""
    return sum(p.pool_bytes for p in _LIVE)


# ---------------------------------------------------------------------------
# trees of tensors


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for sub in tree for t in _leaves(sub)]
    raise TypeError(f"a program takes tensors and tuples or lists of them, "
                    f"not {type(tree).__name__}")


def _rebuild(tree, leaves):
    """``tree``'s structure (tuples for lists too) with its tensors taken
    in order from the iterator ``leaves``."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    return tuple(_rebuild(sub, leaves) for sub in tree)


def dtype_str(t: torch.Tensor) -> str:
    """The dtype's name as the JAX package writes it ("float32")."""
    return str(t.dtype).removeprefix("torch.")


def shapes_key(*trees):
    """The cache key of a program's inputs: the trees' structure with each
    tensor's shape, strides, dtype and device."""
    def spec(tree):
        if isinstance(tree, torch.Tensor):
            return (tuple(tree.shape), tuple(tree.stride()), dtype_str(tree),
                    str(tree.device))
        return tuple(spec(sub) for sub in tree)
    return spec(trees)


def program_for(factory, args, *static) -> "Program":
    """``factory(shapes_key(*args), dtype, *static)``: the program that
    ``call`` runs on ``args``, the first leaf's dtype as the key's."""
    return factory(shapes_key(*args), dtype_str(_leaves(args)[0]), *static)


def call(factory, args, *static, eager: bool = False):
    """``program_for(factory, args, *static)`` on ``args``; with ``eager``
    its function, run eagerly (the plain version, by the caller's explicit
    request)."""
    program = program_for(factory, args, *static)
    return program.fn(*args) if eager else program(*args)


def _graph_nodes(graph) -> int:
    """Nodes of a captured graph (kept by ``keep_graph=True``), by
    libcuda's ``cuGraphGetNodes``."""
    n = ctypes.c_size_t(0)
    rc = _libcuda().cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                    None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
    return int(n.value)


@lru_cache(maxsize=1)
def _libcuda():
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    return lib


def _fresh(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device=t.device)


class Program:
    """``fn`` as a captured CUDA graph on the card, eager on the CPU (see
    the module's docstring).  ``key`` is the inputs' ``shapes_key`` from
    the first call on the card on; after the capture: ``nodes`` (graph
    nodes), ``pool_bytes`` (device memory reserved over the capture: the
    private pool, held for the program's lifetime), ``capture_s`` (host
    seconds of the capture and instantiation), ``deltas`` (counter counts
    added per replay)."""

    eager_runs = 0
    captures = 0
    replays = 0

    def __init__(self, fn, name: str = ""):
        self.fn = fn
        self.name = name or getattr(fn, "__qualname__", "program")
        self.key = None
        self.graph = None
        self.eager_runs = self.captures = self.replays = 0
        self.nodes = self.pool_bytes = 0
        self.capture_s = 0.0
        self.deltas: Dict[Tuple[object, str], int] = {}
        self._static_in: List[torch.Tensor] = []
        self._static_out = None

    def __call__(self, *args):
        leaves = _leaves(args)
        devices = {t.device for t in leaves}
        if all(d.type == "cpu" for d in devices):
            return self.fn(*args)
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise ValueError(f"program {self.name}: inputs on {devices}, "
                             "needs one CUDA device (or the CPU)")
        key = shapes_key(*args)
        if self.key is None:
            self.key = key
        elif key != self.key:
            raise ValueError(f"program {self.name}: inputs {key} differ from "
                             f"the first call's {self.key}")
        if self.graph is not None:
            return self._replay(leaves)
        if self.eager_runs < EAGER_CALLS:
            self.eager_runs += 1
            Program.eager_runs += 1
            return self.fn(*args)
        return self._capture(args, leaves)

    def _load(self, leaves) -> None:
        torch._foreach_copy_(self._static_in, leaves)

    def _capture(self, args, leaves):
        dev = leaves[0].device
        self._static_in = [_fresh(t) for t in leaves]
        self._load(leaves)
        static_args = _rebuild(args, iter(self._static_in))
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            result = self.fn(*static_args)      # the warm-up, a real run
        current.wait_stream(side)
        inputs = {t.untyped_storage().data_ptr() for t in self._static_in}
        result = _rebuild(result, iter([
            t.clone(memory_format=torch.preserve_format)
            if t.untyped_storage().data_ptr() in inputs else t
            for t in _leaves(result)]))

        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        reserved = []

        def capture():
            # entering synchronizes and empties the allocator's cache
            with torch.cuda.graph(graph):
                reserved.append(torch.cuda.memory_reserved(dev))
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return self.fn(*static_args)
                finally:
                    torch.cuda.set_sync_debug_mode(mode)

        out, self.deltas = record_counts(capture)
        self.nodes = _graph_nodes(graph)
        graph.instantiate()
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved[0]
        self.capture_s = time.perf_counter() - t0
        self._static_out = out
        self.graph = graph
        _LIVE.add(self)
        self.captures += 1
        Program.captures += 1
        return result

    def _replay(self, leaves):
        self._load(leaves)
        self.graph.replay()
        add_counts(self.deltas)
        self.replays += 1
        Program.replays += 1
        outs = _leaves(self._static_out)
        copies = [_fresh(t) for t in outs]
        torch._foreach_copy_(copies, outs)
        return _rebuild(self._static_out, iter(copies))
