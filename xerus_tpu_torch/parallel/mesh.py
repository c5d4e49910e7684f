"""Device meshes and the collectives of the parallel layer.

The port of ``xerus_tpu/parallel/mesh.py``.  The JAX package is single-
controller: one process holds a ``Mesh`` of devices, and GSPMD or
``shard_map`` inserts the collectives.  The port is SPMD over
``torch.distributed``: every rank calls each parallel function with the
same replicated inputs, takes its own shard by its mesh coordinate, and
returns the replicated result, so the JAX signatures hold.  JAX's
collectives map to explicit ones over a mesh axis's process group:
``psum`` to ``all_reduce``, ``all_gather`` to ``all_gather_single``,
``psum_scatter`` to ``reduce_scatter_single`` and ``all_to_all`` to
``all_to_all_single``.

Axis roles, as in the JAX package:

* ``dp``: the measurement / sample / batch axis (ADF, UQ-ADF, batched
  sweeps, site blocks);
* ``tp``: the rank axis of large matricizations (ALS environments and
  local systems, TSQR rounding).

No function initializes a process group behind the caller's back: the
caller does (``torch.distributed.init_process_group`` or the
``process_group`` context manager; NCCL on the card, gloo when the caller
asks for the CPU) and passes the mesh.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard


@contextlib.contextmanager
def process_group(backend: str, init_method: str, rank: int = 0,
                  world_size: int = 1):
    """The caller's explicit process group for a block of parallel calls:
    ``init_process_group(backend, init_method, rank, world_size)`` on
    entry, ``destroy_process_group()`` on exit.  ``init_method`` is a
    rendezvous of the caller's choosing (``tcp://localhost:<port>`` or
    ``file://<path>``); "nccl" needs a card and has no fallback."""
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def default_mesh(n_devices: Optional[int] = None,
                 axis_names: Tuple[str, str] = ("dp", "tp")) -> DeviceMesh:
    """2-D (dp, tp) mesh over the ranks of the initialized default group:
    tp is the largest of 2, 4 and 8 that divides n with n / tp >= tp, dp
    gets the rest (the JAX package's rule).  The mesh lives on the card
    for an NCCL group, on the CPU otherwise."""
    if not dist.is_initialized():
        raise RuntimeError(
            "default_mesh: no process group; call torch.distributed."
            "init_process_group (NCCL on the card, gloo on the CPU) first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"default_mesh: requested {n} devices but the "
                         f"process group has {world} ranks")
    tp = 1
    for cand in (2, 4, 8):
        if n % cand == 0 and n // cand >= cand:
            tp = cand
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device, torch.arange(n).reshape(n // tp, tp),
                      mesh_dim_names=tuple(axis_names))


def _placements(mesh: DeviceMesh, sharded: dict):
    return tuple(sharded.get(name, Replicate())
                 for name in mesh.mesh_dim_names)


def measurement_sharding(mesh: DeviceMesh):
    """Placements that shard the leading (measurement) axis over dp."""
    return _placements(mesh, {"dp": Shard(0)})


def rank_sharding(mesh: DeviceMesh, axis_index: int, ndim: int):
    """Placements that shard axis ``axis_index`` (of ``ndim``) over tp."""
    if not 0 <= axis_index < ndim:
        raise ValueError(f"axis {axis_index} out of range for {ndim} dims")
    return _placements(mesh, {"tp": Shard(axis_index)})


def replicated(mesh: DeviceMesh):
    """Placements that replicate over every mesh axis."""
    return _placements(mesh, {})


def local_shard(t: torch.Tensor, mesh: DeviceMesh, placements
                ) -> torch.Tensor:
    """This rank's block of the replicated tensor ``t`` under
    ``placements``: along each sharded dimension the chunk of
    ``torch.tensor_split`` at the rank's coordinate on that mesh axis
    (uneven sizes allowed, as torch's DTensor chunks)."""
    coord = mesh.get_coordinate()
    for mdim, p in enumerate(placements):
        if isinstance(p, Shard):
            t = torch.tensor_split(t, mesh.size(mdim), dim=p.dim)[coord[mdim]]
    return t


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors of ``mesh`` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class Axis:
    """One mesh axis as seen from this rank: its process group, size and
    this rank's index on it, with the collectives over it (issued on an
    axis of size 1 too, so that a one-rank group runs the same calls)."""

    def __init__(self, mesh: DeviceMesh, name: str):
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"expected a torch.distributed DeviceMesh, got "
                            f"{type(mesh).__name__}")
        if name not in mesh.mesh_dim_names:
            raise ValueError(f"mesh has no axis {name!r} "
                             f"(axes {mesh.mesh_dim_names})")
        dim = mesh.mesh_dim_names.index(name)
        self.group = mesh.get_group(name)
        self.size = mesh.size(dim)
        self.index = mesh.get_coordinate()[dim]

    def block(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's ``tensor_split`` chunk of ``t`` along ``dim``."""
        return torch.tensor_split(t, self.size, dim=dim)[self.index]

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the axis (all_reduce), a new tensor."""
        out = t.contiguous().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Concatenate equal-shape blocks of every rank along ``dim``."""
        t = t.movedim(dim, 0).contiguous()
        out = t.new_empty((self.size * t.shape[0],) + tuple(t.shape[1:]))
        _gather_fn()(out, t, group=self.group)
        return out.movedim(0, dim)

    def psum_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Sum over the axis and keep this rank's tiled block along
        ``dim`` (``lax.psum_scatter(..., tiled=True)``)."""
        t = t.movedim(dim, 0).contiguous()
        out = t.new_empty((t.shape[0] // self.size,) + tuple(t.shape[1:]))
        _scatter_fn()(out, t, group=self.group)
        return out.movedim(0, dim)

    def all_to_all(self, t: torch.Tensor, split_dim: int, concat_dim: int
                   ) -> torch.Tensor:
        """``lax.all_to_all(..., tiled=True)``: split ``split_dim`` into
        one block per rank, send block j to rank j and concatenate the
        blocks received along ``concat_dim`` in rank order."""
        blocks = torch.stack(torch.chunk(t, self.size, dim=split_dim))
        out = torch.empty_like(blocks)
        dist.all_to_all_single(out, blocks.contiguous(), group=self.group)
        return torch.cat(list(out.unbind(0)), dim=concat_dim)

    def gather_uneven(self, t: torch.Tensor, total: int, dim: int = 0
                      ) -> torch.Tensor:
        """Concatenate the ``tensor_split`` chunks of a length-``total``
        axis (held one per rank) back into the whole along ``dim``."""
        sizes = [len(c) for c in torch.tensor_split(torch.arange(total),
                                                    self.size)]
        width = max(sizes)
        pad = [0, 0] * (t.dim() - 1 - dim) + [0, width - t.shape[dim]]
        full = self.all_gather(torch.nn.functional.pad(t, pad), dim)
        parts = torch.split(full, width, dim=dim)
        return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)],
                         dim=dim)


def _gather_fn():
    return getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor


def _scatter_fn():
    return getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor


def to_mesh_tensors(arrays: Sequence, mesh: DeviceMesh):
    """Inputs (numpy arrays or tensors) as tensors on this rank's device."""
    dev = mesh_device(mesh)
    return [torch.as_tensor(a, device=dev) for a in arrays]
