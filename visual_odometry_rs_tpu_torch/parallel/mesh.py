"""Device meshes of the port.

The port of ``visual_odometry_rs_tpu/parallel/mesh.py``.  The JAX package is
one controller over every device of its mesh; the port gives each of its two
uses of a mesh the PyTorch idiom that fits it:

- **Lanes over local devices** (data parallel, no communication).  One
  process splits a lane pytree's leading axis over the devices of a mesh
  axis (``shard_batch``), runs each device's part on that device, one thread
  a device so that the devices work at the same time (``run_on_devices``), and
  gathers the results back (``gather_batch``).  What the JAX package does
  with a batch-sharded ``NamedSharding``.
- **Ranks of a process group** (SPMD reductions).  A mesh axis named in
  ``groups`` spans the ranks of a ``torch.distributed`` process group, one
  rank a device: NCCL on CUDA, gloo on the CPU (``init_distributed``).
  Every rank calls the same sharded function with the same replicated
  inputs and works on its own ``1/n`` slice; ``parallel.collectives`` reduces
  across the ranks.  What the JAX package does with ``shard_map`` over
  ``P(axis)`` inputs and ``P()`` outputs.

A mesh has one axis, which is all the port's callers build: the devices of
this process along it (the rank's own device when the axis spans ranks)
and, for an axis that spans ranks, its process group.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..utils.types import resolve_device


class AxisGroup(NamedTuple):
    """The process group of a mesh axis that spans ranks, this rank's index
    in it and its size."""

    group: Any
    rank: int
    size: int


class Mesh(NamedTuple):
    devices: tuple  # torch.device along the axis; the rank's one device on a rank axis
    axis_name: str
    group: Optional[AxisGroup]  # the process group of a rank axis, None for a local one

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size (a rank axis counts its ranks), as JAX's ``Mesh.shape``."""
        return {self.axis_name: self.group.size if self.group is not None else len(self.devices)}

    @property
    def device(self) -> torch.device:
        """This rank's (first) device."""
        return self.devices[0]

    def axis_devices(self, axis: str) -> list:
        """The local devices along ``axis``."""
        if axis != self.axis_name:
            raise KeyError(f"mesh has axis {self.axis_name!r}, not {axis!r}")
        return list(self.devices)


def local_devices(device_type: str = "cuda") -> list:
    """This process's devices of a type: every CUDA device, or the one CPU."""
    if torch.device(device_type).type == "cpu":
        return [torch.device("cpu")]
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None, device="cuda") -> None:
    """Start the default process group of a multi-process run (the JAX
    package's ``jax.distributed.initialize``); nothing if one is up.

    ``backend`` defaults to NCCL when ``device`` is CUDA and to gloo
    otherwise.  ``init_method``, ``world_size`` and ``rank`` default to the
    environment that ``torchrun`` sets (``env://``).  On CUDA the rank's
    device becomes the current one: ``device`` if it names an index, else
    ``cuda:$LOCAL_RANK``."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        resolve_device(device)
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank)


def make_mesh(axis_sizes: Optional[Sequence[int]] = None, axis_names: Sequence[str] = ("data",), devices=None,
              groups: Optional[Dict[str, Any]] = None) -> Mesh:
    """A one-axis mesh, in the JAX package's ``make_mesh`` arguments.

    Default: a ``data`` axis over every local CUDA device.  ``groups`` maps
    the axis name to the process group it spans (``dist.group.WORLD`` or a
    subgroup); such an axis has the group's size, and this process holds
    one index of it on ``devices[0]`` (default: the current CUDA device).
    Otherwise ``devices`` (default: the local CUDA devices) fills the axis
    in order; a device may repeat (two lane shards on one GPU, or several
    on the CPU)."""
    import torch.distributed as dist

    axis_names = tuple(axis_names)
    if len(axis_names) != 1 or (axis_sizes is not None and len(axis_sizes) != 1):
        raise ValueError(f"a mesh has one axis; got sizes {axis_sizes} and names {axis_names}")
    (name,) = axis_names
    groups = dict(groups or {})
    if set(groups) - {name}:
        raise ValueError(f"groups name axes {sorted(set(groups) - {name})} that are not in {axis_names}")
    group = None
    if name in groups:
        group = AxisGroup(groups[name], dist.get_rank(groups[name]), dist.get_world_size(groups[name]))
        if devices is None:
            resolve_device("cuda")
            devices = [torch.device("cuda", torch.cuda.current_device())]
        if axis_sizes is not None and axis_sizes[0] != group.size:
            raise ValueError(f"axis {name!r} has size {axis_sizes[0]} but its group has {group.size} ranks")
        devices = devices[:1]
    elif devices is None:
        devices = local_devices("cuda")
    devices = tuple(torch.device(d) for d in devices)
    if group is None and axis_sizes is not None:
        if axis_sizes[0] > len(devices):
            raise ValueError(f"a mesh of {axis_sizes[0]} devices needs that many, {len(devices)} given")
        devices = devices[:axis_sizes[0]]
    return Mesh(devices=devices, axis_name=name, group=group)


# ---------------------------------------------------------------------------
# Lanes over local devices
# ---------------------------------------------------------------------------


def _map_tree(fn, tree):
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tree(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return tree


def _zip_tree(fn, trees):
    first = trees[0]
    if isinstance(first, (torch.Tensor, np.ndarray)):
        return fn(trees)
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_zip_tree(fn, [t[i] for t in trees]) for i in range(len(first))))
    if isinstance(first, (tuple, list)):
        return type(first)(_zip_tree(fn, [t[i] for t in trees]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _zip_tree(fn, [t[k] for t in trees]) for k in first}
    return first


def shard_batch(tree, mesh: Mesh, axis: str = "data", dim: int = 0) -> list:
    """Split the lane axis ``dim`` of every leaf of ``tree`` over the devices
    of ``mesh[axis]``: a list with one tree per device, its tensors moved
    there.  0-d tensors (shared intrinsics) are copied to every device;
    numpy leaves are sliced and stay on the host.  The lane count must be a
    multiple of the axis size, as the JAX package's sharding needs."""
    devices = mesh.axis_devices(axis)
    n = len(devices)

    def split(x):
        if x.ndim == 0:
            return [x] * n
        lanes = x.shape[dim]
        if lanes % n:
            raise ValueError(f"{lanes} lanes do not split over {n} devices")
        size = lanes // n
        return [x[(slice(None),) * dim + (slice(i * size, (i + 1) * size),)] for i in range(n)]

    parts = []
    for i, device in enumerate(devices):
        def take(x, i=i, device=device):
            piece = split(x)[i]
            return piece.to(device).contiguous() if isinstance(piece, torch.Tensor) else piece
        parts.append(_map_tree(take, tree))
    return parts


def gather_batch(shards: Sequence, device, dim: int = 0):
    """The inverse of ``shard_batch``: every leaf's shards concatenated along
    ``dim`` on ``device`` (0-d leaves: the first shard's)."""
    device = torch.device(device)

    def cat(xs):
        if isinstance(xs[0], np.ndarray):
            return xs[0] if xs[0].ndim == 0 else np.concatenate(xs, axis=dim)
        if xs[0].dim() == 0:
            return xs[0].to(device)
        return torch.cat([x.to(device) for x in xs], dim=dim)

    return _zip_tree(cat, list(shards))


def replicated(tree, mesh: Mesh, axis: str = "data") -> list:
    """``tree`` copied to every device of ``mesh[axis]`` (the JAX package's
    ``P()`` placement): one tree per device."""
    return [_map_tree(lambda x, d=d: x.to(d) if isinstance(x, torch.Tensor) else x, tree)
            for d in mesh.axis_devices(axis)]


def run_on_devices(fn, devices: Sequence[torch.device], args: Sequence[tuple]) -> list:
    """``fn(*args[i])`` for each device, one thread a device with that device
    current (CUDA launches from each thread go to its device and run at the
    same time); the results in device order.  One device: no thread.
    Each thread keeps the caller's intra-op thread count, so that a device's
    CPU operations split their work as the caller's would."""
    threads = torch.get_num_threads()

    def call(device, a):
        torch.set_num_threads(threads)
        with torch.cuda.device(device) if device.type == "cuda" else nullcontext():
            return fn(*a)

    if len(devices) == 1:
        return [call(devices[0], args[0])]
    with ThreadPoolExecutor(max_workers=len(devices)) as pool:
        futures = [pool.submit(call, d, a) for d, a in zip(devices, args)]
        return [f.result() for f in futures]
