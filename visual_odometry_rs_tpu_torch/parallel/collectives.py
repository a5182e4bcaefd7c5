"""Collectives over a mesh axis that spans the ranks of a process group.

The port of ``visual_odometry_rs_tpu/parallel/collectives.py`` on
``torch.distributed``, plus the fixed-order sum that the port's sharded
solves use where the JAX package calls ``psum``.

- ``psum``: an all-gather, then a sum in rank order on every rank.  NCCL's
  and gloo's ``all_reduce`` fix no order in which the ranks are summed;
  here two runs, and every rank, get the same bits, so the replicated LM
  state stays the same on every rank (the rule "reductions in a fixed
  order, no float atomic").  A pytree of tensors travels packed in one
  tensor: one collective a call.
- ``ring_reduce_scatter``, ``ring_all_gather``, ``ring_all_reduce``: the
  JAX package's rings, hop for hop.  Each hop sends to rank ``j + 1`` and
  receives from ``j - 1`` (``dist.batch_isend_irecv``, JAX's ``ppermute``
  permutation ``j → j+1``); the reduce-scatter's accumulator starts at chunk
  ``idx - 1`` and adds chunk ``(idx - s - 2) % n`` at hop ``s``, so every
  element is summed in JAX's order and the results are bit-equal to its.

gloo moves no CUDA tensor point to point, so on gloo a CUDA tensor goes
through a host copy (NCCL moves it directly).  An axis without a process
group has one index (a local axis of size 1): every collective is then the
identity.
"""

from __future__ import annotations

from typing import Optional

import torch

from .mesh import AxisGroup, Mesh


def axis_group(mesh: Mesh, axis: str) -> Optional[AxisGroup]:
    """The process group of ``mesh[axis]``, or None for a local axis of one
    device; a local axis of several devices cannot carry a sharded
    reduction (one rank a device: ``mesh.init_distributed``)."""
    if mesh.group is not None and axis == mesh.axis_name:
        return mesh.group
    if mesh.shape[axis] != 1:
        raise ValueError(
            f"mesh axis {axis!r} spans {mesh.shape[axis]} local devices; a sharded reduction needs an axis that "
            "spans the ranks of a process group (make_mesh(..., groups={axis: group}))"
        )
    return None


def _staged(x: torch.Tensor, ag: AxisGroup):
    """``x`` as the backend can move it: a host copy for gloo and CUDA."""
    import torch.distributed as dist

    if x.device.type == "cuda" and dist.get_backend(ag.group) == "gloo":
        return x.cpu()
    return x


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for item in tree for leaf in _leaves(item)]


def _unflatten(tree, flat: torch.Tensor, offset: int = 0):
    if isinstance(tree, torch.Tensor):
        n = tree.numel()
        return flat[offset: offset + n].view(tree.shape).to(tree.dtype), offset + n
    out = []
    for item in tree:
        value, offset = _unflatten(item, flat, offset)
        out.append(value)
    return (type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)), offset


def psum(tree, mesh: Mesh, axis: str):
    """Sum a tensor, or a tuple of tensors, over ``mesh[axis]``: every rank
    gets the same sum, taken in rank order.  The tensors are packed in one
    f32 tensor (integer counts included, exact below 2^24)."""
    import torch.distributed as dist

    ag = axis_group(mesh, axis)
    if ag is None:
        return tree
    leaves = _leaves(tree)
    packed = torch.cat([x.reshape(-1).to(torch.float32) for x in leaves])
    send = _staged(packed, ag)
    parts = [torch.empty_like(send) for _ in range(ag.size)]
    dist.all_gather(parts, send, group=ag.group)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    total = total.to(packed.device)
    return _unflatten(tree, total)[0]


def _shift(x: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """One ring hop: send ``x`` to rank ``j + 1``, return what rank ``j - 1`` sent."""
    import torch.distributed as dist

    send = _staged(x.contiguous(), ag)
    recv = torch.empty_like(send)
    to = dist.get_global_rank(ag.group, (ag.rank + 1) % ag.size)
    frm = dist.get_global_rank(ag.group, (ag.rank - 1) % ag.size)
    ops = [dist.P2POp(dist.isend, send, to, ag.group), dist.P2POp(dist.irecv, recv, frm, ag.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device)


def _chunks(x: torch.Tensor, n: int) -> torch.Tensor:
    lead = x.shape[0]
    if lead % n != 0:
        raise ValueError(f"leading dim {lead} not divisible by axis size {n}")
    return x.reshape(n, lead // n, *x.shape[1:])


def ring_reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Ring reduce-scatter: rank ``i`` returns chunk ``i`` (leading dim
    ``x.shape[0] / n``) of the sum of every rank's ``x``, after n-1 hops.
    The leading dim must be a multiple of the axis size."""
    ag = axis_group(mesh, axis)
    n = 1 if ag is None else ag.size
    chunks = _chunks(x, n)
    if n == 1:
        return chunks[0]
    idx = ag.rank
    acc = chunks[(idx - 1) % n]
    for s in range(n - 1):
        acc = _shift(acc, ag) + chunks[(idx - s - 2) % n]
    return acc


def ring_all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Ring all-gather: every rank's ``x`` concatenated along the leading
    axis in rank order, after n-1 hops."""
    ag = axis_group(mesh, axis)
    if ag is None or ag.size == 1:
        return x
    n, idx = ag.size, ag.rank
    out = x.new_empty((n, *x.shape))
    out[idx] = x
    buf = x
    for s in range(n - 1):
        buf = _shift(buf, ag)
        out[(idx - s - 1) % n] = buf  # whose chunk just arrived
    return out.reshape(n * x.shape[0], *x.shape[1:])


def ring_all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """All-reduce as a ring reduce-scatter and a ring all-gather; the
    leading dim must be a multiple of the axis size."""
    return ring_all_gather(ring_reduce_scatter(x, mesh, axis), mesh, axis)
