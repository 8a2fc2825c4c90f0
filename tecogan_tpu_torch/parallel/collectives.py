"""The collectives of the multi-device paths, on ``torch.distributed``.

* :func:`all_reduce_sum`: a sum all-reduce that autograd can go through:
  its backward all-reduces the incoming gradient, so a loss that reads a
  statistic of the global batch (BatchNorm over the data-parallel
  batch) gets the total derivative over every rank's samples.
* :func:`all_gather_cat`: the ranks' blocks joined along a dim: the row
  blocks of a frame along H (JAX's ``all_gather(..., tiled=True)``), or
  per-rank batches.
* :func:`halo_rows`: a row block extended by its neighbours' boundary
  rows, zeros at the image's edge, which is SAME padding
  (tecogan_tpu/parallel/spatial.py:63-88, there with ``ppermute``).  It
  is one ``all_gather`` of each rank's top and bottom rows: gloo and NCCL
  both implement it, on CPU and CUDA tensors, so one path serves both.

Tensors are NHWC; "rows" is dim 1.  With a mesh of one process
(``group`` None) every collective is the identity and the halo is zeros.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import Mesh


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, on every rank; the
    gradient of the output is summed over the ranks in the backward.
    Every rank must call it (and run its backward) in the same order."""
    return _AllReduceSum.apply(x, group)


def all_gather_cat(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) joined along ``dim`` in rank order,
    on every rank: dim 1 of NHWC blocks is JAX's ``all_gather(...,
    tiled=True)`` over rows, dim 0 joins per-rank batches."""
    if mesh.group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, dim=dim)


def halo_rows(x: torch.Tensor, mesh: Mesh, up: int = 1, down: int = 1) -> torch.Tensor:
    """``(B, R, W, C)`` -> ``(B, up + R + down, W, C)``: ``up`` rows of the
    previous rank's bottom above, ``down`` rows of the next rank's top
    below, zeros where there is no neighbour (the image's edge).  Needs
    ``up, down <= R``; contiguous out."""
    B, R, W, C = x.shape
    if max(up, down) > R:
        raise ValueError(f"a halo of {max(up, down)} rows needs blocks of at least as "
                         f"many rows, got {R}")
    if mesh.group is None or mesh.size == 1 or up == down == 0:
        return F.pad(x, (0, 0, 0, 0, up, down))
    # what this rank's neighbours read: its top rows (the previous rank's
    # bottom halo) and its bottom rows (the next rank's top halo)
    edge = torch.cat([x[:, :down], x[:, R - up:]], dim=1).contiguous()
    parts = [torch.empty_like(edge) for _ in range(mesh.size)]
    dist.all_gather(parts, edge, group=mesh.group)
    r, n = mesh.rank, mesh.size
    top = parts[r - 1][:, down:] if r > 0 else x.new_zeros((B, up, W, C))
    bottom = parts[r + 1][:, :down] if r < n - 1 else x.new_zeros((B, down, W, C))
    return torch.cat([top, x, bottom], dim=1)
