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
* :func:`copy_to_model` / :func:`gather_channels`: the two operators of a
  column-parallel conv over a model group (parallel/tp.py).  The conv's
  input is replicated and each rank computes its slice of the output
  channels, so the input's gradient on a rank is only its channels' share:
  ``copy_to_model`` is the identity whose backward sums the gradient over
  the group.  ``gather_channels`` joins the slices; everything after it
  runs alike on every rank, so its backward keeps the rank's slice of the
  (equal) full gradient.

Tensors are NHWC, "rows" dim 1, but for the two TP operators, which take
the convs' NCHW tensors.  With a mesh of one process (``group`` None)
every collective is the identity and the halo is zeros.
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


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        # summed in float32 at least: a bf16 gradient is rounded once, after
        # the sum, as a single conv's backward rounds it
        g = grad.to(torch.promote_types(grad.dtype, torch.float32),
                    memory_format=torch.contiguous_format, copy=True)
        dist.all_reduce(g, group=ctx.group)
        return g.to(grad.dtype), None


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        ctx.rank, ctx.c = dist.get_rank(group), y.shape[1]
        return gather_cat(y, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return grad[:, ctx.rank * ctx.c:(ctx.rank + 1) * ctx.c], None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; in the backward the gradient is summed over the
    model group's ranks.  The input of a conv whose output channels are
    split over the group."""
    return _CopyToModel.apply(x, group)


def gather_channels(y: torch.Tensor, group) -> torch.Tensor:
    """``(B, C / n, H, W)`` -> ``(B, C, H, W)``: the group's channel slices
    joined in rank order, on every rank (contiguous NCHW out); in the
    backward each rank keeps its slice of the gradient.  Every rank must
    call it with slices of one shape."""
    return _GatherChannels.apply(y, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, on every rank; the
    gradient of the output is summed over the ranks in the backward.
    Every rank must call it (and run its backward) in the same order."""
    return _AllReduceSum.apply(x, group)


def gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) of ``group`` joined along ``dim``
    in rank order, on every rank; contiguous out."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group.size())]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def all_gather_cat(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """Every data rank's ``x`` (equal shapes) joined along ``dim`` in rank
    order, on every rank: dim 1 of NHWC blocks is JAX's ``all_gather(...,
    tiled=True)`` over rows, dim 0 joins per-rank batches."""
    return x if mesh.group is None else gather_cat(x, mesh.group, dim)


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
