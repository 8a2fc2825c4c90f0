"""One stream's frames split over the ranks by rows
(tecogan_tpu/parallel/spatial.py): the single-stream scaling axis for
output above 1080p.

The LR frame's H rows are split into ``n`` blocks of ``R = H / n``; rank
r serves rows ``[r R, (r + 1) R)`` of every activation (``4R`` at HR)
through the whole generator.  The port computes what the JAX functions
compute, with the layers the single-device routes run:

* **3x3 convs** run on the block extended by one row of each neighbour
  (:func:`collectives.halo_rows`, zeros at the image's edge), then
  keep the middle ``R`` rows: rows 1..R of a SAME conv over R + 2 rows read
  no padding, which is ``_conv3x3_rows``' H-VALID conv.
* **The 2x transposed convs** (``ConvTranspose2x``, ``int8_up2x``) run on
  the block extended by the next rank's top row and keep the first ``2R``
  output rows: ``out[2t + 1]`` reads ``x_t`` and ``x_{t+1}``, ``out[2t]``
  reads ``x_t`` alone.  This replaces the phase decomposition of
  ``_convt2x_rows``.
* **The int8 layers** get their bf16 rows extended before the kernel,
  which quantizes every row with the layer's global scale: the integers of
  quantizing first and exchanging after.  The fused residual of
  ``int8_conv3x3`` is extended with zero rows and cropped with its input.
* **conv_out + sigmoid + s2d** (the ``conv_out_s2d`` kernel, which needs an
  HR height a multiple of 4) runs on the ``4R`` feature rows extended by 4
  rows each side and keeps the middle ``R`` s2d rows.  The JAX sharded path
  takes an XLA conv here; the port keeps its kernel.
* **The warp** is the one global dependency: the carried SR frame is
  all-gathered once a frame, the warp computed on the full frame and this
  rank's rows kept.  The exact route builds the full pseudo-flow grid,
  slices the rank's ``4R`` grid rows and samples with ``grid_sample``; the
  fused route runs the warp kernel on the full s2d carry (``n`` times the
  work of one rank's rows on a short kernel) and keeps ``R`` rows of its
  feedback.  Every rank holds the whole LR clip, so the previous LR frame
  needs no gather (JAX gathers it because its input is row-sharded).

``infer`` takes the whole clip on every rank and returns the whole SR clip
on every rank (the ranks' rows all-gathered at the end).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ..config import TecoConfig
from ..engine import fused
from ..engine.inference import _dequant_in, _require_fused
from ..engine.quant import _chain, _conv_layers, int8_conv3x3, int8_up2x
from ..models import Generator
from ..ops.image import deprocess
from ..ops.space import space_to_depth
from ..ops.warp import grid_sample, pseudo_flow_nchw
from .collectives import all_gather_cat, halo_rows
from .mesh import Mesh


def _nhwc_layer(layer: torch.nn.Module) -> Callable:
    return lambda x: layer(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def conv3x3_rows(conv: Callable, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A 3x3 SAME conv ``conv`` (NHWC -> NHWC) on a row block ``(B, R, W, C)``:
    the unsharded conv's R rows (a mesh of one rank runs it as it is)."""
    if mesh.size == 1:
        return conv(x)
    R = x.shape[1]
    return conv(halo_rows(x, mesh, 1, 1))[:, 1:R + 1]


def up2x_rows(up: Callable, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A 2x transposed conv ``up`` (k3, s2, p1, op1; NHWC) on a row block
    ``(B, R, W, C)`` -> the unsharded output's ``2R`` rows."""
    if mesh.size == 1:
        return up(x)
    R = x.shape[1]
    return up(halo_rows(x, mesh, 0, 1))[:, :2 * R]


def spatial_generator_apply(model: Generator, x_blk: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``model(x)`` (models/generator.py) on a row block ``(B, R, W, 51)`` ->
    ``(B, 4R, 4W, out)``, every conv on halo'd rows."""
    relu = F.relu

    def conv(layer, x):
        return conv3x3_rows(_nhwc_layer(layer), x, mesh)

    def convt(layer, x):
        return up2x_rows(_nhwc_layer(layer), x, mesh)

    net = relu(conv(model.conv_in, x_blk.to(model.dtype)))
    for i in range(model.num_resblock):
        rb = getattr(model, f"resblock_{i}")
        net = conv(rb.Conv_1, relu(conv(rb.Conv_0, net))) + net
    net = relu(convt(model.up1, net))
    for rb in (model.trunk_rb1, model.trunk_rb2):  # plain conv stacks, no skip
        net = conv(rb.Conv_1, relu(conv(rb.Conv_0, net)))
    net = relu(convt(model.up2, net))
    net = relu(conv(model.conv_hr, net))
    net = conv(model.conv_out, net)
    return torch.sigmoid(net.to(model.out_dtype))


def _check_rows(H: int, mesh: Mesh) -> int:
    if H % mesh.size:
        raise ValueError(f"LR height {H} not divisible by {mesh.size} shards")
    return H // mesh.size


def build_spatial_clip_inference(cfg: TecoConfig, mesh: Mesh):
    """``infer(model, lr_clip) -> sr_clip`` with ONE stream's rows split over
    the mesh's ranks: the exact route of ``engine.inference`` (``sr_step`` /
    ``first_frame``, with the fp16 grid rounding under ``bug_parity``).

    lr_clip: (B, T, H, W, 3) float [0, 1] or uint8, the whole clip on every
    rank; H divisible by the mesh's size.  Returns (B, T, 4H, 4W, 3) float32
    on every rank."""
    parity_half = cfg.bug_parity

    @torch.inference_mode()
    def infer(model: Generator, lr_clip: torch.Tensor) -> torch.Tensor:
        lr = _dequant_in(lr_clip)
        B, T, H, W, _ = lr.shape
        R = _check_rows(H, mesh)
        rows = slice(mesh.rank * R, (mesh.rank + 1) * R)
        zeros = torch.zeros((B, R, W, 48), dtype=torch.float32, device=lr.device)
        sr = spatial_generator_apply(model, torch.cat([lr[:, 0, rows], zeros], dim=-1), mesh)
        out = [sr]
        for t in range(1, T):
            prev_sr = all_gather_cat(sr.float(), mesh, 1)  # (B, 4H, 4W, 3)
            grid = pseudo_flow_nchw(lr[:, t - 1].permute(0, 3, 1, 2), parity_half)
            warped = grid_sample(prev_sr, grid[:, 4 * rows.start:4 * rows.stop])
            feedback = space_to_depth(deprocess(warped))  # (B, R, W, 48)
            sr = spatial_generator_apply(
                model, torch.cat([lr[:, t, rows], feedback], dim=-1), mesh)
            out.append(sr)
        return all_gather_cat(torch.stack(out, dim=1).float(), mesh, 2)

    return infer


# ---------------------------------------------------------------------------
# the fused route (engine/fused.py), row-sharded
# ---------------------------------------------------------------------------

def _first_layer_rows(model: Generator, inp: torch.Tensor, weight: torch.Tensor,
                      mesh: Mesh) -> torch.Tensor:
    """relu(conv3x3(inp) + conv_in's bias) on a row block, NHWC."""
    bias = model.conv_in.bias

    def conv(x):
        y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, padding=1)
        return y.permute(0, 2, 3, 1)

    return F.relu(conv3x3_rows(conv, inp.to(model.dtype), mesh))


def spatial_tail_features(model: Generator, net: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``model.tail_features`` on a row block ``(B, R, W, 64)`` -> ``(B, 4R,
    4W, 64)``: ``engine.quant._chain``'s control flow over the model's
    layers on halo'd rows."""
    layers = _conv_layers(model)

    def conv(x, name, relu=False, residual=None):
        layer = layers[name]
        rows = up2x_rows if layer.transposed else conv3x3_rows
        y = rows(_nhwc_layer(layer.module), x, mesh)
        if relu:
            y = F.relu(y)
        return y if residual is None else y + residual

    return _chain(model, net.to(model.dtype), conv)


def spatial_tail_features_int8(model: Generator, qtail, net: torch.Tensor,
                               mesh: Mesh) -> torch.Tensor:
    """``engine.quant.tail_features_int8`` on a row block: each layer's
    int8 kernel on the halo'd bf16 rows (quantized inside with the layer's
    global scale), the fused residual extended by zero rows and cropped
    with its input."""
    layers = _conv_layers(model)

    def conv(x, name, relu=False, residual=None):
        q = qtail[name]
        args = (q["inv_s"], q["wq"], q["deq"], q["bias"], relu)
        if layers[name].transposed:
            return up2x_rows(lambda h: int8_up2x(h, *args), x, mesh)
        if residual is not None and mesh.size > 1:
            residual = F.pad(residual, (0, 0, 0, 0, 1, 1))
        return conv3x3_rows(lambda h: int8_conv3x3(h, *args, residual), x, mesh)

    return _chain(model, net.to(model.dtype).contiguous(), conv)


def conv_out_s2d_rows(model: Generator, feat: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``engine.fused.conv_out_s2d`` (the kernel on the card) on ``4R``
    feature rows ``(B, 4R, 4W, 64)`` -> the carry's ``R`` s2d rows
    ``(B, R, W, 48)``: 4 halo rows each side keep the kernel's HR height a
    multiple of 4."""
    params = fused.conv_out_params(model)
    if mesh.size == 1:
        return fused.conv_out_s2d(feat, *params)
    R = feat.shape[1] // 4
    return fused.conv_out_s2d(halo_rows(feat, mesh, 4, 4), *params)[:, 1:R + 1]


def build_spatial_fused_clip_inference(cfg: TecoConfig, mesh: Mesh, quantize: bool = False):
    """The fused s2d-carry route (``engine.fused``, what
    ``build_clip_inference`` serves with ``use_pallas`` and not
    ``bug_parity``) with ONE stream's rows split over the mesh's ranks.

    Returns ``infer(model, lr_clip)``, or with ``quantize=True``
    ``infer(model, qtail, lr_clip)`` with the qtail of
    ``build_quantized_clip_inference``'s ``prepare`` (the same on every
    rank: ``parallel.dp.calibrate_on_rank0``).  Shapes as
    :func:`build_spatial_clip_inference`.  On the card every rank runs the
    hand kernels: ``warp_s2d`` on the gathered carry, ``conv_out_s2d`` on
    its halo'd feature rows and, quantized, both int8 kernels on its
    halo'd rows."""
    if quantize:
        _require_fused(cfg)

    def run(model: Generator, lr_clip: torch.Tensor, tail: Callable) -> torch.Tensor:
        lr = _dequant_in(lr_clip)
        B, T, H, W, _ = lr.shape
        R = _check_rows(H, mesh)
        rows = slice(mesh.rank * R, (mesh.rank + 1) * R)
        w_in = model.conv_in.weight
        # frame 0: zero feedback, so conv_in reduces to its LR slice
        net = _first_layer_rows(model, lr[:, 0, rows], w_in[:, :3], mesh)
        carry = conv_out_s2d_rows(model, tail(net), mesh)
        carries = [carry]
        for t in range(1, T):
            carry_full = all_gather_cat(carry, mesh, 1)  # (B, H, W, 48)
            feedback = fused.carry_feedback(carry_full, lr[:, t - 1], cfg.warp_group)
            inp = torch.cat([lr[:, t, rows].to(model.dtype),
                             feedback[:, rows].to(model.dtype)], dim=-1)
            net = _first_layer_rows(model, inp, w_in, mesh)
            carry = conv_out_s2d_rows(model, tail(net), mesh)
            carries.append(carry)
        s2d = all_gather_cat(torch.stack(carries, dim=1), mesh, 2)  # (B, T, H, W, 48)
        return fused.s2d_to_frame(s2d).to(torch.float32,
                                          memory_format=torch.contiguous_format)

    if quantize:
        @torch.inference_mode()
        def infer_q(model: Generator, qtail, lr_clip: torch.Tensor) -> torch.Tensor:
            return run(model, lr_clip,
                       lambda net: spatial_tail_features_int8(model, qtail, net, mesh))

        return infer_q

    @torch.inference_mode()
    def infer(model: Generator, lr_clip: torch.Tensor) -> torch.Tensor:
        return run(model, lr_clip, lambda net: spatial_tail_features(model, net, mesh))

    return infer
