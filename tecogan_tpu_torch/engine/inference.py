"""Recurrent 4x VSR inference (tecogan_tpu/engine/inference.py): the
one-shot clip, the chunked long-clip loop and the frame-by-frame stream.

Frame 0 runs with zero feedback; each later frame warps the previous SR
output by the pseudo-flow, packs it space-to-depth, concatenates the next
LR frame and runs the generator.  The JAX ``lax.scan`` becomes a Python
loop over T and ``lax.cond`` a Python branch; the carry stays on the
model's device.  All three entry points run the same per-frame functions
(:func:`_route`), so they agree bit for bit.  On the fused route a bf16
model runs its tail on the fused conv kernels (engine/bf16_tail.py).  The
int8 (W8A8) serving mode (:func:`build_quantized_clip_inference`, and the
chunked loop with a ``qtail``) is the fused route with the generator tail
swapped for the quantized one (engine/quant.py).

Every loop also serves TecoGAN as published: given a
``models.PublishedTecoGAN``, it runs that model's route
(:func:`_published_route`, engine/published.py: FNet's flow, the dense
warp, the bicubic skip) on the s2d carry, whatever route ``cfg`` selects
for dwight-foster's generator; each call picks the route by the model's
class once.  The int8 tail is dwight-foster's generator's only.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch
import torch.nn as nn

from ..config import TecoConfig
from ..models import Generator, PublishedTecoGAN
from ..ops.image import (deprocess, start_host_copy, transfer_dequantize_f32,
                         transfer_to_uint8)
from ..ops.space import space_to_depth
from ..ops.warp import grid_sample, pseudo_flow_nchw
from ..utils.spans import span
from . import published
from .bf16_tail import tail_features_bf16
from .fused import fused_first_frame_s2d, fused_sr_step_s2d, s2d_to_frame
from .quant import calibrate_clip, quantize_tail, tail_features_int8
from .state import model_defs, resolve_device


def sr_step(model: Generator, prev_sr: torch.Tensor, prev_lr: torch.Tensor,
            cur_lr: torch.Tensor, parity_half: bool = True) -> torch.Tensor:
    """One recurrent step, all NHWC: prev_sr (B, 4H, 4W, 3), LR frames
    (B, H, W, 3) -> SR frame (B, 4H, 4W, 3)."""
    with span("warp"):
        grid = pseudo_flow_nchw(prev_lr.permute(0, 3, 1, 2), parity_half)
        warped = grid_sample(prev_sr.float(), grid)
        feedback = space_to_depth(deprocess(warped))  # (B, H, W, 48)
    return model(torch.cat([cur_lr.float(), feedback], dim=-1))


def first_frame(model: Generator, lr0: torch.Tensor) -> torch.Tensor:
    """Frame 0: 48 zero feedback channels."""
    B, H, W, _ = lr0.shape
    zeros = torch.zeros((B, H, W, 48), dtype=torch.float32, device=lr0.device)
    return model(torch.cat([lr0.float(), zeros], dim=-1))


def _dequant_in(lr: torch.Tensor) -> torch.Tensor:
    """uint8 input -> float32 [0,1] on the device; float input of any
    width -> float32, as JAX takes it (the warp kernel reads float32)."""
    if lr.dtype == torch.uint8:
        return transfer_dequantize_f32(lr)
    return lr.float()


class _Route(NamedTuple):
    """The per-frame functions of one route.  ``carry`` is the SR frame
    (B, 4H, 4W, 3) f32 on the exact route and the s2d frame
    (B, H, W, 48) bf16 on the fused route."""

    first: Callable  # (model, lr0) -> carry
    step: Callable  # (model, carry, prev_lr, cur_lr) -> carry
    frames: Callable  # (B, K, *carry) -> (B, K, 4H, 4W, 3) float32
    carry_shape: Callable  # (B, H, W) -> shape of the carry
    carry_dtype: torch.dtype


def _route(cfg: TecoConfig) -> _Route:
    """The route ``cfg`` selects, as in the JAX package: ``use_pallas``
    without ``bug_parity`` is the fused route, with the s2d carry at
    every ``warp_group`` (the JAX NHWC route's bf16 frame, rearranged; the
    warp per :func:`engine.fused.fused_sr_step_s2d`); every other setting
    is the exact route, with the fp16 grid rounding under ``bug_parity``.
    ``cfg.gather_unroll_streams`` only picks a TPU gather lowering, so it
    has nothing to select here.

    On the fused route the model's compute dtype picks the tail: a bf16
    model runs :func:`engine.bf16_tail.tail_features_bf16` (each conv with
    its bias, ReLU and skip add one fused op), any other its modules."""
    if cfg.use_pallas and not cfg.bug_parity:
        def tail(model):
            if model.dtype != torch.bfloat16:
                return None
            return lambda net: tail_features_bf16(model, net)

        def fused_first(model, lr0):
            return fused_first_frame_s2d(model, lr0, tail(model))

        def fused_step(model, carry, prev_lr, cur_lr):
            return fused_sr_step_s2d(model, carry, prev_lr, cur_lr, tail(model),
                                     warp_group=cfg.warp_group)

        return _Route(
            first=fused_first, step=fused_step,
            frames=lambda s2d: s2d_to_frame(s2d).to(
                torch.float32, memory_format=torch.contiguous_format),
            carry_shape=lambda B, H, W: (B, H, W, 48),
            carry_dtype=torch.bfloat16)

    def step(model, prev_sr, prev_lr, cur_lr):
        return sr_step(model, prev_sr, prev_lr, cur_lr, parity_half=cfg.bug_parity)

    return _Route(first=first_frame, step=step, frames=lambda sr: sr.float(),
                  carry_shape=lambda B, H, W: (B, 4 * H, 4 * W, 3),
                  carry_dtype=torch.float32)


def _published_route() -> _Route:
    """The route of TecoGAN as published (engine/published.py): the s2d
    carry of the unclamped SR frame, float32."""
    return _Route(first=published.first_frame, step=published.step,
                  frames=lambda s2d: s2d_to_frame(s2d).contiguous(),
                  carry_shape=lambda B, H, W: (B, H, W, 48), carry_dtype=torch.float32)


def _routes(cfg: TecoConfig) -> Callable:
    """``pick(model) -> _Route``: the published route for a
    ``PublishedTecoGAN``, ``cfg``'s route for dwight-foster's generator."""
    route, pub = _route(cfg), _published_route()
    return lambda model: pub if isinstance(model, PublishedTecoGAN) else route


def _no_published_int8(model) -> None:
    if isinstance(model, PublishedTecoGAN):
        raise ValueError("the int8 (W8A8) tail is dwight-foster's generator's only: "
                         "TecoGAN as published serves in bf16 (float32 on the CPU)")


def _require_fused(cfg: TecoConfig) -> None:
    if cfg.bug_parity or not cfg.use_pallas or cfg.warp_group != 4:
        raise ValueError(
            "int8 inference requires the fused s2d fast path "
            "(bug_parity=False, use_pallas=True, warp_group=4)")


def _int8_route(route: _Route, qtail) -> _Route:
    """The fused ``route`` with the quantized tail ``qtail``."""
    def tail(model):
        return lambda net: tail_features_int8(model, qtail, net)

    return route._replace(
        first=lambda model, lr0: fused_first_frame_s2d(model, lr0, tail(model)),
        step=lambda model, carry, prev_lr, cur_lr: fused_sr_step_s2d(
            model, carry, prev_lr, cur_lr, tail(model)))


def _run(route: _Route, model: Generator, lr: torch.Tensor, carry=None):
    """Frames ``lr`` (B, K, H, W, 3) f32 on the model's device, after the
    state ``carry`` = (SR carry, previous LR frame), or from frame 0 when
    it is None.  Returns the new state and the K carries stacked on dim 1.
    Each frame is the span ``frame``."""
    carries = []
    for t in range(lr.shape[1]):
        with span("frame"):
            if carry is None:
                sr = route.first(model, lr[:, t])
            else:
                sr = route.step(model, carry[0], carry[1], lr[:, t])
        carry = (sr, lr[:, t])
        carries.append(sr)
    return carry, torch.stack(carries, dim=1)


def build_clip_inference(cfg: TecoConfig):
    """Returns ``infer(model, lr_clip) -> sr_clip``.

    ``model`` is a ``models.Generator`` (``engine.state.model_defs(cfg)``
    with loaded weights) on the clip's device; its dtype is the compute
    dtype.  lr_clip: (B, T, H, W, 3) float [0,1] or uint8;
    sr_clip: (B, T, 4H, 4W, 3) float32.  ``model`` may also be a
    ``models.PublishedTecoGAN``, served on its own route.
    """
    pick = _routes(cfg)

    @torch.inference_mode()
    def infer(model: Generator, lr_clip: torch.Tensor) -> torch.Tensor:
        route = pick(model)
        _, carries = _run(route, model, _dequant_in(lr_clip))
        return route.frames(carries)

    return infer


def build_quantized_clip_inference(cfg: TecoConfig):
    """int8 (W8A8) serving: returns ``(prepare, infer)``.  Raises
    ``ValueError`` unless ``cfg`` selects the fused s2d route.

    * ``prepare(model, params, calib_clip, frames=8) -> qtail``: calibrates
      the static activation scales on the first ``frames`` frames of
      ``calib_clip`` (float [0, 1] or uint8) through the real recurrence
      run by ``model``, and quantizes the weights from ``params``, the
      generator's float32 params (the flax tree or a float32
      ``state_dict``; not the serving model's weights, which are held in
      the compute dtype).  The qtail lies on the model's device.
    * ``infer(model, qtail, lr_clip) -> sr_clip``: the fused route with the
      tail's convs as int8 kernels; the first layer, the warp and
      ``conv_out`` stay in the compute dtype.  Shapes as
      :func:`build_clip_inference`.

    The output differs from the bf16 route by the quantization error.
    """
    _require_fused(cfg)
    route = _route(cfg)

    @torch.inference_mode()
    def prepare(model: Generator, params, calib_clip, frames: int = 8):
        _no_published_int8(model)
        dev = next(model.parameters()).device
        clip = _dequant_in(torch.as_tensor(calib_clip)[:, :frames].to(dev))
        return quantize_tail(params, calibrate_clip(model, clip, frames), device=dev)

    @torch.inference_mode()
    def infer(model: Generator, qtail, lr_clip: torch.Tensor) -> torch.Tensor:
        _no_published_int8(model)
        q = _int8_route(route, qtail)
        _, carries = _run(q, model, _dequant_in(lr_clip))
        return q.frames(carries)

    return prepare, infer


def build_chunked_inference(cfg: TecoConfig, out_u8: bool = False):
    """Device memory O(chunk) inference for long clips.  Returns
    ``infer(model, lr_clip, chunk=64, sink=None, qtail=None)``:

    * lr_clip: (B, T, H, W, 3) float [0,1] or uint8, a CPU tensor or a
      numpy array.  It stays on the host; each window of at most ``chunk``
      frames is uploaded, run after the carried (SR carry, previous LR)
      state and handed back.  uint8 windows upload 4x fewer bytes and are
      dequantized on the device.
    * The per-frame math is that of ``build_clip_inference``, so the
      chunked output equals the one-shot output bit for bit.
    * sink=None returns the assembled (B, T, 4H, 4W, 3) CPU clip;
      sink=callable receives each (B, K, 4H, 4W, 3) CPU window in order
      and the function returns None.  A window handed to the sink is its
      own pinned buffer, never written again.
    * out_u8=True converts the windows to uint8 on the device
      (``transfer_to_uint8``), so the sink or the clip receives uint8.
    * qtail: a quantized tail (``build_quantized_clip_inference``'s
      ``prepare``): the windows run the int8 route, bit-equal to its
      one-shot clip.  Fused route only, and dwight-foster's generator only
      (``ValueError`` otherwise).
    * ``model``: a ``models.Generator``, or a ``models.PublishedTecoGAN``
      served on its own route.

    The copy of window i to the host overlaps window i+1's compute: it
    runs on a side stream that waits for window i, and the host hands
    window i over only after it has queued window i+1.

    A window's spans (``utils/spans.py``): ``upload`` (to the device,
    dequantized), its frames' (:func:`_run`), ``output`` (the carries to
    frames, and to uint8), ``copy_start`` (the copy queued) and
    ``copy_wait`` (the host waiting for it); the sink runs outside them.
    """
    pick = _routes(cfg)

    @torch.inference_mode()
    def infer(model: Generator, lr_clip, chunk: int = 64,
              sink: Optional[Callable] = None, qtail=None):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        run_route = pick(model)
        if qtail is not None:
            _no_published_int8(model)
            _require_fused(cfg)
            run_route = _int8_route(run_route, qtail)
        lr_clip = torch.as_tensor(lr_clip).cpu()
        if lr_clip.dtype != torch.uint8:
            lr_clip = lr_clip.float()
        dev = next(model.parameters()).device
        side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        T = lr_clip.shape[1]
        out = []

        def emit(pending):
            host, done = pending
            with span("copy_wait"):
                if done is not None:
                    done.synchronize()
            if sink is None:
                out.append(host)
            else:
                sink(host)

        # Windows run eagerly at their own length: a partial last window
        # needs no padding, since nothing here is compiled per shape.
        carry = pending = None
        for pos in range(0, T, chunk):
            with span("upload"):
                window = _dequant_in(lr_clip[:, pos:pos + chunk].to(dev))
            carry, carries = _run(run_route, model, window, carry)
            with span("output"):
                sr = run_route.frames(carries)
                if out_u8:
                    sr = transfer_to_uint8(sr)
            if pending is not None:
                emit(pending)
            with span("copy_start"):
                pending = start_host_copy(sr, side)
            del sr, carries  # free this window on the device before the next runs
        if pending is not None:
            emit(pending)
        if sink is None:
            return torch.cat(out, dim=1)
        return None

    return infer


class _Window(nn.Module):
    """One window of the chunked loop as a module around the generator,
    so that ``torch.func.functional_call`` can bind its parameters."""

    def __init__(self, model: Generator, route: _Route, out_u8: bool):
        super().__init__()
        self.model = model
        self.route = route
        self.out_u8 = out_u8

    def forward(self, lr_window, carry=None, qtail=None):
        route = self.route if qtail is None else _int8_route(self.route, qtail)
        carry, carries = _run(route, self.model, _dequant_in(lr_window), carry)
        sr = route.frames(carries)
        if self.out_u8:
            sr = transfer_to_uint8(sr)
        # the carried LR frame is a view of the window: a copy, so that the
        # carry is a tensor of its own (as JAX's is)
        return (carry[0], carry[1].clone()), sr


def window_params(model: Generator) -> Dict[str, torch.Tensor]:
    """The params the window programs take: ``model``'s parameters as it
    holds them (the compute dtype, 4-D weights ``channels_last``)."""
    return {k: v.detach() for k, v in model.named_parameters()}


def build_window_programs(cfg: TecoConfig, out_u8: bool = False, quantized: bool = False):
    """The chunked loop's two window programs, as the JAX package's
    ``head_fn`` / ``cont_fn`` (tecogan_tpu/engine/inference.py): returns
    ``(head, cont)`` with

    * ``head(params, lr_window[, qtail]) -> (carry, sr_window)``: frame 0
      cold, then the warm steps over the rest of the window;
    * ``cont(params, carry, lr_window[, qtail]) -> (carry, sr_window)``:
      the warm steps after the carried state.

    ``params`` is :func:`window_params` of a serving generator for
    ``cfg`` (its parameters by name), bound by ``torch.func.
    functional_call`` to a generator on the meta device, so a program
    holds no weights.  ``lr_window`` (B, K, H, W, 3) float [0, 1] or
    uint8 on the params' device; ``carry`` = (SR carry, previous LR frame);
    ``sr_window`` (B, K, 4H, 4W, 3) float32, or uint8 with ``out_u8``
    (``transfer_to_uint8`` on the device).  ``quantized`` programs take
    the qtail (``build_quantized_clip_inference``'s ``prepare``) as their
    last input and run the int8 route (fused route only, ``ValueError``
    otherwise).  Each window runs ``_run``, the per-frame functions of
    :func:`build_chunked_inference`, so the windows equal its output bit
    for bit; a partial last window may be padded with its last frame and
    trimmed, since a frame depends on none after it.  No gradient is
    recorded when no input requires one; ``torch.export.export`` traces
    either program (``tecogan_tpu_torch/tools/export_infer.py``)."""
    if quantized:
        _require_fused(cfg)
    window = _Window(model_defs(cfg, device="meta"), _route(cfg), out_u8)

    def call(params, lr_window, carry, qtail):
        bound = {f"model.{k}": v for k, v in params.items()}
        return torch.func.functional_call(window, bound, (lr_window, carry, qtail),
                                          strict=True)

    if quantized:
        def head(params, lr_window, qtail):
            return call(params, lr_window, None, qtail)

        def cont(params, carry, lr_window, qtail):
            return call(params, lr_window, tuple(carry), qtail)
    else:
        def head(params, lr_window):
            return call(params, lr_window, None, None)

        def cont(params, carry, lr_window):
            return call(params, lr_window, tuple(carry), None)
    return head, cont


class StreamState(NamedTuple):
    """Carried state of streaming inference.  ``prev_sr`` is the SR carry:
    (B, 4H, 4W, 3) f32 on the exact route, the (B, H, W, 48) bf16 s2d
    frame on the fused route; treat it as opaque."""

    prev_sr: torch.Tensor
    prev_lr: torch.Tensor  # (B, H, W, 3) f32
    initialized: bool


def build_stream_inference(cfg: TecoConfig):
    """Returns ``(init_fn, step_fn)`` for O(1)-state streaming SR.

    ``init_fn(lr_shape, device=None) -> StreamState`` for LR frames of
    shape (B, H, W, 3), on ``device`` (default: the card, as
    ``engine.state.model_defs``).  ``step_fn(model, state, lr_frame) ->
    (state, sr_frame)``: the first call runs the zero-feedback frame,
    later calls the warp step (a Python branch).  lr_frame is float [0,1]
    or uint8, on any device; sr_frame is (B, 4H, 4W, 3) float32.  A
    stream of frames reproduces ``build_clip_inference`` bit for bit.
    A step's spans are ``upload``, ``frame`` and ``output``, as in the
    chunked loop.  ``model`` may also be a ``models.PublishedTecoGAN``,
    served on its own route (its first step needs no carry).
    """
    pick = _routes(cfg)
    route = _route(cfg)

    def init_fn(lr_shape, device=None) -> StreamState:
        B, H, W, C = lr_shape
        dev = resolve_device(device)
        return StreamState(
            prev_sr=torch.zeros(route.carry_shape(B, H, W), dtype=route.carry_dtype,
                                device=dev),
            prev_lr=torch.zeros((B, H, W, C), dtype=torch.float32, device=dev),
            initialized=False)

    @torch.inference_mode()
    def step_fn(model: Generator, state: StreamState, lr_frame: torch.Tensor):
        route = pick(model)
        with span("upload"):
            lr = _dequant_in(lr_frame.to(state.prev_lr.device))
        with span("frame"):
            if state.initialized:
                sr = route.step(model, state.prev_sr, state.prev_lr, lr)
            else:
                sr = route.first(model, lr)
        with span("output"):
            out = route.frames(sr[:, None])[:, 0]
        return StreamState(prev_sr=sr, prev_lr=lr, initialized=True), out

    return init_fn, step_fn
