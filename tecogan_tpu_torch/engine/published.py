"""TecoGAN as published (Chu et al. 2020, arXiv:1811.09393;
github.com/thunil/TecoGAN ``lib/frvsr.py`` and ``main.py``'s inference),
served on the s2d carry: the per-frame functions that the inference loops
run for a :class:`models.PublishedTecoGAN` (``engine/inference.py``).

Frame 0 runs the generator with zero feedback and no FNet.  Frame t >= 1:

1. ``fnet``: FNet on (x[t-1], x[t]), the flow (B, H, W, 2) float32 padded
   to the frame as the published inference pads it;
2. ``flow_warp``: the flow upscaled 4x in HR pixels warps the previous SR
   frame, packed space-to-depth: the ``flow_warp_s2d`` op
   (``ops/kernels/flow_warp_s2d.py``), one kernel launch on the card;
3. ``first_layer``: ``relu(conv_in([x[t] || feedback]))`` on cuDNN;
4. ``trunk``: the resblocks (``trunk.resblocks``) and the two ``up``
   layers (``trunk.upsample``), on a bf16 model the fused ops
   ``bf16_conv3x3`` / ``bf16_up2x`` (each conv with its bias, ReLU and skip
   add one launch), on any other its modules;
5. ``conv_out``: ``conv_out + bicubic_four(x[t])`` into the s2d carry, the
   ``conv_out_bicubic_s2d`` op, one launch on the card.

The carry is the SR frame, not clamped, in space-to-depth layout (B, H, W,
48), channel ``c*16 + a*4 + b``, as on dwight-foster's fused route, but
float32: the frame is the bicubic skip plus a residual of a few levels, and
a bf16 carry's own rounding (up to a quarter level) would be a large part
of what the served frame may differ from the model's by.  Only the served
uint8 frame is clamped (``ops.image.transfer_to_uint8``).
Each step is in the span its number names (``utils/spans.py``).

On the card, FNet, the resblocks and the ``up`` layers each replay as a
CUDA graph (:func:`replayed`), captured at their first call for an input
shape: FNet alone is ~70 small ops a frame, and issued one by one from
the host they and the trunk's 34 launches took longer than the device
needed for the frame, so the host set the pace.  The graphs run the same
kernels on the same inputs as the eager calls.  dwight-foster's routes
issue their 39 trunk launches a frame one by one: its first layer and
trunk, without FNet, take about as long on the host as on the device.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, NamedTuple, Tuple

import torch
import torch.nn as nn

from ..models.generator import PublishedGenerator, PublishedTecoGAN
from ..ops.kernels import bf16_conv as _bf16
from ..ops.kernels import conv_out_bicubic_s2d as _conv_out
from ..ops.kernels import flow_warp_s2d as _warp
from ..utils.spans import span
from .bf16_tail import fused_conv
from .fused import conv_out_params, first_layer_zero_feedback, fused_first_layer


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: Tuple[torch.Tensor, ...]
    output: torch.Tensor
    # the owner's parameters as (their module's ``_parameters``, name):
    # not the modules, which would keep the weakly held owner alive
    params: Tuple[Tuple[dict, str], ...]
    ptrs: Tuple[int, ...]  # their data_ptrs at capture


# per module: {(name, input shapes and dtypes): _Graph}
_GRAPHS: "weakref.WeakKeyDictionary[nn.Module, Dict[tuple, _Graph]]" = weakref.WeakKeyDictionary()

# Graph replays by the name given to :func:`replayed`; callers reset it.
# A replay launches no wrapper, so the hand kernels' launch counters count
# only the eager calls; a device trace counts the kernels a replay runs.
replay_count: Dict[str, int] = {}


def _ptrs(params: Tuple[Tuple[dict, str], ...]) -> Tuple[int, ...]:
    return tuple(held[name].data_ptr() for held, name in params)


def _capture(owner: nn.Module, fn: Callable, inputs: Tuple[torch.Tensor, ...]) -> _Graph:
    """``fn`` on copies of ``inputs`` captured as a CUDA graph.  A capture
    launches nothing, so the bf16 kernels' launch counters are put back to
    what they read before it."""
    static = tuple(x.clone() for x in inputs)
    before = _bf16.conv3x3_launch_count, _bf16.up2x_launch_count
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        output = fn(*static)
    _bf16.conv3x3_launch_count, _bf16.up2x_launch_count = before
    params = tuple((m._parameters, name) for m in owner.modules()
                   for name, p in m._parameters.items() if p is not None)
    return _Graph(graph, static, output, params, _ptrs(params))


def replayed(owner: nn.Module, name: str, fn: Callable, *inputs: torch.Tensor) -> torch.Tensor:
    """``fn(*inputs)``, one tensor out.  On the card: the first call for an
    input shape runs ``fn`` eagerly (its kernels built, its cuDNN plans and
    index tables made) and then captures it as a CUDA graph kept with
    ``owner``; later calls copy ``inputs`` into the graph's inputs and
    replay it (``replay_count[name]``), and return the graph's output
    buffer, which the next replay overwrites (stream-ordered: consume it
    before the next call).  The graph reads ``owner``'s parameters where
    they are: weights changed in place (``load_state_dict``) are seen, and
    a parameter moved or replaced (``.to()``, ``.half()``, a new
    ``nn.Parameter`` set on its module) makes the next call capture anew;
    a submodule set in place of another after the capture is not seen
    (build the model anew instead).  On the CPU: ``fn(*inputs)``."""
    if inputs[0].device.type != "cuda":
        return fn(*inputs)
    graphs = _GRAPHS.setdefault(owner, {})
    key = (name,) + tuple((tuple(x.shape), x.dtype) for x in inputs)
    g = graphs.get(key)
    if g is None or _ptrs(g.params) != g.ptrs:
        graphs.pop(key, None)
        out = fn(*inputs)
        graphs[key] = _capture(owner, fn, inputs)
        return out
    for dst, src in zip(g.inputs, inputs):
        dst.copy_(src)
    g.graph.replay()
    replay_count[name] = replay_count.get(name, 0) + 1
    return g.output


def _resblocks(gen: PublishedGenerator, net: torch.Tensor) -> torch.Tensor:
    for i in range(gen.num_resblock):
        y = fused_conv(gen.get_submodule(f"resblock_{i}.Conv_0"), False, net, relu=True)
        net = fused_conv(gen.get_submodule(f"resblock_{i}.Conv_1"), False, y, residual=net)
    return net


def _upsample(gen: PublishedGenerator, net: torch.Tensor) -> torch.Tensor:
    net = fused_conv(gen.up1, True, net, relu=True)
    return fused_conv(gen.up2, True, net, relu=True)


def trunk_bf16(gen: PublishedGenerator, net: torch.Tensor) -> torch.Tensor:
    """``gen.tail_features`` on the fused bf16 ops
    (:func:`engine.bf16_tail.fused_conv`): (B, H, W, 64) -> (B, 4H, 4W, 64)
    contiguous NHWC bf16, ``2 * num_resblock`` ``bf16_conv3x3`` and 2
    ``bf16_up2x`` kernels, the resblocks and the ``up`` layers each
    :func:`replayed`; the spans are ``PublishedGenerator._features``'."""
    net = net.to(torch.bfloat16).contiguous()
    with span("trunk.resblocks"):
        net = replayed(gen, "resblocks", lambda x: _resblocks(gen, x), net)
    with span("trunk.upsample"):
        return replayed(gen, "upsample", lambda x: _upsample(gen, x), net)


def _tail_s2d(gen: PublishedGenerator, net: torch.Tensor, lr: torch.Tensor) -> torch.Tensor:
    """First-layer activations and the LR frame -> the s2d carry, under the
    spans ``trunk`` and ``conv_out``."""
    with span("trunk"):
        if gen.dtype == torch.bfloat16:
            feat = trunk_bf16(gen, net)
        else:
            feat = gen.tail_features(net)
    with span("conv_out"):
        return _conv_out.conv_out_bicubic_s2d(feat, *conv_out_params(gen),
                                              lr.float().contiguous())


def first_frame(model: PublishedTecoGAN, lr0: torch.Tensor) -> torch.Tensor:
    """Frame 0 (zero feedback, no FNet) -> its s2d carry."""
    with span("first_layer"):
        net = first_layer_zero_feedback(model.generator, lr0)
    return _tail_s2d(model.generator, net, lr0)


def step(model: PublishedTecoGAN, carry: torch.Tensor, prev_lr: torch.Tensor,
         cur_lr: torch.Tensor) -> torch.Tensor:
    """One recurrent step: the s2d carry of frame t - 1 and the LR frames
    t - 1 and t (B, H, W, 3) -> the s2d carry of frame t."""
    with span("fnet"):
        flow = replayed(model.fnet, "fnet", model.fnet, prev_lr, cur_lr)
    with span("flow_warp"):
        feedback = _warp.flow_warp_s2d(flow.contiguous(), carry)
    with span("first_layer"):
        net = fused_first_layer(model.generator, cur_lr, feedback)
    return _tail_s2d(model.generator, net, cur_lr)
