"""Serve a clip from the window programs ``export_infer`` wrote, with no
model code: this module imports ``torch``, numpy and
``tecogan_tpu_torch.ops.kernels`` (which registers the hand kernels'
custom ops the programs call) and nothing of ``models`` or ``engine``.

    from tecogan_tpu_torch.tools.serve_exported import serve_exported
    sr = serve_exported("export/", lr_clip, params, device="cuda")

The protocol is the manifest's (the JAX package's ``tools/export_infer.py``
protocol): ``head(params, lr_window) -> (carry, sr_window)`` for the first
window, ``cont(params, carry, lr_window) -> (carry, sr_window)`` for every
later one; a short last window is padded with its last frame and the
padding's frames trimmed.  ``quantized=True`` runs ``head_q`` / ``cont_q``
with the qtail of ``qtail.npz`` as their last input.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..ops import kernels  # noqa: F401  (registers the custom ops the programs call)
from ..ops.image import start_host_copy

QTAIL_FIELDS = ("wq", "inv_s", "deq", "bias")


def load_manifest(out_dir: str) -> dict:
    with open(os.path.join(out_dir, "manifest.json")) as f:
        return json.load(f)


def load_programs(out_dir: str, quantized: bool = False) -> Tuple[Callable, Callable]:
    """The loaded ``(head, cont)`` programs (``head_q`` / ``cont_q`` when
    ``quantized``), callable modules."""
    suffix = "_q" if quantized else ""
    return tuple(torch.export.load(os.path.join(out_dir, f"{name}{suffix}.pt2")).module()
                 for name in ("head", "cont"))


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name.replace("torch.", ""))


def program_params(manifest: dict, params: Mapping, device) -> Dict[str, torch.Tensor]:
    """``params`` (the generator's ``state_dict`` by name, tensors or arrays
    of any float dtype) as the programs take them: in the manifest's
    order and dtype, on ``device``, 4-D weights ``channels_last`` (as the
    serving generator holds them, so the convs run as on the live route).
    Raises on a missing name or a shape that differs."""
    out = {}
    for name, (shape, dtype) in manifest["params"].items():
        if name not in params:
            raise KeyError(f"params has no {name!r}")
        t = torch.as_tensor(np.asarray(params[name]) if not isinstance(params[name], torch.Tensor)
                            else params[name])
        if list(t.shape) != shape:
            raise ValueError(f"{name}: shape {list(t.shape)}, the programs take {shape}")
        t = t.to(device, _dtype(dtype))
        out[name] = t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 else t
    return out


def load_qtail(out_dir: str, manifest: dict, device) -> Dict[str, Dict[str, Optional[torch.Tensor]]]:
    """``qtail.npz`` as the quantized programs take it: every layer of the
    manifest's ``qtail`` with its four fields in order, ``None`` for a
    bias the layer has not."""
    with np.load(os.path.join(out_dir, "qtail.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    qtail: Dict[str, Dict[str, Optional[torch.Tensor]]] = {}
    for key in manifest["qtail"]:  # "['<layer>']['<field>']", in the programs' order
        layer = key[2:key.index("']")]
        if layer in qtail:
            continue
        qtail[layer] = {}
        for field in QTAIL_FIELDS:
            a = arrays.get(f"['{layer}']['{field}']")
            qtail[layer][field] = None if a is None else torch.from_numpy(a).to(device)
    return qtail


def load_server(out_dir: str, params: Mapping, device="cuda", quantized: bool = False
                ) -> Callable:
    """Load the programs, params (and qtail) of ``out_dir`` on ``device``
    once; returns ``serve(lr_clip)``, which runs a clip as
    :func:`serve_exported` does."""
    manifest = load_manifest(out_dir)
    head, cont = load_programs(out_dir, quantized)
    dev = torch.device(device)
    p = program_params(manifest, params, dev)
    extra = (load_qtail(out_dir, manifest, dev),) if quantized else ()
    (B, K, H, W, _), wire = manifest["lr_window"]

    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    @torch.inference_mode()
    def serve(lr_clip) -> torch.Tensor:
        clip = torch.as_tensor(lr_clip)
        if tuple(clip.shape[:1]) + tuple(clip.shape[2:]) != (B, H, W, 3):
            raise ValueError(f"clip {tuple(clip.shape)} does not fit the programs' "
                             f"({B}, T, {H}, {W}, 3)")
        if (clip.dtype == torch.uint8) != (wire == "uint8"):
            raise ValueError(f"a {clip.dtype} clip for programs that take {wire} windows")
        clip = clip.to(_dtype(wire))
        out, carry = [], None
        for pos in range(0, clip.shape[1], K):
            window = clip[:, pos:pos + K]
            k = window.shape[1]
            if k < K:  # pad the tail window with its last frame, then trim
                window = torch.cat([window, window[:, -1:].expand(-1, K - k, -1, -1, -1)],
                                   dim=1)
            window = window.to(dev).contiguous()
            if carry is None:
                carry, sr = head(p, window, *extra)
            else:
                carry, sr = cont(p, carry, window, *extra)
            # window i's copy to the host overlaps window i+1's compute
            out.append(start_host_copy(sr[:, :k], side))
            del sr
        for _, done in out:
            if done is not None:
                done.synchronize()
        return torch.cat([host for host, _ in out], dim=1)

    return serve


def serve_exported(out_dir: str, lr_clip, params: Mapping, device="cuda",
                   quantized: bool = False) -> torch.Tensor:
    """Run a clip through the exported window programs in ``out_dir``.

    ``lr_clip`` (B, T, H, W, 3), numpy or a tensor: uint8 for a u8-wire
    export, float [0, 1] otherwise; B, H and W as exported, any T.
    ``params`` as :func:`program_params` takes them.  Each window is
    uploaded and run with no autograd (``torch.inference_mode``), and
    copied to pinned host memory on a side stream while the next window
    runs.  Returns the (B, T, 4H, 4W, 3) CPU clip (float32, or uint8 on
    the u8 wire).  A tail window of k < chunk frames runs padded to the
    chunk, so the kernels launch for the padding's frames too."""
    return load_server(out_dir, params, device, quantized)(lr_clip)
