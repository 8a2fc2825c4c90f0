"""Export the chunked inference's two window programs for serving.

    python -m tecogan_tpu_torch.tools.export_infer --out export/ --height 270 \\
        --width 480 [--batch 1] [--chunk 16] [--g_checkpoint g.ckpt] \\
        [--wire u8] [--quantize int8 [--calib_dir frames/]] [--check]

The JAX package's ``tools/export_infer.py`` on the port, with its flags.
``engine.inference.build_window_programs`` gives ``head`` (the cold-start
window) and ``cont`` (a continuation window); ``torch.export.export``
traces each at (batch, chunk, height, width) on the device (the card
unless ``--device`` names another) into ``head.pt2`` / ``cont.pt2``.  The
graphs keep the ATen ops the live route runs (no ``run_decompositions``)
and call the hand kernels as the ``tecogan_tpu_torch`` custom ops, so a
host that imports ``tecogan_tpu_torch.ops.kernels`` runs them with no
model code (``tools/serve_exported.py``).  The params are an input, so the
programs are weight-agnostic.

``--wire u8`` exports the transfer-thrifty specialization: LR windows
arrive uint8 (dequantized on the device, ``x * f32(1/255)``) and SR
windows leave uint8 (``transfer_to_uint8``).  ``--quantize int8`` also
exports ``head_q.pt2`` / ``cont_q.pt2`` with the W8A8 tail, taking the
qtail as their last input, and writes the qtail calibrated on 8 frames
(``--calib_dir``'s first 8 pngs / jpgs, else a synthetic moving scene) to
``qtail.npz``, keyed by tree path as the JAX tool keys it (the port's
``wq`` is ``(Cout, 3, 3, Cin)``).  ``manifest.json`` holds the JAX
manifest's keys.  ``--check`` loads the programs and asserts their
windows bit-equal to the live programs' on random inputs.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.nn as nn

from ..config import TecoConfig
from ..engine.inference import (build_quantized_clip_inference, build_window_programs,
                                window_params)
from ..engine.state import float_params, init_generator, model_defs, resolve_device
from .serve_exported import QTAIL_FIELDS, load_programs


class _Program(nn.Module):
    """A window program as the module ``torch.export.export`` takes."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _flat_spec(tree, path: str = "") -> dict:
    """{JAX keystr path: [shape, dtype]} of the tensors of a nested
    dict / tuple (``None`` leaves skipped)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_spec(v, f"{path}['{k}']"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_spec(v, f"{path}[{i}]"))
        return out
    if tree is None:
        return {}
    return {path: [list(tree.shape), str(tree.dtype).replace("torch.", "")]}


def _calibration_clip(calib_dir, B: int, H: int, W: int) -> np.ndarray:
    """(B, 8, H, W, 3) float32 [0, 1]: the first 8 frames of ``calib_dir``
    resized with ``INTER_AREA``, or the synthetic moving scene."""
    if calib_dir:
        import cv2

        files = sorted(f for f in os.listdir(calib_dir)
                       if f.lower().endswith((".png", ".jpg", ".jpeg")))[:8]
        frames = [cv2.cvtColor(cv2.imread(os.path.join(calib_dir, f)), cv2.COLOR_BGR2RGB)
                  for f in files]
        calib = np.stack([cv2.resize(fr, (W, H), interpolation=cv2.INTER_AREA)
                          for fr in frames]).astype(np.float32) / 255.0
    else:
        from ..data.synthetic import moving_rect_scene

        calib = moving_rect_scene(num_frames=8, height=H, width=W)
        print("int8: calibrating on a synthetic moving scene "
              "(--calib_dir with real serving content preferred)")
    return np.repeat(calib[None], B, axis=0)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--g_checkpoint", default=None,
                    help="generator .ckpt (ours or converted torch); "
                    "random init if omitted (export is weight-agnostic)")
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--chunk", type=int, default=16, help="frames per exported window")
    ap.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    ap.add_argument("--num_resblock", type=int, default=16)
    ap.add_argument("--check", action="store_true",
                    help="load the programs and assert bit-equality vs live")
    ap.add_argument("--wire", default="f32", choices=["f32", "u8"],
                    help="u8: LR windows arrive uint8 and SR windows leave uint8")
    ap.add_argument("--quantize", default="none", choices=["none", "int8"],
                    help="int8: also export head_q/cont_q with the W8A8 tail and "
                    "qtail.npz")
    ap.add_argument("--calib_dir", default=None,
                    help="frames (pngs) to calibrate the int8 scales on; a synthetic "
                    "moving scene if omitted")
    ap.add_argument("--device", default=None,
                    help="torch device to export for (default: the card)")
    return ap


def export(args) -> dict:
    """Export per ``args`` (:func:`build_parser`'s); returns the manifest
    with ``export_seconds`` (each program's ``torch.export.export`` time)."""
    dev = resolve_device(args.device)
    cfg = TecoConfig(precision=args.precision, num_resblock=args.num_resblock,
                     bug_parity=False)
    if args.g_checkpoint:
        from ..utils.checkpoint import load_generator_params

        params_g = load_generator_params(args.g_checkpoint)
    else:
        params_g = init_generator(cfg, torch.Generator().manual_seed(0))
    model = model_defs(cfg, device=dev)
    model.load_state_dict(float_params(params_g))
    model.eval()
    p = window_params(model)

    wire_u8 = args.wire == "u8"
    B, K, H, W = args.batch, args.chunk, args.height, args.width
    lr = torch.zeros((B, K, H, W, 3), dtype=torch.uint8 if wire_u8 else torch.float32,
                     device=dev)
    os.makedirs(args.out, exist_ok=True)
    seconds = {}

    def save(name, fn, example):
        t0 = time.perf_counter()
        ep = torch.export.export(_Program(fn), example, strict=False)
        seconds[name] = time.perf_counter() - t0
        torch.export.save(ep, os.path.join(args.out, f"{name}.pt2"))

    head, cont = build_window_programs(cfg, out_u8=wire_u8)
    live = {"": ((head, cont), ())}
    with torch.no_grad():
        carry, sr = head(p, lr)
    save("head", head, (p, lr))
    save("cont", cont, (p, carry, lr))
    manifest = {
        "platforms": [dev.type],
        "batch": B, "chunk": K, "height": H, "width": W,
        "precision": args.precision, "num_resblock": args.num_resblock,
        "wire": args.wire,
        "lr_window": [[B, K, H, W, 3], str(lr.dtype).replace("torch.", "")],
        "sr_window": [list(sr.shape), str(sr.dtype).replace("torch.", "")],
        "carry": _flat_spec(carry),
        "params": {k: _flat_spec(v)[""] for k, v in p.items()},  # by name, in order
        "protocol": "head(params, lr_window) -> (carry, sr_window); "
                    "cont(params, carry, lr_window) -> (carry, sr_window); "
                    "pad the tail window with its last frame and trim."
                    + (" u8 wire: lr = rint(f32*255) on the client; sr "
                       "comes back uint8, write it as-is." if wire_u8 else ""),
    }
    if args.quantize == "int8":
        prepare, _ = build_quantized_clip_inference(cfg)
        calib = torch.from_numpy(_calibration_clip(args.calib_dir, B, H, W))
        qtail = prepare(model, params_g, calib, frames=8)
        head_q, cont_q = build_window_programs(cfg, out_u8=wire_u8, quantized=True)
        save("head_q", head_q, (p, lr, qtail))
        save("cont_q", cont_q, (p, carry, lr, qtail))
        live["_q"] = ((head_q, cont_q), (qtail,))
        np.savez(os.path.join(args.out, "qtail.npz"),
                 **{f"['{layer}']['{f}']": q[f].cpu().numpy() for layer, q in qtail.items()
                    for f in QTAIL_FIELDS if q[f] is not None})
        manifest["qtail"] = _flat_spec(qtail)
        manifest["protocol_q"] = (
            "head_q(params, lr_window, qtail) -> (carry, sr_window); "
            "cont_q(params, carry, lr_window, qtail) -> (carry, sr_window); "
            "qtail values in qtail.npz keyed by tree path (biases may be absent: "
            "second resblock convs have none); wq is (Cout, 3, 3, Cin).")
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    sizes = {n: os.path.getsize(os.path.join(args.out, n))
             for n in sorted(os.listdir(args.out)) if n.endswith(".pt2")}
    print(f"exported to {args.out} ({sizes}, platforms={manifest['platforms']}, "
          f"export s {', '.join(f'{k} {v:.2f}' for k, v in seconds.items())})")

    if args.check:
        _check(args, p, live, dev)
    return {**manifest, "export_seconds": seconds}


def _check(args, p, live: dict, dev) -> None:
    """The loaded programs against the live ones (``live``: {suffix:
    ((head, cont), extra inputs)}) on random windows: head, then cont
    after it, bit for bit."""
    B, K, H, W = args.batch, args.chunk, args.height, args.width
    rng = np.random.default_rng(0)

    def window():
        if args.wire == "u8":
            return torch.from_numpy(rng.integers(0, 256, (B, K, H, W, 3), dtype=np.uint8)).to(dev)
        return torch.from_numpy(rng.random((B, K, H, W, 3), np.float32)).to(dev)

    lr1, lr2 = window(), window()
    for suffix, ((head, cont), extra) in live.items():
        loaded_head, loaded_cont = load_programs(args.out, quantized=suffix == "_q")
        what = f"head{suffix}+cont{suffix}"
        with torch.no_grad():
            carry_l, sr1_l = head(p, lr1, *extra)
            carry_r, sr1_r = loaded_head(p, lr1, *extra)
            if not torch.equal(sr1_l, sr1_r):
                raise AssertionError(f"{what}: the loaded head differs from the live one")
            _, sr2_l = cont(p, carry_l, lr2, *extra)
            t0 = time.perf_counter()
            _, sr2_r = loaded_cont(p, carry_r, lr2, *extra)
            sr2_r = sr2_r.cpu()
            dt = time.perf_counter() - t0
        if not torch.equal(sr2_l.cpu(), sr2_r):
            raise AssertionError(f"{what}: the loaded cont differs from the live one")
        print(f"check ok: {what} bit-equal vs live; cont window ({K} frames) "
              f"{dt * 1e3:.1f} ms cold")


def main(argv=None) -> dict:
    return export(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
