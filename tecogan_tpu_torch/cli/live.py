"""Live streaming SR (tecogan_tpu/cli/live.py) on the port: frames from a
webcam, a file, a ``synth:class=...`` procedural capture or ``synthetic``
(moving-rect) go one by one through ``build_stream_inference``, whose
recurrent state stays on the card; each frame is upscaled as it arrives.

Usage:
  python -m tecogan_tpu_torch.cli.live --g_checkpoint <ckpt> [--source 0]
      [--crop_size 128] [--display/--no-display] [--frames N]

Prints the frame count, fps and the per-frame latency (host time from a
frame's upload to its uint8 SR frame on the host, converted on the
device), and returns them.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch


def main(argv=None, device=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--g_checkpoint", required=True)
    p.add_argument("--source", default="0", help="cv2 source index/path, or 'synthetic'")
    p.add_argument("--crop_size", type=int, default=128)
    p.add_argument("--num_resblock", type=int, default=16)
    p.add_argument("--frames", type=int, default=-1, help="stop after N frames (-1: until q/EOF)")
    p.add_argument("--display", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--fast", action=argparse.BooleanOptionalAction, default=True,
                   help="the fused route (hand kernels); --no-fast keeps the exact "
                        "reference-shaped per-frame math")
    p.add_argument("--output", default="", help="optional mp4 path to record the SR stream")
    args = p.parse_args(argv)

    import cv2

    from ..config import TecoConfig
    from ..engine.inference import build_stream_inference
    from ..engine.state import model_defs, resolve_device
    from ..ops import image
    from ..utils.checkpoint import load_generator_params
    from ..utils.convert import generator_state_dict_from_jax

    dev = resolve_device(device)
    cfg = TecoConfig(crop_size=args.crop_size, num_resblock=args.num_resblock,
                     bug_parity=not args.fast)
    model = model_defs(cfg, device=dev)
    model.load_state_dict(generator_state_dict_from_jax(load_generator_params(args.g_checkpoint)))
    model.eval()
    init_fn, step_fn = build_stream_inference(cfg)

    if args.source == "synthetic":
        from ..data.synthetic import moving_rect_scene

        reader = iter(moving_rect_scene(max(args.frames, 60), args.crop_size, args.crop_size))

        def read():
            return next(reader, None)
    else:
        # an int index, a file path, or a synth:class=chess:... spec, with
        # the procedural fallback of data/capture.py
        from ..data.capture import create_capture

        cap = create_capture(args.source)

        def read():
            ok, frame = cap.read()
            if not ok:
                return None
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            frame = cv2.resize(frame, (args.crop_size, args.crop_size),
                               interpolation=cv2.INTER_AREA)
            return frame.astype(np.float32) / 255.0

    writer = None
    state = init_fn((1, args.crop_size, args.crop_size, 3), device=dev)
    n, lat_ms, t0 = 0, [], time.time()
    while args.frames < 0 or n < args.frames:
        frame = read()
        if frame is None:
            break
        t_frame = time.perf_counter()
        state, sr = step_fn(model, state, torch.from_numpy(frame)[None])
        # uint8 on the device (to_uint8's device half, bit-identical): a
        # quarter of the f32 frame's bytes cross to the host
        sr_u8 = image.transfer_to_uint8(sr[0]).cpu().numpy()
        lat_ms.append((time.perf_counter() - t_frame) * 1e3)
        if args.output:
            if writer is None:
                h, w = sr_u8.shape[:2]
                writer = cv2.VideoWriter(args.output, cv2.VideoWriter_fourcc(*"mp4v"), 24,
                                         (w, h))
            writer.write(cv2.cvtColor(sr_u8, cv2.COLOR_RGB2BGR))
        if args.display:
            cv2.imshow("TecoGAN live", cv2.cvtColor(sr_u8, cv2.COLOR_RGB2BGR))
            if cv2.waitKey(1) & 0xFF == ord("q"):
                break
        n += 1
    dt = time.time() - t0
    if writer is not None:
        writer.release()
    stats = {"frames": n, "fps": n / max(dt, 1e-9),
             "latency_p50_ms": statistics.median(lat_ms) if lat_ms else 0.0,
             "latency_max_ms": max(lat_ms, default=0.0)}
    print(f"{n} frames in {dt:.2f}s ({stats['fps']:.1f} fps); frame latency p50 "
          f"{stats['latency_p50_ms']:.3f} ms, max {stats['latency_max_ms']:.3f} ms")
    return stats


if __name__ == "__main__":
    main()
