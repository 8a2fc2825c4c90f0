"""Faults planted in the program under test, to show that the check of
``correct`` fails them (benchmark/tests/test_benchmark_faults.py on the
CPU; ``benchmark.readings --fault`` reads them on the card).  Each takes a
``setattr(obj, name, value)`` that the caller undoes (pytest's
``monkeypatch.setattr``, or a list it unwinds).

* ``stale_state``: a step that returns its state unchanged.  The stream
  step serves its frame but hands back the state it was given; the
  chunked loop's recurrent step returns the carry it was given.
* ``altered_answer``: an answer altered where it is produced: the top
  quarter of every served uint8 frame 12 levels brighter.
"""

from __future__ import annotations

import torch


def stale_state(setattr) -> None:
    from tecogan_tpu_torch.engine import inference

    build = inference.build_stream_inference

    def build_stale(cfg):
        init, step = build(cfg)
        return init, lambda model, state, lr: (state, step(model, state, lr)[1])

    setattr(inference, "build_stream_inference", build_stale)
    setattr(inference, "fused_sr_step_s2d",
            lambda model, carry, prev_lr, cur_lr, *a, **k: carry)


def brighten_top(u8: torch.Tensor) -> torch.Tensor:
    """The top quarter of uint8 frames (..., H, W, 3) 12 levels brighter."""
    out = u8.clone()
    rows = out.shape[-3] // 4
    top = out[..., :rows, :, :].to(torch.int16) + 12
    out[..., :rows, :, :] = top.clamp(0, 255).to(torch.uint8)
    return out


def altered_answer(setattr) -> None:
    from tecogan_tpu_torch.engine import inference
    from tecogan_tpu_torch.ops import image

    real = image.transfer_to_uint8

    def altered(x):
        return brighten_top(real(x))

    setattr(inference, "transfer_to_uint8", altered)
    setattr(image, "transfer_to_uint8", altered)


FAULTS = {"stale_state": stale_state, "altered_answer": altered_answer}
