"""The system under test, and all the benchmark takes from it:
``tecogan_tpu_torch``'s ``PublishedTecoGAN`` (TecoGAN as published) with
the benchmark's weights, served by the port's chunked loop (archive
traffic) and stream step (live traffic).  The only module of this
architecture that imports the program.
"""

from __future__ import annotations

import torch


class System:
    def __init__(self, config: dict, params: dict, device, lr_shape: tuple, calib_u8=None):
        from tecogan_tpu_torch.config import TecoConfig
        from tecogan_tpu_torch.engine import inference
        from tecogan_tpu_torch.engine.state import published_model_defs
        from tecogan_tpu_torch.ops.image import transfer_to_uint8

        if config["calibration_frames"]:
            raise ValueError("TecoGAN as published has no int8 tail to calibrate")
        self.cfg = TecoConfig(num_resblock=config["num_resblock"],
                              precision=config["precision"])
        self.device = torch.device(device)
        self.lr_shape = lr_shape
        self.model = published_model_defs(self.cfg, device=self.device)
        self.model.load_state_dict(params)
        self.model.eval()
        self._chunked = inference.build_chunked_inference(self.cfg, out_u8=True)
        self._init, self._step = inference.build_stream_inference(self.cfg)
        self._to_u8 = transfer_to_uint8

    def archive(self, clip_u8, chunk: int, sink) -> None:
        """One clip (1, T, H, W, 3) uint8 on the host, in windows of
        ``chunk`` frames; ``sink`` receives each (1, K, 4H, 4W, 3) uint8
        host window."""
        self._chunked(self.model, clip_u8, chunk=chunk, sink=sink)

    def stream_init(self):
        return self._init(self.lr_shape, device=self.device)

    def stream_step(self, state, frame_u8):
        """One frame (1, H, W, 3) uint8 on the host -> (state, its uint8
        SR frame (1, 4H, 4W, 3) on the device)."""
        state, sr = self._step(self.model, state, frame_u8)
        return state, self._to_u8(sr)

    @staticmethod
    def stream_carry(state) -> torch.Tensor:
        """The state's SR carry: the (B, H, W, 48) space-to-depth frame."""
        return state.prev_sr

    def close(self) -> None:
        del self.model, self._chunked, self._init, self._step
