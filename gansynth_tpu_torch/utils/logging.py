"""Metrics logging (``gansynth_tpu/utils/logging.py``): JSONL always;
TensorBoard scalars, audio and spectrogram images through
``torch.utils.tensorboard`` when it imports (the reference writes them
through TensorFlow when that imports). ``MetricLogger.tensorboard`` says
which ran."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


class MetricLogger:
    def __init__(self, workdir: str):
        os.makedirs(workdir, exist_ok=True)
        self._jsonl = open(os.path.join(workdir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(os.path.join(workdir, "tb"))

    @property
    def tensorboard(self) -> bool:
        """True when TensorBoard summaries are written beside the JSONL."""
        return self._tb is not None

    def log(self, step: int, metrics: Dict, stage: Optional[int] = None) -> None:
        record = {
            "step": int(step),
            "time": time.time(),
            **({"stage": int(stage)} if stage is not None else {}),
            **{k: float(v) for k, v in metrics.items()},
        }
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in record.items():
                if k not in ("step", "time") and isinstance(v, float):
                    self._tb.add_scalar(k, v, int(step))
            self._tb.flush()

    def log_artifacts(self, step: int, waves, images, sample_rate: int) -> None:
        """Audio and spectrogram-image summaries for TensorBoard. No-op
        without a writer."""
        if self._tb is None:
            return
        waves = np.asarray(waves, np.float32)
        images = np.asarray(images, np.float32)
        for i, wave in enumerate(np.clip(waves, -1, 1)):
            self._tb.add_audio(f"ema_samples/{i}", wave[None], int(step),
                               sample_rate=sample_rate)
        # channel 0 (scaled log-mel magnitude), [-1, 1] -> [0, 1], as
        # [B, 1, mel, time] with low mel at the bottom
        mag = np.clip((images[..., 0] + 1.0) / 2.0, 0.0, 1.0)
        mag = np.ascontiguousarray(np.transpose(mag, (0, 2, 1))[:, None, ::-1])
        self._tb.add_images("ema_logmelmag", mag, int(step))
        self._tb.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
