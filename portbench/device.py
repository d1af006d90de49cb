"""The card, or the CPU for the harness's own tests: synchronising,
marking a point in the device's stream, and the result's ``device``."""

from __future__ import annotations

from typing import Dict

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Marker:
    """A recorded CUDA event; on the CPU the work is already done."""

    def __init__(self, device):
        self.event = None
        if torch.device(device).type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def info(device) -> Dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def free(device) -> None:
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
