"""Device rule of the port: every entry point runs on the card unless the
caller asks for the CPU. A missing card is an error, never a quiet CPU
run."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises ``RuntimeError`` when a CUDA
    device is asked for (the default) and CUDA is unavailable."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "namazu_tpu_torch: CUDA is not available; pass "
                "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise RuntimeError(f"namazu_tpu_torch: unsupported device {dev}")
    return dev
