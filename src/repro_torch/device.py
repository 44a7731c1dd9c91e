"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: a missing
card is an error, never a silent fallback.
"""
from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """``"cuda"`` (the default) or ``"cpu"``; raises if CUDA is asked for
    on a machine without a usable card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def host_to_device(arr, device: torch.device,
                   dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """A small host array (list or numpy) as a tensor on ``device``.

    On the GPU the data goes through pinned memory with a non-blocking
    copy on the current stream, so building index tensors never
    synchronises the host with the device (a copy from pageable memory
    would)."""
    t = torch.as_tensor(arr, dtype=dtype)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class HostCopy:
    """Device tensors on their way to host numpy arrays.

    On the GPU each tensor is copied into pinned memory with a
    non-blocking copy on the current stream and a CUDA event is recorded
    behind the copies; ``wait`` (callable from any thread, e.g. the host
    stage worker) blocks on that event only.  On the CPU the copy is
    immediate."""

    def __init__(self, *tensors: Optional[torch.Tensor]):
        self._event = None
        self._host: List[Optional[torch.Tensor]] = []
        for t in tensors:
            if t is None or t.device.type == "cpu":
                self._host.append(t)
                continue
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            self._host.append(buf)
            self._event = torch.cuda.Event()
        if self._event is not None:
            self._event.record(torch.cuda.current_stream())

    def wait(self) -> List[Optional[np.ndarray]]:
        if self._event is not None:
            self._event.synchronize()
        return [None if t is None else t.numpy() for t in self._host]
