"""Device resolution for the port's entry points, the host-device copies
of its serving planes, and the guard of their async dispatch window.

Entry points run on the GPU unless the caller asks for the CPU: a missing
card is an error, never a silent fallback.
"""
from __future__ import annotations

import contextlib
import threading
import warnings
from typing import Dict, Iterator, List, Optional, Union

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
    """Device tensors on their way to host memory.

    On the GPU each tensor is copied into pinned memory with a
    non-blocking copy on the current stream and a CUDA event is recorded
    behind the copies; ``wait`` (callable from any thread, e.g. the host
    stage worker) blocks on that event only and returns the host tensors.
    On the CPU the copy is immediate.  ``host_bytes``: bytes copied."""

    def __init__(self, *tensors: Optional[torch.Tensor]):
        self._event = None
        self._host: List[Optional[torch.Tensor]] = []
        self.host_bytes = 0
        for t in tensors:
            if t is None or t.device.type == "cpu":
                self._host.append(t)
                continue
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            self._host.append(buf)
            self.host_bytes += buf.nbytes
            self._event = torch.cuda.Event()
        if self._event is not None:
            self._event.record(torch.cuda.current_stream())

    def wait(self) -> List[Optional[torch.Tensor]]:
        if self._event is not None:
            self._event.synchronize()
        return list(self._host)


class OnDevice:
    """Tensors that stay where they are, behind ``HostCopy``'s interface:
    ``wait`` returns them as they are (device tensors, for consumers that
    run on the device's stream); nothing is copied."""

    host_bytes = 0

    def __init__(self, *tensors: Optional[torch.Tensor]):
        self._tensors = list(tensors)

    def wait(self) -> List[Optional[torch.Tensor]]:
        return list(self._tensors)


# ---------------------------------------------------------------------------
# The guarded dispatch window
# ---------------------------------------------------------------------------

# what torch.cuda.set_sync_debug_mode("warn") says at a synchronizing call
_SYNC_WARNING = "called a synchronizing CUDA operation"


class SyncInDispatchWindow(RuntimeError):
    """A synchronizing CUDA call on the dispatch thread inside an async
    dispatch window (plane contract: no-sync-in-dispatch-window)."""


class DispatchGuard:
    """Counts of the guarded windows of this process: ``windows`` entered,
    synchronizing calls ``flagged`` on the dispatch thread inside one
    (each raised ``SyncInDispatchWindow``), and ``other_threads``: those
    another thread made meanwhile (the host stage worker's waits), which
    are legitimate."""

    def __init__(self):
        self._tls = threading.local()
        self.reset()

    def reset(self) -> None:
        self.windows = 0
        self.flagged = 0
        self.other_threads = 0

    def snapshot(self) -> Dict[str, int]:
        return {"windows": self.windows, "flagged": self.flagged,
                "other_threads": self.other_threads}

    @property
    def active(self) -> bool:
        return getattr(self._tls, "active", False)

    def _on_warning(self, show):
        def handler(message, category, filename, lineno, file=None,
                    line=None):
            if _SYNC_WARNING not in str(message):
                return show(message, category, filename, lineno, file, line)
            if not self.active:
                self.other_threads += 1
                return None
            self.flagged += 1
            raise SyncInDispatchWindow(
                f"a synchronizing CUDA call inside the async dispatch window "
                f"({filename}:{lineno}): the dispatch thread must not wait "
                f"for the device between the selected ids' copy and the "
                f"attend launch")
        return handler

    @contextlib.contextmanager
    def routed(self) -> Iterator[None]:
        """Route the synchronizing-call warnings to this guard while the
        calling thread is inside the window: every one of them (the
        "always" filter), raised on this thread, counted on others."""
        with warnings.catch_warnings():
            warnings.filterwarnings("always", message=_SYNC_WARNING)
            warnings.showwarning = self._on_warning(warnings.showwarning)
            self._tls.active = True
            self.windows += 1
            try:
                yield
            finally:
                self._tls.active = False


GUARD = DispatchGuard()


@contextlib.contextmanager
def dispatch_window(device: torch.device, armed: bool = True
                    ) -> Iterator[None]:
    """The async dispatch window of one layer's host stage: on CUDA, and
    when ``armed`` (the async branch), a synchronizing call the calling
    thread makes inside raises ``SyncInDispatchWindow``; another thread's
    (the host stage worker waiting for its copies) does not.  The
    counterpart of the reference's ``jax.transfer_guard_device_to_host(
    "disallow")``.  ``torch.cuda.set_sync_debug_mode`` is process-wide,
    so it is set to "warn" for the window only and its warnings are
    routed by thread (``DispatchGuard``).  A no-op on the CPU, where
    device tensors are host memory, as in the reference."""
    if not armed or device.type != "cuda":
        yield
        return
    with GUARD.routed():
        flagged = GUARD.flagged
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        if GUARD.flagged > flagged:
            # raised where the call was made, unless a caller swallowed it
            raise SyncInDispatchWindow(
                f"{GUARD.flagged - flagged} synchronizing CUDA call(s) in "
                f"this dispatch window")
