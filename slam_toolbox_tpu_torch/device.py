"""Device selection for the port's entry points, and host<->device copies
that do not wait.

Entry points run on the card unless the caller asks for the CPU: with no
CUDA device present, the default raises instead of quietly running the
plain versions on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        # a tensor's device always carries its index: "cuda" != "cuda:0"
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def world_size() -> int:
    """Ranks of the default process group, 1 when none is up: the gate of
    the distributed routes (dist/), which costs one call and creates
    nothing."""
    d = torch.distributed
    return d.get_world_size() if d.is_available() and d.is_initialized() \
        else 1


def upload(a, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on `device`. To a card the copy goes through
    pinned memory and does not wait (a pageable copy synchronizes the
    stream); on the CPU the tensor owns a copy of `a`."""
    t = torch.from_numpy(np.array(a, copy=True, order="C"))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def upload_into(dst: torch.Tensor, a) -> None:
    """Host array -> the existing tensor `dst`, in place, so `dst` keeps
    its storage (a CUDA graph captured on it stays valid). To a card the
    copy goes through pinned memory and does not wait."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dst.device.type == "cuda":
        dst.copy_(t.pin_memory(), non_blocking=True)
    else:
        dst.copy_(t)


class HostCopy:
    """A tensor's copy to host memory, started at construction without
    waiting: on a card a non-blocking copy into pinned memory plus an
    event, which numpy() waits on; on the CPU a snapshot. Later in-place
    writes to the source do not reach the copy."""

    __slots__ = ("src", "_host", "_event")

    def __init__(self, t: torch.Tensor):
        self.src = t
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t.clone()
            self._event = None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()
