"""Explicit device selection.

The port never picks a device on its own: callers name one, and asking for
CUDA on a machine without a usable card raises instead of falling back to
the CPU. Selecting a device also pins full float32 precision for matrix
products and convolutions — the reference renders under
default_matmul_precision("highest") (vulkan_renderer_tpu/render/
pipeline.py:218-223), and TF32 would round the per-pixel frame transforms.
"""

from __future__ import annotations

import torch


def set_precision_flags() -> None:
    """Full float32 everywhere (TF32 keeps only ~3 decimal digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def get_device(name: str | torch.device) -> torch.device:
    """Resolve `name` ("cpu", "cuda", "cuda:1", ...) to a torch.device.

    Raises RuntimeError when a CUDA device is requested but none is
    available; there is no silent CPU fallback."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch.cuda.is_available() "
                "is False (no CUDA build of PyTorch or no visible card)")
        index = device.index if device.index is not None else 0
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {name!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device type {device.type!r}")
    set_precision_flags()
    return device


def to_device_async(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """CPU tensor `t` on `device`, copied in stream order. A copy from
    pageable memory makes the host wait for every kernel already queued;
    one from pinned memory does not, so the host goes on queuing."""
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
