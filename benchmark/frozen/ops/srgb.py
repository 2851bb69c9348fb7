"""linear <-> sRGB conversion (reference: src/shaders/srgb_utility.glsl:20-53).

The numpy versions serve the host-side texture codec (assets/vkt.py)
through the torch ones. Both compute in float32 like the JAX package's
ops/srgb.py.
"""

from __future__ import annotations

import numpy as np
import torch


def linear_to_srgb(linear: torch.Tensor) -> torch.Tensor:
    linear = torch.clamp(linear, 0.0, 1.0)
    return torch.where(
        linear <= 0.0031308,
        12.92 * linear,
        1.055 * torch.pow(torch.clamp(linear, min=1e-12), 1.0 / 2.4) - 0.055)


def srgb_to_linear(srgb: torch.Tensor) -> torch.Tensor:
    srgb = torch.clamp(srgb, 0.0, 1.0)
    return torch.where(
        srgb <= 0.04045,
        (1.0 / 12.92) * srgb,
        torch.pow((srgb + 0.055) * (1.0 / 1.055), 2.4))


def linear_to_srgb_np(linear: np.ndarray) -> np.ndarray:
    return linear_to_srgb(torch.from_numpy(
        np.ascontiguousarray(linear, np.float32))).numpy()


def srgb_to_linear_np(srgb: np.ndarray) -> np.ndarray:
    return srgb_to_linear(torch.from_numpy(
        np.ascontiguousarray(srgb, np.float32))).numpy()
