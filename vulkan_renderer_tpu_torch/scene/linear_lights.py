"""Linear (segment) lights: the HPG 2021 companion capability.

Counterpart of vulkan_renderer_tpu/scene/linear_lights.py. The reference
keeps linear lights on a branch of its own (line_sampling.glsl and a
linear_lights array in the constant buffer); here, as in the JAX package,
they are scene objects beside the polygonal lights.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

M_PI = float(np.pi)


@dataclasses.dataclass
class LinearLightSpec:
    start: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([-1.0, 0.0, 2.0], np.float32))
    end: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 0.0, 2.0], np.float32))
    radiant_flux: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32))


@dataclasses.dataclass
class LinearLights:
    """Stacked linear lights on the device (leading light axis; may be
    empty)."""
    start: torch.Tensor            # (L, 3)
    end: torch.Tensor              # (L, 3)
    linear_radiance: torch.Tensor  # (L, 3) = flux / (pi^2 * length)

    @property
    def count(self) -> int:
        return self.start.shape[0]


def line_flux_to_linear_radiance_np(radiant_flux, length):
    """L_eff = flux / (pi^2 * length) in float32 (ops/line_sampling.py of
    the JAX package): a Lambertian thin cylinder of total flux Phi emits
    intensity per length L_eff * sin(alpha)."""
    return np.asarray(radiant_flux, np.float32) / (
        np.float32(M_PI * M_PI) * np.maximum(np.float32(length),
                                             np.float32(1e-20)))


def linear_lights_from_numpy(start, end, linear_radiance,
                             device) -> LinearLights:
    def t(a):
        return torch.from_numpy(np.array(a, np.float32).reshape(-1, 3)) \
            .to(device)
    return LinearLights(t(start), t(end), t(linear_radiance))


def stack_linear_lights(specs: list[LinearLightSpec],
                        device) -> LinearLights:
    if not specs:
        empty = np.zeros((0, 3), np.float32)
        return linear_lights_from_numpy(empty, empty, empty, device)
    start = np.stack([np.asarray(s.start, np.float32) for s in specs])
    end = np.stack([np.asarray(s.end, np.float32) for s in specs])
    lengths = np.linalg.norm(end - start, axis=-1)
    radiance = np.stack([
        line_flux_to_linear_radiance_np(s.radiant_flux, lengths[i])
        for i, s in enumerate(specs)])
    return linear_lights_from_numpy(start, end, radiance, device)
