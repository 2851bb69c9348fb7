"""Noise tables (reference: noise_table.c, noise_utility.glsl).

Counterpart of vulkan_renderer_tpu/assets/noise.py, with its order of
sources: the blob <data_directory>/noise/<type>_rgba_WxH_LL.blob, then a
blob of that type packaged with the JAX package (data_builtin/noise, any
resolution), then for the Sobol family (the default Ahmed table among
them) the port's numpy generator (tools/generate_noise.py, the same bytes
as the JAX package's), cached in the data directory; white noise, the
reference's Wang-hash stream, with a warning when none of them has the
table. Blue-noise and dithered tables are not generated at load (a
128x128 dither mask takes ~25 s): python -m
vulkan_renderer_tpu_torch.tools.generate_noise writes them. Tables stay
raw UNORM16: (layers, H, W, 4).
"""

from __future__ import annotations

import dataclasses
import glob
import os
import warnings

import numpy as np

from ..ops.math_utils import wang_hash_np

SOBOL_FAMILY = ("sobol_2d", "owen_2d", "burley_owen_2d", "ahmed_2d")
# Every noise type of the reference (noise_table.h:22-55).
NOISE_TYPES = ("white", "blue_noise") + SOBOL_FAMILY + ("dithered_2d",)
_BUILTIN_NOISE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "..",
    "vulkan_renderer_tpu", "data_builtin", "noise")


@dataclasses.dataclass
class NoiseTable:
    table: np.ndarray  # (layers, H, W, 4) uint16
    noise_type: str

    @property
    def texture_index_mask(self) -> int:
        return self.table.shape[0] - 1


def white_noise_table(width: int = 256, height: int = 256,
                      layers: int = 64) -> NoiseTable:
    """The reference's white-noise stream (noise_table.c, seed 243708)."""
    count = width * height * layers * 4
    data = (wang_hash_np(np.arange(count, dtype=np.uint32)
                         + np.uint32(243708))
            & np.uint32(0xFFFF)).astype(np.uint16)
    return NoiseTable(data.reshape(layers, height, width, 4), "white")


def default_noise_resolution(noise_type: str) -> tuple[int, int, int]:
    """(width, height, layers) (noise_table.c:23-43)."""
    if noise_type == "blue_noise":
        return 64, 64, 64
    if noise_type == "dithered_2d":
        return 128, 128, 1
    return 256, 256, 64


def load_noise_table(noise_type: str = "ahmed_2d",
                     data_directory: str = "data", width: int | None = None,
                     height: int | None = None,
                     layers: int | None = None) -> NoiseTable:
    """Load (or generate and cache) the table of one noise type, by
    default at its default resolution; an unknown name raises
    ValueError."""
    if noise_type not in NOISE_TYPES:
        raise ValueError(f"unknown noise type {noise_type!r}")
    dw, dh, dl = default_noise_resolution(noise_type)
    width, height, layers = width or dw, height or dh, layers or dl
    if noise_type == "white":
        return white_noise_table(width, height, layers)
    name = f"{noise_type}_rgba_{width:02d}x{height:02d}_{layers:02d}.blob"
    path = os.path.join(data_directory, "noise", name)
    if not os.path.exists(path):
        builtin = sorted(glob.glob(os.path.join(
            _BUILTIN_NOISE, f"{noise_type}_rgba_*.blob")))
        if builtin:
            path = builtin[-1]
            dims, layer_s = os.path.basename(path)[:-5].rsplit("_", 2)[-2:]
            width, height = (int(v) for v in dims.split("x"))
            layers = int(layer_s)
    if not os.path.exists(path) and noise_type in SOBOL_FAMILY:
        from ..tools.generate_noise import generate_sobol_family
        try:
            path = generate_sobol_family(data_directory, noise_type, width,
                                         height, layers)
        except OSError:
            pass  # a read-only data directory: white noise below
    if not os.path.exists(path):
        warnings.warn(
            f"noise table {name!r} not found under {data_directory}/noise "
            "or the packaged data_builtin/noise: falling back to white "
            "noise. Write it with python -m "
            "vulkan_renderer_tpu_torch.tools.generate_noise "
            f"{data_directory}", stacklevel=2)
        return white_noise_table(width, height, layers)
    data = np.fromfile(path, np.uint16, width * height * layers * 4)
    return NoiseTable(data.reshape(layers, height, width, 4), noise_type)
