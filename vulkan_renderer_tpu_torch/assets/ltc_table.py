"""LTC fit tables (the reference's fit<i>.dat files, ltc_table.c:31-116).

Counterpart of vulkan_renderer_tpu/assets/ltc_table.py: the same analytic
inversion, max-magnitude normalization, negation of entry 1 and clamped
16-bit UNORM quantization, then dequantized to float32. The fits ship with
the JAX package as data files (vulkan_renderer_tpu/data_builtin/ltc_fits/)
and are read from there, by a path relative to this file (nothing is
imported to find them); the corner-quad view of the TPU build is not
carried over (a GPU gathers the four bilinear corners directly).
"""

from __future__ import annotations

import os

import numpy as np

BUILTIN_LTC_DIRECTORY = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..",
    "vulkan_renderer_tpu", "data_builtin", "ltc_fits")


def _process_records(records: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(N, 5) fit records -> (data_0 (N, 4), data_1 (N, 2)) as the
    reference quantizes them (ltc_table.c:82-116)."""
    d0, d1, d2, d3, albedo = [records[:, i] for i in range(5)]
    inverse = np.zeros((len(records), 3, 3), np.float32)
    inverse[:, 0, 0] = d2
    inverse[:, 0, 2] = -d1 * d2
    inverse[:, 1, 1] = d0 - d1 * d3
    inverse[:, 2, 0] = -d2 * d3
    inverse[:, 2, 2] = d0 * d2
    max_mag = np.abs(inverse).reshape(len(records), 9).max(axis=1)
    inverse /= np.maximum(max_mag, 1e-30)[:, None, None]
    processed = np.stack([
        inverse[:, 0, 0], inverse[:, 0, 2], inverse[:, 1, 1],
        inverse[:, 2, 0], inverse[:, 2, 2], albedo,
    ], axis=-1)
    processed[:, 1] *= -1.0
    quantized = np.clip(processed, 0.0, 1.0)
    quantized = np.floor(quantized * 65535.0 + 0.5) / 65535.0
    return quantized[:, :4].astype(np.float32), \
        quantized[:, 4:6].astype(np.float32)


def ltc_constants(fresnel_count: int, roughness_count: int,
                  inclination_count: int) -> np.ndarray:
    """Texture-coordinate constants of ltc_table.c:184-192 as float32
    [fresnel factor, fresnel summand, roughness factor, roughness summand,
    inclination factor, inclination summand]."""
    return np.array([
        fresnel_count - 1, 0.0,
        (roughness_count - 1) / roughness_count, 0.5 / roughness_count,
        (inclination_count - 1) / (0.5 * np.pi * inclination_count),
        0.5 / inclination_count], np.float32)


def load_ltc_table_files(directory: str, fresnel_count: int = 51):
    """fit0.dat .. fit<fresnel_count-1>.dat -> (table (F, I, R, 6) float32
    [m00, m02_neg, m11, m20, m22, albedo], constants (6,) float32)."""
    slices = []
    resolution = None
    for i in range(fresnel_count):
        path = os.path.join(directory, f"fit{i}.dat")
        with open(path, "rb") as f:
            res = int(np.frombuffer(f.read(8), np.uint64)[0])
            if resolution is None:
                resolution = res
            elif res != resolution:
                raise ValueError(f"{path}: inconsistent resolution {res}")
            records = np.frombuffer(f.read(res * res * 20), np.float32) \
                .reshape(res * res, 5)
        data_0, data_1 = _process_records(records)
        slices.append(np.concatenate([data_0.reshape(res, res, 4),
                                      data_1.reshape(res, res, 2)], axis=-1))
    return (np.stack(slices).astype(np.float32),
            ltc_constants(fresnel_count, resolution, resolution))


def default_ltc_table(directory: str = BUILTIN_LTC_DIRECTORY):
    """The packaged fits: every fit<i>.dat present in `directory`."""
    available = 0
    while os.path.exists(os.path.join(directory, f"fit{available}.dat")):
        available += 1
    if available == 0:
        raise FileNotFoundError(f"no LTC fit files under {directory}")
    return load_ltc_table_files(directory, available)
