"""LTC fit tables (the reference's fit<i>.dat files, ltc_table.c:31-116).

Counterpart of vulkan_renderer_tpu/assets/ltc_table.py: the same analytic
inversion, max-magnitude normalization, negation of entry 1 and clamped
16-bit UNORM quantization, then dequantized to float32. default_ltc_table
takes the sources in the JAX package's order: the fits under
<data_directory>/ltc_fits (tools/fit_ltc.py writes them), then the fits
packaged with the JAX package as data files
(vulkan_renderer_tpu/data_builtin/ltc_fits/, read by a path relative to
this file: nothing is imported to find them), then identity_ltc_table.
The corner-quad view of the TPU build is not carried over (a GPU gathers
the four bilinear corners directly).
"""

from __future__ import annotations

import os
import warnings

import numpy as np

BUILTIN_LTC_DIRECTORY = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "..",
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


def save_ltc_table_files(directory: str, records: np.ndarray) -> None:
    """Write fit<i>.dat files; records: (F, res, res, 5) float32 of
    (m00, m02, m11, m20, albedo) per texel (ltc_table.c:31-47 reads
    them: a u64 resolution, then the records)."""
    os.makedirs(directory, exist_ok=True)
    fresnel_count, res = records.shape[0], records.shape[1]
    for i in range(fresnel_count):
        with open(os.path.join(directory, f"fit{i}.dat"), "wb") as f:
            f.write(np.uint64(res).tobytes())
            f.write(np.ascontiguousarray(records[i], np.float32).tobytes())


def ggx_albedo_approx(roughness: np.ndarray, mu: np.ndarray,
                      f0: np.ndarray) -> np.ndarray:
    """Analytic approximation of the directional albedo of the Frostbite
    GGX+Schlick BRDF (the Lazarov/Karis environment-BRDF polynomial), in
    float64. It only weights MIS techniques, so moderate accuracy
    suffices."""
    r = np.sqrt(np.clip(roughness, 0.0, 1.0))  # perceptual roughness
    c0 = np.array([-1.0, -0.0275, -0.572, 0.022])
    c1 = np.array([1.0, 0.0425, 1.04, -0.04])
    rr = np.stack([r, r, r, r], axis=-1) * c0 + c1
    a004 = np.minimum(rr[..., 0] * rr[..., 0],
                      np.exp2(-9.28 * mu)) * rr[..., 0] + rr[..., 1]
    scale = a004 * -1.04 + rr[..., 2]
    bias = a004 * 1.04 + rr[..., 3]
    return np.clip(f0 * scale + bias, 0.0, 1.0)


def identity_ltc_table(roughness_count: int = 32, inclination_count: int = 32,
                       fresnel_count: int = 8):
    """The fallback when no fits load: an identity transform in every
    texel, with ggx_albedo_approx as the albedo. MIS stays unbiased with
    any table; only variance suffers. Returns (table, constants) as
    load_ltc_table_files does."""
    table = np.zeros((fresnel_count, inclination_count, roughness_count, 6),
                     np.float32)
    table[..., 0] = 1.0  # m00
    table[..., 2] = 1.0  # m11
    table[..., 4] = 1.0  # m22
    constants = ltc_constants(fresnel_count, roughness_count,
                              inclination_count)
    # Texel centres: x = sqrt(roughness), y = inclination (ltc_table.c).
    tex_x = (np.arange(roughness_count) + 0.5) / roughness_count
    sqrt_rough = (tex_x - float(constants[3])) \
        / max(float(constants[2]), 1e-6)
    roughness = np.clip(sqrt_rough, 0.0, 1.0) ** 2
    tex_y = (np.arange(inclination_count) + 0.5) / inclination_count
    inclination = (tex_y - float(constants[5])) / float(constants[4])
    mu = np.clip(np.cos(inclination), 0.0, 1.0)
    f0 = np.linspace(0.0, 1.0, fresnel_count)
    table[..., 5] = ggx_albedo_approx(roughness[None, None, :],
                                      mu[None, :, None], f0[:, None, None])
    return table, constants


def default_ltc_table(data_directory: str = "data"):
    """The best available (table, constants), in the JAX package's order:
    <data_directory>/ltc_fits, then the packaged fits, then
    identity_ltc_table. Each fit directory is read with every
    fit<i>.dat present up to the reference's 51 Fresnel levels: a
    truncated set is taken with a warning, and a set that fails to load
    warns and the next source is tried."""
    count = 51  # ltc_table.c:31-47
    for directory in (os.path.join(data_directory, "ltc_fits"),
                      BUILTIN_LTC_DIRECTORY):
        if not os.path.exists(os.path.join(directory, "fit0.dat")):
            continue
        available = sum(
            os.path.exists(os.path.join(directory, f"fit{i}.dat"))
            for i in range(count))
        try:
            table = load_ltc_table_files(directory, available)
        except Exception as exc:
            warnings.warn(f"failed to load LTC fits from {directory}: "
                          f"{exc!r}; trying the next source", stacklevel=2)
            continue
        if available < count:
            warnings.warn(
                f"LTC table at {directory} has only {available} of {count} "
                "Fresnel fit levels (reference: ltc_table.c:31-47 expects "
                "51); specular MIS weights will be coarser.", stacklevel=2)
        return table
    warnings.warn(
        "no LTC fit tables found: falling back to the identity LTC table "
        "(specular sampling degenerates to cosine sampling). Run python -m "
        "vulkan_renderer_tpu_torch.tools.fit_ltc to fit tables.",
        stacklevel=2)
    return identity_ltc_table()
