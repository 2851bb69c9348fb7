"""Noise tables generated from scratch: blue noise and dither masks by
void-and-cluster, and the Sobol family.

    python -m vulkan_renderer_tpu_torch.tools.generate_noise data [--small]

The port's own copy of vulkan_renderer_tpu/tools/generate_noise.py: the
same constructions in numpy float64 on the host give the same blob bytes
(numpy's FFT, never torch.fft: void-and-cluster takes a greedy argmax and
argmin over FFT energies, so another FFT's last bits change which tie
wins). The reference ships these tables as precomputed blobs
(noise_table.c:77-106); their semantics are documented in
noise_table.h:28-55:
  blue_noise, dithered_2d: void-and-cluster (Ulichney 1993) ranks per
                  channel and layer, from a wrapped Gaussian energy,
                  converted to u16 thresholds.
  sobol_2d:       4D Sobol points; dims (0,1) pick the screen pixel, the
                  later dims are the sample value for that pixel/layer.
  owen_2d:        same + nested (Owen) scrambling of the value dims.
  burley_owen_2d: same, Owen scrambling via Burley's hash construction
                  (Burley 2020, JCGT 9(4), "Practical Hash-based Owen
                  Scrambling").
  ahmed_2d:       Ahmed & Wonka 2020 (ToG 39:6): the Sobol sequence is
                  distributed across pixels by a hierarchically scrambled
                  Z-order so each pixel gets a CONSECUTIVE subsequence and
                  the error diffuses as screen-space blue noise.
Files follow the loader's naming: <type>_rgba_%02dx%02d_%02d.blob, raw u16
RGBA, (layers, H, W, 4).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _wrapped_gaussian_energy(size: int, sigma: float = 1.9) -> np.ndarray:
    x = np.arange(size)
    d = np.minimum(x, size - x).astype(np.float64)
    g1 = np.exp(-(d * d) / (2.0 * sigma * sigma))
    return np.outer(g1, g1)


def void_and_cluster(size: int, rng: np.random.Generator) -> np.ndarray:
    """A (size, size) blue-noise rank array (0 .. size^2 - 1)."""
    kernel_f = np.fft.rfft2(_wrapped_gaussian_energy(size))

    def energy(mask):
        return np.fft.irfft2(np.fft.rfft2(mask) * kernel_f, s=(size, size))

    n = size * size
    # Initial pattern: ~10% random minority points, relaxed.
    count = max(1, n // 10)
    mask = np.zeros((size, size))
    idx = rng.choice(n, count, replace=False)
    mask.ravel()[idx] = 1.0
    for _ in range(8 * count):
        e = energy(mask)
        cluster = np.unravel_index(np.argmax(np.where(mask > 0, e, -np.inf)),
                                   mask.shape)
        mask[cluster] = 0.0
        e = energy(mask)
        void = np.unravel_index(np.argmin(np.where(mask > 0, np.inf, e)),
                                mask.shape)
        if void == cluster:
            mask[cluster] = 1.0
            break
        mask[void] = 1.0

    ranks = np.zeros((size, size), np.int64)
    # Phase 1: remove minority points one by one (ranks count-1 .. 0).
    work = mask.copy()
    for rank in range(count - 1, -1, -1):
        e = energy(work)
        cluster = np.unravel_index(np.argmax(np.where(work > 0, e, -np.inf)),
                                   work.shape)
        work[cluster] = 0.0
        ranks[cluster] = rank
    # Phase 2: insert points into voids (ranks count .. n-1).
    work = mask.copy()
    for rank in range(count, n):
        e = energy(work)
        void = np.unravel_index(np.argmin(np.where(work > 0, np.inf, e)),
                                work.shape)
        work[void] = 1.0
        ranks[void] = rank
    return ranks


def ranks_to_u16(ranks: np.ndarray) -> np.ndarray:
    n = ranks.size
    return np.floor(ranks.astype(np.float64) / n * 65536.0) \
        .clip(0, 65535).astype(np.uint16)


def generate_blob(kind: str, width: int, height: int, layers: int,
                  seed: int = 0) -> np.ndarray:
    """(layers, H, W, 4) uint16 blue_noise or dithered_2d table: one
    void-and-cluster mask of side `width` per layer and channel, all
    drawn from one generator seeded with `seed`."""
    if kind not in ("blue_noise", "dithered_2d"):
        raise ValueError(kind)
    rng = np.random.default_rng(seed)
    out = np.empty((layers, height, width, 4), np.uint16)
    for layer in range(layers):
        for channel in range(4):
            out[layer, :, :, channel] = ranks_to_u16(
                void_and_cluster(width, rng))
    return out


def write_blob(data_directory: str, kind: str, table: np.ndarray) -> str:
    """Write a (layers, H, W, 4) table under the loader's name; returns
    the path."""
    layers, height, width = table.shape[:3]
    noise_dir = os.path.join(data_directory, "noise")
    os.makedirs(noise_dir, exist_ok=True)
    path = os.path.join(
        noise_dir, f"{kind}_rgba_{width:02d}x{height:02d}_{layers:02d}.blob")
    table.tofile(path)
    return path


# Joe & Kuo (new-joe-kuo-6.21201) primitive polynomials + initial direction
# numbers for Sobol dims 1..6 (dim 0 is the van der Corput sequence).
_SOBOL_DIMS = (
    (1, 0, (1,)),
    (2, 1, (1, 3)),
    (3, 1, (1, 3, 1)),
    (3, 2, (1, 1, 1)),
    (4, 1, (1, 1, 3, 3)),
    (4, 4, (1, 3, 5, 13)),
)
_BITS = 32


def _direction_vectors(dim: int) -> np.ndarray:
    """(32,) uint32 direction vectors v_b for Sobol dimension `dim`."""
    if dim == 0:
        return np.array([1 << (_BITS - 1 - b) for b in range(_BITS)],
                        np.uint32)
    s, a, m_init = _SOBOL_DIMS[dim - 1]
    m = list(m_init)
    for i in range(s, _BITS):
        mi = m[i - s] ^ (m[i - s] << s)
        for k in range(1, s):
            if (a >> (s - 1 - k)) & 1:
                mi ^= m[i - k] << k
        m.append(mi)
    return np.array([m[b] << (_BITS - 1 - b) for b in range(_BITS)],
                    np.uint32)


def _sobol_u32(indices: np.ndarray, dim: int) -> np.ndarray:
    """Sobol sample (32-bit fixed point) for each index; vectorized."""
    idx = indices.astype(np.uint64)
    v = _direction_vectors(dim)
    out = np.zeros(idx.shape, np.uint32)
    b = 0
    rem = idx.copy()
    while rem.any() and b < _BITS:
        out ^= np.where((rem & 1).astype(bool), v[b], np.uint32(0))
        rem >>= 1
        b += 1
    return out


def _hash_u32(x: np.ndarray, seed: int) -> np.ndarray:
    """Wang-hash based mixer (vectorized uint32 -> uint32)."""
    with np.errstate(over="ignore"):
        x = (x.astype(np.uint32) ^ np.uint32(seed & 0xFFFFFFFF)) \
            * np.uint32(0x9E3779B9)
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x21F0AAAD)
        x ^= x >> np.uint32(15)
        x *= np.uint32(0x735A2D97)
        x ^= x >> np.uint32(15)
    return x


def _owen_scramble_nested(x: np.ndarray, seed: int, bits: int) -> np.ndarray:
    """Exact nested uniform (Owen) scrambling of `bits`-bit values: the flip
    of each bit is a hash of all more-significant (scrambled-input) bits —
    the tree-of-permutations definition, vectorized with one pass per bit."""
    x = x.astype(np.uint32)
    out = np.zeros_like(x)
    for b in range(bits):  # b = 0 is the MSB
        prefix = x >> np.uint32(bits - b) if b else np.zeros_like(x)
        flip = _hash_u32(prefix, seed ^ (b * 0x632BE59B)) & np.uint32(1)
        bit = (x >> np.uint32(bits - 1 - b)) & np.uint32(1)
        out |= (bit ^ flip) << np.uint32(bits - 1 - b)
    return out


def _reverse_bits32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x = ((x >> np.uint32(1)) & np.uint32(0x55555555)) \
        | ((x & np.uint32(0x55555555)) << np.uint32(1))
    x = ((x >> np.uint32(2)) & np.uint32(0x33333333)) \
        | ((x & np.uint32(0x33333333)) << np.uint32(2))
    x = ((x >> np.uint32(4)) & np.uint32(0x0F0F0F0F)) \
        | ((x & np.uint32(0x0F0F0F0F)) << np.uint32(4))
    x = ((x >> np.uint32(8)) & np.uint32(0x00FF00FF)) \
        | ((x & np.uint32(0x00FF00FF)) << np.uint32(8))
    return (x >> np.uint32(16)) | (x << np.uint32(16))


def _burley_owen_scramble(x: np.ndarray, seed: int) -> np.ndarray:
    """Burley 2020 hash-based Owen scrambling: bit-reverse, Laine-Karras
    style permutation (carries only propagate upward), bit-reverse back."""
    x = _reverse_bits32(x)
    with np.errstate(over="ignore"):
        x = x + _hash_u32(np.full_like(x, 1), seed)
        x ^= x * np.uint32(0x6C50B47C)
        x ^= x * np.uint32(0xB82F1E52)
        x ^= x * np.uint32(0xC7AFE638)
        x ^= x * np.uint32(0x8D22F6E6)
    return _reverse_bits32(x)


def _interleave_bits(x: np.ndarray, y: np.ndarray, bits: int) -> np.ndarray:
    """Morton code with y in the higher of each bit pair."""
    out = np.zeros(x.shape, np.uint32)
    for b in range(bits):
        out |= ((x >> np.uint32(b)) & 1) << np.uint32(2 * b)
        out |= ((y >> np.uint32(b)) & 1) << np.uint32(2 * b + 1)
    return out


def _pixel_slots(pix: np.ndarray, n_pixels: int, layers: int):
    """Chronological per-pixel slot for each point. Returns (order, slot)
    where order is a stable sort by pixel and slot the arrival index."""
    order = np.argsort(pix, kind="stable")
    sp = pix[order]
    counts = np.bincount(sp, minlength=n_pixels)
    if not np.all(counts == layers):
        raise ValueError(
            "Sobol screen dims failed to stratify the pixel grid "
            f"(expected {layers} points/pixel, got range "
            f"[{counts.min()}, {counts.max()}]) — W/H/layers must be "
            "powers of two")
    starts = np.repeat(np.arange(n_pixels) * layers, layers)
    slot = np.arange(pix.size) - starts
    return order, slot


def sobol_family_blob(kind: str, width: int, height: int, layers: int,
                      seed: int = 0x5EED) -> np.ndarray:
    """(layers, H, W, 4) uint16 table for the sobol/owen/burley_owen kinds."""
    if width & (width - 1) or height & (height - 1) or layers & (layers - 1):
        raise ValueError("width/height/layers must be powers of two")
    n = width * height * layers
    lw, lh = width.bit_length() - 1, height.bit_length() - 1
    idx = np.arange(n, dtype=np.uint64)
    dims = [_sobol_u32(idx, d) for d in range(6)]
    if kind == "owen_2d":
        for d in (2, 3, 4, 5):
            dims[d] = _owen_scramble_nested(dims[d] >> np.uint32(16),
                                            seed + 101 * d, 16) \
                << np.uint32(16)
    elif kind == "burley_owen_2d":
        for d in (2, 3, 4, 5):
            dims[d] = _burley_owen_scramble(dims[d], seed + 101 * d)
    elif kind != "sobol_2d":
        raise ValueError(kind)
    px = (dims[0] >> np.uint32(_BITS - lw)).astype(np.int64)
    py = (dims[1] >> np.uint32(_BITS - lh)).astype(np.int64)
    order, slot = _pixel_slots(py * width + px, width * height, layers)
    table = np.empty((layers, height, width, 4), np.uint16)
    for ch, d in enumerate((2, 3, 4, 5)):
        vals = (dims[d] >> np.uint32(16)).astype(np.uint16)
        table[slot, py[order], px[order], ch] = vals[order]
    return table


def ahmed_blob(width: int, height: int, layers: int,
               seed: int = 0xA44ED) -> np.ndarray:
    """(layers, H, W, 4) uint16 table per Ahmed & Wonka 2020: pixels are
    ranked by an Owen-scrambled Z-order; the pixel of rank m consumes the
    consecutive Sobol subsequence [m*layers, (m+1)*layers).

    The within-chunk order is XOR-permuted per pixel: without it, layer 0
    of every pixel would read Sobol index m*layers — a multiple of
    `layers`, whose van der Corput value always lands in [0, 1/layers) —
    so a 1-spp render would sample one corner of the domain frame-wide.
    The XOR is a bijection of the chunk (the per-pixel point SET and its
    power-of-two-prefix stratification are unchanged) that assigns each
    layer a uniformly spread stratum."""
    if width != height or width & (width - 1) or layers & (layers - 1):
        raise ValueError("ahmed_2d needs square power-of-two resolution")
    lw = width.bit_length() - 1
    n_pix = width * height
    ys, xs = np.divmod(np.arange(n_pix, dtype=np.uint32), np.uint32(width))
    morton = _interleave_bits(xs, ys, lw)
    scrambled = _owen_scramble_nested(morton, seed, 2 * lw)
    order = np.argsort(scrambled, kind="stable")  # rank m -> pixel id
    ranks = np.arange(n_pix, dtype=np.uint64)
    chunk_xor = (_hash_u32(ranks.astype(np.uint32), seed ^ 0x51AB)
                 & np.uint32(layers - 1)).astype(np.uint64)
    lay = np.tile(np.arange(layers, dtype=np.uint64), n_pix)
    g = (np.repeat(ranks * layers, layers)
         + (lay ^ np.repeat(chunk_xor, layers)))
    table = np.empty((layers, height, width, 4), np.uint16)
    pix = np.repeat(order, layers)
    for ch, d in enumerate((0, 1, 2, 3)):
        vals = (_sobol_u32(g, d) >> np.uint32(16)).astype(np.uint16)
        table[lay, pix // width, pix % width, ch] = vals
    return table


def generate_sobol_family(data_directory: str, kind: str,
                          width: int = 256, height: int = 256,
                          layers: int = 64) -> str:
    """Generate one Sobol-family blob and write it with the loader's naming
    convention. Returns the written path."""
    if kind == "ahmed_2d":
        table = ahmed_blob(width, height, layers)
    else:
        table = sobol_family_blob(kind, width, height, layers)
    return write_blob(data_directory, kind, table)


def main(data_directory: str = "data", small: bool = False) -> None:
    """Write every generated table the loader reads, at the JAX tool's
    resolutions: dithered 128x128x1 (64 with small), blue noise 64x64 with
    8 layers (2 with small; the loader masks by layers - 1) from seed 1,
    and the four Sobol-family tables at 256x256x64 (64x64x16)."""
    size = 64 if small else 128
    path = write_blob(data_directory, "dithered_2d",
                      generate_blob("dithered_2d", size, size, 1))
    print(f"wrote {path}")
    layers = 2 if small else 8
    path = write_blob(data_directory, "blue_noise",
                      generate_blob("blue_noise", 64, 64, layers, seed=1))
    print(f"wrote {path}")
    size, layers = (64, 16) if small else (256, 64)
    for kind in ("sobol_2d", "owen_2d", "burley_owen_2d", "ahmed_2d"):
        path = generate_sobol_family(data_directory, kind, size, size, layers)
        print(f"wrote {path}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="Write the noise tables into <directory>/noise.")
    parser.add_argument("directory", nargs="?", default="data")
    parser.add_argument("--small", action="store_true",
                        help="smaller dithered and blue-noise tables and "
                        "64x64x16 Sobol-family tables")
    args = parser.parse_args()
    main(args.directory, args.small)
