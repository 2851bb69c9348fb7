"""two_product's error term in the kernels' form and the plain versions'.

Kernels K4 and K5 compute the error term of p = fl(a * b) with one fused
multiply-add, fma(a, b, -p) (csrc/techniques.cuh two_product); the plain
versions keep Dekker's split (ops/math_utils.py two_product). The kernels
cannot run here, so fma_error() below gives the FMA's result: a * b and
a * b - p are exact in float64 for float32 a and b, so one rounding to
float32 is what the FMA rounds once.

The two forms give the same bits wherever Dekker's split is exact:
|a|, |b| < 2**115 (a * 4097 finite), |a * b| < 2**127, and a * b zero or
at least 2**-102 in magnitude (the exact error then has no bit below
float32's least subnormal). The cross products of K4 and K5 take vertex
coordinates of the lights in the shading frame, which a scene keeps far
inside that range. Outside it the forms part: the last test pins that
boundary, so a kernel/plain mismatch there points here."""

import numpy as np
import pytest
import torch

from vulkan_renderer_tpu_torch.ops.math_utils import two_product

N = 100_000


def fma_error(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float32 fma(a, b, -fl(a * b)), rounded once."""
    p = a * b
    exact = a.astype(np.float64) * b.astype(np.float64) - p.astype(np.float64)
    return exact.astype(np.float32)


def dekker_error(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return two_product(torch.from_numpy(a), torch.from_numpy(b))[1].numpy()


def signed_values(rng, exponents) -> np.ndarray:
    """float32 values of random sign and significand at the exponents."""
    mantissa = rng.uniform(1.0, 2.0, len(exponents)) \
        * rng.choice([-1.0, 1.0], len(exponents))
    return np.ldexp(mantissa, exponents).astype(np.float32)


def band(rng, name):
    """(a, b) of one operand band."""
    if name == "scene":
        return (signed_values(rng, rng.integers(-20, 21, N)),
                signed_values(rng, rng.integers(-20, 21, N)))
    if name == "wide":
        return (signed_values(rng, rng.integers(-50, 51, N)),
                signed_values(rng, rng.integers(-50, 51, N)))
    if name == "near_underflow":
        # Products between 2**-102 and 2**-95.
        ea = rng.integers(-70, 1, N)
        eb = rng.integers(-102, -95, N) - ea
        return signed_values(rng, ea), signed_values(rng, eb)
    if name == "near_split_overflow":
        # |a| up to 2**115, products below 2**127.
        ea = rng.integers(100, 115, N)
        eb = rng.integers(-60, 127 - 115, N)
        return signed_values(rng, ea), signed_values(rng, eb)
    if name == "exact_and_zero":
        # Products with no rounding error, and zero operands of both signs.
        a = rng.integers(-4096, 4097, N).astype(np.float32)
        b = rng.integers(-4096, 4097, N).astype(np.float32)
        b[::7] = 0.0
        b[3::7] = -0.0
        return a, b
    raise ValueError(name)


@pytest.mark.parametrize("name", ["scene", "wide", "near_underflow",
                                  "near_split_overflow", "exact_and_zero"])
def test_fma_error_term_equals_dekker_bit_for_bit(name):
    a, b = band(np.random.default_rng(17), name)
    want = dekker_error(a, b)
    got = fma_error(a, b)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    # The error term is exact: p + e == a * b in float64.
    p = (a * b).astype(np.float64)
    assert np.array_equal(p + got.astype(np.float64),
                          a.astype(np.float64) * b.astype(np.float64))


def test_fma_and_dekker_part_outside_the_stated_range():
    rng = np.random.default_rng(5)
    # Products near 2**-115: the exact error needs bits below 2**-149.
    ea = rng.integers(-70, 1, N)
    a = signed_values(rng, ea)
    b = signed_values(rng, -116 - ea)
    assert np.count_nonzero(fma_error(a, b).view(np.int32)
                            != dekker_error(a, b).view(np.int32)) > 0
    # |a| >= 2**116: a * 4097 overflows and Dekker's split is NaN.
    a = signed_values(rng, np.full(64, 116))
    b = signed_values(rng, rng.integers(-40, 0, 64))
    assert np.all(np.isnan(dekker_error(a, b)))
    assert np.all(np.isfinite(fma_error(a, b)))
