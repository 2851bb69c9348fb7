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
float32's least subnormal). Outside it the forms part
(test_fma_and_dekker_part_outside_the_stated_range pins that boundary), so
the kernels take the FMA only where every coordinate of a polygon is 0
or between 2**-50 and 2**63 in magnitude (read off its exponent field;
the products then lie inside the range), and run Dekker's split itself
elsewhere;
kernel_error() models that in float32 numpy, and it equals the plain
version's bits in every band, inside the range and out of it."""

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


def dekker_np(a: np.ndarray, b: np.ndarray, p: np.ndarray) -> np.ndarray:
    """csrc/techniques.cuh dekker_error in float32 numpy, its order."""
    with np.errstate(all="ignore"):
        split = np.float32(4097.0)
        a_hi = a * split
        a_hi = a_hi - (a_hi - a)
        a_lo = a - a_hi
        b_hi = b * split
        b_hi = b_hi - (b_hi - b)
        b_lo = b - b_hi
        return ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo


def fma_exact(c: np.ndarray) -> np.ndarray:
    """csrc/techniques.cuh fma_exact on the float32 bits: c is 0 or
    2**-50 <= |c| < 2**63."""
    u = c.view(np.uint32) & np.uint32(0x7FFFFFFF)
    with np.errstate(over="ignore"):
        field = (u >> np.uint32(23)) - np.uint32(77)
    return (u == 0) | (field < np.uint32(190 - 77))


def kernel_error(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The error term of the kernels' two_product: the FMA where both
    operands are fma_exact (the kernels ask for it only where every
    coordinate of a polygon is, a subset), Dekker's split elsewhere."""
    with np.errstate(all="ignore"):
        p = a * b
        return np.where(fma_exact(a) & fma_exact(b), fma_error(a, b),
                        dekker_np(a, b, p))


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
    if name == "fma_range":
        # Every operand fma_exact, to both ends: products 2**-100 to 2**126.
        return (signed_values(rng, rng.integers(-50, 63, N)),
                signed_values(rng, rng.integers(-50, 63, N)))
    if name == "below_range":
        # Products near 2**-115 and subnormal ones: the FMA parts there.
        ea = rng.integers(-70, 1, N)
        eb = rng.integers(-150, -100, N) - ea
        return signed_values(rng, ea), signed_values(rng, eb)
    if name == "split_overflow":
        # |a| from 2**114 to 2**127: a * 4097 overflows from 2**116 on.
        return (signed_values(rng, rng.integers(114, 127, N)),
                signed_values(rng, rng.integers(-120, 0, N)))
    if name == "product_overflow":
        # |a * b| from 2**125 past float32's largest.
        ea = rng.integers(4, 115, N)
        eb = rng.integers(125, 130, N) - ea
        return signed_values(rng, ea), signed_values(rng, eb)
    if name == "specials":
        # inf, NaN and zeros of both signs against every band above.
        a = signed_values(rng, rng.integers(-149, 127, N))
        b = signed_values(rng, rng.integers(-149, 127, N))
        a[::5] = np.inf
        a[1::5] = -0.0
        b[2::5] = np.nan
        b[3::5] = 0.0
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


@pytest.mark.parametrize("name", ["scene", "wide", "near_underflow",
                                  "near_split_overflow", "exact_and_zero",
                                  "fma_range", "below_range",
                                  "split_overflow", "product_overflow",
                                  "specials"])
def test_kernel_two_product_is_dekker_bit_for_bit(name):
    a, b = band(np.random.default_rng(23), name)
    want = dekker_error(a, b)
    got = kernel_error(a, b)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    # The kernel's own split is the plain version's, op for op.
    with np.errstate(all="ignore"):
        p = a * b
    assert np.array_equal(dekker_np(a, b, p).view(np.int32),
                          want.view(np.int32))
    if name == "fma_range":
        # The kernels' FMA on all of it: the bare FMA is Dekker's there.
        assert (fma_exact(a) & fma_exact(b)).all()
        assert np.array_equal(fma_error(a, b).view(np.int32),
                              want.view(np.int32))
    if name in ("below_range", "split_overflow", "product_overflow"):
        # These bands leave the FMA's range, where the bare FMA parts.
        assert (~(fma_exact(a) & fma_exact(b))).any()


@pytest.fixture(scope="module")
def probe_inputs(tmp_path_factory):
    from vulkan_renderer_tpu_torch.tools import two_product_probe as probe
    return probe.base_inputs(str(tmp_path_factory.mktemp("probe")))


def test_probe_parts_the_bare_fma_not_the_kernels_form(probe_inputs,
                                                       monkeypatch):
    """tools/two_product_probe.py on the CPU: with the bare FMA's error
    term the plain versions of K4 and K5 (PSA) part from themselves on the
    probe's lights; with kernel_error, the kernels' form, they give the
    same bits in every value."""
    from vulkan_renderer_tpu_torch.ops import soa
    from vulkan_renderer_tpu_torch.tools import two_product_probe as probe
    rows = {(r["kernel"], r["technique"], r["case"]): r
            for r in probe.predict(probe_inputs)}
    psa, arvo = "PROJECTED_SOLID_ANGLE", "PROJECTED_SOLID_ANGLE_ARVO"
    assert rows[("K4", psa, "tiny")]["predicted_mismatches"] > 0
    assert rows[("K5", psa, "tiny")]["predicted_mismatches"] > 0
    assert rows[("K4", psa, "far_2^116")]["predicted_mismatches"] > 0
    for case in probe.CASES:
        assert rows[("K4", psa, case)]["error_terms_differing"] > 0 \
            or case == "far_2^64"
        assert rows[("K5", arvo, case)]["error_terms"] == 0

    def kernel_form(a, b):
        e = kernel_error(a.numpy(), b.numpy())
        return a * b, torch.from_numpy(e)

    for i, (kernel, _, _, _) in enumerate(probe.RUNS):
        plain = probe._kernel(kernel, True)
        for case in probe.CASES:
            args = probe.case_inputs(probe_inputs[i], case)
            with torch.no_grad():
                want = plain(*args)
                with monkeypatch.context() as m:
                    m.setattr(soa, "two_product", kernel_form)
                    got = plain(*args)
            assert probe.bit_mismatches(got, want) == 0, (kernel, case)
