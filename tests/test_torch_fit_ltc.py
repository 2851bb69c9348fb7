"""tools/fit_ltc.py and assets/ltc_table.py save_ltc_table_files on the
port against the JAX package's.

Tolerances: the loss at fixed parameters within 1e-4 relative of a
float64 numpy evaluation of the same formula; a 4 x 4 x 2 fit (64
samples) at 0 and at 50 Adam steps within 1e-4 absolute + 1e-3 relative
of the JAX fit (measured: albedo 1.3e-4 relative, parameters 2.1e-5
absolute after 50 steps; the two packages' GGX sampling and BRDF round
differently in float32, and Adam carries it); fit files byte-equal."""

import filecmp
import os

import numpy as np
import pytest
import torch

from vulkan_renderer_tpu.assets import ltc_table as j_ltc_table
from vulkan_renderer_tpu.tools import fit_ltc as j_fit
from vulkan_renderer_tpu_torch.assets import ltc_table
from vulkan_renderer_tpu_torch.tools import fit_ltc


def _softplus(x):
    return np.logaddexp(x, 0.0)


def _loss_np(params, directions, target):
    """The fit's loss in float64 numpy, texel by texel."""
    out = []
    for p, d, t in zip(params, directions, target):
        m00, m02 = _softplus(p[0]) + 1e-4, p[1]
        m11, m20 = _softplus(p[2]) + 1e-4, p[3]
        det2 = max(m00 - m02 * m20, 1e-5)
        inv = np.array([[1.0, 0.0, -m02], [0.0, det2 / m11, 0.0],
                        [-m20, 0.0, m00]]) / det2
        dc = d @ inv.T
        len_sq = np.sum(dc * dc, axis=-1)
        model = np.maximum(dc[:, 2], 0.0) * abs(np.linalg.det(inv)) \
            / (len_sq * len_sq) / np.pi
        fit = np.mean((np.sqrt(model + 1e-6) - np.sqrt(t + 1e-6)) ** 2)
        out.append(fit + max(0.05 - (m00 - m02 * m20), 0.0) ** 2 * 100.0)
    return np.array(out)


def test_loss_by_value():
    f0, roughness, inclination = (torch.from_numpy(a.reshape(-1))
                                  for a in fit_ltc.texel_parameters(4, 2))
    directions, target, _, params = fit_ltc.fit_problem(
        f0, roughness, inclination, 64)
    rng = np.random.default_rng(4)
    params = params + torch.from_numpy(
        rng.normal(0.0, 0.3, params.shape).astype(np.float32))
    # One texel past the barrier (m00 - m02 m20 < 0.05).
    params[0] = torch.tensor([-3.0, 2.0, 0.0, 1.0])
    got = fit_ltc.fit_loss(params, directions, target).numpy()
    want = _loss_np(params.double().numpy(), directions.double().numpy(),
                    target.double().numpy())
    assert want[0] > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_records_loss_is_the_fit_loss():
    """records_loss recovers the parameters from the records: at the
    starting parameters it is fit_loss within 1e-5 relative, and 50 Adam
    steps lower every texel's loss."""
    f0, roughness, inclination = (torch.from_numpy(a.reshape(-1))
                                  for a in fit_ltc.texel_parameters(4, 2))
    directions, target, albedo, params = fit_ltc.fit_problem(
        f0, roughness, inclination, 64)
    start = torch.stack([torch.nn.functional.softplus(params[:, 0]) + 1e-4,
                         params[:, 1],
                         torch.nn.functional.softplus(params[:, 2]) + 1e-4,
                         params[:, 3], albedo], dim=-1)
    want = fit_ltc.fit_loss(params, directions, target)
    got = fit_ltc.records_loss(start, f0, roughness, inclination, 64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)
    fitted = fit_ltc.fit_texels(f0, roughness, inclination, 64, 50)
    after = fit_ltc.records_loss(fitted, f0, roughness, inclination, 64)
    assert torch.all(after < got)


@pytest.mark.parametrize("steps", [0, 50])
def test_fit_matches_reference(steps):
    want = j_fit.fit_ltc_tables(resolution=4, fresnel_count=2,
                                sample_count=64, steps=steps)
    got = fit_ltc.fit_ltc_tables(resolution=4, fresnel_count=2,
                                 sample_count=64, steps=steps, device="cpu")
    assert got.shape == want.shape == (2, 4, 4, 5)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)
    assert np.all(got[..., 0] > 0) and np.all(got[..., 2] > 0)
    assert np.all((got[..., 4] >= 0) & (got[..., 4] <= 1))


def test_fit_files_match_reference(tmp_path):
    records = np.random.default_rng(2).uniform(
        0.1, 1.0, (3, 4, 4, 5)).astype(np.float32)
    ltc_table.save_ltc_table_files(str(tmp_path / "port"), records)
    j_ltc_table.save_ltc_table_files(str(tmp_path / "jax"), records)
    for i in range(3):
        assert filecmp.cmp(tmp_path / "port" / f"fit{i}.dat",
                           tmp_path / "jax" / f"fit{i}.dat", shallow=False)
    table, constants = ltc_table.load_ltc_table_files(str(tmp_path
                                                          / "port"), 3)
    assert table.shape == (3, 4, 4, 6) and constants.shape == (6,)
    assert fit_ltc.main(["--output", str(tmp_path / "cli"),
                         "--resolution", "2", "--fresnel-count", "2",
                         "--samples", "8", "--steps", "2",
                         "--device", "cpu"]) == 0
    assert sorted(os.listdir(tmp_path / "cli")) == ["fit0.dat", "fit1.dat"]
