"""The LTC table's sources in the port against the JAX package: fit files
in <data_directory>/ltc_fits come first (a truncated set with a warning,
a set that fails to load with a warning and the next source), then the
packaged fits, then the identity table; build_scene takes a caller's
(table, constants) pair as is. The JAX package reads data/ltc_fits under
the working directory and caches its choice in a process global, so each
JAX call here runs in the temporary directory with that cache reset."""

import os
import warnings

import numpy as np
import pytest

from vulkan_renderer_tpu.assets import ltc_table as j_ltc_table
from vulkan_renderer_tpu_torch.assets import ltc_table
from vulkan_renderer_tpu_torch.scene.lights import PolygonalLightSpec
from vulkan_renderer_tpu_torch.scene.scene import load_scene
from vulkan_renderer_tpu_torch.tools import export_scene


def _records(fresnel_count, resolution=8, seed=4):
    """Plausible fit records (m00, m02, m11, m20, albedo), float32."""
    rng = np.random.default_rng(seed)
    shape = (fresnel_count, resolution, resolution)
    return np.stack([rng.uniform(0.2, 1.5, shape), rng.uniform(-0.5, 0.5,
                                                                shape),
                     rng.uniform(0.2, 1.5, shape), rng.uniform(-0.5, 0.5,
                                                                shape),
                     rng.uniform(0.0, 1.0, shape)], axis=-1) \
        .astype(np.float32)


def _jax_default(monkeypatch, directory):
    """The JAX package's default_ltc_table() run in `directory`, its cache
    reset: (table, constants) as numpy."""
    monkeypatch.chdir(directory)
    monkeypatch.setattr(j_ltc_table, "_DEFAULT_CACHE", None)
    ref = j_ltc_table.default_ltc_table()
    return np.asarray(ref.table), np.array(
        [np.asarray(v) for v in ref.constants], np.float32)


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ltc_scene"))
    vks = export_scene.write_test_scene(d, "cornell_box",
                                        texture_resolution=8)
    return vks, os.path.join(d, "cornell_box_textures")


def _scene_ltc(cornell, **kwargs):
    vks, textures = cornell
    scene = load_scene(vks, textures, [PolygonalLightSpec()], "cpu",
                       **kwargs)
    return scene.ltc.table.numpy(), scene.ltc.constants.numpy()


def test_fits_in_the_data_directory_reach_the_scene(cornell, tmp_path,
                                                    monkeypatch):
    data = tmp_path / "data"
    packaged, _ = ltc_table.default_ltc_table(str(data))
    ltc_table.save_ltc_table_files(str(data / "ltc_fits"), _records(51))
    want = ltc_table.load_ltc_table_files(str(data / "ltc_fits"), 51)
    assert want[0].shape == (51, 8, 8, 6)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = _scene_ltc(cornell, data_directory=str(data))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, _jax_default(monkeypatch, tmp_path)):
        np.testing.assert_array_equal(a, b)
    # No state between calls: a directory without fits takes the
    # packaged table again.
    again, _ = ltc_table.default_ltc_table(str(tmp_path / "empty"))
    np.testing.assert_array_equal(again, packaged)
    assert packaged.shape == (51, 32, 32, 6)


def test_truncated_fit_set_warns_in_both(tmp_path, monkeypatch):
    ltc_table.save_ltc_table_files(str(tmp_path / "data" / "ltc_fits"),
                                   _records(3, seed=9))
    with pytest.warns(UserWarning, match="only 3 of 51"):
        got = ltc_table.default_ltc_table(str(tmp_path / "data"))
    with pytest.warns(UserWarning, match="only 3 of 51"):
        want = _jax_default(monkeypatch, tmp_path)
    assert got[0].shape == (3, 8, 8, 6)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_fit_set_that_fails_to_load_takes_the_packaged_fits(tmp_path,
                                                           monkeypatch):
    fits = tmp_path / "data" / "ltc_fits"
    ltc_table.save_ltc_table_files(str(fits), _records(2))
    with open(fits / "fit1.dat", "r+b") as f:
        f.write(np.uint64(16).tobytes())  # another resolution
    with pytest.warns(UserWarning, match="failed to load"):
        got = ltc_table.default_ltc_table(str(tmp_path / "data"))
    with pytest.warns(UserWarning, match="failed to load"):
        want = _jax_default(monkeypatch, tmp_path)
    packaged = ltc_table.load_ltc_table_files(
        ltc_table.BUILTIN_LTC_DIRECTORY, 51)
    for a, b, c in zip(got, want, packaged):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_identity_table_matches_reference():
    table, constants = ltc_table.identity_ltc_table()
    ref = j_ltc_table.identity_ltc_table()
    assert table.shape == (8, 32, 32, 6) and table.dtype == np.float32
    np.testing.assert_allclose(table, np.asarray(ref.table), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(constants, [np.asarray(v) for v in
                                           ref.constants], rtol=0, atol=1e-6)
    assert 0.0 <= table[..., 5].min() and table[..., 5].max() <= 1.0


def test_no_fits_anywhere_takes_the_identity_table(tmp_path, monkeypatch):
    missing = str(tmp_path / "missing")
    monkeypatch.setattr(ltc_table, "BUILTIN_LTC_DIRECTORY", missing)
    monkeypatch.setattr(j_ltc_table, "_BUILTIN_DIRECTORY", missing)
    with pytest.warns(UserWarning, match="identity LTC table"):
        got = ltc_table.default_ltc_table(str(tmp_path / "data"))
    with pytest.warns(UserWarning, match="IDENTITY LTC TABLE"):
        want = _jax_default(monkeypatch, tmp_path)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_build_scene_takes_the_given_table(cornell, tmp_path):
    ltc_table.save_ltc_table_files(str(tmp_path / "ltc_fits"), _records(51))
    given = ltc_table.identity_ltc_table(16, 16, 4)
    got = _scene_ltc(cornell, data_directory=str(tmp_path), ltc=given)
    for a, b in zip(got, given):
        np.testing.assert_array_equal(a, b)
