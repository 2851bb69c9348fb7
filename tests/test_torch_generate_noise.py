"""The port's void-and-cluster noise generator against the JAX package's:
blue-noise and dithered tables byte for byte at 16x16 and 32x32 over two
seeds, the packaged 64x64x4 blue-noise blob reproduced byte for byte, and
main(small=True) writing the same files with the same bytes."""

import filecmp
import os

import numpy as np
import pytest

from vulkan_renderer_tpu.tools import generate_noise as j_generate_noise
from vulkan_renderer_tpu_torch.assets.noise import _BUILTIN_NOISE
from vulkan_renderer_tpu_torch.tools import generate_noise


@pytest.mark.parametrize("kind", ["blue_noise", "dithered_2d"])
@pytest.mark.parametrize("size", [16, 32])
@pytest.mark.parametrize("seed", [0, 5])
def test_blob_matches_reference(kind, size, seed):
    got = generate_noise.generate_blob(kind, size, size, 1, seed=seed)
    want = j_generate_noise.generate_blob(kind, size, size, 1, seed=seed)
    assert got.dtype == want.dtype == np.uint16
    assert got.tobytes() == want.tobytes()
    # Each channel is a rank mask: every threshold once.
    ranks = np.sort(got[0, :, :, 0].ravel().astype(np.int64))
    np.testing.assert_array_equal(
        ranks, np.floor(np.arange(size * size) / (size * size) * 65536.0))


def test_void_and_cluster_matches_reference():
    got = generate_noise.void_and_cluster(16, np.random.default_rng(3))
    want = j_generate_noise.void_and_cluster(16, np.random.default_rng(3))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.sort(got.ravel()), np.arange(256))
    with pytest.raises(ValueError):
        generate_noise.generate_blob("white", 16, 16, 1)


def test_packaged_blue_noise_blob_is_reproduced():
    path = os.path.join(_BUILTIN_NOISE, "blue_noise_rgba_64x64_04.blob")
    packaged = np.fromfile(path, np.uint16)
    assert packaged.size == 64 * 64 * 4 * 4
    got = generate_noise.generate_blob("blue_noise", 64, 64, 4, seed=1)
    assert got.tobytes() == packaged.tobytes()


def test_main_small_writes_the_reference_files(tmp_path, capsys):
    ours, ref = tmp_path / "port", tmp_path / "jax"
    generate_noise.main(str(ours), small=True)
    j_generate_noise.main(str(ref), small=True)
    names = sorted(os.listdir(ours / "noise"))
    assert names == sorted(os.listdir(ref / "noise"))
    assert names == sorted([
        "dithered_2d_rgba_64x64_01.blob", "blue_noise_rgba_64x64_02.blob"]
        + [f"{k}_rgba_64x64_16.blob" for k in
           ("sobol_2d", "owen_2d", "burley_owen_2d", "ahmed_2d")])
    for name in names:
        assert filecmp.cmp(ours / "noise" / name, ref / "noise" / name,
                           shallow=False), name
    assert capsys.readouterr().out.count("wrote ") == 2 * len(names)
