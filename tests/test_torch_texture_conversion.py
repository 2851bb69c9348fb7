"""tools/texture_conversion.py on the port against the JAX package's: for
the same PNG (RGB and RGBA), HDR and .npy inputs, every KNOWN_FORMATS
code gives byte-equal .vkt files, or the same refusal where the JAX
encoder has no encoding for the format. The PNG path decodes sRGB in
float32 in both packages, and the two pow implementations part in the
last ulp on ~3% of texels (held at 1 ulp); no .vkt byte shows it."""

import filecmp
import re

import numpy as np
import pytest

from vulkan_renderer_tpu.render.screenshot import write_hdr, write_png
from vulkan_renderer_tpu.tools import texture_conversion as j_conv
from vulkan_renderer_tpu_torch.tools import texture_conversion as conv


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(9)
    paths = {}
    for name, channels in (("rgb", 3), ("rgba", 4)):
        paths[name] = str(d / f"{name}.png")
        write_png(paths[name], rng.integers(0, 256, (16, 8, channels),
                                            dtype=np.uint8))
    paths["hdr"] = str(d / "light.hdr")
    write_hdr(paths["hdr"], rng.uniform(0.0, 20.0, (8, 16, 3))
              .astype(np.float32))
    paths["npy"] = str(d / "normals.npy")
    np.save(paths["npy"], rng.uniform(0.0, 1.0, (8, 8, 2)))
    paths["odd"] = str(d / "odd.png")
    write_png(paths["odd"], np.zeros((6, 8, 3), np.uint8))
    return paths


@pytest.mark.parametrize("code", conv.KNOWN_FORMATS)
@pytest.mark.parametrize("source", ["rgb", "rgba", "hdr", "npy"])
def test_vkt_bytes_match_reference(inputs, tmp_path, code, source):
    assert conv.KNOWN_FORMATS == j_conv.KNOWN_FORMATS
    ours, ref = str(tmp_path / "ours.vkt"), str(tmp_path / "ref.vkt")
    try:
        j_conv.convert(code, inputs[source], ref)
    except ValueError as exc:
        with pytest.raises(ValueError, match=re.escape(str(exc))):
            conv.convert(code, inputs[source], ours)
        return
    conv.convert(code, inputs[source], ours)
    assert filecmp.cmp(ours, ref, shallow=False)


def test_loaders_and_refusals(inputs):
    np.testing.assert_array_equal(conv.load_image(inputs["hdr"]),
                                  j_conv.load_image(inputs["hdr"]))
    for source in ("rgb", "rgba"):
        np.testing.assert_array_max_ulp(conv.load_image(inputs[source]),
                                        j_conv.load_image(inputs[source]),
                                        maxulp=1)
    with pytest.raises(ValueError, match="power of two"):
        conv.convert(132, inputs["odd"], "unused.vkt")
    with pytest.raises(ValueError, match="unknown VkFormat"):
        conv.convert(7, inputs["rgb"], "unused.vkt")
    with pytest.raises(ValueError, match="unsupported input"):
        conv.load_image("image.jpg")
    assert conv.main([]) == 1
