"""Parity of the PyTorch port's host-side modules with the JAX package:
scene writers (.vks/.vkt bytes), the vkt codec, math codecs, LTC tables,
noise tables and the noise image, the texture atlas and fetch, cluster
tables and the scene build. Inputs come from seeded numpy generators and
go through both packages."""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_renderer_tpu.assets import ltc_table as j_ltc_table
from vulkan_renderer_tpu.assets import noise as j_noise
from vulkan_renderer_tpu.assets import vkt as j_vkt
from vulkan_renderer_tpu.ops import ltc as j_ltc
from vulkan_renderer_tpu.ops import math_utils as j_math
from vulkan_renderer_tpu.ops import noise as j_ops_noise
from vulkan_renderer_tpu.render import texture as j_texture
from vulkan_renderer_tpu.render import trace_kernel as j_trace
from vulkan_renderer_tpu.render.wavefront import build_clusters
from vulkan_renderer_tpu.scene.lights import PolygonalLightSpec
from vulkan_renderer_tpu.scene.scene import load_scene as j_load_scene
from vulkan_renderer_tpu.tools import city as j_city
from vulkan_renderer_tpu.tools import export_scene as j_export
from vulkan_renderer_tpu_torch.assets import ltc_table, noise, vkt
from vulkan_renderer_tpu_torch.ops import ltc, math_utils
from vulkan_renderer_tpu_torch.ops.noise import get_noise_image
from vulkan_renderer_tpu_torch.render import clusters as t_clusters
from vulkan_renderer_tpu_torch.render import texture
from vulkan_renderer_tpu_torch.render.trace_kernel import (
    cluster_candidates, inverse_directions, ray_box_slab)
from vulkan_renderer_tpu_torch.scene import scene as t_scene
from vulkan_renderer_tpu_torch.tools import city, export_scene


def _tree_equal(a_dir, b_dir):
    names = []
    for root, _, files in os.walk(a_dir):
        for f in files:
            p = os.path.join(root, f)
            q = os.path.join(b_dir, os.path.relpath(p, a_dir))
            assert filecmp.cmp(p, q, shallow=False), p
            names.append(f)
    return names


def test_city_and_cornell_files_match_reference_bytes(tmp_path):
    """Same seeds -> byte-identical .vks and .vkt files."""
    a, b = tmp_path / "port", tmp_path / "jax"
    city.write_city_scene(str(a), "c", n_buildings=12, detail=3,
                          texture_resolution=16)
    j_city.write_city_scene(str(b), "c", n_buildings=12, detail=3,
                            texture_resolution=16)
    export_scene.write_test_scene(str(a), texture_resolution=8)
    j_export.write_test_scene(str(b), "cornell_box", texture_resolution=8)
    names = _tree_equal(str(a), str(b))
    assert "c.vks" in names and "cornell_box.vks" in names
    assert len(names) == 2 + 3 * (6 + 3)


def test_morton_order_and_checkerboard_match(rng):
    pts = rng.normal(size=(500, 3)) * 10.0
    lo, hi = pts.min(0), pts.max(0)
    np.testing.assert_array_equal(export_scene.morton_order(pts, lo, hi),
                                  j_export.morton_order(pts, lo, hi))
    np.testing.assert_array_equal(
        export_scene.checkerboard_texture(32, 4, (0.1, 0.2, 0.3)),
        j_export.checkerboard_texture(32, 4, (0.1, 0.2, 0.3)))


def test_math_codecs_match_reference(rng):
    n = rng.normal(size=(1000, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    codes = math_utils.encode_normal_octahedral_32bit_np(n)
    np.testing.assert_array_equal(
        codes, j_math.encode_normal_octahedral_32bit_np(n))
    ref = np.asarray(j_math.decode_normal_octahedral_32bit(
        jnp.asarray(codes.astype(np.float32) / 65535.0)))
    # Float32 decode in numpy vs XLA: a few ulp.
    np.testing.assert_allclose(
        math_utils.decode_normal_octahedral_32bit_np(codes), ref, atol=2e-7)
    pos = rng.uniform(-5, 7, size=(400, 3))
    got = math_utils.encode_position_64bit_np(pos, pos.min(0), pos.max(0))
    want = j_math.encode_position_64bit_np(pos, pos.min(0), pos.max(0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    dec = math_utils.decode_position_64bit_np(*got)
    ref = np.asarray(j_math.decode_position_64bit(
        jnp.asarray(got[0]), got[1], got[2]))
    np.testing.assert_allclose(dec, ref, rtol=1e-6, atol=1e-6)
    seeds = rng.integers(0, 2**32, size=1000, dtype=np.uint64) \
        .astype(np.uint32)
    np.testing.assert_array_equal(math_utils.wang_hash_np(seeds),
                                  j_math.wang_hash_np(seeds))


def test_vkt_codec_matches_reference(rng, tmp_path):
    img = rng.uniform(0, 1, size=(16, 16, 3)).astype(np.float32)
    two = rng.uniform(0, 1, size=(16, 16, 2)).astype(np.float32)
    bc1 = vkt.encode_bc1(img)
    bc5 = vkt.encode_bc5(two)
    np.testing.assert_array_equal(bc1, j_vkt.encode_bc1(img))
    np.testing.assert_array_equal(bc5, j_vkt.encode_bc5(two))
    np.testing.assert_array_equal(vkt.decode_bc1(bc1, 16, 16),
                                  j_vkt.decode_bc1(bc1, 16, 16))
    np.testing.assert_array_equal(vkt.decode_bc5(bc5, 16, 16),
                                  j_vkt.decode_bc5(bc5, 16, 16))
    for a, b in zip(vkt.gaussian_mip_pyramid(img),
                    j_vkt.gaussian_mip_pyramid(img)):
        np.testing.assert_array_equal(a, b)
    # sRGB BC1 round trip through files written by the port, read by both.
    tex = vkt.encode_texture(img, vkt.VK_FORMAT_BC1_RGB_SRGB_BLOCK)
    path = str(tmp_path / "t.vkt")
    vkt.save_vkt(path, tex)
    got = vkt.load_vkt(path).decode_to_float()
    want = j_vkt.load_vkt(path).decode_to_float()
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        # float32 pow in torch vs XLA: at most a few ulp.
        np.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-7)


def test_ltc_table_and_coefficients_match_reference(rng):
    table, constants = ltc_table.default_ltc_table()
    count = table.shape[0]
    ref = j_ltc_table.load_ltc_table_files(ltc_table.BUILTIN_LTC_DIRECTORY,
                                           count)
    np.testing.assert_array_equal(table, np.asarray(ref.table))
    np.testing.assert_array_equal(constants, np.array(
        [np.asarray(v) for v in ref.constants], np.float32))

    p = 512
    normal = rng.normal(size=(p, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    outgoing = rng.normal(size=(p, 3)).astype(np.float32)
    outgoing /= np.linalg.norm(outgoing, axis=1, keepdims=True)
    position = rng.normal(size=(p, 3)).astype(np.float32) * 5
    rough = rng.uniform(0, 1.2, p).astype(np.float32)
    f0 = rng.uniform(-0.1, 1.1, p).astype(np.float32)
    want = jax.vmap(lambda *a: j_ltc.get_ltc_coefficients(ref, *a))(
        jnp.asarray(f0), jnp.asarray(rough), jnp.asarray(position),
        jnp.asarray(normal), jnp.asarray(outgoing))
    got = ltc.get_ltc_coefficients(
        ltc.LtcTable(torch.from_numpy(table), torch.from_numpy(constants)),
        *(torch.from_numpy(a) for a in (f0, rough, position, normal,
                                         outgoing)))
    # acos/sqrt/normalize in torch vs XLA: float32 rounding only.
    for field in ("world_to_shading_space", "shading_to_cosine_space",
                  "world_to_cosine_space", "cosine_to_shading_space",
                  "albedo", "shading_to_cosine_space_determinant"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=2e-5, atol=2e-5, err_msg=field)


def test_noise_tables_match_reference(tmp_path):
    got = noise.load_noise_table("ahmed_2d", str(tmp_path / "a"), 64, 64, 4)
    want = j_noise.load_noise_table(j_noise.NoiseType.AHMED,
                                    str(tmp_path / "b"), (64, 64, 4))
    np.testing.assert_array_equal(got.table, want.table)
    assert got.texture_index_mask == int(want.texture_index_mask)
    white = noise.white_noise_table(32, 32, 8)
    want = j_noise.load_noise_table(j_noise.NoiseType.WHITE, str(tmp_path),
                                    (32, 32, 8))
    np.testing.assert_array_equal(white.table, want.table)


@pytest.mark.parametrize("width,height,pairs", [(40, 24, 3), (64, 80, 8)])
def test_noise_image_is_bit_exact(rng, width, height, pairs):
    table = rng.integers(0, 65536, size=(8, 32, 32, 4)).astype(np.uint16)
    mask = np.uint32(7)
    for seed in range(3):
        rnd = rng.integers(0, 2**32, size=4, dtype=np.uint64) \
            .astype(np.uint32)
        planes = get_noise_image(torch.from_numpy(table.astype(np.int32)),
                                 width, height, pairs, int(mask), rnd)
        assert planes.shape == (2 * pairs, width * height)
        # The port's plane-major layout, as the reference's (P, pairs, 2).
        got = planes.T.reshape(width * height, pairs, 2).numpy()
        want = np.asarray(j_ops_noise.get_noise_image(
            jnp.asarray(table), width, height, pairs, mask, jnp.asarray(rnd)))
        np.testing.assert_array_equal(got, want)
        ys, xs = np.meshgrid(np.arange(height), np.arange(width),
                             indexing="ij")
        pix = jnp.asarray(np.stack([xs, ys], -1).reshape(-1, 2), jnp.int32)
        per_pixel = np.asarray(j_ops_noise.get_noise_pairs(
            jnp.asarray(table), pix, pairs, jnp.asarray([31, 31], jnp.uint32),
            mask, jnp.asarray(rnd)))
        np.testing.assert_array_equal(got, per_pixel)


def test_texture_atlas_and_fetch_match_reference(rng):
    textures = []
    for size in (8, 16):
        mips = [rng.uniform(0, 1, size=(size >> l, size >> l, 8))
                .astype(np.float32) for l in range(size.bit_length())]
        textures.append(mips)
    got = texture.build_texture_atlas_np(textures)
    want = j_texture.build_texture_atlas(textures, channels=8,
                                         dtype=np.uint16)
    for key in ("texels", "mip_offset", "mip_width", "mip_height",
                "mip_count"):
        np.testing.assert_array_equal(got[key], np.asarray(getattr(want,
                                                                   key)))
    p = 300
    tex = rng.integers(0, 2, p)
    uv = rng.uniform(-3, 3, size=(p, 2)).astype(np.float32)
    dx = (rng.normal(size=(p, 2)) * 0.05).astype(np.float32)
    dy = (rng.normal(size=(p, 2)) * 0.05).astype(np.float32)
    ref = jax.vmap(lambda t, u, a, b: j_texture.sample_texture_grad(
        want, t, u, a, b))(jnp.asarray(tex, jnp.int32), jnp.asarray(uv),
                           jnp.asarray(dx), jnp.asarray(dy))
    atlas = texture.atlas_from_numpy(got, "cpu")
    out = texture.sample_texture_grad(
        atlas, torch.from_numpy(tex).long(), torch.from_numpy(uv),
        torch.from_numpy(dx), torch.from_numpy(dy))
    # log2 in torch vs XLA can move the LOD by an ulp.
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6)


def _city_tris(buildings=12):
    tris, norms, uvs, mats, _ = city.make_city(buildings, detail=3)
    return (tris.astype(np.float32), norms.astype(np.float32),
            uvs.astype(np.float32), mats)


def test_cluster_tables_match_reference():
    tris, norms, uvs, mats = _city_tris()
    got = t_clusters.build_clusters_np(tris, norms, uvs, mats, 64)
    want = build_clusters(tris, 64, norms, uvs, mats)
    assert want.cluster_count * 64 > tris.shape[0]  # a partial last cluster
    for key in ("aabb_lo", "aabb_hi", "planes", "attrs", "subboxes"):
        np.testing.assert_array_equal(got[key], np.asarray(getattr(want,
                                                                   key)))
    assert np.isnan(got["subboxes"][-1]).any()
    member_rows, sc_lo, sc_hi = j_trace._supercluster_aabbs(want)
    p_sc_lo, p_sc_hi, m_lo, m_hi = t_clusters.supercluster_tables_np(
        got["aabb_lo"], got["aabb_hi"])
    np.testing.assert_array_equal(p_sc_lo, np.asarray(sc_lo))
    np.testing.assert_array_equal(p_sc_hi, np.asarray(sc_hi))
    ks = p_sc_lo.shape[0]
    rows = np.asarray(member_rows)
    np.testing.assert_array_equal(m_lo.reshape(ks, -1), rows[:, :96])
    np.testing.assert_array_equal(m_hi.reshape(ks, -1), rows[:, 96:])


def test_nan_pad_boxes_never_hit(rng):
    """NaN padding boxes (superclusters, sub-boxes) must fail the slab test
    for every ray, including axis-parallel ones whose 1/d is 1e30."""
    r = 256
    origins = torch.from_numpy(rng.normal(size=(r, 3)).astype(np.float32))
    dirs = torch.from_numpy(rng.normal(size=(r, 3)).astype(np.float32))
    dirs[:32, 1:] = 0.0  # axis-parallel rays
    inv = inverse_directions(dirs)
    t_cap = torch.full((r,), float("inf"))
    nan_boxes = torch.full((4, 3), float("nan"))
    partial = torch.tensor([[0.0, float("nan"), 0.0]] * 4)
    mask, _ = ray_box_slab(torch.cat([nan_boxes, partial]),
                           torch.cat([nan_boxes, partial + 1.0]),
                           origins, inv, t_cap)
    assert not bool(mask.any())
    # A huge real box still hits everything that is alive.
    big_lo = torch.full((1, 3), -1e6)
    mask, _ = ray_box_slab(big_lo, -big_lo, origins, inv, t_cap)
    assert bool(mask.all())
    tris, norms, uvs, mats = _city_tris()
    clusters = t_clusters.clusters_from_numpy(
        t_clusters.build_clusters_np(tris, norms, uvs, mats), "cpu")
    cand = cluster_candidates(clusters, origins * 0.0, inv,
                              t_cap)
    assert not bool(cand[:, clusters.cluster_count:].any())
    assert bool(cand[:, :clusters.cluster_count].any())


LIGHT = PolygonalLightSpec(
    translation=np.array([1.0, 1.0, 1.99], np.float32),
    rotation_angles=np.array([np.pi, 0, 0], np.float32),
    scaling_x=0.4, scaling_y=0.4,
    radiant_flux=np.array([40.0, 35.0, 30.0], np.float32))


def test_scene_build_matches_reference(tmp_path):
    """The port's own load_scene equals the JAX scene carried over by
    scene_from_numpy (same files, same white noise table)."""
    vks = export_scene.write_test_scene(str(tmp_path), texture_resolution=8)
    tex = str(tmp_path / "cornell_box_textures")
    jscene = j_load_scene(vks, tex, [LIGHT],
                          noise_type=j_noise.NoiseType.WHITE,
                          data_directory=str(tmp_path))
    carried = t_scene.scene_from_numpy(t_scene.tree_leaves(jscene), "cpu")
    own = t_scene.load_scene(vks, tex, [LIGHT], "cpu",
                             noise=noise.white_noise_table())
    # Dequantization and the octahedral decode: float32 rounding only.
    np.testing.assert_allclose(own.triangle_positions.numpy(),
                               carried.triangle_positions.numpy(), atol=1e-6)
    for field in ("aabb_lo", "aabb_hi", "planes", "attrs", "subboxes",
                  "sc_lo", "sc_hi", "member_lo", "member_hi"):
        np.testing.assert_allclose(
            getattr(own.clusters, field).numpy(),
            getattr(carried.clusters, field).numpy(), atol=2e-6,
            err_msg=field)
    for field in ("texels", "mip_offset", "mip_width", "mip_height",
                  "mip_count"):
        a = getattr(own.material_atlas, field).numpy()
        b = getattr(carried.material_atlas, field).numpy()
        # UNORM16 of torch- vs XLA-decoded sRGB: at most one step.
        assert np.abs(a.astype(np.int64) - b).max() <= 1, field
    for field in t_scene.LIGHT_FIELDS:
        np.testing.assert_array_equal(getattr(own.lights, field).numpy(),
                                      getattr(carried.lights, field).numpy())
    np.testing.assert_array_equal(own.ltc.table.numpy(),
                                  carried.ltc.table.numpy())
    np.testing.assert_array_equal(own.noise_table.numpy(),
                                  carried.noise_table.numpy())
    assert own.noise_texture_index_mask == carried.noise_texture_index_mask
