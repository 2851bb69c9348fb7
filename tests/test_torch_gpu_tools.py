"""The port's tools and entry points on the card: the harness's --hdr
screenshot read back, the RMSE table's configurations, the LTC fit
against its CPU records, K4 and K5 on the blue-noise and dithered noise
tables, K4 and K5 where two_product leaves the FMA's exact range
(tools/two_product_probe.py), K1 where its sub-box gate decides
(tools/anyhit_gate_check.py), and the bench entry (vulkan_renderer_tpu_
torch/bench.py): its record against the window of the same frame, and
the kernels its frames launch. Marked gpu: they skip where
torch.cuda.is_available() is False; run them on the card with the rest of
the suite (tests/test_torch_gpu.py says how). This file imports only the
port (no JAX), and holds that no module of JAX or of the JAX package is
loaded."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_gpu_fixtures import (  # noqa: F401
    built, data_dir, jax_free, loaded_jax_modules)
from vulkan_renderer_tpu_torch.tools import bench_frame, kernel_check

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The RMSE table's cut: 8 spp against a 64-spp reference (the table: 128
# against 1,024).
RMSE_SPP, RMSE_REF_SPP = 8, 64
# The LTC fit: texels of the card's fit refitted on the CPU; the tolerance
# of the records after one Adam step and of each texel's fit loss after
# the full fit (the later steps amplify the last-bit differences of the
# two devices' float32 arithmetic). On an H100 (PyTorch 2.11, CUDA 12.8)
# the records differed by at most 7e-7 after 1 step, and a texel's loss
# by at most 1.85% relative after 600.
LTC_CPU_TEXELS = 16
LTC_STEP1_ATOL, LTC_STEP1_RTOL = 2e-6, 1e-5
LTC_LOSS_RTOL = 0.03
# The bench entry's frame: the bench frame at 4 spp, which the card paces
# (at 1 spp the host's dispatch paces it, and both measures read the
# host's jitter); --frames 20 gives the entry's run 40 pipelined frames,
# the window's count. Its value lies within ENTRY_WINDOW_RTOL of the
# window.
ENTRY_SPP, ENTRY_FRAMES, ENTRY_WINDOW_RTOL = 4, 20, 0.10
# bench.py's record (bench.py:270-289) and the card.
RECORD_KEYS = {"metric", "value", "unit", "vs_baseline", "loadavg",
               "pipelined_reps_ms", "sync_latency_ms", "card"}


def test_no_module_of_jax_or_the_jax_package_is_loaded():
    """Also held by jax_free before and after each gpu file, the last
    file's teardown after every test has imported what it uses."""
    assert not loaded_jax_modules(), loaded_jax_modules()


def test_harness_hdr_screenshot_reads_back(data_dir):
    """Experiment 113 (the central 4-gon 128-light PSA sweep frame, K5)
    through the harness with --hdr (1 warm-up, 2 measured frames): the
    .hdr it writes reads back as the frame, within RGBE quantization."""
    from vulkan_renderer_tpu_torch.experiments import harness
    from vulkan_renderer_tpu_torch.render.screenshot import read_hdr
    exp = harness.create_experiment_list(
        output_dir=os.path.join(data_dir, "hdr"),
        take_hdr_screenshots=True)[bench_frame.PSA_SWEEP_EXPERIMENT]
    last = {}
    result = harness.run_experiments(
        [exp], bench_frame.recording_application(data_dir, last),
        min_warmup_seconds=0.0, min_warmup_frames=1, measure_frames=2,
        data_directory=data_dir, device="cuda")[0]
    frame = last["image"].cpu().numpy()
    written = read_hdr(result.screenshot_path)
    assert result.screenshot_path.endswith(".hdr")
    assert written.shape == frame.shape
    _, exponent = np.frexp(frame.max(axis=-1, keepdims=True))
    assert not np.count_nonzero(
        np.abs(written - frame) > np.ldexp(1.0, exponent - 8))


@pytest.mark.parametrize("config", [1, 2, 3])
def test_rmse_table_configuration_on_card(data_dir, config):
    """The RMSE table's configuration at its own size, cut to RMSE_SPP
    against a RMSE_REF_SPP reference: an RMSE above 0 and under 0.05."""
    from vulkan_renderer_tpu_torch.tools import rmse_table
    r = rmse_table.run_config(config, RMSE_SPP, RMSE_REF_SPP, data_dir,
                              csv_path=None, device="cuda")
    assert 0.0 < r.rmse < 0.05, r.row


def test_ltc_fit_on_card(data_dir):
    """The default LTC fit (8 x 32 x 32 texels, 512 samples, 600 Adam
    steps, tools/fit_ltc.py) on the card: finite, m00 and m11 > 0, albedo
    in [0, 1], and its files load with assets/ltc_table.py. LTC_CPU_TEXELS
    texels fitted on the CPU too: after one step the records agree within
    LTC_STEP1_ATOL + LTC_STEP1_RTOL relative; after 600 each texel's fit
    loss (records_loss, both records evaluated on the CPU) within
    LTC_LOSS_RTOL relative."""
    from vulkan_renderer_tpu_torch.assets.ltc_table import (
        load_ltc_table_files, save_ltc_table_files)
    from vulkan_renderer_tpu_torch.tools import fit_ltc
    records = fit_ltc.fit_ltc_tables(device="cuda")
    assert records.shape == (8, 32, 32, 5)
    assert np.isfinite(records).all()
    assert (records[..., 0] > 0).all() and (records[..., 2] > 0).all()
    assert ((records[..., 4] >= 0) & (records[..., 4] <= 1)).all()
    fits = os.path.join(data_dir, "ltc_fits")
    save_ltc_table_files(fits, records)
    table, _ = load_ltc_table_files(fits, records.shape[0])
    assert table.shape == (8, 32, 32, 6) and np.isfinite(table).all()
    flat = np.arange(records[..., 0].size)
    pick = flat[np.linspace(0, flat.size - 1, LTC_CPU_TEXELS).astype(int)]
    texels = [torch.from_numpy(g.reshape(-1)[pick])
              for g in fit_ltc.texel_parameters()]
    step1 = fit_ltc.fit_ltc_tables(steps=1, device="cuda")
    card = torch.from_numpy(step1.reshape(-1, 5)[pick])
    cpu = fit_ltc.fit_texels(*texels, steps=1)
    assert bool(((card - cpu).abs()
                 <= LTC_STEP1_ATOL + LTC_STEP1_RTOL * cpu.abs()).all())
    card = torch.from_numpy(records.reshape(-1, 5)[pick])
    cpu = fit_ltc.fit_texels(*texels, steps=600)
    with torch.no_grad():
        loss_card = fit_ltc.records_loss(card, *texels)
        loss_cpu = fit_ltc.records_loss(cpu, *texels)
    assert float(((loss_card - loss_cpu).abs() / loss_cpu).max()) \
        <= LTC_LOSS_RTOL


@pytest.fixture(scope="module")
def noise_scenes(data_dir):
    """The bench scene with each other noise table: the packaged blue
    noise (64x64x4, layer mask 3) and a dithered table (128x128x1, mask
    0) that the port's void-and-cluster generator writes into data_dir."""
    from vulkan_renderer_tpu_torch.assets.noise import load_noise_table
    from vulkan_renderer_tpu_torch.tools import generate_noise
    generate_noise.write_blob(data_dir, "dithered_2d",
                              generate_noise.generate_blob(
                                  "dithered_2d", 128, 128, 1))
    scene, static = bench_frame.load_city(data_dir, "cuda")
    scenes = {}
    for name, shape, mask in (("blue_noise", (4, 64, 64, 4), 3),
                              ("dithered_2d", (1, 128, 128, 4), 0)):
        table = load_noise_table(name, data_dir)
        assert table.noise_type == name and table.table.shape == shape \
            and table.texture_index_mask == mask, (name, table.table.shape)
        scenes[name] = dataclasses.replace(
            scene, noise_table=torch.from_numpy(
                table.table.astype(np.int32)).to("cuda"),
            noise_texture_index_mask=table.texture_index_mask)
    return scenes, static


@pytest.mark.parametrize("kernel", ["K4", "K5"])
@pytest.mark.parametrize("table", ["blue_noise", "dithered_2d"])
def test_noise_table_on_shading_kernels(noise_scenes, table, kernel):
    """K4 (shadows on) and K5 (shadows off) against their plain versions
    on 4,096 of the bench frame's pixels with the noise table: bit for
    bit."""
    from vulkan_renderer_tpu_torch.render import fused
    scenes, static = noise_scenes
    settings = dataclasses.replace(bench_frame.settings(),
                                   trace_shadow_rays=kernel == "K4")
    with torch.no_grad():
        captured = bench_frame.capture_inputs(scenes[table], static, settings)
    if kernel == "K4":
        args = kernel_check.pixel_subset(captured["fused_shading"])
        r = kernel_check.compare(fused.fused_light_shading(*args),
                                 fused.fused_light_shading_plain(*args))
    else:
        args = kernel_check.pixel_subset(captured["fused_resolved"])
        r = kernel_check.compare(
            fused.fused_light_shading_resolved(*args).T,
            fused.fused_light_shading_resolved_plain(*args).T)
    assert r["exact"] == 1.0 and r["nonfinite_mismatch"] == 0, r


def test_two_product_probe_on_card(data_dir):
    """K4 (PSA, DIFFUSE_SPECULAR_MIS, shadows on) and K5 (PSA and Arvo
    PSA, DIFFUSE_ONLY) against their plain versions by bit pattern where
    two_product's products leave the range in which one FMA equals
    Dekker's split: lights 1e-17 to 1e-15 m from the shading points, near
    2^64 m and 2^116 m out (tools/two_product_probe.py)."""
    from vulkan_renderer_tpu_torch.tools import two_product_probe
    rows = two_product_probe.measure(two_product_probe.base_inputs(data_dir),
                                     "cuda")
    assert rows and not [r for r in rows if r["mismatches"]], rows


@pytest.mark.parametrize("probe", ["city_20x3_vertices", "city_60x5_vertices",
                                   "thin_edge_segments"])
def test_anyhit_gate_on_card(probe):
    """K1 against its plain version, which is the Pallas K1's function
    (every triangle of each cluster whose box passes), where a sub-box
    gate decides (tools/anyhit_gate_check.py): no mismatch, and no ray
    where the float32 model of K1's grown gate parts from the plain
    version; on the small city's vertex rays a bare slab test of the
    sub-box (K1's gate before it was grown) does part, so the probe
    reaches the gate."""
    from vulkan_renderer_tpu_torch.tools import anyhit_gate_check
    row = anyhit_gate_check.measure("cuda", probe)
    assert row["k1_mismatches"] == 0, row
    assert row["grown_gate_parts"] == 0, row
    if probe == "city_20x3_vertices":
        assert row["slab_gate_parts"] > 0, row


def test_bench_entry_record_within_the_window(data_dir):
    """The port's bench entry (python -m vulkan_renderer_tpu_torch.bench)
    at ENTRY_SPP with ENTRY_FRAMES in its own process exits 0 with
    bench.py's record (its keys, the card, uncertain=0 and overflow=0,
    no exactness failure), whose value lies within ENTRY_WINDOW_RTOL of
    the window ms/frame of the same frame measured here
    (bench_frame.window_ms)."""
    proc = subprocess.run(
        [sys.executable, "-m", "vulkan_renderer_tpu_torch.bench", "--data",
         data_dir, "--spp", str(ENTRY_SPP), "--frames", str(ENTRY_FRAMES)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    assert RECORD_KEYS <= set(record), record
    assert record["card"] == bench_frame.card_name(), record
    assert "uncertain=0, overflow=0" in record["metric"], record
    assert "exactness_failed" not in record, record
    window = bench_frame.window_ms(
        torch, bench_frame.application(data_dir, "cuda", ENTRY_SPP),
        bench_frame.WARMUP)
    assert abs(record["value"] / window - 1.0) <= ENTRY_WINDOW_RTOL, \
        (record["value"], window)


def test_bench_entry_launches_the_shadowed_kernels(data_dir):
    """The bench entry's pipelined run at its defaults launches K1-K4 and
    not K5."""
    from vulkan_renderer_tpu_torch import bench as entry
    from vulkan_renderer_tpu_torch.core import trace
    frame = entry.BenchFrame(entry.parse_args(["--data", data_dir]))
    frame.sync_latency_ms(1)
    trace.reset_counters()
    frame.pipelined_ms(10, 3124705)
    launches = trace.launch_counts()
    assert all(launches[k] > 0 for k in ("K1", "K2", "K3", "K4")), launches
    assert launches["K5"] == 0, launches
