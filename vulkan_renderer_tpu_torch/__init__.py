"""vulkan_renderer_tpu_torch — the PyTorch/CUDA port of vulkan_renderer_tpu.

The JAX package beside it is the reference; this package computes the same
frames with PyTorch on the host and hand-written CUDA kernels on an NVIDIA
H100 (sm_90a). It never imports JAX. Module names follow the JAX package so
each counterpart is easy to find:

  core/       device selection, precision flags, the Application frame loop
  ops/        pure shading math on tensors (plain PyTorch)
  assets/     .vkt codec, LTC fit tables, noise tables (numpy)
  scene/      the device-resident Scene
  render/     clusters, texture fetch, tracers (K1-K3), fused shading (K4)
              and its no-shadow resolved form (K5), the frame pipeline
  kernels/    nvcc build + ctypes loading of csrc/*.cu
  tools/      procedural scene writers (.vks/.vkt)
  experiments/ the experiment list, scene setups and the timing harness

Every kernel wrapper takes its plain PyTorch twin for CPU tensors and
launches its CUDA kernel (or raises) for CUDA tensors.
"""

__version__ = "0.1.0"

# Same light-record limits as the JAX package (vulkan_renderer_tpu/__init__.py).
MAX_POLYGONAL_LIGHT_VERTEX_COUNT = 7
MAX_POLYGON_VERTEX_COUNT = MAX_POLYGONAL_LIGHT_VERTEX_COUNT + 1
