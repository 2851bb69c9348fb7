"""vulkan_renderer_tpu_torch — the PyTorch/CUDA port of the JAX package
vulkan_renderer_tpu, which lives beside it.

The JAX package is the reference; this package computes the same frames
with PyTorch on the host and hand-written CUDA kernels on an NVIDIA H100
(sm_90a). It imports neither JAX nor any module of the JAX package (it
keeps its own copies of the JAX-free ones it needs, and reads the JAX
package's data files by path). Module names follow the JAX package so
each counterpart is easy to find:

  core/       device selection, precision flags, settings, frame timer,
              the Application frame loop
  ops/        pure shading math on tensors (plain PyTorch)
  assets/     .vks/.vkt codecs, quicksaves, LTC fit tables, noise tables
  scene/      camera, polygonal lights, the device-resident Scene
  render/     clusters and their BVH, texture fetch, tracers (K1-K3), fused
              shading (K4) and its no-shadow resolved form (K5), the frame
              pipeline, screenshot writers
  kernels/    nvcc build + ctypes loading of csrc/*.cu
  tools/      procedural scene and noise writers, the bench-frame timer
  experiments/ the experiment list, scene setups and the timing harness

Every kernel wrapper takes its plain PyTorch twin for CPU tensors and
launches its CUDA kernel (or raises) for CUDA tensors.
"""

__version__ = "0.1.0"

# Same light-record limits as the JAX package (vulkan_renderer_tpu/__init__.py).
MAX_POLYGONAL_LIGHT_VERTEX_COUNT = 7
MAX_POLYGON_VERTEX_COUNT = MAX_POLYGONAL_LIGHT_VERTEX_COUNT + 1
