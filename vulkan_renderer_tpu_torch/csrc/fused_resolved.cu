// K5: fused shading with visibility resolved to 1 (no shadow rays), one
// thread per pixel, color accumulated in registers.
//
// Replaces the Pallas kernel vulkan_renderer_tpu/render/fused.py::
// fused_light_shading_resolved (one_group.kernel at :795, pallas_call at
// :816). The estimator is affine in visibility, so with trace_shadow_rays
// off every ray slot resolves to V = 1 and a pixel's color is
// base + sum over lights and slots of b. Each thread loops over the lights
// of one vertex-count group and over all samples at run time and writes
// only the (3, P) color: none of K4's 3 + 7 S slot planes is stored (at the
// timing sweep's 128 lights and 1920x1080 they would be 7.5 GB). One
// launch per distinct vertex count; the first writes, the others add
// (render/fused.py fused_light_shading_resolved).
//
// The TPU kernel split Arvo PSA at 128 spp into sample chunks because
// Mosaic could not compile 128 unrolled bodies (fused.py:737-745); the
// sample loop here is a run-time loop, so there is one chunk. The light
// and slot sums go in the order of fused_light_shading_resolved_plain:
// per light base + (0 + b_0 + b_1 + ...), lights added in group order.
//
// Inputs: the 62 base planes (62, P); the noise table with the frame's
// per-fetch offsets and layers (techniques.cuh Noise; no noise image);
// the (L, 58) light records. Column p of the planes is frame pixel
// pixels[p] (all pixels in row-major order when pixels is null), at
// x = pixel % frame_width, y = pixel / frame_width. Technique, strategy and
// heuristic are compile-time defines shared with K4 (techniques.cuh).
//
// What bounds it on the H100: issued float operations and their latency,
// as for K4 (see fused_shading.cu); the only memory traffic per
// pixel-light is one 8-byte table read per noise pair. At the timing
// sweep's shapes the counted operations bound it ~24x above its bytes,
// and it runs at ~2.5-3x that bound for PSA and ~7-9x for Arvo PSA, whose
// sector search spills (PERF.md section 6). The design does as K4 does:
// 128 registers for 16 warps per SM, and a pixel that hit nothing adds +0
// without shading its lights.

#include "techniques.cuh"

// Block size and the blocks per SM that __launch_bounds__ asks the
// register allocator for: render/fused.py LAUNCH_BOUNDS, chosen by
// measurement (PERF.md).
#if !defined(VR_THREADS) || !defined(VR_MIN_BLOCKS)
#error "VR_THREADS and VR_MIN_BLOCKS must be defined (render/fused.py LAUNCH_BOUNDS)"
#endif

namespace {

using namespace shade;

template <int NV>
__global__ void __launch_bounds__(VR_THREADS, VR_MIN_BLOCKS)
fused_resolved_kernel(const float* __restrict__ planes, int pixel_count,
                      Noise noise, const int* __restrict__ pixels,
                      int frame_width, const float* __restrict__ lights,
                      const int* __restrict__ light_ids, int group_size,
                      int sample_count, bool first_group, float vis,
                      float* __restrict__ out,
                      unsigned long long* __restrict__ op_counts) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pixel_count) return;
  vrt::begin_op_count();
  const size_t P = (size_t)pixel_count;
  const Pixel px = load_pixel(planes, P, p);
  const int pixel = pixels != nullptr ? pixels[p] : p;
  noise.x = pixel % frame_width;
  noise.y = pixel / frame_width;
  const int ppl = rays_per_light(sample_count);

  f32 group[3] = {0.0f, 0.0f, 0.0f};
  // A pixel that hit nothing gates every slot and base term to +0, so its
  // sum is +0 and it skips the light loop (bit for bit the same sum).
  if (px.hit) {
    for (int li = 0; li < group_size; ++li) {
      const int light = light_ids[li];
      const float* ls = lights + (size_t)light * kLightScalars;
      f32 lbase[3];
      f32 bsum[3] = {0.0f, 0.0f, 0.0f};
      shade_light<NV>(px, ls, noise, light * ppl, sample_count, vis, lbase,
                      [&](int, const f32* b, V3, f32) {
                        bsum[0] = bsum[0] + b[0];
                        bsum[1] = bsum[1] + b[1];
                        bsum[2] = bsum[2] + b[2];
                      });
#pragma unroll
      for (int c = 0; c < 3; ++c) group[c] = group[c] + (lbase[c] + bsum[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float* o = out + (size_t)c * P + p;
    *o = raw(first_group ? group[c] : *o + group[c]);
  }
  vrt::flush_op_count(op_counts);
}

// Launches the NV instantiation if VR_NV_MASK compiles it in.
template <int NV>
int launch(const float* planes, int pixel_count, Noise noise,
           const int* pixels, int frame_width, const float* lights,
           const int* light_ids, int group_size, int sample_count,
           int first_group, float vis, float* out,
           unsigned long long* op_counts, cudaStream_t stream) {
  if constexpr (((VR_NV_MASK >> NV) & 1) != 0) {
    const int blocks = (pixel_count + VR_THREADS - 1) / VR_THREADS;
    fused_resolved_kernel<NV><<<blocks, VR_THREADS, 0, stream>>>(
        planes, pixel_count, noise, pixels, frame_width, lights, light_ids,
        group_size, sample_count, first_group != 0, vis, out, op_counts);
    return (int)cudaGetLastError();
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int k5_fused_resolved(
    const float* planes, int pixel_count, const int* table, int table_height,
    int table_width, const int* fetches, const int* pixels, int frame_width,
    const float* lights, const int* light_ids, int group_size,
    int vertex_count, int sample_count, int first_group, float vis,
    float* out, unsigned long long* op_counts, cudaStream_t stream) {
  const Noise noise = {table, fetches, table_height, table_width, 0, 0};
  switch (vertex_count) {
    case 3: return launch<3>(planes, pixel_count, noise, pixels, frame_width, lights, light_ids, group_size, sample_count, first_group, vis, out, op_counts, stream);
    case 4: return launch<4>(planes, pixel_count, noise, pixels, frame_width, lights, light_ids, group_size, sample_count, first_group, vis, out, op_counts, stream);
    case 5: return launch<5>(planes, pixel_count, noise, pixels, frame_width, lights, light_ids, group_size, sample_count, first_group, vis, out, op_counts, stream);
    case 6: return launch<6>(planes, pixel_count, noise, pixels, frame_width, lights, light_ids, group_size, sample_count, first_group, vis, out, op_counts, stream);
    case 7: return launch<7>(planes, pixel_count, noise, pixels, frame_width, lights, light_ids, group_size, sample_count, first_group, vis, out, op_counts, stream);
    case 8: return launch<8>(planes, pixel_count, noise, pixels, frame_width, lights, light_ids, group_size, sample_count, first_group, vis, out, op_counts, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
