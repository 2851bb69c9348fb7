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
// Inputs: the 62 base planes (62, P) without noise; the noise light-major
// (L, 2 ppl, P), so a warp's reads of one pair plane are coalesced; the
// (L, 58) light records. Technique, strategy and heuristic are
// compile-time defines shared with K4 (techniques.cuh).
//
// What bounds it on the H100: arithmetic and registers, as for K4 (see
// fused_shading.cu); the only memory traffic per pixel-light is its
// 2 ppl noise floats.

#include "techniques.cuh"

namespace {

using namespace shade;

template <int NV>
__global__ void __launch_bounds__(128)
fused_resolved_kernel(const float* __restrict__ planes, int pixel_count,
                      const float* __restrict__ noise,
                      const float* __restrict__ lights,
                      const int* __restrict__ light_ids, int group_size,
                      int sample_count, bool first_group, float vis,
                      float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pixel_count) return;
  const size_t P = (size_t)pixel_count;
  const Pixel px = load_pixel(planes, P, p);
  const int ppl = rays_per_light(sample_count);

  float group[3] = {0.0f, 0.0f, 0.0f};
  for (int li = 0; li < group_size; ++li) {
    const int light = light_ids[li];
    const float* ls = lights + (size_t)light * kLightScalars;
    const float* nz = noise + (size_t)light * 2 * ppl * P + p;
    float lbase[3];
    float bsum[3] = {0.0f, 0.0f, 0.0f};
    shade_light<NV>(px, ls, nz, P, sample_count, vis, lbase,
                    [&](int, const float* b, V3, float) {
                      bsum[0] = bsum[0] + b[0];
                      bsum[1] = bsum[1] + b[1];
                      bsum[2] = bsum[2] + b[2];
                    });
#pragma unroll
    for (int c = 0; c < 3; ++c) group[c] = group[c] + (lbase[c] + bsum[c]);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float* o = out + (size_t)c * P + p;
    *o = first_group ? group[c] : *o + group[c];
  }
}

// Launches the NV instantiation if VR_NV_MASK compiles it in.
template <int NV>
int launch(const float* planes, int pixel_count, const float* noise,
           const float* lights, const int* light_ids, int group_size,
           int sample_count, int first_group, float vis, float* out,
           cudaStream_t stream) {
  if constexpr (((VR_NV_MASK >> NV) & 1) != 0) {
    const int threads = 128;
    const int blocks = (pixel_count + threads - 1) / threads;
    fused_resolved_kernel<NV><<<blocks, threads, 0, stream>>>(
        planes, pixel_count, noise, lights, light_ids, group_size,
        sample_count, first_group != 0, vis, out);
    return (int)cudaGetLastError();
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int k5_fused_resolved(const float* planes, int pixel_count,
                                 const float* noise, const float* lights,
                                 const int* light_ids, int group_size,
                                 int vertex_count, int sample_count,
                                 int first_group, float vis, float* out,
                                 cudaStream_t stream) {
  switch (vertex_count) {
    case 3: return launch<3>(planes, pixel_count, noise, lights, light_ids, group_size, sample_count, first_group, vis, out, stream);
    case 4: return launch<4>(planes, pixel_count, noise, lights, light_ids, group_size, sample_count, first_group, vis, out, stream);
    case 5: return launch<5>(planes, pixel_count, noise, lights, light_ids, group_size, sample_count, first_group, vis, out, stream);
    case 6: return launch<6>(planes, pixel_count, noise, lights, light_ids, group_size, sample_count, first_group, vis, out, stream);
    case 7: return launch<7>(planes, pixel_count, noise, lights, light_ids, group_size, sample_count, first_group, vis, out, stream);
    case 8: return launch<8>(planes, pixel_count, noise, lights, light_ids, group_size, sample_count, first_group, vis, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
