// K4: fused per-light shading with per-ray-slot outputs, one thread per
// pixel.
//
// Replaces the Pallas kernel vulkan_renderer_tpu/render/fused.py::
// fused_light_shading (kernel2 at :666, pallas_call at :672). Per pixel and
// light it prepares the light's sampler and draws the light's ray slots:
// under DIFFUSE_SPECULAR_MIS (PSA and PSA-biased) two slots per sample,
// diffuse and specular, with the LTC density and the MIS estimate; under
// DIFFUSE_ONLY one slot per sample for any of the 13 techniques. The math
// lives in techniques.cuh; every operation is the plain PyTorch version's
// (render/fused.py fused_light_shading_plain) in the same order.
// Visibility is deferred: the frame resolves base + sum_slot b * V(ray).
//
// Specialization: the vertex count NV (3-8) is a template parameter, so
// every polygon lane array is unrolled; technique, strategy and MIS
// heuristic are compile-time defines (VR_TECHNIQUE, VR_MIS, VR_HEURISTIC),
// one library per combination, and VR_NV_MASK limits the vertex counts a
// library instantiates. The light loop and the sample loop run at run
// time: unrolling them blew up Mosaic's compile time on the TPU
// (fused.py:741-745) and would blow up register allocation here.
//
// Layout: input planes (NIN, P) = the 62 base planes then the noise pairs
// (light-major: light i's pair q at 62 + 2 (i ppl + q)); output (3 + 7 S, P):
// base RGB, then per ray slot b RGB, direction xyz, t_max. Plane-major, so
// a warp's loads and stores of one plane coalesce. Lights are (L, 58)
// records (fused.py:49-60) read uniformly by all threads.
//
// What bounds it on the H100: arithmetic and registers. Each pixel-light
// pair costs thousands of FP32 operations (clip, prepare with a sort,
// Newton steps, tens of transcendentals) against 62 input floats and 7
// output floats per slot, so it is far above the memory roofline. A
// prepared polygon takes 50-200 live floats; past the 255-register budget
// it spills to L1-resident local memory. __launch_bounds__(128) lets the
// compiler use up to 255 registers a thread.

#include "techniques.cuh"

namespace {

using namespace shade;

template <int NV>
__global__ void __launch_bounds__(128)
fused_shading_kernel(const float* __restrict__ planes, int pixel_count,
                     const float* __restrict__ lights,
                     const int* __restrict__ light_ids, int group_size,
                     int sample_count, bool first_group, float vis,
                     float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pixel_count) return;
  const size_t P = (size_t)pixel_count;
  const Pixel px = load_pixel(planes, P, p);
  const int ppl = rays_per_light(sample_count);

  float base[3] = {0.0f, 0.0f, 0.0f};
  for (int li = 0; li < group_size; ++li) {
    const int light = light_ids[li];
    const float* ls = lights + (size_t)light * kLightScalars;
    const float* nz = planes + (size_t)(kBasePlanes + 2 * light * ppl) * P + p;
    float lbase[3];
    shade_light<NV>(px, ls, nz, P, sample_count, vis, lbase,
                    [&](int q, const float* b, V3 d, float t_max) {
                      float* o = out + (size_t)(3 + 7 * (light * ppl + q)) * P + p;
                      o[0] = b[0];
                      o[P] = b[1];
                      o[2 * P] = b[2];
                      o[3 * P] = d.x;
                      o[4 * P] = d.y;
                      o[5 * P] = d.z;
                      o[6 * P] = t_max;
                    });
#pragma unroll
    for (int c = 0; c < 3; ++c) base[c] = base[c] + lbase[c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float* o = out + (size_t)c * P + p;
    *o = first_group ? base[c] : *o + base[c];
  }
}

// Launches the NV instantiation if VR_NV_MASK compiles it in.
template <int NV>
int launch(const float* planes, int pixel_count, const float* lights,
           const int* light_ids, int group_size, int sample_count,
           int first_group, float vis, float* out, cudaStream_t stream) {
  if constexpr (((VR_NV_MASK >> NV) & 1) != 0) {
    const int threads = 128;
    const int blocks = (pixel_count + threads - 1) / threads;
    fused_shading_kernel<NV><<<blocks, threads, 0, stream>>>(
        planes, pixel_count, lights, light_ids, group_size, sample_count,
        first_group != 0, vis, out);
    return (int)cudaGetLastError();
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int k4_fused_shading(const float* planes, int pixel_count,
                                const float* lights, const int* light_ids,
                                int group_size, int vertex_count,
                                int sample_count, int first_group, float vis,
                                float* out, cudaStream_t stream) {
  switch (vertex_count) {
    case 3: return launch<3>(planes, pixel_count, lights, light_ids, group_size, sample_count, first_group, vis, out, stream);
    case 4: return launch<4>(planes, pixel_count, lights, light_ids, group_size, sample_count, first_group, vis, out, stream);
    case 5: return launch<5>(planes, pixel_count, lights, light_ids, group_size, sample_count, first_group, vis, out, stream);
    case 6: return launch<6>(planes, pixel_count, lights, light_ids, group_size, sample_count, first_group, vis, out, stream);
    case 7: return launch<7>(planes, pixel_count, lights, light_ids, group_size, sample_count, first_group, vis, out, stream);
    case 8: return launch<8>(planes, pixel_count, lights, light_ids, group_size, sample_count, first_group, vis, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
