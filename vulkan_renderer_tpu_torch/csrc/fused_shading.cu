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
// Layout: input planes (62, P), the base planes of render/fused.py
// BASE_PLANES. The noise is read from the table (techniques.cuh Noise;
// light i's pair q is the frame's pair i ppl + q) at the frame pixel of
// each column: pixels[p], or p when pixels is null, at x = pixel %
// frame_width, y = pixel / frame_width. Output (3 + 7 S, P): base RGB, then
// per ray slot b RGB, direction xyz, t_max. Plane-major, so a warp's loads
// and stores of one plane coalesce. Lights are (L, 58) records
// (fused.py:49-60) read uniformly by all threads.
//
// A pixel that hit nothing skips its lights: its base and every b are +0
// (the gate includes the hit), and its slots are written dead, direction 0
// and t_max -1, as the plain version writes them; the frame traces no ray
// whose b is 0 (render/pipeline.py).
//
// What bounds it on the H100: issued float operations, and the latency of
// their long dependent chains (clip, sort, Newton steps, IEEE divisions)
// at the occupancy the registers allow. The counting build
// (-DVR_COUNT_OPS=1, chip_smoke.py) counts ~2,750 operations per hit
// pixel-light under DIFFUSE_SPECULAR_MIS against 62 input floats and 7
// output floats per slot, so at the bench frame the operation bound is
// above the byte bound, and the kernel runs at ~7x it (PERF.md section 6).
// What the design does about it: __launch_bounds__ caps a thread at 128
// registers for 16 resident warps per SM (the rest of a prepared polygon
// spills to L1-resident local memory), which measured faster than 8 warps
// at 221 registers without spills; miss pixels skip their lights; and
// two_product's error term is one exact FMA instead of Dekker's split.

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
fused_shading_kernel(const float* __restrict__ planes, int pixel_count,
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

  f32 base[3] = {0.0f, 0.0f, 0.0f};
  for (int li = 0; li < group_size; ++li) {
    const int light = light_ids[li];
    if (!px.hit) {
      for (int slot = 0; slot < ppl; ++slot) {
        float* o = out + (size_t)(3 + 7 * (light * ppl + slot)) * P + p;
#pragma unroll
        for (int k = 0; k < 6; ++k) o[k * P] = 0.0f;
        o[6 * P] = -1.0f;
      }
      continue;
    }
    const float* ls = lights + (size_t)light * kLightScalars;
    f32 lbase[3];
    shade_light<NV>(px, ls, noise, light * ppl, sample_count, vis, lbase,
                    [&](int slot, const f32* b, V3 d, f32 t_max) {
                      float* o = out + (size_t)(3 + 7 * (light * ppl + slot)) * P + p;
                      o[0] = raw(b[0]);
                      o[P] = raw(b[1]);
                      o[2 * P] = raw(b[2]);
                      o[3 * P] = raw(d.x);
                      o[4 * P] = raw(d.y);
                      o[5 * P] = raw(d.z);
                      o[6 * P] = raw(t_max);
                    });
#pragma unroll
    for (int c = 0; c < 3; ++c) base[c] = base[c] + lbase[c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float* o = out + (size_t)c * P + p;
    *o = raw(first_group ? base[c] : *o + base[c]);
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
    fused_shading_kernel<NV><<<blocks, VR_THREADS, 0, stream>>>(
        planes, pixel_count, noise, pixels, frame_width, lights, light_ids,
        group_size, sample_count, first_group != 0, vis, out, op_counts);
    return (int)cudaGetLastError();
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int k4_fused_shading(
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
