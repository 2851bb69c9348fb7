// K2: primary closest hit and K3: attribute fetch + finalize, one thread
// per ray each.
//
// K2 replaces the Pallas kernel
// vulkan_renderer_tpu/render/trace_kernel.py::_closest_pass_one (kernel at
// :976, pallas_call at :1060). The TPU build runs it over work items of an
// XLA cull with supercluster budgets, an occlusion seed and an exactness
// re-trace; here each ray walks one binary tree over the clusters
// (common.cuh walk_bvh) nearer child first, then a cluster's 8-triangle
// sub-boxes, then their triangles. A box is pruned when
// !(t_near <= cap), with cap the best t so far (as at :992) widened by
// kPruneMargin, and a sub-box when its slab test fails against [0, cap].
// The widening keeps the answer exact: the slab test's entry and
// Moeller-Trumbore's t round one distance in two ways and part by a few
// ulps, so a box can enter beyond the t of its own triangle, and with a
// hit already found in between, the bare best t would drop the winner
// (tools/prune_check.py builds a scene where it does; chip_smoke.py holds
// K2 exact there). Triangle test: the reciprocal-det Moeller-Trumbore
// of :1013-1028 with det_ok = |det| > 1e-12. A hit replaces the best when
// tt < best_t, or tt == best_t with a lower primitive id, so the answer is
// the lexicographic minimum of (t, prim) over the triangles behind the
// boxes, whatever order the walk visits them in: the minimum that the
// ascending-id scan with a strict < and trace_closest_plain return (the
// reference's order below 1,024 clusters, :232-256). Pruning by the cap
// only drops boxes that lie wholly beyond a hit already found.
//
// K3 replaces _attr_pass_one (kernel at :1244, pallas_call at :1298) plus
// the XLA finalize _attrs_finalize (:1311-1381): the winning triangle's 9
// geometry and 16 attribute scalars are gathered straight from the cluster
// tables (a GPU gather is cheap, so the TPU's item-grid select is gone) and
// the finalize math runs in the same thread. The stale-attribute fixup of
// the TPU pipeline has no counterpart: K2 never re-traces.
//
// What bounds them on the H100: K2, like K1, is bound by the latency of
// dependent, divergent loads and branches over L2-resident tables (~11 MB
// of planes and a 300 KB tree at the bench city), with ~45 FLOPs per
// triangle test. The tree visits boxes front to back, so best_t falls
// early and prunes everything behind the first surface; rays of
// neighbouring pixels share a warp (row-major pixel order), so a warp
// mostly walks the same branches. K3 is a gather of 100 bytes per ray plus
// ~150 FLOPs, bound by the scattered L2 reads of the winners' rows; its 18
// output planes are written plane-major so the stores coalesce.

#include "common.cuh"

namespace {

using vrt::Ray;
using vrt::Tri;

// Relative widening of the prune: 2^-16, 128-256 ulps of float32, far
// above the few ulps by which the two roundings of a distance part.
constexpr float kPruneMargin = 1.0f / 65536.0f;

__global__ void __launch_bounds__(128)
closest_kernel(const float* __restrict__ origins,
               const float* __restrict__ dirs,
               const float* __restrict__ t_max, int ray_count,
               const float4* __restrict__ nodes,
               const float* __restrict__ planes, int cluster_count,
               int cluster_size, const float* __restrict__ subboxes,
               int subbox_count, float t_min, float* __restrict__ t_out,
               int* __restrict__ prim_out,
               unsigned long long* __restrict__ test_counts) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= ray_count) return;
  const Ray ray = vrt::load_ray(origins, dirs, t_max, r);
  float best_t = INFINITY;
  int best = -1;
  vrt::TestCounts counts;
  // best_t > 0 (t >= t_min), and inf stays inf.
  auto cap = [&]() { return best_t + best_t * kPruneMargin; };
  auto keep = [&](float t_near) { return t_near <= cap(); };
  auto visit = [&](int k) {
    const float* row = planes + (size_t)k * 9 * cluster_size;
    const float* boxes = subboxes + (size_t)k * 6 * subbox_count;
    for (int g = 0; g < subbox_count; ++g) {
      // Sub-box pruned by the current cap; empty groups are NaN.
      float t_sub;
      VR_COUNT(counts, subboxes, 1);
      if (!vrt::slab(boxes + 6 * g, boxes + 6 * g + 3, ray, cap(), &t_sub))
        continue;
      const int t_end = min((g + 1) * vrt::kSubGroup, cluster_size);
      for (int t = g * vrt::kSubGroup; t < t_end; ++t) {
        VR_COUNT(counts, triangles, 1);
        const Tri p = vrt::load_tri(row, t, cluster_size);
        const float px = ray.dy * p.e2z - ray.dz * p.e2y;
        const float py = ray.dz * p.e2x - ray.dx * p.e2z;
        const float pz = ray.dx * p.e2y - ray.dy * p.e2x;
        const float det = p.e1x * px + p.e1y * py + p.e1z * pz;
        const bool det_ok = fabsf(det) > 1e-12f;
        const float inv_det = 1.0f / (det_ok ? det : 1.0f);
        const float tx = ray.ox - p.v0x, ty = ray.oy - p.v0y,
                    tz = ray.oz - p.v0z;
        const float u = (tx * px + ty * py + tz * pz) * inv_det;
        const float qx = ty * p.e1z - tz * p.e1y;
        const float qy = tz * p.e1x - tx * p.e1z;
        const float qz = tx * p.e1y - ty * p.e1x;
        const float v = (ray.dx * qx + ray.dy * qy + ray.dz * qz) * inv_det;
        const float tt = (p.e2x * qx + p.e2y * qy + p.e2z * qz) * inv_det;
        const int prim = k * cluster_size + t;
        if (det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
            tt >= t_min && (tt < best_t || (tt == best_t && prim < best))) {
          best_t = tt;
          best = prim;
        }
      }
    }
    return false;
  };
  vrt::walk_bvh(nodes, ray, cluster_count, keep, visit, counts);
  t_out[r] = best_t;
  prim_out[r] = best;
  vrt::flush_counts(counts, test_counts);
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__global__ void __launch_bounds__(128)
attrs_kernel(const int* __restrict__ prim, const float* __restrict__ origins,
             const float* __restrict__ dirs, int ray_count,
             const float* __restrict__ planes,
             const float* __restrict__ attrs, int cluster_size,
             const float* __restrict__ dcam, float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= ray_count) return;
  const int p = prim[r];
  float res[18];
  bool ok = false;
  if (p >= 0) {
    const int k = p / cluster_size, t = p % cluster_size;
    const float* g = planes + (size_t)k * 9 * cluster_size + t;
    const float* a = attrs + (size_t)k * 16 * cluster_size + t;
    const int c = cluster_size;
    const V3 v0 = {g[0], g[c], g[2 * c]};
    const V3 e1 = {g[3 * c], g[4 * c], g[5 * c]};
    const V3 e2 = {g[6 * c], g[7 * c], g[8 * c]};
    const V3 n0 = {a[0], a[c], a[2 * c]};
    const V3 n1 = {a[3 * c], a[4 * c], a[5 * c]};
    const V3 n2 = {a[6 * c], a[7 * c], a[8 * c]};
    const float uv0x = a[9 * c], uv0y = a[10 * c];
    const float uv1x = a[11 * c], uv1y = a[12 * c];
    const float uv2x = a[13 * c], uv2y = a[14 * c];
    const float material = a[15 * c];
    const V3 o = {origins[3 * r], origins[3 * r + 1], origins[3 * r + 2]};
    const V3 d = {dirs[3 * r], dirs[3 * r + 1], dirs[3 * r + 2]};

    // Re-intersection barycentrics (trace_kernel.py:1334-1344).
    const V3 rce1 = cross(d, e2);
    const float det = dot(e1, rce1);
    ok = fabsf(det) > 1e-30f;
    const float rcp = 1.0f / (ok ? det : 1.0f);
    const V3 r0 = {o.x - v0.x, o.y - v0.y, o.z - v0.z};
    const float det0 = dot(r0, rce1);
    const float b1 = rcp * det0;
    const V3 e0c0 = cross(e1, r0);
    const float det1 = dot(d, e0c0);
    const float b2 = -rcp * det1;
    const float b0 = 1.0f - (b1 + b2);
    // Analytic d(uv)/d(pixel) from the camera derivative rows.
    float duv[4];
    for (int di = 0; di < 2; ++di) {
      const V3 dd = {dcam[3 * di], dcam[3 * di + 1], dcam[3 * di + 2]};
      const V3 rce1d = cross(dd, e2);
      const float rcpd = -dot(e1, rce1d) * rcp * rcp;
      const float det0d = dot(r0, rce1d);
      const float db1 = rcpd * det0 + rcp * det0d;
      const float det1d = dot(dd, e0c0);
      const float db2 = -rcpd * det1 - rcp * det1d;
      const float db0 = -(db1 + db2);
      duv[2 * di] = db0 * uv0x + db1 * uv1x + db2 * uv2x;
      duv[2 * di + 1] = db0 * uv0y + db1 * uv1y + db2 * uv2y;
    }
    V3 ni = {b0 * n0.x + b1 * n1.x + b2 * n2.x,
             b0 * n0.y + b1 * n1.y + b2 * n2.y,
             b0 * n0.z + b1 * n1.z + b2 * n2.z};
    const float inv_len = rsqrtf(vrt::jmax(dot(ni, ni), 1e-30f));
    ni = {ni.x * inv_len, ni.y * inv_len, ni.z * inv_len};
    const float u = b0 * uv0x + b1 * uv1x + b2 * uv2x;
    const float v = b0 * uv0y + b1 * uv1y + b2 * uv2y;
    const float te0x = uv1x - uv0x, te0y = uv1y - uv0y;
    const float te1x = uv2x - uv0x, te1y = uv2y - uv0y;
    const V3 nxe0 = cross(ni, e1);
    const V3 e1xn = cross(e2, ni);
    const V3 tangent = {e1xn.x * te0x + nxe0.x * te1x,
                        e1xn.y * te0x + nxe0.y * te1x,
                        e1xn.z * te0x + nxe0.z * te1x};
    const V3 bitangent = {e1xn.x * te0y + nxe0.x * te1y,
                          e1xn.y * te0y + nxe0.y * te1y,
                          e1xn.z * te0y + nxe0.z * te1y};
    const float mtl =
        sqrtf(0.5f * (dot(tangent, tangent) + dot(bitangent, bitangent)));
    res[0] = ni.x; res[1] = ni.y; res[2] = ni.z;
    res[3] = u; res[4] = v;
    res[5] = duv[0]; res[6] = duv[1]; res[7] = duv[2]; res[8] = duv[3];
    res[9] = tangent.x; res[10] = tangent.y; res[11] = tangent.z;
    res[12] = bitangent.x; res[13] = bitangent.y; res[14] = bitangent.z;
    res[15] = mtl; res[16] = material;
  }
  for (int j = 0; j < 17; ++j) out[(size_t)j * ray_count + r] = ok ? res[j] : 0.0f;
  out[(size_t)17 * ray_count + r] = ok ? 1.0f : 0.0f;
}

}  // namespace

extern "C" int k2_closest(const float* origins, const float* dirs,
                          const float* t_max, int ray_count,
                          const float* nodes, const float* planes,
                          int cluster_count, int cluster_size,
                          const float* subboxes, int subbox_count, float t_min,
                          float* t_out, int* prim_out,
                          unsigned long long* test_counts,
                          cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (ray_count + threads - 1) / threads;
  closest_kernel<<<blocks, threads, 0, stream>>>(
      origins, dirs, t_max, ray_count,
      reinterpret_cast<const float4*>(nodes), planes, cluster_count,
      cluster_size, subboxes, subbox_count, t_min, t_out, prim_out,
      test_counts);
  return (int)cudaGetLastError();
}

extern "C" int k3_attrs(const int* prim, const float* origins,
                        const float* dirs, int ray_count, const float* planes,
                        const float* attrs, int cluster_size,
                        const float* dcam, float* out, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (ray_count + threads - 1) / threads;
  attrs_kernel<<<blocks, threads, 0, stream>>>(prim, origins, dirs, ray_count,
                                               planes, attrs, cluster_size,
                                               dcam, out);
  return (int)cudaGetLastError();
}
