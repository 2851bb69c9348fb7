// K2: primary closest hit and K3: attribute fetch + finalize, one thread
// per ray each.
//
// K2 replaces the Pallas kernel
// vulkan_renderer_tpu/render/trace_kernel.py::_closest_pass_one (kernel at
// :976, pallas_call at :1060). The TPU build runs it over work items of an
// XLA cull with supercluster budgets, an occlusion seed and an exactness
// re-trace; here each ray walks one binary tree over the clusters (the
// while-while walk of common.cuh walk_bvh, nearer child first, with the
// prune below), then a cluster's 8-triangle sub-boxes, then their
// triangles. Triangle test: the reciprocal-det Moeller-Trumbore of
// :1013-1028 with det_ok = |det| > 1e-12. A hit replaces the best when
// tt < best_t, or tt == best_t with a lower primitive id, so the answer is
// the lexicographic minimum of (t, prim) over the triangles behind the
// boxes the ray passes, whatever order the walk visits them in: the
// minimum that the ascending-id scan with a strict < and
// trace_closest_plain return (the reference's order below 1,024 clusters,
// :232-256), as long as the prune drops no box that holds a triangle
// whose computed t could be below the best t.
//
// The prune, and the bound that makes it exact. A box B (a BVH child or a
// sub-box) that passes the slab test against [0, t_max] is dropped when
// hit_t_floor(B) > best_t, where hit_t_floor is a lower bound on the
// computed t of every hit on a triangle in B. Moeller-Trumbore's computed
// t is not bounded below by B's entry: a triangle whose plane holds the
// ray (edge-on) has det and t's numerator both at rounding level, and its
// computed hit lands anywhere along the ray (tools/prune_check.py
// thin_edge_scene: up to 40% short); and a computed hit (u, v inside the
// triangle) can lie beside it, outside B, on a ray that enters B later.
// The bound exists for axis triangles: both edges have the same exactly
// zero component (e1.a == e2.a == 0, a = x, y or z), so every term of det
// and of t's numerator off that axis is an exact zero, and det = d_a W(1 +
// e), numerator = t_a W(1 + e'), with |e|, |e'| <= 2 kappa u + O(u^2),
// u = 2^-24, kappa = |e1||e2| / |e1 x e2| (the sliver factor). So, with
// t* the ray's exact distance to the triangle's plane:
//   (1) t >= t* (1 - (5 + 4 kappa) u): three roundings of t_a, 1/det and
//       the product, two of each of the two terms of W;
//   (2) the ray meets the plane within u (kappa (|T| + t*) + |e1| +
//       |e2|) of the triangle (|T|: the distance from the origin to v0):
//       the errors of u and v, the rounding of u + v, and the edges e1 =
//       fl(v1 - v0), which move the triangle's corners against the box's.
// Every vertex is within F of the origin (F: the sum over axes of the farther
// of |lo - o| and |hi - o| over the scene's box, the root's), so |T| <= F and
// t* <= F + D + eps, D the scene box's side sum (|e1| + |e2| <= 2 D): with
// rho = 4 kappa u, the ray passes B within eps = 2 (rho (2 F + D) + 4 u D) =
// kappa 8 u (2 F + D) + 8 u D at t* (per ray, floor_scale), and enters B
// grown by eps no later than t*. Along the axis that sets B's computed entry
// t_near, that grown box's entry is t_near - eps |1/d_a|, so t >= (t_near -
// eps |1/d_a|) (1 - eta) with eta = 2 (5 + 4 kappa) u + 16 u, the factors of
// 2 and the 16 u covering the roundings of the slab test and of the bound
// itself. `python -m vulkan_renderer_tpu_torch.tools.prune_check --bounds 40`
// checks (1) and (2) in float32 numpy over 8 M random axis triangles, slivers
// to kappa = 10^4, and rays at their edges and to 10^-6 rad off their plane:
// the measured worst is under half of the terms that eta and eps take
// (PERF.md section 6). For any other triangle t's error grows as 1 / |d . n|
// for rays near its plane, with no bound but the det gate, so a box holding
// one is never pruned by t. render/clusters.py stores per BVH child the
// largest kappa below it (record words 14 and 15), +inf where a child holds a
// triangle that is not an axis triangle, a collinear one, or one with kappa >
// 2^20; triangles with a zero edge are never hit (det is an exact 0) and
// count 0. The bench city and the sweep's planes are axis triangles of kappa
// <= 5.1, where the floor lies millimetres below the entry and the walk
// makes 0.02-0.08% more box and triangle tests than a flat 2^-16 margin;
// general meshes keep the prune only below the nodes that hold axis
// triangles alone. The floor is straight-line code: with early returns it
// cost K2 more than its arithmetic.
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

constexpr float kU = 1.0f / 16777216.0f;   // 2^-24, float32's unit roundoff
constexpr float kKappaMax = 1048576.0f;    // 2^20

// The slab test of common.cuh slab against [0, t_cap], which also writes
// |1/d| of the axis whose entry is t_near (the last of equal entries).
__device__ __forceinline__ bool slab_entry(const float* lo, const float* hi,
                                           const Ray& ray, float t_cap,
                                           float* t_near_out,
                                           float* inv_entry_out) {
  const float o[3] = {ray.ox, ray.oy, ray.oz};
  const float inv[3] = {ray.ix, ray.iy, ray.iz};
  float t_near = 0.0f, t_far = 0.0f, inv_entry = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = (lo[a] - o[a]) * inv[a];
    const float t1 = (hi[a] - o[a]) * inv[a];
    const float near = vrt::jmin(t0, t1), far = vrt::jmax(t0, t1);
    if (a == 0) {
      t_near = near;
      t_far = far;
      inv_entry = fabsf(inv[a]);
    } else {
      inv_entry = (near >= t_near) ? fabsf(inv[a]) : inv_entry;
      t_near = vrt::jmax(t_near, near);
      t_far = vrt::jmin(t_far, far);
    }
  }
  *t_near_out = t_near;
  *inv_entry_out = inv_entry;
  return (t_near <= t_far) && (t_far >= 0.0f) && (t_near <= t_cap) &&
         (t_cap >= 0.0f);
}

// Per ray: eps = kappa * scale.x + scale.y (header), from the scene's box
// (the union of the root's children; NaN children drop out).
__device__ __forceinline__ float2 floor_scale(const float4* nodes,
                                              const Ray& ray) {
  const float4 a = __ldg(nodes), b = __ldg(nodes + 1), c = __ldg(nodes + 2);
  const float lo[3] = {fminf(a.x, b.z), fminf(a.y, b.w), fminf(a.z, c.x)};
  const float hi[3] = {fmaxf(a.w, c.y), fmaxf(b.x, c.z), fmaxf(b.y, c.w)};
  const float o[3] = {ray.ox, ray.oy, ray.oz};
  float far = 0.0f, size = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    far += fmaxf(fabsf(lo[k] - o[k]), fabsf(hi[k] - o[k]));
    size += hi[k] - lo[k];
  }
  return {8.0f * kU * (2.0f * far + size), 8.0f * kU * size};
}

// A lower bound on the computed t of any hit on a triangle in a box
// entered at t_near along an axis with |1/d| = inv_entry, whose
// triangles' largest sliver factor is kappa (see the header); -inf where
// there is none.
__device__ __forceinline__ float hit_t_floor(float t_near, float inv_entry,
                                             float kappa, float2 scale) {
  const float eps = kappa * scale.x + scale.y;
  const float eta = (26.0f + 8.0f * kappa) * kU;
  const float at = (t_near - eps * inv_entry) * (1.0f - eta);
  // Straight-line code: a branch here costs K2 more than the arithmetic.
  const bool bounded =
      (kappa <= kKappaMax) & (inv_entry < 1e30f) & (t_near > 0.0f);
  return bounded ? at : -INFINITY;
}

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
  const float2 scale = floor_scale(nodes, ray);
  float best_t = INFINITY;
  int best = -1;
  vrt::TestCounts counts;
  // NaN floors keep their box.
  auto keep = [&](float at) { return !(at > best_t); };
  auto visit = [&](int k, float kappa) {
    const float* row = planes + (size_t)k * 9 * cluster_size;
    const float* boxes = subboxes + (size_t)k * 6 * subbox_count;
    for (int g = 0; g < subbox_count; ++g) {
      // Empty groups are NaN and fail the slab test.
      float t_sub, inv_sub;
      VR_COUNT(counts, subboxes, 1);
      const float* lo = boxes + 6 * g;
      const float* hi = lo + 3;
      if (!(slab_entry(lo, hi, ray, ray.t_max, &t_sub, &inv_sub) &
            keep(hit_t_floor(t_sub, inv_sub, kappa, scale))))
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
  };
  // common.cuh walk_bvh's while-while walk; the stack keeps each pushed
  // child's hit floor (checked again when popped) and its kappa.
  int stack_ref[vrt::kStack];
  float stack_floor[vrt::kStack], stack_kappa[vrt::kStack];
  int sp = 0;
  int ref = 0;  // the root
  float ref_kappa = INFINITY;
  auto pop = [&]() {
    while (sp > 0) {
      --sp;
      if (keep(stack_floor[sp])) {
        ref = stack_ref[sp];
        ref_kappa = stack_kappa[sp];
        return true;
      }
    }
    return false;
  };
  for (;;) {
    while (ref >= 0) {
      const float4* rec = nodes + 4 * ref;
      const float4 a = __ldg(rec), b = __ldg(rec + 1), c = __ldg(rec + 2),
                   d = __ldg(rec + 3);
      const float lo_l[3] = {a.x, a.y, a.z}, hi_l[3] = {a.w, b.x, b.y};
      const float lo_r[3] = {b.z, b.w, c.x}, hi_r[3] = {c.y, c.z, c.w};
      float t_l, t_r, inv_l, inv_r;
      const bool pass_l =
          slab_entry(lo_l, hi_l, ray, ray.t_max, &t_l, &inv_l);
      const bool pass_r =
          slab_entry(lo_r, hi_r, ray, ray.t_max, &t_r, &inv_r);
      const float floor_l = hit_t_floor(t_l, inv_l, d.z, scale);
      const float floor_r = hit_t_floor(t_r, inv_r, d.w, scale);
      const bool in_l = pass_l & keep(floor_l);
      const bool in_r = pass_r & keep(floor_r);
      VR_COUNT(counts, boxes, 2);
      const int ref_l = __float_as_int(d.x), ref_r = __float_as_int(d.y);
      if (in_l && in_r) {
        const bool right_first = t_r < t_l;
        stack_ref[sp] = right_first ? ref_l : ref_r;
        stack_floor[sp] = right_first ? floor_l : floor_r;
        stack_kappa[sp] = right_first ? d.z : d.w;
        ++sp;
        ref = right_first ? ref_r : ref_l;
        ref_kappa = right_first ? d.w : d.z;
      } else if (in_l || in_r) {
        ref = in_l ? ref_l : ref_r;
        ref_kappa = in_l ? d.z : d.w;
      } else if (!pop()) {
        goto done;
      }
    }
    if (-1 - ref < cluster_count) visit(-1 - ref, ref_kappa);
    if (!pop()) break;
  }
done:
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
