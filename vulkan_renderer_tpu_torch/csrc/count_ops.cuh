// The float type of the shading code (techniques.cuh), and the counting
// build that counts its operations.
//
// In every library that render/fused.py launches, f32 is float and this
// header adds nothing. Built with -DVR_COUNT_OPS=1 (chip_smoke.py's
// counting libraries, render/fused.py `op_counts=`), f32 is a float that
// adds one to a per-thread counter for every operation the source
// executes, by kind and by stage (per pixel, per light prepare, per
// sample), and each thread adds its counters into a global array when it
// ends. That is the operation count of K4's and K5's bounds: what these
// inputs execute, branches and early exits included. Kinds: add and
// subtract; multiply; fused multiply-add (one rounding, __fmaf_rn);
// divide; square root and reciprocal square root; sin, cos, exp and log;
// compare, min and max. Negation, fabs and selects are not counted (the
// card folds the first two into an operand and a select has no float
// arithmetic), nor are conversions and integer index math. Each counted
// operation is at least one instruction on the card, and a divide, a
// square root or a transcendental is several, so the count is a lower
// bound of the instructions issued.
#pragma once

#include "common.cuh"

#ifndef VR_COUNT_OPS
#define VR_COUNT_OPS 0
#endif

namespace vrt {

// Counter layout: op_counts[stage * kOpKinds + kind].
enum OpKind : int { kOpAdd, kOpMul, kOpFma, kOpDiv, kOpSqrt, kOpTrans,
                    kOpCmp, kOpKinds };
enum OpStage : int { kStagePixel, kStagePrepare, kStageSample, kOpStages };
constexpr int kOpSlots = kOpKinds * kOpStages;

#if VR_COUNT_OPS

#ifndef VR_THREADS
#error "the counting build needs VR_THREADS (the block size)"
#endif
// One row of counters per thread of the block, and each thread's stage.
__shared__ unsigned vr_op_counter[VR_THREADS * kOpSlots];
__shared__ int vr_op_stage[VR_THREADS];

K_INLINE void count_op(int kind) {
  ++vr_op_counter[threadIdx.x * kOpSlots + vr_op_stage[threadIdx.x] * kOpKinds +
                  kind];
}

struct f32 {
  float v;
  f32() = default;
  __host__ __device__ constexpr f32(float x) : v(x) {}
};

K_INLINE float raw(f32 x) { return x.v; }

K_INLINE f32 operator-(f32 a) { return f32(-a.v); }
K_INLINE f32 operator+(f32 a, f32 b) { count_op(kOpAdd); return a.v + b.v; }
K_INLINE f32 operator-(f32 a, f32 b) { count_op(kOpAdd); return a.v - b.v; }
K_INLINE f32 operator*(f32 a, f32 b) { count_op(kOpMul); return a.v * b.v; }
K_INLINE f32 operator/(f32 a, f32 b) { count_op(kOpDiv); return a.v / b.v; }
K_INLINE bool operator<(f32 a, f32 b) { count_op(kOpCmp); return a.v < b.v; }
K_INLINE bool operator>(f32 a, f32 b) { count_op(kOpCmp); return a.v > b.v; }
K_INLINE bool operator<=(f32 a, f32 b) { count_op(kOpCmp); return a.v <= b.v; }
K_INLINE bool operator>=(f32 a, f32 b) { count_op(kOpCmp); return a.v >= b.v; }
K_INLINE bool operator==(f32 a, f32 b) { count_op(kOpCmp); return a.v == b.v; }
K_INLINE bool operator!=(f32 a, f32 b) { count_op(kOpCmp); return a.v != b.v; }

K_INLINE f32 fabsf(f32 x) { return ::fabsf(x.v); }
K_INLINE f32 sqrtf(f32 x) { count_op(kOpSqrt); return ::sqrtf(x.v); }
K_INLINE f32 rsqrtf(f32 x) { count_op(kOpSqrt); return ::rsqrtf(x.v); }
K_INLINE f32 sinf(f32 x) { count_op(kOpTrans); return ::sinf(x.v); }
K_INLINE f32 cosf(f32 x) { count_op(kOpTrans); return ::cosf(x.v); }
K_INLINE f32 expf(f32 x) { count_op(kOpTrans); return ::expf(x.v); }
K_INLINE f32 logf(f32 x) { count_op(kOpTrans); return ::logf(x.v); }
K_INLINE f32 fma_rn(f32 a, f32 b, f32 c) {
  count_op(kOpFma);
  return __fmaf_rn(a.v, b.v, c.v);
}
K_INLINE f32 jmin(f32 a, f32 b) { count_op(kOpCmp); return jmin(a.v, b.v); }
K_INLINE f32 jmax(f32 a, f32 b) { count_op(kOpCmp); return jmax(a.v, b.v); }
K_INLINE f32 jclip(f32 x, f32 lo, f32 hi) { return jmin(jmax(x, lo), hi); }

K_INLINE void set_op_stage(int stage) { vr_op_stage[threadIdx.x] = stage; }

K_INLINE void begin_op_count() {
  for (int k = 0; k < kOpSlots; ++k)
    vr_op_counter[threadIdx.x * kOpSlots + k] = 0;
  set_op_stage(kStagePixel);
}

K_INLINE void flush_op_count(unsigned long long* __restrict__ out) {
  if (out == nullptr) return;
  for (int k = 0; k < kOpSlots; ++k) {
    const unsigned n = vr_op_counter[threadIdx.x * kOpSlots + k];
    if (n != 0) atomicAdd(out + k, (unsigned long long)n);
  }
}

#else

using f32 = float;
K_INLINE float raw(float x) { return x; }
K_INLINE float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
K_INLINE void set_op_stage(int) {}
K_INLINE void begin_op_count() {}
K_INLINE void flush_op_count(unsigned long long*) {}

#endif

}  // namespace vrt
