// Warp-per-ray building blocks shared by the port's compositor kernels
// (planar_compositor.cu, fused_compositing.cu): one warp holds a ray's
// S = 128 samples, four consecutive samples per lane (16-byte loads and
// stores of (N, S) planes), and scans along the ray run as warp shuffles.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace warp_ray {

constexpr int S = 128;
constexpr int Q = S / 32;  // samples per lane
constexpr float STATIC_FAR_DELTA = 100.f, TRANSIENT_FAR_DELTA = 1e-3f;

__device__ __forceinline__ float softplus(float x) {
  return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.f);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Row { float v[Q]; };

__device__ __forceinline__ Row load(const float* p, size_t base) {
  Row r;
  if (p == nullptr) {
#pragma unroll
    for (int q = 0; q < Q; ++q) r.v[q] = 0.f;
    return r;
  }
  const float4 x = *reinterpret_cast<const float4*>(p + base);
  r.v[0] = x.x; r.v[1] = x.y; r.v[2] = x.z; r.v[3] = x.w;
  return r;
}

// load of a plane the kernel only reads and that is never null, through
// the read-only data path
__device__ __forceinline__ Row load_ro(const float* p, size_t base) {
  Row r;
  const float4 x = __ldg(reinterpret_cast<const float4*>(p + base));
  r.v[0] = x.x; r.v[1] = x.y; r.v[2] = x.z; r.v[3] = x.w;
  return r;
}

__device__ __forceinline__ void store(float* p, size_t base, const Row& r) {
  *reinterpret_cast<float4*>(p + base) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
}

// exclusive prefix sum along the ray (lane l holds samples 4l..4l+3)
__device__ __forceinline__ Row excl_cumsum(const Row& x, int lane) {
  float loc = 0.f;
#pragma unroll
  for (int q = 0; q < Q; ++q) loc += x.v[q];
  float inc = loc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  Row r;
  float c = inc - loc;
#pragma unroll
  for (int q = 0; q < Q; ++q) { r.v[q] = c; c += x.v[q]; }
  return r;
}

// out[j] = sum_{i > j} x[i] along the ray
__device__ __forceinline__ Row rev_excl_cumsum(const Row& x, int lane) {
  float loc = 0.f;
#pragma unroll
  for (int q = 0; q < Q; ++q) loc += x.v[q];
  float inc = loc;  // sum over lanes >= lane
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_down_sync(0xffffffffu, inc, off);
    if (lane + off < 32) inc += y;
  }
  Row r;
  float c = inc - loc;  // sum over lanes > lane
#pragma unroll
  for (int q = Q - 1; q >= 0; --q) { r.v[q] = c; c += x.v[q]; }
  return r;
}

// exclusive prefix product along the ray: out[j] = prod_{i < j} x[i]
__device__ __forceinline__ Row excl_cumprod(const Row& x, int lane) {
  float loc = 1.f;
#pragma unroll
  for (int q = 0; q < Q; ++q) loc *= x.v[q];
  float inc = loc;  // product over lanes <= lane
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc *= y;
  }
  float c = __shfl_up_sync(0xffffffffu, inc, 1);  // product over lanes < lane
  if (lane == 0) c = 1.f;
  Row r;
#pragma unroll
  for (int q = 0; q < Q; ++q) { r.v[q] = c; c *= x.v[q]; }
  return r;
}

// the static and transient sample spacings of the lane's samples: the
// difference to the next depth, and the far deltas at the last sample
__device__ __forceinline__ void deltas(const Row& z, int lane, Row& ds, Row& dt) {
  const float z_next = __shfl_down_sync(0xffffffffu, z.v[0], 1);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const float nxt = q < Q - 1 ? z.v[q + 1] : z_next;
    const bool far = lane == 31 && q == Q - 1;
    const float dz = nxt - z.v[q];
    ds.v[q] = far ? STATIC_FAR_DELTA : dz;
    dt.v[q] = far ? TRANSIENT_FAR_DELTA : dz;
  }
}

}  // namespace warp_ray
