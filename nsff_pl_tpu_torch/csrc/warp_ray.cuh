// Warp-per-ray building blocks shared by the port's compositor kernels
// (planar_compositor.cu, fused_compositing.cu): one warp holds a ray's
// samples, Q consecutive samples per lane (S = 128: four, 16-byte loads
// and stores of (N, S) planes; planar_compositor.cu also takes Q = 2, 6
// and 8 for 64, 192 and 256 samples), and scans along the ray run as warp
// shuffles. The row type RowT<Q> carries Q; Row is the 128-sample one.
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

template <int QQ>
struct RowT { float v[QQ]; };
using Row = RowT<Q>;

// a lane's QQ samples from base (QQ even: 16-byte accesses when QQ % 4 ==
// 0, else 8-byte ones); RO: through the read-only data path (a plane the
// kernel only reads and that is never null)
template <int QQ, bool RO = false>
__device__ __forceinline__ RowT<QQ> load_q(const float* p, size_t base) {
  RowT<QQ> r;
  if (!RO && p == nullptr) {
#pragma unroll
    for (int q = 0; q < QQ; ++q) r.v[q] = 0.f;
    return r;
  }
  if constexpr (QQ % 4 == 0) {
#pragma unroll
    for (int q = 0; q < QQ; q += 4) {
      const float4* a = reinterpret_cast<const float4*>(p + base + q);
      const float4 x = RO ? __ldg(a) : *a;
      r.v[q] = x.x; r.v[q + 1] = x.y; r.v[q + 2] = x.z; r.v[q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < QQ; q += 2) {
      const float2* a = reinterpret_cast<const float2*>(p + base + q);
      const float2 x = RO ? __ldg(a) : *a;
      r.v[q] = x.x; r.v[q + 1] = x.y;
    }
  }
  return r;
}

__device__ __forceinline__ Row load(const float* p, size_t base) { return load_q<Q>(p, base); }

__device__ __forceinline__ Row load_ro(const float* p, size_t base) {
  return load_q<Q, true>(p, base);
}

template <int QQ>
__device__ __forceinline__ void store(float* p, size_t base, const RowT<QQ>& r) {
  if constexpr (QQ % 4 == 0) {
#pragma unroll
    for (int q = 0; q < QQ; q += 4)
      *reinterpret_cast<float4*>(p + base + q) =
          make_float4(r.v[q], r.v[q + 1], r.v[q + 2], r.v[q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < QQ; q += 2)
      *reinterpret_cast<float2*>(p + base + q) = make_float2(r.v[q], r.v[q + 1]);
  }
}

// exclusive prefix sum along the ray (lane l holds samples QQ l..QQ l+QQ-1)
template <int QQ>
__device__ __forceinline__ RowT<QQ> excl_cumsum(const RowT<QQ>& x, int lane) {
  float loc = 0.f;
#pragma unroll
  for (int q = 0; q < QQ; ++q) loc += x.v[q];
  float inc = loc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  RowT<QQ> r;
  float c = inc - loc;
#pragma unroll
  for (int q = 0; q < QQ; ++q) { r.v[q] = c; c += x.v[q]; }
  return r;
}

// out[j] = sum_{i > j} x[i] along the ray
template <int QQ>
__device__ __forceinline__ RowT<QQ> rev_excl_cumsum(const RowT<QQ>& x, int lane) {
  float loc = 0.f;
#pragma unroll
  for (int q = 0; q < QQ; ++q) loc += x.v[q];
  float inc = loc;  // sum over lanes >= lane
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_down_sync(0xffffffffu, inc, off);
    if (lane + off < 32) inc += y;
  }
  RowT<QQ> r;
  float c = inc - loc;  // sum over lanes > lane
#pragma unroll
  for (int q = QQ - 1; q >= 0; --q) { r.v[q] = c; c += x.v[q]; }
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
template <int QQ>
__device__ __forceinline__ void deltas(const RowT<QQ>& z, int lane, RowT<QQ>& ds,
                                       RowT<QQ>& dt) {
  const float z_next = __shfl_down_sync(0xffffffffu, z.v[0], 1);
#pragma unroll
  for (int q = 0; q < QQ; ++q) {
    const float nxt = q < QQ - 1 ? z.v[q + 1] : z_next;
    const bool far = lane == 31 && q == QQ - 1;
    const float dz = nxt - z.v[q];
    ds.v[q] = far ? STATIC_FAR_DELTA : dz;
    dt.v[q] = far ? TRANSIENT_FAR_DELTA : dz;
  }
}

}  // namespace warp_ray
