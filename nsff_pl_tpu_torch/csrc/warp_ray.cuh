// Warp-per-ray building blocks shared by the port's compositor kernels
// (planar_compositor.cu, fused_compositing.cu). In planar_compositor.cu one
// warp holds a chunk of a ray's samples, QQ consecutive samples per lane
// (32 QQ samples a chunk; the lane's samples past the ray's last are
// masked), and scans along the chunk run as warp shuffles, with carries
// from chunk to chunk. The row type RowT<QQ> carries QQ.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace warp_ray {

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

// The widest access (4, 2 or 1 floats) that every lane's QQ samples allow:
// a row of S samples keeps 16-byte (8-byte) alignment when S and QQ are
// multiples of 4 (2) and every plane starts so aligned (`align` is the OR
// of the planes' addresses).
inline int access_width(int S, int QQ, uintptr_t align) {
  if (S % 4 == 0 && QQ % 4 == 0 && align % 16 == 0) return 4;
  if (S % 2 == 0 && QQ % 2 == 0 && align % 8 == 0) return 2;
  return 1;
}

// a lane's QQ samples from base, the first nv of them real (0..QQ; the
// rest read as 0), by accesses of VW floats (access_width: nv is then a
// multiple of VW); RO: through the read-only data path (a plane the
// kernel only reads and that is never null)
template <int QQ, int VW, bool RO = false>
__device__ __forceinline__ RowT<QQ> load_q(const float* p, size_t base, int nv) {
  static_assert(QQ % VW == 0, "whole accesses a lane");
  RowT<QQ> r;
#pragma unroll
  for (int q = 0; q < QQ; ++q) r.v[q] = 0.f;
  if (!RO && p == nullptr) return r;
  if constexpr (VW == 4) {
#pragma unroll
    for (int q = 0; q < QQ; q += 4) {
      if (q >= nv) break;
      const float4* a = reinterpret_cast<const float4*>(p + base + q);
      const float4 x = RO ? __ldg(a) : *a;
      r.v[q] = x.x; r.v[q + 1] = x.y; r.v[q + 2] = x.z; r.v[q + 3] = x.w;
    }
  } else if constexpr (VW == 2) {
#pragma unroll
    for (int q = 0; q < QQ; q += 2) {
      if (q >= nv) break;
      const float2* a = reinterpret_cast<const float2*>(p + base + q);
      const float2 x = RO ? __ldg(a) : *a;
      r.v[q] = x.x; r.v[q + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < QQ; ++q)
      if (q < nv) r.v[q] = RO ? __ldg(p + base + q) : p[base + q];
  }
  return r;
}

// the first nv of a lane's QQ samples to base, as load_q reads them
template <int QQ, int VW>
__device__ __forceinline__ void store(float* p, size_t base, const RowT<QQ>& r, int nv) {
  if constexpr (VW == 4) {
#pragma unroll
    for (int q = 0; q < QQ; q += 4)
      if (q < nv)
        *reinterpret_cast<float4*>(p + base + q) =
            make_float4(r.v[q], r.v[q + 1], r.v[q + 2], r.v[q + 3]);
  } else if constexpr (VW == 2) {
#pragma unroll
    for (int q = 0; q < QQ; q += 2)
      if (q < nv) *reinterpret_cast<float2*>(p + base + q) = make_float2(r.v[q], r.v[q + 1]);
  } else {
#pragma unroll
    for (int q = 0; q < QQ; ++q)
      if (q < nv) p[base + q] = r.v[q];
  }
}

// exclusive prefix sum along the chunk (lane l holds samples QQ l..QQ l+QQ-1)
// plus `carry`, the sum of the ray's earlier chunks; adds the chunk's total
// to `carry`
template <int QQ>
__device__ __forceinline__ RowT<QQ> excl_cumsum(const RowT<QQ>& x, int lane, float& carry) {
  float loc = 0.f;
#pragma unroll
  for (int q = 0; q < QQ; ++q) loc += x.v[q];
  float inc = loc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  // the lanes before this one, by a shift and not inc - loc: a far
  // sample's optical depth (delta 100) would cancel in the difference
  float c = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) c = 0.f;
  c += carry;
  RowT<QQ> r;
#pragma unroll
  for (int q = 0; q < QQ; ++q) { r.v[q] = c; c += x.v[q]; }
  carry += __shfl_sync(0xffffffffu, inc, 31);
  return r;
}

// out[j] = sum_{i > j} x[i] along the chunk plus `carry`, the sum of the
// ray's later chunks; adds the chunk's total to `carry`
template <int QQ>
__device__ __forceinline__ RowT<QQ> rev_excl_cumsum(const RowT<QQ>& x, int lane,
                                                    float& carry) {
  float loc = 0.f;
#pragma unroll
  for (int q = 0; q < QQ; ++q) loc += x.v[q];
  float inc = loc;  // sum over lanes >= lane
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_down_sync(0xffffffffu, inc, off);
    if (lane + off < 32) inc += y;
  }
  // the lanes after this one, by a shift (not inc - loc), and the later
  // chunks
  float c = __shfl_down_sync(0xffffffffu, inc, 1);
  if (lane == 31) c = 0.f;
  c += carry;
  RowT<QQ> r;
#pragma unroll
  for (int q = QQ - 1; q >= 0; --q) { r.v[q] = c; c += x.v[q]; }
  carry += __shfl_sync(0xffffffffu, inc, 0);
  return r;
}

}  // namespace warp_ray
