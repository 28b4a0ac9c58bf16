// Device building blocks shared by the port's tower kernels
// (planar_eval_comp.cu, planar_nerf_train.cu): the ray-tile geometry, the
// range-reduced posenc sine, nvcuda::wmma products of a ray's (S, K) bf16
// tile in shared memory with weights streamed from global memory (L2),
// their epilogues, the narrow heads and the 8-layer ReLU tower with its
// skip layer. One CTA of NWARPS warps works on one ray; the ray's S
// samples are the M dimension of every product.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace planar {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int S = 128;        // samples per ray (rows of every matmul)
constexpr int SEG = 128;      // padded posenc segment
constexpr int WID = 256;      // tower width
constexpr int DEPTH = 8;
constexpr int SKIP = 4;
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDX = SEG + 8;  // bf16 row pitch of the posenc tile
constexpr int LDH = WID + 8;  // bf16 row pitch of the activation tiles
constexpr int MAXF = 16;
constexpr int NSLOT = 22;
constexpr int MT = S / 16;    // 16-row tiles per ray

// weight slots (_SLOTS in ops/raymarch_kernel.py)
enum {
  W_S0 = 0, W_SFIN = 8, W_SDIR = 9, W_SSIG = 10, W_SRGB = 11,
  W_T0 = 12, W_TFIN = 20, W_THEAD = 21
};

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

__device__ __forceinline__ float sin_poly(float x) {
  // range reduction to [-pi, pi], then the degree-9 odd polynomial of
  // ops/raymarch_kernel.py::_sin_poly (hardware __sinf is wrong at |x|~1e3)
  float n = rintf(__fmul_rn(x, 0.15915494309189535f));
  float r = __fsub_rn(x, __fmul_rn(n, 6.283185307179586f));
  float u = r * r;
  return r * (0.999979402976f + u * (-0.166624406237f + u * (
      0.00830899340721f + u * (-0.000192651216281f + u * 2.14793467522e-06f))));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float bfr(float x) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float softplus(float x) {
  return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.f);
}

// posenc pre-activation of lane j (< xyz_w) at depth z:
// o_c f + (d_c f) z [+ flow_c f], without fused multiply-adds (as the
// plain version); od = (o0, o1, o2, d0, d1, d2), fl = the sample's flow
// (3 floats) or null. Returns the identity flag and the phase.
__device__ __forceinline__ float posenc_xs(const float* freqs,
                                           const float* od, const float* fl,
                                           float z, int j, bool& id,
                                           float& ph) {
  int c;
  float f;
  ph = 0.f;
  id = j < 3;
  if (id) {
    c = j; f = 1.f;
  } else {
    const int k = (j - 3) / 6, r = (j - 3) % 6;
    c = r % 3; f = freqs[k];
    if (r >= 3) ph = 1.5707963267948966f;
  }
  float xs = __fadd_rn(__fmul_rn(od[c], f), __fmul_rn(__fmul_rn(od[3 + c], f), z));
  if (fl != nullptr) xs = __fadd_rn(xs, __fmul_rn(fl[c], f));
  return xs;
}

// the same for a given point x (3 floats): x_c f
__device__ __forceinline__ float posenc_xs_pt(const float* freqs,
                                              const float* x, int j, bool& id,
                                              float& ph) {
  ph = 0.f;
  id = j < 3;
  if (id) return x[j];
  const int k = (j - 3) / 6, r = (j - 3) % 6;
  if (r >= 3) ph = 1.5707963267948966f;
  return __fmul_rn(x[r % 3], freqs[k]);
}

// the encoding value of lane j < xyz_w
__device__ __forceinline__ float posenc_val(const float* freqs,
                                            const float* od, const float* fl,
                                            float z, int j) {
  bool id;
  float ph;
  const float xs = posenc_xs(freqs, od, fl, z, j, id, ph);
  return id ? xs : sin_poly(__fadd_rn(xs, ph));
}

// the per-ray part of the static_dir layer: bf16(dir) @ Wd[WID:WID+dir_w]
// + b [+ bf16(a) @ Wd[WID+SEG:WID+SEG+n_a]], thread per output column
__device__ void static_dir_bias(const bf16* Wd, const float* bd,
                                const float* dir, int dir_w, const float* a,
                                int n_a, float* ray_b) {
  for (int n = threadIdx.x; n < WID; n += NTHREADS) {
    float z = 0.f;
    for (int k = 0; k < dir_w; ++k)
      z += bfr(dir[k]) * __bfloat162float(Wd[(WID + k) * WID + n]);
    z += bd[n];
    if (a != nullptr) {
      float za = 0.f;
      for (int k = 0; k < n_a; ++k)
        za += bfr(a[k]) * __bfloat162float(Wd[(WID + SEG + k) * WID + n]);
      z += za;
    }
    ray_b[n] = z;
  }
}

template <int NP>
__device__ __forceinline__ void zero_acc(Acc (&acc)[NP][MT]) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int m = 0; m < MT; ++m) wmma::fill_fragment(acc[p][m], 0.f);
}

// acc[p][m] += A[m-th 16 rows, 0:K] @ B[0:K, n0 + 16p : +16]. A is a bf16
// tile in shared memory (pitch lda). B is row-major in global memory with
// pitch ldb (B(k, n) = B[k*ldb + n]).
template <int NP>
__device__ __forceinline__ void mma_seg(Acc (&acc)[NP][MT], const bf16* A,
                                        int lda, int K,
                                        const bf16* __restrict__ B, int ldb,
                                        int n0) {
#pragma unroll 1
  for (int k = 0; k < K; k += 16) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p)
      wmma::load_matrix_sync(b[p], B + size_t(k) * ldb + n0 + 16 * p, ldb);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afr;
      wmma::load_matrix_sync(afr, A + m * 16 * lda + k, lda);
#pragma unroll
      for (int p = 0; p < NP; ++p) wmma::mma_sync(acc[p][m], afr, b[p], acc[p][m]);
    }
  }
}

// forward epilogue: bf16(relu?(acc + bias)) -> out_s (pitch LDH) and, when
// given, out_g (this ray's rows, pitch WID)
template <int NP>
__device__ __forceinline__ void epi_fwd(Acc (&acc)[NP][MT], int n0,
                                        const float* bias, bool relu,
                                        bf16* out_s, bf16* out_g, float* stage) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* st = stage + warp * 256;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      wmma::store_matrix_sync(st, acc[p][m], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = m * 16 + (e >> 4), col = n0 + p * 16 + (e & 15);
        float v = st[e] + bias[col];
        if (relu) v = fmaxf(v, 0.f);
        const bf16 h = __float2bfloat16_rn(v);
        out_s[row * LDH + col] = h;
        if (out_g != nullptr) out_g[row * WID + col] = h;
      }
      __syncwarp();
    }
  }
}

// NOUT-wide head on the (S, WID) bf16 feature tile: res[c][r] =
// sum_k h[r][k] W[k][c] + b[c]. Warp per row, lanes split k.
template <int NOUT>
__device__ void head(const bf16* h, const bf16* __restrict__ W,
                     const float* __restrict__ b, float* res0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < S; r += NWARPS) {
    float acc[NOUT];
#pragma unroll
    for (int c = 0; c < NOUT; ++c) acc[c] = 0.f;
#pragma unroll
    for (int j = 0; j < WID / 32; ++j) {
      const int k = lane * (WID / 32) + j;
      const float hv = __bfloat162float(h[r * LDH + k]);
#pragma unroll
      for (int c = 0; c < NOUT; ++c)
        acc[c] += hv * __bfloat162float(W[k * NOUT + c]);
    }
#pragma unroll
    for (int c = 0; c < NOUT; ++c) {
      const float v = warp_sum(acc[c]);
      if (lane == 0) res0[c * S + r] = v + b[c];
    }
  }
}

// linear layer (S, WID) -> (S, WID) on shared tiles: out = bf16(act(in @ W + bias))
__device__ __forceinline__ void dense_fwd(const bf16* in, const bf16* W,
                                          const float* bias, bool relu,
                                          bf16* out_s, bf16* out_g,
                                          float* stage) {
  const int n0 = (threadIdx.x >> 5) * 32;
  Acc acc[2][MT];
  zero_acc<2>(acc);
  mma_seg<2>(acc, in, LDH, WID, W, WID, n0);
  epi_fwd<2>(acc, n0, bias, relu, out_s, out_g, stage);
}

// the 8-layer ReLU tower (weights W[w0..w0+7]) on the input tile xin;
// returns the buffer holding the last activation. With act_g, layer i's
// output also goes to act_g + i * layer_stride (this ray's rows).
__device__ bf16* tower_fwd(const bf16* const* W, const float* const* B,
                           int w0, const bf16* xin, bf16* h0, bf16* h1,
                           float* stage, bf16* act_g, size_t layer_stride) {
  const int n0 = (threadIdx.x >> 5) * 32;
  bf16* src = h0;
  bf16* dst = h0;
  for (int i = 0; i < DEPTH; ++i) {
    dst = (i % 2 == 0) ? h0 : h1;
    Acc acc[2][MT];
    zero_acc<2>(acc);
    const bf16* Wi = W[w0 + i];
    if (i == 0) {
      mma_seg<2>(acc, xin, LDX, SEG, Wi, WID, n0);
    } else if (i == SKIP) {
      mma_seg<2>(acc, xin, LDX, SEG, Wi, WID, n0);
      mma_seg<2>(acc, src, LDH, WID, Wi + SEG * WID, WID, n0);
    } else {
      mma_seg<2>(acc, src, LDH, WID, Wi, WID, n0);
    }
    epi_fwd<2>(acc, n0, B[w0 + i], true, dst,
               act_g != nullptr ? act_g + i * layer_stride : nullptr, stage);
    __syncthreads();
    src = dst;
  }
  return dst;
}

}  // namespace planar
