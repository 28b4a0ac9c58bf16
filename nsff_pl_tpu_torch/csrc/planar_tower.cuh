// Scalar building blocks and the argument block shared by the port's tower
// kernels (planar_eval_comp.cu, planar_nerf_train.cu, fused_nerf_eval.cu,
// fused_nerf_train.cu, and tower_wgmma.cuh / tower_bwd_wgmma.cuh under
// them): the ray-tile geometry, the weight slots, the range-reduced posenc
// sine, the posenc pre-activation of one lane, and `Common`, the per-call
// arguments of the trainable evaluators. A ray's sample points come either
// from its origin, direction and depths (planar layout, xyz = o + d*z
// [+ flow] formed in the kernel) or from a given (n_rays, S, 3) array
// (packed layout).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace planar {

typedef __nv_bfloat16 bf16;

constexpr int S = 128;        // rows of a tile: the M rows of every matmul
constexpr int SEG = 128;      // padded posenc segment
constexpr int WID = 256;      // tower width
constexpr int DEPTH = 8;
constexpr int SKIP = 4;
// posenc frequencies a one-segment kernel (B1, B2, B4) takes, at most:
// ops/raymarch_kernel.py's MAX_FREQS (as many as fit one input segment),
// which ops/cuda_build.py passes to nvcc, so one constant bounds both
// sides; the packed evaluator (fused_nerf_eval.cu) reads any count from a
// device table instead
#ifndef NSFF_MAX_FREQS
#error "build with -DNSFF_MAX_FREQS=<ops/raymarch_kernel.py MAX_FREQS> (ops/cuda_build.py does)"
#endif
constexpr int MAXF = NSFF_MAX_FREQS;
constexpr int NSLOT = 22;
constexpr int NHEAD = 10;     // packed transient heads [sigma, rgb, fw, bw]

// weight slots (_SLOTS in ops/raymarch_kernel.py)
enum {
  W_S0 = 0, W_SFIN = 8, W_SDIR = 9, W_SSIG = 10, W_SRGB = 11,
  W_T0 = 12, W_TFIN = 20, W_THEAD = 21
};

__device__ __forceinline__ float sin_poly(float x) {
  // range reduction to [-pi, pi], then the degree-9 odd polynomial of
  // ops/raymarch_kernel.py::_sin_poly (hardware __sinf is wrong at |x|~1e3),
  // every product and sum rounded on its own as the plain version rounds
  // them: a multiply-add contracted by the compiler moves the result by an
  // ulp, which now and then turns the bf16 rounding of a posenc lane
  const float n = rintf(__fmul_rn(x, 0.15915494309189535f));
  const float r = __fsub_rn(x, __fmul_rn(n, 6.283185307179586f));
  const float u = __fmul_rn(r, r);
  float p = __fadd_rn(-0.000192651216281f, __fmul_rn(u, 2.14793467522e-06f));
  p = __fadd_rn(0.00830899340721f, __fmul_rn(u, p));
  p = __fadd_rn(-0.166624406237f, __fmul_rn(u, p));
  p = __fadd_rn(0.999979402976f, __fmul_rn(u, p));
  return __fmul_rn(r, p);
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

// tiles of S rows that hold n_samples samples
__host__ __device__ __forceinline__ int tiles_of(int n_samples) {
  return (n_samples + S - 1) / S;
}

struct Common {
  const float* o; const float* d; const float* zs;  // planar layout
  const float* xyz;  // packed layout: (n_rays, S, 3) points, else null
  const float* dir; const float* a; const float* t;
  const float* flows[3];
  const bf16* W[NSLOT]; const float* B[NSLOT];
  int n_rays, xyz_w, dir_w, n_a, n_tau;
  // samples per ray (any count >= 1), and the ray's tiles of S rows:
  // ceil(n_samples / S), the last one holding 1..S real samples
  int n_samples, n_tiles;
  int use_viewdir, encode_a;
  float flow_scale;
  float freqs[MAXF];
};

// `flows` may be null (no flow planes); `xyz` non-null selects the packed
// layout, where o, d, zs and flows are not read
inline void fill_common(Common& A, const void* o, const void* d, const void* zs,
                 const void* xyz, const void* dir, const void* a, const void* t,
                 const void* const* flows, const void* const* w,
                 const void* const* b, int n_rays, int xyz_w, int dir_w,
                 int n_a, const float* freqs, int n_freqs, int use_viewdir,
                 int encode_a, float flow_scale, int n_tau) {
  A.o = static_cast<const float*>(o);
  A.d = static_cast<const float*>(d);
  A.zs = static_cast<const float*>(zs);
  A.xyz = static_cast<const float*>(xyz);
  A.dir = static_cast<const float*>(dir);
  A.a = static_cast<const float*>(a);
  A.t = static_cast<const float*>(t);
  for (int c = 0; c < 3; ++c)
    A.flows[c] = flows != nullptr ? static_cast<const float*>(flows[c]) : nullptr;
  for (int i = 0; i < NSLOT; ++i) {
    A.W[i] = static_cast<const bf16*>(w[i]);
    A.B[i] = static_cast<const float*>(b[i]);
  }
  A.n_rays = n_rays; A.xyz_w = xyz_w; A.dir_w = dir_w; A.n_a = n_a;
  A.n_tau = n_tau; A.use_viewdir = use_viewdir; A.encode_a = encode_a;
  A.n_samples = S; A.n_tiles = 1;
  A.flow_scale = flow_scale;
  for (int i = 0; i < MAXF; ++i) A.freqs[i] = i < n_freqs ? freqs[i] : 0.f;
}

}  // namespace planar
