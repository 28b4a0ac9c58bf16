// Per-ray set-up shared by the port's trainable tower kernels
// (planar_nerf_train.cu, fused_nerf_eval.cu, fused_nerf_train.cu): the
// argument block, the shared-memory carve-up of one CTA and the posenc
// tile of one ray. A ray's sample points come either from its origin,
// direction and depths (planar layout, xyz = o + d*z [+ flow] formed here)
// or from a given (n_rays, S, 3) array (packed layout).
#pragma once

#include "planar_tower.cuh"

namespace planar {

constexpr int NHEAD = 10;     // packed transient heads [sigma, rgb, fw, bw]

struct Common {
  const float* o; const float* d; const float* zs;  // planar layout
  const float* xyz;  // packed layout: (n_rays, S, 3) points, else null
  const float* dir; const float* a; const float* t;
  const float* flows[3];
  const bf16* W[NSLOT]; const float* B[NSLOT];
  int n_rays, xyz_w, dir_w, n_a, n_tau;
  int use_viewdir, encode_a;
  float flow_scale;
  float freqs[MAXF];
};

// shared-memory layout of both per-ray kernels
constexpr size_t SM_X = size_t(S) * LDX * sizeof(bf16);
constexpr size_t SM_H = size_t(S) * LDH * sizeof(bf16);
constexpr size_t SM_STAGE = size_t(NWARPS) * 256 * sizeof(float);
constexpr int NPLS = 20;  // per-sample f32 planes kept in shared memory
constexpr size_t SM_BYTES = SM_X + 2 * SM_H + SM_STAGE + WID * sizeof(float)
    + size_t(NPLS + 1 + 3) * S * sizeof(float) + 8 * sizeof(float);

struct Smem {
  bf16* xin; bf16* h0; bf16* h1; float* stage; float* ray_b;
  float* pl;   // NPLS planes of S floats
  float* zsh; float* fl; float* od;
};

__device__ __forceinline__ Smem carve(unsigned char* smem) {
  Smem m;
  m.xin = reinterpret_cast<bf16*>(smem);
  m.h0 = reinterpret_cast<bf16*>(smem + SM_X);
  m.h1 = reinterpret_cast<bf16*>(smem + SM_X + SM_H);
  m.stage = reinterpret_cast<float*>(smem + SM_X + 2 * SM_H);
  m.ray_b = m.stage + NWARPS * 256;
  m.pl = m.ray_b + WID;
  m.zsh = m.pl + NPLS * S;
  m.fl = m.zsh + S;
  m.od = m.fl + 3 * S;
  return m;
}

// posenc pre-activation of lane j < xyz_w of the ray's sample s, from the
// ray's data in shared memory (see ray_setup)
__device__ __forceinline__ float lane_xs(const Common& A, const Smem& m,
                                         bool with_flow, int s, int j,
                                         bool& id, float& ph) {
  if (A.xyz != nullptr) return posenc_xs_pt(A.freqs, m.fl + 3 * s, j, id, ph);
  return posenc_xs(A.freqs, m.od, with_flow ? m.fl + 3 * s : nullptr, m.zsh[s],
                   j, id, ph);
}

// The ray's data into shared memory (planar layout: zs, flows, o/d; packed
// layout: its S points, in m.fl); the posenc tile (+ the time latent in
// lanes [xyz_w, xyz_w + n_tau) when with_t); the per-ray bias of the
// static_dir layer when with_dir. Ends with a barrier.
__device__ void ray_setup(const Common& A, const Smem& m, int ray,
                          bool with_t, bool with_dir, bool with_flow) {
  const int tid = threadIdx.x;
  if (A.xyz != nullptr) {
    for (int e = tid; e < 3 * S; e += NTHREADS)
      m.fl[e] = A.xyz[size_t(ray) * S * 3 + e];
  } else {
    if (tid < 6) m.od[tid] = tid < 3 ? A.o[ray * 3 + tid] : A.d[ray * 3 + tid - 3];
    for (int s = tid; s < S; s += NTHREADS) {
      m.zsh[s] = A.zs[size_t(ray) * S + s];
      if (with_flow)
        for (int c = 0; c < 3; ++c) m.fl[s * 3 + c] = A.flows[c][size_t(ray) * S + s];
    }
  }
  __syncthreads();
  for (int e = tid; e < S * SEG; e += NTHREADS) {
    const int s = e / SEG, j = e % SEG;
    float v = 0.f;
    if (j < A.xyz_w) {
      bool id;
      float ph;
      const float xs = lane_xs(A, m, with_flow, s, j, id, ph);
      v = id ? xs : sin_poly(__fadd_rn(xs, ph));
    } else if (with_t && j < A.xyz_w + A.n_tau) {
      v = A.t[size_t(ray) * A.n_tau + (j - A.xyz_w)];
    }
    m.xin[s * LDX + j] = __float2bfloat16_rn(v);
  }
  if (with_dir)
    static_dir_bias(A.W[W_SDIR], A.B[W_SDIR], A.dir + size_t(ray) * A.dir_w,
                    A.dir_w, A.encode_a ? A.a + size_t(ray) * A.n_a : nullptr,
                    A.n_a, m.ray_b);
  __syncthreads();
}

template <typename K>
inline cudaError_t big_smem(K kern) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(SM_BYTES));
}

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
  A.flow_scale = flow_scale;
  for (int i = 0; i < MAXF; ++i) A.freqs[i] = i < n_freqs ? freqs[i] : 0.f;
}

}  // namespace planar
