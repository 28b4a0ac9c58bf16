// Trainable planar NSFF evaluator for Hopper (sm_90a): forward and backward.
//
// Replaces nsff_pl_tpu/ops/raymarch_kernel.py::make_planar_nerf_train, whose
// Pallas TPU kernels are a forward (posenc of o + d*z [+ flow] -> static and
// transient 8x256 towers -> heads -> dense (N, S) planes) and one backward
// per branch (tower recompute, dW/db over the whole grid, per-ray embedding
// gradients, flow-plane cotangents). The plain versions are
// planar_nerf_train_ref / planar_nerf_train_bwd_ref in
// ops/raymarch_kernel.py; the rounding points are the same: bf16 matmul
// inputs, f32 accumulation, activations rounded to bf16 after each ReLU,
// every cotangent dz rounded to bf16 before its products, biases and
// bias gradients in f32.
//
// Bound: operations. The forward is PR 1's evaluator design (one CTA of 8
// warps per ray, the ray's 128 samples are the M dimension, nvcuda::wmma
// bf16 with weights streamed from L2, planar_tower.cuh) writing planes. The
// backward (a wgmma + TMA chain kernel, a wgmma split-K dW GEMM, fixed-order
// reductions) is csrc/tower_bwd_wgmma.cuh, shared with fused_nerf_train.cu.
//
// Plain C interface (loaded with ctypes); launches on the given stream and
// returns the cudaError_t of the launches.

#include "tower_bwd_wgmma.cuh"

using namespace planar;

namespace {

// output / cotangent plane slots (_TRAIN_PLANES in ops/raymarch_kernel.py)
enum {
  P_SR = 0, P_SG, P_SB, P_SSIG, P_TR, P_TG, P_TB, P_TSIG,
  P_FW0, P_FW1, P_FW2, P_BW0, P_BW1, P_BW2, NPL
};

// ------------------------------- forward -------------------------------

struct FwdArgs {
  Common c;
  float* out[NPL];
};

template <bool STATIC, bool TRANS>
__global__ void __launch_bounds__(NTHREADS, 1)
train_fwd_kernel(const FwdArgs F) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Common& A = F.c;
  const Smem m = carve(smem);
  const int ray = blockIdx.x, tid = threadIdx.x;
  ray_setup(A, m, ray, TRANS, STATIC && A.use_viewdir, A.flows[0] != nullptr);

  if (STATIC) {
    bf16* h = tower_fwd(A.W, A.B, W_S0, m.xin, m.h0, m.h1, m.stage, nullptr, 0);
    bf16* other = (h == m.h0) ? m.h1 : m.h0;
    head<1>(h, A.W[W_SSIG], A.B[W_SSIG], m.pl + P_SSIG * S);
    dense_fwd(h, A.W[W_SFIN], A.B[W_SFIN], false, other, nullptr, m.stage);
    __syncthreads();
    bf16* feat = other;
    if (A.use_viewdir) {
      dense_fwd(other, A.W[W_SDIR], m.ray_b, true, h, nullptr, m.stage);
      __syncthreads();
      feat = h;
    }
    head<3>(feat, A.W[W_SRGB], A.B[W_SRGB], m.pl + P_SR * S);
    __syncthreads();
    for (int e = tid; e < 4 * S; e += NTHREADS) {
      const int k = e / S, s = e % S;
      const float v = m.pl[k * S + s];
      F.out[k][size_t(ray) * S + s] = k == P_SSIG ? v : sigmoid(v);
    }
    __syncthreads();
  }
  if (TRANS) {
    bf16* h = tower_fwd(A.W, A.B, W_T0, m.xin, m.h0, m.h1, m.stage, nullptr, 0);
    bf16* other = (h == m.h0) ? m.h1 : m.h0;
    dense_fwd(h, A.W[W_TFIN], A.B[W_TFIN], false, other, nullptr, m.stage);
    __syncthreads();
    head<NHEAD>(other, A.W[W_THEAD], A.B[W_THEAD], m.pl);
    __syncthreads();
    // heads [sigma, rgb(3), fw(3), bw(3)] -> planes trgb, tsig, fw, bw
    for (int e = tid; e < NHEAD * S; e += NTHREADS) {
      const int k = e / S, s = e % S;
      const float v = m.pl[k * S + s];
      const int slot = k == 0 ? P_TSIG : (k < 4 ? P_TR + k - 1 : P_FW0 + k - 4);
      float* dst = F.out[slot];
      if (dst == nullptr) continue;
      dst[size_t(ray) * S + s] =
          k == 0 ? v : (k < 4 ? sigmoid(v) : A.flow_scale * tanhf(v));
    }
  }
}

}  // namespace

extern "C" int nsff_planar_train_fwd(
    const void* o, const void* d, const void* zs, const void* dir,
    const void* a, const void* t, const void* const* flows,
    const void* const* w, const void* const* b, void* const* outs,
    int n_rays, int xyz_w, int dir_w, int n_a, const float* freqs,
    int n_freqs, int static_branch, int encode_t, int use_viewdir,
    int encode_a, float flow_scale, int n_tau, void* stream) {
  if (n_freqs > MAXF || xyz_w + n_tau > SEG || (!static_branch && !encode_t))
    return int(cudaErrorInvalidValue);
  FwdArgs F;
  fill_common(F.c, o, d, zs, nullptr, dir, a, t, flows, w, b, n_rays, xyz_w,
              dir_w, n_a, freqs, n_freqs, use_viewdir, encode_a, flow_scale,
              n_tau);
  for (int i = 0; i < NPL; ++i) F.out[i] = static_cast<float*>(outs[i]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (static_branch && encode_t) {
    err = big_smem(train_fwd_kernel<true, true>);
    if (err == cudaSuccess)
      train_fwd_kernel<true, true><<<n_rays, NTHREADS, SM_BYTES, s>>>(F);
  } else if (static_branch) {
    err = big_smem(train_fwd_kernel<true, false>);
    if (err == cudaSuccess)
      train_fwd_kernel<true, false><<<n_rays, NTHREADS, SM_BYTES, s>>>(F);
  } else {
    err = big_smem(train_fwd_kernel<false, true>);
    if (err == cudaSuccess)
      train_fwd_kernel<false, true><<<n_rays, NTHREADS, SM_BYTES, s>>>(F);
  }
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

extern "C" size_t nsff_planar_train_bwd_scratch_bytes(int static_branch,
                                                      int n_rays,
                                                      int use_viewdir,
                                                      int encode_a) {
  return bwd_scratch_bytes(static_branch != 0, n_rays, use_viewdir, encode_a);
}

extern "C" int nsff_planar_train_bwd(
    int static_branch, const void* o, const void* d, const void* zs,
    const void* dir, const void* a, const void* t, const void* const* flows,
    const void* const* w, const void* const* b, const void* const* g,
    void* const* dw, void* const* db, void* ddir, void* da, void* dt,
    void* const* dflows, void* scratch, int n_rays, int xyz_w, int dir_w,
    int n_a, const float* freqs, int n_freqs, int use_viewdir, int encode_a,
    float flow_scale, int n_tau, void* stream) {
  const bool stat = static_branch != 0;
  if (n_freqs > MAXF || xyz_w + n_tau > SEG || n_rays <= 0)
    return int(cudaErrorInvalidValue);
  BwdArgs G;
  fill_common(G.c, o, d, zs, nullptr, dir, a, t, flows, w, b, n_rays, xyz_w,
              dir_w, n_a, freqs, n_freqs, stat && use_viewdir,
              stat && encode_a, flow_scale, n_tau);
  const int ng = stat ? 4 : NHEAD;
  for (int k = 0; k < NHEAD; ++k)
    G.g[k] = k < ng ? static_cast<const float*>(g[k]) : nullptr;
  G.g_stride = 1;
  G.ddir = static_cast<float*>(ddir);
  G.da = static_cast<float*>(da);
  G.dt = static_cast<float*>(dt);
  for (int c = 0; c < 3; ++c) G.dflows[c] = static_cast<float*>(dflows[c]);
  G.dx_stride = 1;
  G.round_dx = 0;
  return int(launch_branch_bwd(G, stat, use_viewdir, encode_a, scratch, dw, db,
                               static_cast<cudaStream_t>(stream)));
}
