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
// Bound: operations (forward ~1.2 M MACs, 2.4 MFLOP, per sample of the main
// call, 0.16 ms at batch 512 and 989 TFLOP/s; a warp call about half of it).
//
// Forward design: the wgmma tower of tower_wgmma.cuh, as in
// fused_nerf_eval.cu: one CTA per (ray, tile of 128 samples) of two
// consumer warpgroups (64 rows each, wgmma m64n256k16 on the tiles in shared memory,
// epilogues in place from the accumulators, the narrow heads folded into
// the epilogues that feed them) and a producer warpgroup (one thread
// streams the weight K-slabs through TMA into a 6-stage ring, three warps
// stage the parameters and the static_dir bias). The ray's depths, o, d
// and (warp calls) flows are staged in the head-plane region, free until
// the first head, and the posenc tile is wg::posenc_tile's, the bits the
// backward's recompute builds. Each warpgroup then writes its 64 rows of
// every requested plane, 256 contiguous bytes a plane, with the heads'
// activations (sigmoid, flow_scale * tanh) applied on the way.
// The backward (a wgmma + TMA chain kernel, a wgmma split-K dW GEMM,
// fixed-order reductions) is csrc/tower_bwd_wgmma.cuh, shared with
// fused_nerf_train.cu.
//
// Plain C interface (loaded with ctypes); launches on the given stream and
// returns the cudaError_t of the launches (or of the tensor-map encoding).

#include "tower_bwd_wgmma.cuh"

using namespace planar;

namespace {

// output / cotangent plane slots (_TRAIN_PLANES in ops/raymarch_kernel.py)
enum {
  P_SR = 0, P_SG, P_SB, P_SSIG, P_TR, P_TG, P_TB, P_TSIG,
  P_FW0, P_FW1, P_FW2, P_BW0, P_BW1, P_BW2, NPL
};

// ------------------------------- forward -------------------------------

struct FwdParams {
  wg::Maps maps;
  Common c;
  float* out[NPL];  // (n_rays, S) planes; null: not written
};
static_assert(sizeof(FwdParams) <= 4096, "kernel parameters fit 4 KB");

template <bool STATIC, bool TRANS>
__global__ void __launch_bounds__(wg::NTHR, 1)
train_fwd_kernel(const __grid_constant__ FwdParams P) {
  // 1024-byte aligned dynamic shared memory (swizzle atoms, TMA boxes)
  extern __shared__ __align__(1024) unsigned char sm[];
  if ((wg::saddr(sm) & 1023u) != 0) __trap();
  const Common& A = P.c;
  // one CTA per (ray, tile): rows s0.. of the ray, nv of them real (the
  // rest of a last tile repeats the ray's last sample and is not written)
  const int tid = threadIdx.x, ray = blockIdx.x / A.n_tiles;
  const int s0 = (blockIdx.x % A.n_tiles) * S, nv = min(S, A.n_samples - s0);
  if (tid == 0) wg::init_ring(wg::saddr(sm + wg::OFF_BAR));
  __syncthreads();
  const bool dir = STATIC && A.use_viewdir;
  if (tid >= wg::NCONS) {
    // producer warpgroup: the weight slabs, the parameters, the dir bias
    wg::producer_wg(P.maps, A, sm, ray, STATIC, dir, TRANS);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  float* pl = reinterpret_cast<float*>(sm + wg::OFF_PLANES);
  // the ray's inputs, in the head planes until the posenc tile is built
  float* zsh = pl;
  float* fl = pl + S;      // (S, 3) flows
  float* od = pl + 4 * S;  // o, d
  const bool flow = A.flows[0] != nullptr;
  const size_t row0 = size_t(ray) * A.n_samples + s0;
  if (tid < S) {
    const size_t r = row0 + min(tid, nv - 1);
    zsh[tid] = A.zs[r];
    if (flow)
      for (int c = 0; c < 3; ++c) fl[tid * 3 + c] = A.flows[c][r];
  } else if (tid < S + 6) {
    const int c = tid - S;
    od[c] = c < 3 ? A.o[ray * 3 + c] : A.d[ray * 3 + c - 3];
  }
  wg::consumers_sync();
  // posenc tile (+ the time latent for the transient tower; the static
  // tower's padded weight rows there are zero)
  const float* t = TRANS ? A.t + size_t(ray) * A.n_tau : nullptr;
  if (flow)
    wg::posenc_tile<wg::PE_RAY_FLOW>(sm + wg::OFF_PE, A.freqs, A.xyz_w, t, A.n_tau, fl,
                                     od, zsh);
  else
    wg::posenc_tile<wg::PE_RAY>(sm + wg::OFF_PE, A.freqs, A.xyz_w, t, A.n_tau, nullptr,
                                od, zsh);
  wg::fence_async_smem();
  wg::consumers_sync();  // the inputs are read: the head planes are free
  wg::run_towers<STATIC, TRANS>(sm, dir);

  // ---- this warpgroup's 64 rows of every requested plane ----
  const int g = tid >> 7;
  for (int e = tid & 127; e < NPL * 64; e += 128) {
    const int k = e >> 6, s = 64 * g + (e & 63);  // k is warp-uniform
    float* dst = P.out[k];
    if (dst == nullptr || (k < P_TR ? !STATIC : !TRANS) || s >= nv) continue;
    float v;
    if (k < P_SSIG)
      v = sigmoid(pl[(wg::PL_SRGB + k) * S + s]);
    else if (k == P_SSIG)
      v = pl[wg::PL_SSIG * S + s];
    else if (k < P_TSIG)
      v = sigmoid(pl[(wg::PL_TH + 1 + k - P_TR) * S + s]);
    else if (k == P_TSIG)
      v = pl[wg::PL_TH * S + s];
    else
      v = A.flow_scale * tanhf(pl[(wg::PL_TH + 4 + k - P_FW0) * S + s]);
    dst[row0 + s] = v;
  }
}

}  // namespace

extern "C" int nsff_planar_train_fwd(
    const void* o, const void* d, const void* zs, const void* dir,
    const void* a, const void* t, const void* const* flows,
    const void* const* w, const void* const* b, void* const* outs,
    int n_rays, int n_samples, int xyz_w, int dir_w, int n_a,
    const float* freqs, int n_freqs, int static_branch, int encode_t,
    int use_viewdir, int encode_a, float flow_scale, int n_tau,
    void* stream) {
  if (n_freqs > MAXF || xyz_w + n_tau > SEG || (!static_branch && !encode_t) ||
      n_samples < 1)
    return int(cudaErrorInvalidValue);
  FwdParams P;
  memset(&P, 0, sizeof(P));
  fill_common(P.c, o, d, zs, nullptr, dir, a, t, flows, w, b, n_rays, xyz_w,
              dir_w, n_a, freqs, n_freqs, use_viewdir, encode_a, flow_scale,
              n_tau);
  P.c.n_samples = n_samples;
  P.c.n_tiles = tiles_of(n_samples);
  const int n_ctas = n_rays * P.c.n_tiles;
  // only the evaluated branches get tensor maps and planes
  if (!static_branch)
    for (int i = W_S0; i < W_T0; ++i) P.c.W[i] = nullptr;
  if (!encode_t)
    for (int i = W_T0; i < NSLOT; ++i) P.c.W[i] = nullptr;
  if (!(static_branch && use_viewdir)) P.c.W[W_SDIR] = nullptr;
  for (int i = 0; i < NPL; ++i)
    P.out[i] = (i < P_TR ? static_branch : encode_t) ? static_cast<float*>(outs[i])
                                                      : nullptr;
  if (!wg::encode_maps(P.maps, P.c.W)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_branch && encode_t)
    return int(wg::launch(train_fwd_kernel<true, true>, P, n_ctas, s));
  if (static_branch) return int(wg::launch(train_fwd_kernel<true, false>, P, n_ctas, s));
  return int(wg::launch(train_fwd_kernel<false, true>, P, n_ctas, s));
}

extern "C" size_t nsff_planar_train_bwd_scratch_bytes(int static_branch,
                                                      int n_rays,
                                                      int n_samples,
                                                      int use_viewdir,
                                                      int encode_a) {
  return bwd_scratch_bytes(static_branch != 0, n_rays, n_samples, use_viewdir, encode_a);
}

extern "C" int nsff_planar_train_bwd(
    int static_branch, const void* o, const void* d, const void* zs,
    const void* dir, const void* a, const void* t, const void* const* flows,
    const void* const* w, const void* const* b, const void* const* g,
    void* const* dw, void* const* db, void* ddir, void* da, void* dt,
    void* const* dflows, void* scratch, int n_rays, int n_samples, int xyz_w,
    int dir_w, int n_a, const float* freqs, int n_freqs, int use_viewdir,
    int encode_a, float flow_scale, int n_tau, void* stream) {
  const bool stat = static_branch != 0;
  if (n_freqs > MAXF || xyz_w + n_tau > SEG || n_rays <= 0 || n_samples < 1)
    return int(cudaErrorInvalidValue);
  BwdArgs G;
  fill_common(G.c, o, d, zs, nullptr, dir, a, t, flows, w, b, n_rays, xyz_w,
              dir_w, n_a, freqs, n_freqs, stat && use_viewdir,
              stat && encode_a, flow_scale, n_tau);
  G.c.n_samples = n_samples;
  G.c.n_tiles = tiles_of(n_samples);
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
