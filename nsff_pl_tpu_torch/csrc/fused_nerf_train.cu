// Backward of the packed-boundary trainable NSFF evaluator for Hopper
// (sm_90a).
//
// Replaces the backward of
// nsff_pl_tpu/ops/mlp_train_kernel.py::make_fused_nerf_train (one Pallas
// TPU kernel call per branch; its forward is make_fused_nerf_eval, here
// fused_nerf_eval.cu). Given the sample points xyz (N, S, 3), the per-ray
// embeddings and the cotangent g (N, S, 16) of the packed output, one call
// per branch recomputes the tower and backpropagates through the heads and
// the tower: dW / db summed over all rows in the padded weight layout,
// per-ray d(dir), d(a) (static) or d(t) (transient), and, when asked, the
// per-row xyz cotangent through the positional encoding. The plain
// version is fused_nerf_train_bwd_ref in ops/mlp_train_kernel.py; the
// rounding points are the TPU kernel's: every cotangent dz rounded to
// bf16 before its products, bias gradients from the f32 dz, the
// dir/appearance rows of dW[static_dir] and d(dir), d(a) from the
// ray-summed dz rounded to bf16, d(t) the bf16 of the ray-summed input
// cotangent, the static dir layer's ReLU mask taken on the f32
// pre-activation, flow cotangents through 1 - tanh^2 of the recomputed
// heads, and dxyz = bf16(dxs) @ bf16(selector^T) with the cosine as the
// polynomial sine of xs + phase + pi/2.
//
// Bound: operations (recompute, data gradient and weight gradient of every
// layer: about 3.6 MFLOP per sample). Design: csrc/tower_bwd_wgmma.cuh,
// shared with planar_nerf_train.cu: a wgmma + TMA chain kernel with one CTA
// per (ray, tile of 128 samples) (activations and cotangents through a
// global scratch buffer), a wgmma split-K dW GEMM over the units' rows and
// fixed-order reductions, so the gradients are the same bits on every run
// (no atomics). A ray of any S >= 1 samples is ceil(S / 128) units; the
// rows past S of a partly used last tile repeat the ray's last point and
// get zero cotangent, so they add nothing to dW, db or a ray sum; a ray of several tiles has its d(dir),
// d(a) and d(t) summed over its tiles in tile order by ray_reduce_kernel,
// while dxyz stays per sample. The packed cotangent is read
// column by column with stride 16; a transient call whose output lacks a
// flow passes no cotangent for that head's columns, which leaves exact
// zeros in its weight gradient. Without `dxyz` the input-cotangent
// products of the static branch and the posenc adjoint are skipped, not
// zeroed afterwards.
//
// Plain C interface (loaded with ctypes); launches on the given stream and
// returns the cudaError_t of the launches.

#include "tower_bwd_wgmma.cuh"

using namespace planar;

extern "C" size_t nsff_fused_train_bwd_scratch_bytes(int static_branch,
                                                     int n_rays,
                                                     int n_samples,
                                                     int use_viewdir,
                                                     int encode_a) {
  return bwd_scratch_bytes(static_branch != 0, n_rays, n_samples, use_viewdir,
                           encode_a);
}

// g: (n_rays, n_samples, 16) cotangent of the packed output, whose flow
// columns 8-10 / 11-13 belong to the heads has_fw / has_bw name (fw
// first); dxyz: (n_rays, n_samples, 3) or null.
extern "C" int nsff_fused_train_bwd(
    int static_branch, const void* xyz, const void* dir, const void* a,
    const void* t, const void* const* w, const void* const* b, const void* g,
    int has_fw, int has_bw, void* const* dw, void* const* db, void* ddir,
    void* da, void* dt, void* dxyz, void* scratch, int n_rays, int n_samples, int xyz_w,
    int dir_w, int n_a, const float* freqs, int n_freqs, int use_viewdir,
    int encode_a, float flow_scale, int n_tau, void* stream) {
  const bool stat = static_branch != 0;
  if (n_freqs > MAXF || xyz_w + n_tau > SEG || n_rays <= 0 || xyz == nullptr ||
      g == nullptr || n_samples < 1)
    return int(cudaErrorInvalidValue);
  BwdArgs G;
  fill_common(G.c, nullptr, nullptr, nullptr, xyz, dir, a, t, nullptr, w, b,
              n_rays, xyz_w, dir_w, n_a, freqs, n_freqs, stat && use_viewdir,
              stat && encode_a, flow_scale, n_tau);
  G.c.n_samples = n_samples;
  G.c.n_tiles = tiles_of(n_samples);
  const float* gp = static_cast<const float*>(g);
  for (int k = 0; k < NHEAD; ++k) G.g[k] = nullptr;
  if (stat) {
    for (int k = 0; k < 4; ++k) G.g[k] = gp + k;  // rgb(3), sigma
  } else {
    for (int k = 0; k < 4; ++k) G.g[k] = gp + 4 + k;
    int col = 8;
    if (has_fw) {
      for (int k = 0; k < 3; ++k) G.g[4 + k] = gp + col + k;
      col += 3;
    }
    if (has_bw)
      for (int k = 0; k < 3; ++k) G.g[7 + k] = gp + col + k;
  }
  G.g_stride = 16;
  G.ddir = static_cast<float*>(ddir);
  G.da = static_cast<float*>(da);
  G.dt = static_cast<float*>(dt);
  for (int c = 0; c < 3; ++c)
    G.dflows[c] = dxyz != nullptr ? static_cast<float*>(dxyz) + c : nullptr;
  G.dx_stride = 3;
  G.round_dx = 1;
  return int(launch_branch_bwd(G, stat, use_viewdir, encode_a, scratch, dw, db,
                               static_cast<cudaStream_t>(stream)));
}

#ifdef WG_PROFILE
extern "C" int nsff_prof_read(void* host, int n) {
  return int(cudaMemcpyFromSymbol(host, bw::bw_prof, size_t(n) * 8));
}
extern "C" int nsff_prof_clear() {
  static unsigned long long zero[4096 * 32];
  return int(cudaMemcpyToSymbol(bw::bw_prof, zero, sizeof(zero)));
}
#endif
