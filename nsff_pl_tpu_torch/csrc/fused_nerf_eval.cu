// Packed-boundary NSFF evaluator for Hopper (sm_90a).
//
// Replaces nsff_pl_tpu/ops/mlp_kernel.py::make_fused_nerf_eval (one Pallas
// TPU kernel): for given sample points xyz (N, S, 3) it computes the
// positional encoding (pre-activation x_c * f per lane, the range-reduced
// polynomial sine), the static 8x256 tower with its sigma / final / dir /
// rgb heads (direction and appearance embeddings per ray), the transient
// tower with the per-ray time latent in lanes [xyz_w, xyz_w + n_tau) of
// its input, and the packed transient heads, and writes one row-major
// (rows, 16) f32 tile
//   [s_rgb(3), s_sigma, t_rgb(3), t_sigma, flow(3), flow(3), 0, 0]
// whose flow columns hold the requested heads in the order fw, bw (raw
// flow_scale * tanh; the caller masks far samples). Without the static
// branch columns 0-3 are zero, without the transient branch columns 4-15.
// It is also the forward of the trainable evaluator (fused_nerf_train.cu
// is its backward). The plain version is fused_nerf_eval_ref in
// ops/mlp_kernel.py, with the same rounding points: bf16 matmul inputs,
// f32 accumulation, activations rounded to bf16 after each ReLU, biases
// in f32.
//
// Bound: operations (about 1.2 MFLOP per sample against 12 input and 64
// output bytes). Design: the evaluator of planar_nerf_train.cu, one CTA of
// 8 warps per ray with the ray's 128 samples as the M dimension of every
// product (nvcuda::wmma bf16, weights streamed from L2, activations in
// shared memory); the head results stay in shared memory as planes and
// the ray's (128, 16) tile, 8 KB contiguous, is written with coalesced
// stores. The transient heads matrix is always 10 wide
// [sigma, rgb, fw, bw]; has_fw / has_bw choose the columns written.
//
// Plain C interface (loaded with ctypes); launches on the given stream and
// returns the cudaError_t of the launch.

#include "tower_ray.cuh"

using namespace planar;

namespace {

constexpr int NCOL = 16;  // packed output columns

struct EvalArgs {
  Common c;
  float* out;  // (n_rays, S, NCOL)
  int has_fw, has_bw;
};

template <bool STATIC, bool TRANS>
__global__ void __launch_bounds__(NTHREADS, 1)
fused_eval_kernel(const EvalArgs F) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Common& A = F.c;
  const Smem m = carve(smem);
  const int ray = blockIdx.x, tid = threadIdx.x;
  ray_setup(A, m, ray, TRANS, STATIC && A.use_viewdir, false);
  // head results as planes of S floats: transient heads 0..9, static rgb
  // 10..12, static sigma 13
  float* s_rgb = m.pl + NHEAD * S;
  float* s_sig = s_rgb + 3 * S;

  if (STATIC) {
    bf16* h = tower_fwd(A.W, A.B, W_S0, m.xin, m.h0, m.h1, m.stage, nullptr, 0);
    bf16* other = (h == m.h0) ? m.h1 : m.h0;
    head<1>(h, A.W[W_SSIG], A.B[W_SSIG], s_sig);
    dense_fwd(h, A.W[W_SFIN], A.B[W_SFIN], false, other, nullptr, m.stage);
    __syncthreads();
    bf16* feat = other;
    if (A.use_viewdir) {
      dense_fwd(other, A.W[W_SDIR], m.ray_b, true, h, nullptr, m.stage);
      __syncthreads();
      feat = h;
    }
    head<3>(feat, A.W[W_SRGB], A.B[W_SRGB], s_rgb);
    __syncthreads();
  }
  if (TRANS) {
    bf16* h = tower_fwd(A.W, A.B, W_T0, m.xin, m.h0, m.h1, m.stage, nullptr, 0);
    bf16* other = (h == m.h0) ? m.h1 : m.h0;
    dense_fwd(h, A.W[W_TFIN], A.B[W_TFIN], false, other, nullptr, m.stage);
    __syncthreads();
    head<NHEAD>(other, A.W[W_THEAD], A.B[W_THEAD], m.pl);
    __syncthreads();
  }
  // head column behind each flow slot of the packed row (-1: none)
  const int flow0 = F.has_fw ? 4 : (F.has_bw ? 7 : -1);
  const int flow1 = (F.has_fw && F.has_bw) ? 7 : -1;
  float* out = F.out + size_t(ray) * S * NCOL;
  for (int e = tid; e < S * NCOL; e += NTHREADS) {
    const int s = e / NCOL, c = e % NCOL;
    float v = 0.f;
    if (c < 4) {
      if (STATIC) v = c < 3 ? sigmoid(s_rgb[c * S + s]) : s_sig[s];
    } else if (TRANS) {
      if (c < 7) {
        v = sigmoid(m.pl[(c - 3) * S + s]);
      } else if (c == 7) {
        v = m.pl[s];
      } else if (c < 14) {
        const int col = c < 11 ? flow0 : flow1;
        if (col >= 0) v = A.flow_scale * tanhf(m.pl[(col + (c - 8) % 3) * S + s]);
      }
    }
    out[e] = v;
  }
}

}  // namespace

extern "C" int nsff_fused_eval(
    const void* xyz, const void* dir, const void* a, const void* t,
    const void* const* w, const void* const* b, void* out, int n_rays,
    int xyz_w, int dir_w, int n_a, const float* freqs, int n_freqs,
    int static_branch, int encode_t, int use_viewdir, int encode_a,
    int has_fw, int has_bw, float flow_scale, int n_tau, void* stream) {
  if (n_freqs > MAXF || xyz_w + n_tau > SEG || (!static_branch && !encode_t) ||
      xyz == nullptr)
    return int(cudaErrorInvalidValue);
  EvalArgs F;
  fill_common(F.c, nullptr, nullptr, nullptr, xyz, dir, a, t, nullptr, w, b,
              n_rays, xyz_w, dir_w, n_a, freqs, n_freqs, use_viewdir, encode_a,
              flow_scale, n_tau);
  F.out = static_cast<float*>(out);
  F.has_fw = has_fw;
  F.has_bw = has_bw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (static_branch && encode_t) {
    err = big_smem(fused_eval_kernel<true, true>);
    if (err == cudaSuccess)
      fused_eval_kernel<true, true><<<n_rays, NTHREADS, SM_BYTES, s>>>(F);
  } else if (static_branch) {
    err = big_smem(fused_eval_kernel<true, false>);
    if (err == cudaSuccess)
      fused_eval_kernel<true, false><<<n_rays, NTHREADS, SM_BYTES, s>>>(F);
  } else {
    err = big_smem(fused_eval_kernel<false, true>);
    if (err == cudaSuccess)
      fused_eval_kernel<false, true><<<n_rays, NTHREADS, SM_BYTES, s>>>(F);
  }
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}
