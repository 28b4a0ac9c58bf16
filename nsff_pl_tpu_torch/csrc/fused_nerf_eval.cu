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
// Bound: operations (about 1.2 M MACs, 2.4 MFLOP, per sample against 12
// input and 64 output bytes; 10.2 ms per 32768-ray chunk of 128 samples at
// 989 TFLOP/s).
//
// Design: the wgmma tower of tower_wgmma.cuh, as in planar_eval_comp.cu:
// one CTA per (ray, tile of 128 samples) of two consumer warpgroups (64
// samples each, wgmma m64n256k16 on the tile in shared memory, epilogues
// in place from the accumulators, the narrow heads folded into the
// epilogues that feed them) and a producer warpgroup (one thread streams
// the weight K-slabs through TMA into a 6-stage ring, three warps stage
// the parameters and the ray's static_dir bias, recomputed for each of
// its tiles). A ray of any S >= 1 samples is ceil(S / 128) tiles; the
// rows past S of a partly used last tile (1 to 128 real rows) repeat the
// ray's last point, are computed by both warpgroups (an idle warpgroup
// was measured slower in B1) and are not written. The tile's points are staged in
// shared memory for the posenc tile; each warpgroup writes its rows of
// the (128, 16) tile, up to 4 KB contiguous, with coalesced stores, zeros
// included. The
// transient heads matrix is always 10 wide [sigma, rgb, fw, bw]; has_fw /
// has_bw choose the columns written.
// What bounds it now: as planar_eval_comp.cu, the epilogues that the
// products wait for and slabs still in flight from L2.
// Input wider than one segment (xyz_w [+ n_tau] > 128, e.g. N_tau 80 or
// 22 posenc frequencies, which the JAX kernel runs in its unpadded
// layout): the packing of ops/raymarch_kernel.py::pack_padded_weights has
// n = ceil((xyz_w + n_tau) / 128) input segments (layer 0 (128 n, 256),
// the skip layer (128 n + 256, 256)). At n = 2 the wide instance (NSEG =
// 2) reads a resident two-segment posenc tile, with a 4-stage ring to make
// room for its second segment (tower_wgmma.cuh::Geo). Past two segments no
// third 32 KB region is left, so the streamed instance (NSEG = STREAM)
// keeps two one-segment buffers in the same carve-up: at layer 0 and the
// skip layer of each tower each consumer warpgroup fills its rows of
// segment s into buffer s % 2 while the products of segment s - 1 run
// (tower_wgmma.cuh::mma_layer_stream), and the producer streams the slabs
// in the same K order. Every instance has the same products, order and
// rounding points. The posenc frequencies, any count, come from a device
// table (freqs); the direction and appearance embeddings may take several
// segments each (dir_bias).
//
// Plain C interface (loaded with ctypes); launches on the given stream and
// returns the cudaError_t of the launch (or of the tensor-map encoding).

#include <cstring>

#include "tower_wgmma.cuh"

using namespace planar;

namespace {

constexpr int NCOL = 16;  // packed output columns

struct EvalArgs {
  Common c;            // its freqs unused: B5 reads the device table below
  const float* freqs;  // (n_freqs,) posenc frequencies on the device
  float* out;          // (n_rays, S, NCOL)
  int has_fw, has_bw, n_segs;
  int n_segs_stat;  // the segments holding posenc lanes: the static tower's
};

struct Params {
  wg::Maps maps;
  EvalArgs f;
};

static_assert(sizeof(Params) <= 4096, "kernel parameters fit 4 KB");

template <bool STATIC, bool TRANS, int NSEG>
__global__ void __launch_bounds__(wg::NTHR, 1)
fused_eval_kernel(const __grid_constant__ Params P) {
  using G = wg::Geo<NSEG>;
  // the dynamic shared memory starts 1024-byte aligned (the swizzle atoms
  // and TMA boxes need it); pointers derived from it stay in the shared
  // space, so the compiler emits shared loads and stores
  extern __shared__ __align__(1024) unsigned char sm[];
  if ((wg::saddr(sm) & 1023u) != 0) __trap();
  const EvalArgs& F = P.f;
  const Common& A = F.c;
  const int tid = threadIdx.x;
  if (tid == 0) wg::init_ring<G::STAGES>(wg::saddr(sm + G::OFF_BAR));
  __syncthreads();

  // one CTA per (ray, tile): rows s0.. of the ray, nv of them real
  const int ray = blockIdx.x / A.n_tiles;
  const int s0 = (blockIdx.x % A.n_tiles) * S, nv = min(S, A.n_samples - s0);
  const size_t row0 = size_t(ray) * A.n_samples + s0;
  const bool dir = STATIC && A.use_viewdir;
  if (tid >= wg::NCONS) {
    // producer warpgroup: the weight slabs, the parameters, the dir bias
    wg::producer_wg<NSEG>(P.maps, A, sm, ray, STATIC, dir, TRANS, F.n_segs, F.n_segs_stat);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  // head results as planes of S floats (wg::PL_*)
  const float* pl = reinterpret_cast<const float*>(sm + G::OFF_PLANES);
  const float* s_rgb = pl + wg::PL_SRGB * S;
  const float* s_sig = pl + wg::PL_SSIG * S;
  float* pts = reinterpret_cast<float*>(sm + G::OFF_EXTRA);  // (S, 3)

  for (int e = tid; e < 3 * S; e += wg::NCONS)
    pts[e] = A.xyz[(row0 + min(e / 3, nv - 1)) * 3 + e % 3];
  wg::consumers_sync();
  const float* t_ray = TRANS ? A.t + size_t(ray) * A.n_tau : nullptr;
  if constexpr (NSEG == wg::STREAM) {
    // the towers fill the input segments as they go
    const wg::PeSrc src{sm + G::OFF_PE, F.freqs, t_ray, pts,
                        A.xyz_w, A.n_tau, F.n_segs, F.n_segs_stat};
    wg::run_towers<STATIC, TRANS, NSEG>(sm, dir, &src);
  } else {
    // posenc tile (+ the time latent for the transient tower)
    wg::posenc_tile<wg::PE_PTS, NSEG>(sm + G::OFF_PE, F.freqs, A.xyz_w, t_ray, A.n_tau,
                                      pts, nullptr, nullptr);
    wg::fence_async_smem();
    wg::consumers_sync();
    wg::run_towers<STATIC, TRANS, NSEG>(sm, dir);
  }
  const int g = tid >> 7;

  // ---- this warpgroup's real rows (of its 64) of the packed tile ----
  {
    // head column behind each flow slot of the packed row (-1: none)
    const int flow0 = F.has_fw ? 4 : (F.has_bw ? 7 : -1);
    const int flow1 = (F.has_fw && F.has_bw) ? 7 : -1;
    const int nrow = max(0, min(64, nv - 64 * g));
    float* out = F.out + (row0 + 64 * g) * NCOL;
    for (int e = tid & 127; e < nrow * NCOL; e += 128) {
      const int s = 64 * g + e / NCOL, c = e % NCOL;
      float v = 0.f;
      if (c < 4) {
        if (STATIC) v = c < 3 ? sigmoid(s_rgb[c * S + s]) : s_sig[s];
      } else if (TRANS) {
        if (c < 7) {
          v = sigmoid(pl[(c - 3) * S + s]);
        } else if (c == 7) {
          v = pl[s];
        } else if (c < 14) {
          const int col = c < 11 ? flow0 : flow1;
          if (col >= 0) v = A.flow_scale * tanhf(pl[(col + (c - 8) % 3) * S + s]);
        }
      }
      out[e] = v;
    }
  }
}

template <int NSEG>
cudaError_t launch_variant(const Params& P, bool static_branch, bool encode_t, int n_ctas,
                           cudaStream_t s) {
  if (static_branch && encode_t)
    return wg::launch<NSEG>(fused_eval_kernel<true, true, NSEG>, P, n_ctas, s);
  if (static_branch) return wg::launch<NSEG>(fused_eval_kernel<true, false, NSEG>, P, n_ctas, s);
  return wg::launch<NSEG>(fused_eval_kernel<false, true, NSEG>, P, n_ctas, s);
}

}  // namespace

// n_segs: the input segments of SEG lanes of the packed weights (any count
// >= 1: ceil((xyz_w [+ n_tau]) / SEG)); freqs: the n_freqs posenc
// frequencies, a device pointer; stream_from: the least n_segs that runs
// the streamed instance (3; less only to hold it against the resident
// ones)
extern "C" int nsff_fused_eval(
    const void* xyz, const void* dir, const void* a, const void* t,
    const void* const* w, const void* const* b, void* out, int n_rays,
    int n_samples, int xyz_w, int dir_w, int n_a, const float* freqs, int n_freqs,
    int static_branch, int encode_t, int use_viewdir, int encode_a,
    int has_fw, int has_bw, float flow_scale, int n_tau, int n_segs, int stream_from,
    void* stream) {
  if (n_freqs < 0 || (freqs == nullptr && n_freqs > 0) || xyz_w != 3 + 6 * n_freqs ||
      n_segs < 1 || xyz_w + n_tau > n_segs * SEG || stream_from < 1 ||
      (!static_branch && !encode_t) || xyz == nullptr || n_samples < 1)
    return int(cudaErrorInvalidValue);
  Params P;
  memset(&P, 0, sizeof(P));
  EvalArgs& F = P.f;
  fill_common(F.c, nullptr, nullptr, nullptr, xyz, dir, a, t, nullptr, w, b,
              n_rays, xyz_w, dir_w, n_a, nullptr, 0, use_viewdir, encode_a,
              flow_scale, n_tau);
  F.freqs = freqs;
  F.n_segs = n_segs;
  F.n_segs_stat = (xyz_w + SEG - 1) / SEG;
  F.c.n_samples = n_samples;
  F.c.n_tiles = tiles_of(n_samples);
  const int n_ctas = n_rays * F.c.n_tiles;
  // only the evaluated branches get tensor maps
  if (!static_branch)
    for (int i = W_S0; i < W_T0; ++i) F.c.W[i] = nullptr;
  if (!encode_t)
    for (int i = W_T0; i < NSLOT; ++i) F.c.W[i] = nullptr;
  if (!(static_branch && use_viewdir)) F.c.W[W_SDIR] = nullptr;
  F.out = static_cast<float*>(out);
  F.has_fw = has_fw;
  F.has_bw = has_bw;
  if (!wg::encode_maps(P.maps, F.c.W, n_segs)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sb = static_branch != 0, et = encode_t != 0;
  if (n_segs > 2 || n_segs >= stream_from)
    return int(launch_variant<wg::STREAM>(P, sb, et, n_ctas, s));
  return int(n_segs == 1 ? launch_variant<1>(P, sb, et, n_ctas, s)
                         : launch_variant<2>(P, sb, et, n_ctas, s));
}
