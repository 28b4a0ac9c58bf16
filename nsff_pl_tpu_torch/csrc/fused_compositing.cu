// Fused NeRF-W compositor on the packed (rows, 16) evaluator output for
// Hopper (sm_90a): forward and adjoint.
//
// Replaces nsff_pl_tpu/ops/compositing_kernel.py::make_fused_compositing
// (two Pallas TPU kernels). From the packed tile
// [s_rgb(3), s_sigma, t_rgb(3), t_sigma, ...], the depths zs and the two
// sigma noises it computes softplus(sigma + noise), the alphas with the far
// deltas 100 (static) / 1e-3 (transient) at the last sample, the shared
// transmittance T_j = prod_{i<j} (1 - alpha_i) with
// alpha = 1 - (1 - a_s)(1 - a_t), the static / transient / total weights and
// the rgb and depth maps. The adjoint recomputes the forward and uses
//   dL/dalpha_j = g_w_j T_j - (sum_{i>j} g_T_i T_i) / max(1 - alpha_j, 1e-37)
// with the trailing sum as a direct reverse scan of the next samples'
// terms, never a total or an inclusive sum minus a prefix, so it is an
// exact 0 at the far sample, where 1 - alpha ~ 1e-31 (0 in f32) would
// divide any residue; softplus' is the sigmoid, written out. zs and the noises are data. The
// plain versions are fused_compositing_fwd_ref / _bwd_ref in
// ops/compositing_kernel.py, which take their products and sums in the
// order written below.
//
// Bound: bytes (a few dozen flops per sample; it reads 32 of each packed
// row's 64 bytes, three planes, and writes seven planes, or reads seven
// more and writes the 64-byte cotangent rows). At the training batch (512
// rays) the whole call moves ~5 MB (S = 128), so it is a latency problem:
// NS / 32 warps per ray for NS = 64, 128, 192 or 256 samples (a template
// argument), one sample per thread (2048 warps at 512 rays and 128
// samples, ~16 per SM, where one warp per ray gave four), two rays per CTA
// (four at 64 samples; at most 512 threads; at 128 samples two rays, 256
// threads, were measured on an H100 against one and four rays a CTA the
// fastest by the stopwatch of a graph replay at 512 rays and no slower at
// 8192), every global load issued before any arithmetic (one memory round
// trip), and the scans as warp shuffles joined across a ray's warps
// through shared memory:
//   - products (transmittance): inclusive Hillis-Steele within the warp,
//     exclusive by a shift, times the product of the earlier warps'
//     totals taken in warp order;
//   - trailing sums: the next sample's term shifted in, an inclusive
//     reverse Hillis-Steele within the warp, plus the sum of the later
//     warps' totals taken from the last warp down;
//   - map sums: the warp's butterfly, then the warps' partials in order.
// A packed row is read as two 16-byte loads of one 32-byte sector. The
// adjoint's cotangent rows are staged in shared memory so that each
// store instruction of a warp writes 512 contiguous bytes (columns 8-15
// zero).
//
// Plain C interface (loaded with ctypes); launches on the given stream and
// returns the cudaError_t of the launch.

#include "warp_ray.cuh"

using namespace warp_ray;

namespace {

constexpr int NCOL = 16;   // columns of a packed row
constexpr int NPLANE = 7;  // output planes
constexpr unsigned FULL = 0xffffffffu;

// the launch geometry of NS samples a ray: NS / 32 warps a ray (one
// sample per thread), RAYS rays a CTA
template <int NS>
struct Geo {
  static constexpr int NWARP = NS / 32;
  static constexpr int RAYS = NS <= 64 ? 4 : 2;
  static constexpr int NTHR = RAYS * NS;
  static_assert(NS % 32 == 0 && NTHR <= 512, "NS: 64, 128, 192 or 256");
};
constexpr float TINY = 1e-37f;

// output planes / their cotangents
enum { O_SS = 0, O_ST, O_AS, O_AT, O_WS, O_WT, O_W };

struct Args {
  const float* packed;  // (n, S, 16)
  const float* zs; const float* ns; const float* nt;  // (n, S)
  const float* g[NPLANE];  // adjoint: cotangent planes (null = zero)
  const float* gmap;       // adjoint: (n, 4) cotangent of the maps, or null
  float* out[NPLANE];      // forward: output planes
  float* maps;             // forward: (n, 4) rgb + depth
  float* dpacked;          // adjoint: (n, S, 16)
};

__device__ __forceinline__ float ld(const float* p, size_t i) {
  return p != nullptr ? __ldg(p + i) : 0.f;
}

// prod_{i < s} x_i over the ray; `tot` holds the ray's NWARP floats of
// shared memory
template <int NWARP>
__device__ __forceinline__ float block_excl_cumprod(float x, int lane, int w,
                                                    float* tot) {
  float inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(FULL, inc, off);
    if (lane >= off) inc *= y;
  }
  if (lane == 31) tot[w] = inc;
  float exc = __shfl_up_sync(FULL, inc, 1);
  if (lane == 0) exc = 1.f;
  __syncthreads();
  float pre = 1.f;
  for (int k = 0; k < w; ++k) pre *= tot[k];
  return pre * exc;
}

// sum_{i > s} x_i over the ray, directly; `tot` as above
template <int NWARP>
__device__ __forceinline__ float block_rev_excl_cumsum(float x, int lane,
                                                       int w, float* tot) {
  float inc = __shfl_down_sync(FULL, x, 1);
  if (lane == 31) inc = 0.f;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_down_sync(FULL, inc, off);
    if (lane + off < 32) inc += y;
  }
  if (lane == 0) tot[w] = inc + x;
  __syncthreads();
  float post = 0.f;
  for (int k = NWARP - 1; k > w; --k) post += tot[k];
  return inc + post;
}

// the quantities of one sample that both kernels need
struct Sample {
  float4 c0, c1;  // packed columns 0-3 and 4-7
  float z, ns, nt, ds, dt, s_s, s_t, a_s, a_t, alpha, T;
};

// the ray's sample s: every load is issued before the first use
template <int NS>
__device__ __forceinline__ Sample load_sample(const Args& A, int ray, int s) {
  // a CTA's rays past the last load the last one's and store nothing
  Sample k;
  const size_t i = size_t(ray) * NS + s;
  const float4* row = reinterpret_cast<const float4*>(A.packed + i * NCOL);
  k.c0 = __ldg(row);
  k.c1 = __ldg(row + 1);
  k.z = __ldg(A.zs + i);
  const float zn = s < NS - 1 ? __ldg(A.zs + i + 1) : 0.f;
  k.ns = __ldg(A.ns + i);
  k.nt = __ldg(A.nt + i);
  const float dz = zn - k.z;
  k.ds = s == NS - 1 ? STATIC_FAR_DELTA : dz;
  k.dt = s == NS - 1 ? TRANSIENT_FAR_DELTA : dz;
  return k;
}

__device__ __forceinline__ void alphas(Sample& k) {
  k.s_s = softplus(k.c0.w + k.ns);
  k.s_t = softplus(k.c1.w + k.nt);
  k.a_s = 1.f - expf(-k.ds * k.s_s);
  k.a_t = 1.f - expf(-k.dt * k.s_t);
  k.alpha = 1.f - (1.f - k.a_s) * (1.f - k.a_t);
}

// this thread's ray (of the CTA's RAYS), sample, lane and warp in the ray
struct Slot {
  int r, s, lane, w, ray;
  bool on;
};

template <int NS>
__device__ __forceinline__ Slot slot(int n_rays) {
  Slot t;
  t.r = threadIdx.x / NS;
  t.s = threadIdx.x % NS;
  t.lane = t.s & 31;
  t.w = t.s >> 5;
  t.ray = blockIdx.x * Geo<NS>::RAYS + t.r;
  t.on = t.ray < n_rays;
  if (!t.on) t.ray = n_rays - 1;
  return t;
}

template <int NS>
__global__ void __launch_bounds__(Geo<NS>::NTHR) fused_comp_fwd_kernel(const Args A,
                                                                      int n_rays) {
  constexpr int RAYS = Geo<NS>::RAYS, NWARP = Geo<NS>::NWARP;
  __shared__ float tot[RAYS][NWARP];
  __shared__ float part[RAYS][NWARP][4];
  const Slot t = slot<NS>(n_rays);
  Sample k = load_sample<NS>(A, t.ray, t.s);
  alphas(k);
  k.T = block_excl_cumprod<NWARP>(1.f - k.alpha, t.lane, t.w, tot[t.r]);
  const float w_s = k.a_s * k.T, w_t = k.a_t * k.T, wgt = k.alpha * k.T;
  float m[4] = {w_s * k.c0.x + w_t * k.c1.x, w_s * k.c0.y + w_t * k.c1.y,
                w_s * k.c0.z + w_t * k.c1.z, wgt * k.z};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    m[c] = warp_sum(m[c]);
    if (t.lane == 0) part[t.r][t.w][c] = m[c];
  }
  if (t.on) {
    const size_t i = size_t(t.ray) * NS + t.s;
    A.out[O_SS][i] = k.s_s;
    A.out[O_ST][i] = k.s_t;
    A.out[O_AS][i] = k.a_s;
    A.out[O_AT][i] = k.a_t;
    A.out[O_WS][i] = w_s;
    A.out[O_WT][i] = w_t;
    A.out[O_W][i] = wgt;
  }
  __syncthreads();
  if (t.on && t.s < 4) {
    float acc = part[t.r][0][t.s];
    for (int w = 1; w < NWARP; ++w) acc += part[t.r][w][t.s];
    A.maps[size_t(t.ray) * 4 + t.s] = acc;
  }
}

template <int NS>
__global__ void __launch_bounds__(Geo<NS>::NTHR) fused_comp_bwd_kernel(const Args A,
                                                                      int n_rays) {
  constexpr int RAYS = Geo<NS>::RAYS, NWARP = Geo<NS>::NWARP;
  __shared__ float tot[RAYS][NWARP];
  __shared__ float tot2[RAYS][NWARP];
  __shared__ __align__(16) float4 stage[RAYS * NWARP][64];
  const Slot t = slot<NS>(n_rays);
  const size_t i = size_t(t.ray) * NS + t.s;
  Sample k = load_sample<NS>(A, t.ray, t.s);
  float g[NPLANE], gm[4];
#pragma unroll
  for (int p = 0; p < NPLANE; ++p) g[p] = ld(A.g[p], i);
#pragma unroll
  for (int c = 0; c < 4; ++c) gm[c] = ld(A.gmap, size_t(t.ray) * 4 + c);
  alphas(k);
  k.T = block_excl_cumprod<NWARP>(1.f - k.alpha, t.lane, t.w, tot[t.r]);

  // the rgb and depth map adjoints fold into the weight cotangents
  const float sr[3] = {k.c0.x, k.c0.y, k.c0.z};
  const float tr[3] = {k.c1.x, k.c1.y, k.c1.z};
  float g_ws = g[O_WS], g_wt = g[O_WT];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    g_ws += gm[c] * sr[c];
    g_wt += gm[c] * tr[c];
  }
  const float g_w = g[O_W] + gm[3] * k.z;
  const float g_T = g_ws * k.a_s + g_wt * k.a_t + g_w * k.alpha;
  const float trail = block_rev_excl_cumsum<NWARP>(g_T * k.T, t.lane, t.w,
                                                   tot2[t.r]);
  const float g_alpha = g_w * k.T - trail / fmaxf(1.f - k.alpha, TINY);
  const float g_as = g_ws * k.T + g_alpha * (1.f - k.a_t) + g[O_AS];
  const float g_at = g_wt * k.T + g_alpha * (1.f - k.a_s) + g[O_AT];
  const float g_ss = g_as * k.ds * expf(-k.ds * k.s_s) + g[O_SS];
  const float g_st = g_at * k.dt * expf(-k.dt * k.s_t) + g[O_ST];
  const float ws = k.a_s * k.T, wt = k.a_t * k.T;
  // the warp's 32 rows: columns 0-7 through shared memory, then 2 KB of
  // rows written 512 contiguous bytes an instruction
  float4* tile = stage[threadIdx.x >> 5];
  tile[2 * t.lane] = make_float4(gm[0] * ws, gm[1] * ws, gm[2] * ws,
                                 g_ss * sigmoid(k.c0.w + k.ns));
  tile[2 * t.lane + 1] = make_float4(gm[0] * wt, gm[1] * wt, gm[2] * wt,
                                     g_st * sigmoid(k.c1.w + k.nt));
  __syncwarp();
  if (!t.on) return;
  float4* rows = reinterpret_cast<float4*>(
      A.dpacked + (size_t(t.ray) * NS + t.w * 32) * NCOL);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = j * 32 + t.lane, row = q >> 2, c4 = q & 3;
    rows[q] = c4 < 2 ? tile[2 * row + c4] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// one launch of the forward (fwd) or adjoint kernel at NS samples a ray
template <int NS>
cudaError_t launch(bool fwd, const Args& A, int n_rays, cudaStream_t s) {
  const int grid = (n_rays + Geo<NS>::RAYS - 1) / Geo<NS>::RAYS;
  if (fwd)
    fused_comp_fwd_kernel<NS><<<grid, Geo<NS>::NTHR, 0, s>>>(A, n_rays);
  else
    fused_comp_bwd_kernel<NS><<<grid, Geo<NS>::NTHR, 0, s>>>(A, n_rays);
  return cudaGetLastError();
}

cudaError_t launch_s(bool fwd, const Args& A, int n_rays, int n_samples,
                     cudaStream_t s) {
  switch (n_samples) {
    case 64: return launch<64>(fwd, A, n_rays, s);
    case 128: return launch<128>(fwd, A, n_rays, s);
    case 192: return launch<192>(fwd, A, n_rays, s);
    case 256: return launch<256>(fwd, A, n_rays, s);
    default: return cudaErrorInvalidValue;
  }
}

Args make_args(const void* packed, const void* zs, const void* ns,
               const void* nt) {
  Args A = {};
  A.packed = static_cast<const float*>(packed);
  A.zs = static_cast<const float*>(zs);
  A.ns = static_cast<const float*>(ns);
  A.nt = static_cast<const float*>(nt);
  return A;
}

}  // namespace

extern "C" int nsff_fused_comp_fwd(const void* packed, const void* zs,
                                   const void* ns, const void* nt,
                                   void* const* outs, void* maps, int n_rays,
                                   int n_samples, void* stream) {
  Args A = make_args(packed, zs, ns, nt);
  for (int i = 0; i < NPLANE; ++i) A.out[i] = static_cast<float*>(outs[i]);
  A.maps = static_cast<float*>(maps);
  return int(launch_s(true, A, n_rays, n_samples, static_cast<cudaStream_t>(stream)));
}

extern "C" int nsff_fused_comp_bwd(const void* packed, const void* zs,
                                   const void* ns, const void* nt,
                                   const void* const* g, const void* gmap,
                                   void* dpacked, int n_rays, int n_samples,
                                   void* stream) {
  Args A = make_args(packed, zs, ns, nt);
  for (int i = 0; i < NPLANE; ++i) A.g[i] = static_cast<const float*>(g[i]);
  A.gmap = static_cast<const float*>(gmap);
  A.dpacked = static_cast<float*>(dpacked);
  return int(launch_s(false, A, n_rays, n_samples, static_cast<cudaStream_t>(stream)));
}
