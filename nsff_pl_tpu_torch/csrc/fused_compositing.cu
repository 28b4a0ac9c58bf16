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
// one sample per thread (2048 warps at 512 rays and 128 samples, ~16 per
// SM, where one warp per ray gave four), every global load of a chunk
// issued before any arithmetic (one memory round trip), and the scans as
// warp shuffles joined across a ray's warps through shared memory.
//
// Layout, for any S >= 1: a ray is taken in nk = ceil(S / 256) chunks of
// NW warps, NW = ceil(S / (32 nk)) <= 8 (a template argument; S = 64, 128,
// 192 and 256 are one chunk of 2, 4, 6 and 8 warps, S = 320 two of 5), with
// RAYS rays a CTA (four at NW <= 2, else two; at most 512 threads; at 128
// samples two rays, 256 threads, were measured on an H100 against one and
// four rays a CTA the fastest by the stopwatch of a graph replay at 512
// rays and no slower at 8192). The thread budget of a CTA bounds NW, so a
// longer ray loops over its chunks. Every warp holds 32 consecutive
// samples from a multiple of 32, as the plain versions' `block_*` scans
// cut the ray, and the samples past S are masked: they read nothing, get
// zero deltas and so alpha = 0 exactly (a factor 1 in a product, a term 0
// in a sum: the scans' identities, with which the plain versions pad) and
// are never stored. The scans join the warps in the plain versions'
// order, carried from chunk to chunk:
//   - products (transmittance): inclusive Hillis-Steele within the warp,
//     exclusive by a shift, times the product of the earlier warps'
//     totals taken in warp order, from the product carried over the
//     earlier chunks;
//   - trailing sums: the next sample's term shifted in, an inclusive
//     reverse Hillis-Steele within the warp, plus the sum of the later
//     warps' totals taken from the last warp down, from the sum carried
//     over the later chunks; the adjoint takes the chunks from the last
//     down, and with several chunks a first pass in order computes each
//     chunk's transmittance carry, kept in column 15 of the chunk's first
//     cotangent row until the second pass reads it back (and writes that
//     column's zero);
//   - map sums: the warp's butterfly, then the warps' partials in order.
// A packed row is read as two 16-byte loads of one 32-byte sector. The
// adjoint's cotangent rows are staged in shared memory so that each
// store instruction of a warp writes 512 contiguous bytes (columns 8-15
// zero; rows past S not written).
//
// Plain C interface (loaded with ctypes); launches on the given stream and
// returns the cudaError_t of the launch.

#include "warp_ray.cuh"

using namespace warp_ray;

namespace {

constexpr int NCOL = 16;   // columns of a packed row
constexpr int NPLANE = 7;  // output planes
constexpr unsigned FULL = 0xffffffffu;

// the launch geometry of a chunk of NW warps (one sample per thread),
// RAYS rays a CTA
template <int NW>
struct Geo {
  static constexpr int RAYS = NW <= 2 ? 4 : 2;
  static constexpr int CH = 32 * NW;  // samples of a chunk
  static constexpr int NTHR = RAYS * CH;
  static_assert(NW >= 1 && NTHR <= 512, "NW: 1 to 8");
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

// prod_{i < s} x_i over the ray, within a chunk: `carry` holds the
// product over the earlier chunks and is advanced past this one; `tot`
// holds the ray's NWARP floats of shared memory
template <int NWARP>
__device__ __forceinline__ float block_excl_cumprod(float x, int lane, int w,
                                                    float* tot, float& carry) {
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
  float pre = carry;
  for (int k = 0; k < w; ++k) pre *= tot[k];
  float past = carry;
  for (int k = 0; k < NWARP; ++k) past *= tot[k];
  carry = past;
  return pre * exc;
}

// sum_{i > s} x_i over the ray, directly, within a chunk: `carry` holds
// the sum over the later chunks and is advanced past this one; `tot` as
// above
template <int NWARP>
__device__ __forceinline__ float block_rev_excl_cumsum(float x, int lane, int w,
                                                       float* tot, float& carry) {
  float inc = __shfl_down_sync(FULL, x, 1);
  if (lane == 31) inc = 0.f;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_down_sync(FULL, inc, off);
    if (lane + off < 32) inc += y;
  }
  if (lane == 0) tot[w] = inc + x;
  __syncthreads();
  float post = carry;
  for (int k = NWARP - 1; k > w; --k) post += tot[k];
  float past = carry;
  for (int k = NWARP - 1; k >= 0; --k) past += tot[k];
  carry = past;
  return inc + post;
}

// the quantities of one sample that both kernels need
struct Sample {
  float4 c0, c1;  // packed columns 0-3 and 4-7
  float z, ns, nt, ds, dt, s_s, s_t, a_s, a_t, alpha, T;
};

// the ray's sample s of S: every load is issued before the first use; a
// sample past S reads nothing and gets zero deltas (alpha = 0 exactly)
__device__ __forceinline__ Sample load_sample(const Args& A, int ray, int s, int S) {
  Sample k;
  if (s >= S) {
    k.c0 = k.c1 = make_float4(0.f, 0.f, 0.f, 0.f);
    k.z = k.ns = k.nt = k.ds = k.dt = 0.f;
    return k;
  }
  const size_t i = size_t(ray) * S + s;
  const float4* row = reinterpret_cast<const float4*>(A.packed + i * NCOL);
  k.c0 = __ldg(row);
  k.c1 = __ldg(row + 1);
  k.z = __ldg(A.zs + i);
  const float zn = s < S - 1 ? __ldg(A.zs + i + 1) : 0.f;
  k.ns = __ldg(A.ns + i);
  k.nt = __ldg(A.nt + i);
  const float dz = zn - k.z;
  k.ds = s == S - 1 ? STATIC_FAR_DELTA : dz;
  k.dt = s == S - 1 ? TRANSIENT_FAR_DELTA : dz;
  return k;
}

__device__ __forceinline__ void alphas(Sample& k) {
  k.s_s = softplus(k.c0.w + k.ns);
  k.s_t = softplus(k.c1.w + k.nt);
  k.a_s = 1.f - expf(-k.ds * k.s_s);
  k.a_t = 1.f - expf(-k.dt * k.s_t);
  k.alpha = 1.f - (1.f - k.a_s) * (1.f - k.a_t);
}

// this thread's ray (of the CTA's RAYS), sample in the chunk, lane and
// warp in the ray
struct Slot {
  int r, s, lane, w, ray;
  bool on;
};

template <int NW>
__device__ __forceinline__ Slot slot(int n_rays) {
  Slot t;
  t.r = threadIdx.x / Geo<NW>::CH;
  t.s = threadIdx.x % Geo<NW>::CH;
  t.lane = t.s & 31;
  t.w = t.s >> 5;
  t.ray = blockIdx.x * Geo<NW>::RAYS + t.r;
  t.on = t.ray < n_rays;
  if (!t.on) t.ray = n_rays - 1;  // a CTA's rays past the last store nothing
  return t;
}

template <int NW>
__global__ void __launch_bounds__(Geo<NW>::NTHR) fused_comp_fwd_kernel(const Args A,
                                                                      int n_rays, int S) {
  constexpr int RAYS = Geo<NW>::RAYS, CH = Geo<NW>::CH;
  __shared__ float tot[RAYS][NW];
  __shared__ float part[RAYS][NW][4];
  const Slot t = slot<NW>(n_rays);
  const int nk = (S + CH - 1) / CH;
  float carry = 1.f;  // the transmittance past the earlier chunks
  float acc = 0.f;    // thread t.s < 4: map column t.s over the earlier warps
  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc * CH + t.s;
    Sample k = load_sample(A, t.ray, s, S);
    alphas(k);
    k.T = block_excl_cumprod<NW>(1.f - k.alpha, t.lane, t.w, tot[t.r], carry);
    const float w_s = k.a_s * k.T, w_t = k.a_t * k.T, wgt = k.alpha * k.T;
    float m[4] = {w_s * k.c0.x + w_t * k.c1.x, w_s * k.c0.y + w_t * k.c1.y,
                  w_s * k.c0.z + w_t * k.c1.z, wgt * k.z};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      m[c] = warp_sum(m[c]);
      if (t.lane == 0) part[t.r][t.w][c] = m[c];
    }
    if (t.on && s < S) {
      const size_t i = size_t(t.ray) * S + s;
      A.out[O_SS][i] = k.s_s;
      A.out[O_ST][i] = k.s_t;
      A.out[O_AS][i] = k.a_s;
      A.out[O_AT][i] = k.a_t;
      A.out[O_WS][i] = w_s;
      A.out[O_WT][i] = w_t;
      A.out[O_W][i] = wgt;
    }
    __syncthreads();
    if (t.s < 4)
      for (int w = 0; w < NW; ++w) acc += part[t.r][w][t.s];
    if (kc + 1 < nk) __syncthreads();  // tot and part are the next chunk's
  }
  if (t.on && t.s < 4) A.maps[size_t(t.ray) * 4 + t.s] = acc;
}

template <int NW>
__global__ void __launch_bounds__(Geo<NW>::NTHR) fused_comp_bwd_kernel(const Args A,
                                                                      int n_rays, int S) {
  constexpr int RAYS = Geo<NW>::RAYS, CH = Geo<NW>::CH;
  __shared__ float tot[RAYS][NW];
  __shared__ float tot2[RAYS][NW];
  __shared__ float carry_in[RAYS];
  __shared__ __align__(16) float4 stage[RAYS * NW][64];
  const Slot t = slot<NW>(n_rays);
  const int nk = (S + CH - 1) / CH;
  // column 15 of chunk kc's first cotangent row: its transmittance carry
  auto stash = [&](int kc) { return A.dpacked + (size_t(t.ray) * S + kc * CH) * NCOL + 15; };
  if (nk > 1) {  // pass 1: every chunk's transmittance carry, in order
    float carry = 1.f;
    for (int kc = 0; kc < nk; ++kc) {
      if (t.on && t.s == 0) *stash(kc) = carry;
      Sample k = load_sample(A, t.ray, kc * CH + t.s, S);
      alphas(k);
      block_excl_cumprod<NW>(1.f - k.alpha, t.lane, t.w, tot[t.r], carry);
      __syncthreads();  // tot is the next chunk's
    }
  }
  float gm[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) gm[c] = ld(A.gmap, size_t(t.ray) * 4 + c);
  float trail_carry = 0.f;  // sum of g_T T over the later chunks
  for (int kc = nk - 1; kc >= 0; --kc) {  // pass 2, from the ray's end
    if (nk > 1 && t.s == 0) carry_in[t.r] = t.on ? *stash(kc) : 1.f;
    const int s = kc * CH + t.s;
    const size_t i = size_t(t.ray) * S + s;
    Sample k = load_sample(A, t.ray, s, S);
    float g[NPLANE];
#pragma unroll
    for (int p = 0; p < NPLANE; ++p) g[p] = s < S ? ld(A.g[p], i) : 0.f;
    alphas(k);
    float carry = 1.f;
    if (nk > 1) {
      __syncthreads();  // carry_in
      carry = carry_in[t.r];
    }
    k.T = block_excl_cumprod<NW>(1.f - k.alpha, t.lane, t.w, tot[t.r], carry);

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
    const float trail = block_rev_excl_cumsum<NW>(s < S ? g_T * k.T : 0.f, t.lane, t.w,
                                                  tot2[t.r], trail_carry);
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
    const int sw0 = kc * CH + t.w * 32;  // the warp's first sample
    if (t.on) {
      float4* rows = reinterpret_cast<float4*>(A.dpacked + (size_t(t.ray) * S + sw0) * NCOL);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = j * 32 + t.lane, row = q >> 2, c4 = q & 3;
        if (sw0 + row < S)
          rows[q] = c4 < 2 ? tile[2 * row + c4] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    if (kc > 0) __syncthreads();  // tot, tot2, carry_in, stage: the next chunk's
  }
}

// one launch of the forward (fwd) or adjoint kernel at NW warps a chunk
template <int NW>
cudaError_t launch(bool fwd, const Args& A, int n_rays, int S, cudaStream_t s) {
  const int grid = (n_rays + Geo<NW>::RAYS - 1) / Geo<NW>::RAYS;
  if (fwd)
    fused_comp_fwd_kernel<NW><<<grid, Geo<NW>::NTHR, 0, s>>>(A, n_rays, S);
  else
    fused_comp_bwd_kernel<NW><<<grid, Geo<NW>::NTHR, 0, s>>>(A, n_rays, S);
  return cudaGetLastError();
}

// the ray in nk = ceil(S / 256) chunks of NW = ceil(S / (32 nk)) warps
cudaError_t launch_s(bool fwd, const Args& A, int n_rays, int S, cudaStream_t s) {
  if (S < 1) return cudaErrorInvalidValue;
  const int nk = (S + 255) / 256, nw = (S + 32 * nk - 1) / (32 * nk);
  switch (nw) {
    case 1: return launch<1>(fwd, A, n_rays, S, s);
    case 2: return launch<2>(fwd, A, n_rays, S, s);
    case 3: return launch<3>(fwd, A, n_rays, S, s);
    case 4: return launch<4>(fwd, A, n_rays, S, s);
    case 5: return launch<5>(fwd, A, n_rays, S, s);
    case 6: return launch<6>(fwd, A, n_rays, S, s);
    case 7: return launch<7>(fwd, A, n_rays, S, s);
    case 8: return launch<8>(fwd, A, n_rays, S, s);
  }
  return cudaErrorInvalidValue;
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
