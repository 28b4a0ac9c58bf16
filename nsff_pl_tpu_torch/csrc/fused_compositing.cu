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
// with the trailing sum as a direct reverse scan (total minus prefix
// cancels catastrophically at the far sample, where 1 - alpha ~ 1e-31);
// softplus' is the sigmoid, written out. zs and the noises are data. The
// plain versions are fused_compositing_fwd_ref / _bwd_ref in
// ops/compositing_kernel.py.
//
// Bound: bytes (a few dozen flops per sample; it reads 32 of each packed
// row's 64 bytes, three planes, and writes seven planes, or reads seven
// more and writes the 64-byte cotangent rows). Design: one warp per ray,
// four consecutive samples per lane, scans as warp shuffles
// (csrc/warp_ray.cuh). The packed rows are moved with 16-byte accesses
// that cover whole 32-byte sectors and are transposed through shared
// memory into per-column planes, so that each lane finds its four samples
// of a column as one 16-byte shared-memory access.
//
// Plain C interface (loaded with ctypes); launches on the given stream and
// returns the cudaError_t of the launch.

#include "warp_ray.cuh"

using namespace warp_ray;

namespace {

constexpr int NCOL = 16;   // columns of a packed row
constexpr int NUSED = 8;   // columns the compositor reads and differentiates
constexpr int NPLANE = 7;  // output planes
constexpr int PITCH = S + 4;  // floats per staged column (16-byte aligned)
constexpr int RAYS_PER_BLOCK = 4;
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
  int n_rays;
};

// columns 0..7 of the ray's packed rows -> tile[c * PITCH + s]
__device__ __forceinline__ void stage_in(const float* rows, float* tile, int lane) {
#pragma unroll
  for (int i = 0; i < S * 2 / 32; ++i) {
    const int idx = i * 32 + lane, s = idx >> 1, c0 = (idx & 1) * 4;
    const float4 v = *reinterpret_cast<const float4*>(rows + s * NCOL + c0);
    tile[(c0 + 0) * PITCH + s] = v.x;
    tile[(c0 + 1) * PITCH + s] = v.y;
    tile[(c0 + 2) * PITCH + s] = v.z;
    tile[(c0 + 3) * PITCH + s] = v.w;
  }
  __syncwarp();
}

__device__ __forceinline__ Row col(const float* tile, int c, int lane) {
  const float4 x = *reinterpret_cast<const float4*>(tile + c * PITCH + lane * Q);
  Row r;
  r.v[0] = x.x; r.v[1] = x.y; r.v[2] = x.z; r.v[3] = x.w;
  return r;
}

// the forward quantities both kernels need
struct Core {
  Row z, ds, dt, s_s, s_t, a_s, a_t, alpha, T;
};

__device__ __forceinline__ Core core(const Args& A, const float* tile,
                                     size_t base, int lane) {
  Core k;
  k.z = load(A.zs, base);
  deltas(k.z, lane, k.ds, k.dt);
  const Row ps = col(tile, 3, lane), pt = col(tile, 7, lane);
  const Row ns = load(A.ns, base), nt = load(A.nt, base);
  Row keep;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    k.s_s.v[q] = softplus(ps.v[q] + ns.v[q]);
    k.s_t.v[q] = softplus(pt.v[q] + nt.v[q]);
    k.a_s.v[q] = 1.f - expf(-k.ds.v[q] * k.s_s.v[q]);
    k.a_t.v[q] = 1.f - expf(-k.dt.v[q] * k.s_t.v[q]);
    k.alpha.v[q] = 1.f - (1.f - k.a_s.v[q]) * (1.f - k.a_t.v[q]);
    keep.v[q] = 1.f - k.alpha.v[q];
  }
  k.T = excl_cumprod(keep, lane);
  return k;
}

__global__ void __launch_bounds__(32 * RAYS_PER_BLOCK)
fused_comp_fwd_kernel(const Args A) {
  __shared__ __align__(16) float tiles[RAYS_PER_BLOCK][NUSED * PITCH];
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int ray = blockIdx.x * RAYS_PER_BLOCK + wi;
  if (ray >= A.n_rays) return;
  float* tile = tiles[wi];
  stage_in(A.packed + size_t(ray) * S * NCOL, tile, lane);
  const size_t base = size_t(ray) * S + lane * Q;
  const Core k = core(A, tile, base, lane);
  Row w_s, w_t, w;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    w_s.v[q] = k.a_s.v[q] * k.T.v[q];
    w_t.v[q] = k.a_t.v[q] * k.T.v[q];
    w.v[q] = k.alpha.v[q] * k.T.v[q];
  }
  store(A.out[O_SS], base, k.s_s);
  store(A.out[O_ST], base, k.s_t);
  store(A.out[O_AS], base, k.a_s);
  store(A.out[O_AT], base, k.a_t);
  store(A.out[O_WS], base, w_s);
  store(A.out[O_WT], base, w_t);
  store(A.out[O_W], base, w);
  float m[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const Row sr = col(tile, c, lane), tr = col(tile, 4 + c, lane);
#pragma unroll
    for (int q = 0; q < Q; ++q) m[c] += w_s.v[q] * sr.v[q] + w_t.v[q] * tr.v[q];
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) m[3] += w.v[q] * k.z.v[q];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float v = warp_sum(m[i]);
    if (lane == 0) A.maps[size_t(ray) * 4 + i] = v;
  }
}

__global__ void __launch_bounds__(32 * RAYS_PER_BLOCK)
fused_comp_bwd_kernel(const Args A) {
  __shared__ __align__(16) float tiles[RAYS_PER_BLOCK][NUSED * PITCH];
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int ray = blockIdx.x * RAYS_PER_BLOCK + wi;
  if (ray >= A.n_rays) return;
  float* tile = tiles[wi];
  stage_in(A.packed + size_t(ray) * S * NCOL, tile, lane);
  const size_t base = size_t(ray) * S + lane * Q;
  const Core k = core(A, tile, base, lane);
  float gm[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    gm[i] = A.gmap != nullptr ? A.gmap[size_t(ray) * 4 + i] : 0.f;

  // the rgb and depth map adjoints fold into the weight cotangents
  Row g_ws = load(A.g[O_WS], base), g_wt = load(A.g[O_WT], base);
  Row g_w = load(A.g[O_W], base);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const Row sr = col(tile, c, lane), tr = col(tile, 4 + c, lane);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      g_ws.v[q] += gm[c] * sr.v[q];
      g_wt.v[q] += gm[c] * tr.v[q];
    }
  }
  Row gTT;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    g_w.v[q] += gm[3] * k.z.v[q];
    const float g_T = g_ws.v[q] * k.a_s.v[q] + g_wt.v[q] * k.a_t.v[q]
        + g_w.v[q] * k.alpha.v[q];
    gTT.v[q] = g_T * k.T.v[q];
  }
  const Row trail = rev_excl_cumsum(gTT, lane);
  const Row g_as_in = load(A.g[O_AS], base), g_at_in = load(A.g[O_AT], base);
  const Row g_ss_in = load(A.g[O_SS], base), g_st_in = load(A.g[O_ST], base);
  const Row ps = col(tile, 3, lane), pt = col(tile, 7, lane);
  const Row ns = load(A.ns, base), nt = load(A.nt, base);
  __syncwarp();  // every lane has read the tile: it now takes the cotangent
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const float g_alpha = g_w.v[q] * k.T.v[q]
        - trail.v[q] / fmaxf(1.f - k.alpha.v[q], TINY);
    const float g_as = g_ws.v[q] * k.T.v[q] + g_alpha * (1.f - k.a_t.v[q])
        + g_as_in.v[q];
    const float g_at = g_wt.v[q] * k.T.v[q] + g_alpha * (1.f - k.a_s.v[q])
        + g_at_in.v[q];
    const float g_ss = g_as * k.ds.v[q] * expf(-k.ds.v[q] * k.s_s.v[q])
        + g_ss_in.v[q];
    const float g_st = g_at * k.dt.v[q] * expf(-k.dt.v[q] * k.s_t.v[q])
        + g_st_in.v[q];
    const int s = lane * Q + q;
    const float ws = k.a_s.v[q] * k.T.v[q], wt = k.a_t.v[q] * k.T.v[q];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      tile[c * PITCH + s] = gm[c] * ws;
      tile[(4 + c) * PITCH + s] = gm[c] * wt;
    }
    tile[3 * PITCH + s] = g_ss * sigmoid(ps.v[q] + ns.v[q]);
    tile[7 * PITCH + s] = g_st * sigmoid(pt.v[q] + nt.v[q]);
  }
  __syncwarp();
  // the cotangent rows, columns 8..15 zero, 16 bytes per lane and store
  float* rows = A.dpacked + size_t(ray) * S * NCOL;
#pragma unroll
  for (int i = 0; i < S * 4 / 32; ++i) {
    const int idx = i * 32 + lane, s = idx >> 2, c0 = (idx & 3) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c0 < NUSED)
      v = make_float4(tile[(c0 + 0) * PITCH + s], tile[(c0 + 1) * PITCH + s],
                      tile[(c0 + 2) * PITCH + s], tile[(c0 + 3) * PITCH + s]);
    *reinterpret_cast<float4*>(rows + s * NCOL + c0) = v;
  }
}

Args make_args(const void* packed, const void* zs, const void* ns,
               const void* nt, int n_rays) {
  Args A = {};
  A.packed = static_cast<const float*>(packed);
  A.zs = static_cast<const float*>(zs);
  A.ns = static_cast<const float*>(ns);
  A.nt = static_cast<const float*>(nt);
  A.n_rays = n_rays;
  return A;
}

}  // namespace

extern "C" int nsff_fused_comp_fwd(const void* packed, const void* zs,
                                   const void* ns, const void* nt,
                                   void* const* outs, void* maps, int n_rays,
                                   void* stream) {
  Args A = make_args(packed, zs, ns, nt, n_rays);
  for (int i = 0; i < NPLANE; ++i) A.out[i] = static_cast<float*>(outs[i]);
  A.maps = static_cast<float*>(maps);
  const int blocks = (n_rays + RAYS_PER_BLOCK - 1) / RAYS_PER_BLOCK;
  fused_comp_fwd_kernel<<<blocks, 32 * RAYS_PER_BLOCK, 0,
                          static_cast<cudaStream_t>(stream)>>>(A);
  return int(cudaGetLastError());
}

extern "C" int nsff_fused_comp_bwd(const void* packed, const void* zs,
                                   const void* ns, const void* nt,
                                   const void* const* g, const void* gmap,
                                   void* dpacked, int n_rays, void* stream) {
  Args A = make_args(packed, zs, ns, nt, n_rays);
  for (int i = 0; i < NPLANE; ++i) A.g[i] = static_cast<const float*>(g[i]);
  A.gmap = static_cast<const float*>(gmap);
  A.dpacked = static_cast<float*>(dpacked);
  const int blocks = (n_rays + RAYS_PER_BLOCK - 1) / RAYS_PER_BLOCK;
  fused_comp_bwd_kernel<<<blocks, 32 * RAYS_PER_BLOCK, 0,
                          static_cast<cudaStream_t>(stream)>>>(A);
  return int(cudaGetLastError());
}
