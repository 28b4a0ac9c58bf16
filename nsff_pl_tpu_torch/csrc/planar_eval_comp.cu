// Composited no-grad NSFF evaluator for Hopper (sm_90a).
//
// Replaces nsff_pl_tpu/ops/raymarch_kernel.py::make_planar_nerf_eval_comp
// (the Pallas TPU kernel of the test-time render). For every ray: posenc of
// xyz = o + d*z at its S samples (any S >= 1), the static and transient 8x256 ReLU
// towers (skip at layer 4; per-ray viewdir/appearance/time conditioning), the
// sigma/rgb/flow heads, and the volume compositing; it writes one row of
// n_map floats per ray. The layout of the maps row is comp_map_cols in
// ops/raymarch_kernel.py, whose planar_eval_comp_ref is the plain version.
//
// Bound: operations. A sample costs ~1.2 M bf16 MACs across both towers,
// against ~1 KB of input per ray, so the tensor cores and not memory bound
// it (10.2 ms per 32768-ray chunk at 989 TFLOP/s).
//
// Design (tower_wgmma.cuh): one CTA of three warpgroups per ray, which
// runs the ray's ceil(S / 128) tiles of 128 samples in turn, a run-time
// count (the last tile holds S - 128 (tiles - 1) real samples, 1 to 128;
// its rows past the ray's last sample repeat it and are left out of the
// composite), compositing each tile onto the transmittance prefix and the
// map sums of the tiles before it, which wait in shared memory between
// tiles. Two
// consumer warpgroups each own 64 of a tile's 128 rows and run every
// layer as wgmma m64n256k16 (bf16 in, f32 accumulators in registers) on the
// ray's posenc tile and activation tile in shared memory; one producer
// thread streams the ~2.4 MB of weight K-slabs per ray through TMA into a
// 6-stage ring, while the producer warpgroup's other warps stage biases and
// head weights in shared memory and compute the per-ray static_dir bias.
// Each layer's epilogue adds the bias, rounds to bf16 with the ReLU fused
// into the conversion and writes the activation tile in place, straight
// from the accumulators; the narrow heads (sigma, rgb, transient
// sigma/rgb/flow) are per-row dot products in the epilogue of the layer
// that feeds them, so the features they read never go back to shared
// memory. Rounding points are the TPU kernel's: bf16 matmul inputs, f32
// accumulation, bf16 activations, f32 biases and compositing. Compositing
// (exclusive cumsum of tau over a tile's 128 samples, plus the carried
// prefix) runs in one warp with shuffles; a tile border's delta reads the
// next tile's first depth. The producer streams the weights once a tile.
// What bounds it now: the products wait for each layer's epilogue (the
// next layer reads all of its columns), ~1/3 of a ray's time, and for
// slabs still in flight from L2; the posenc tile and the compositing
// (~9% of a ray) overlap no product, since a CTA holds one ray
// (scripts/profile_evaluator.py prints the breakdown).
//
// Plain C interface (loaded with ctypes); launches on the given stream and
// returns the cudaError_t of the launch (or of the tensor-map encoding).

#include <cstring>
#include <type_traits>

#include "tower_wgmma.cuh"

using namespace planar;

namespace {

// per-sample head outputs kept in shared memory, one (S,) plane each
enum {
  P_SR = 0, P_SG, P_SB, P_SSIG, P_TSIG, P_TR, P_TG, P_TB,
  P_FW0, P_FW1, P_FW2, P_BW0, P_BW1, P_BW2, NPLANE
};
static_assert(NPLANE <= wg::NPL, "planes fit the shared carve-up");

struct Args {
  const float* o; const float* d; const float* zs; const float* vis;
  const float* dir; const float* a; const float* t;
  const bf16* W[NSLOT]; const float* B[NSLOT];
  float* out;
  int n_rays, n_samples, xyz_w, dir_w, n_a, n_tau, n_map;
  int use_viewdir, encode_a, vis_in;
  float z_far, flow_scale;
  float freqs[MAXF];
};

struct Params {
  wg::Maps maps;
  Args a;
};
static_assert(sizeof(Params) <= 4096, "kernel parameters fit 4 KB");

constexpr int NM = 21;  // map columns a composite can fill

// warp 0 of the consumers: composite tile `tile` of the ray (nv real
// samples; zsh[S] holds the next tile's first depth unless `last`) onto
// the prefixes of the tiles before it (carry: static-only, combined) and
// the map sums macc, both in shared memory; the last tile writes the
// maps row
template <bool ENCODE_T, bool FLOW>
__device__ void composite(const Args& A, const float* planes, const float* zsh,
                          const float* vsh, const float* od, float* macc, float* carry,
                          int ray, int tile, int nv, bool last) {
  const int lane = threadIdx.x;
  constexpr int Q = S / 32;
  float z[Q], ts[Q], tt[Q], u[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int s = lane * Q + q;
    z[q] = zsh[s];
    const bool end = last && s == nv - 1;  // the ray's last sample
    const float dz = zsh[s + 1] - zsh[s];
    const float ds = end ? 100.f : dz;
    const float dt = end ? 1e-3f : dz;
    ts[q] = s < nv ? ds * softplus(planes[P_SSIG * S + s]) : 0.f;
    if (ENCODE_T && s < nv) {
      float sig = planes[P_TSIG * S + s];
      if (A.vis_in && vsh[s] == 0.f) sig = -10.f;
      tt[q] = dt * softplus(sig);
    } else {
      tt[q] = 0.f;
    }
    u[q] = ts[q] + tt[q];
  }
  // exclusive prefix sums of tau_s and tau_s + tau_t over the ray
  float loc_s = 0.f, loc_u = 0.f;
#pragma unroll
  for (int q = 0; q < Q; ++q) { loc_s += ts[q]; loc_u += u[q]; }
  float inc_s = loc_s, inc_u = loc_u;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float vs = __shfl_up_sync(0xffffffffu, inc_s, off);
    const float vu = __shfl_up_sync(0xffffffffu, inc_u, off);
    if (lane >= off) { inc_s += vs; inc_u += vu; }
  }
  float cs = inc_s - loc_s, cu = inc_u - loc_u;
  if (tile > 0) {
    cs += carry[0];
    cu += carry[1];
  }
  const float tot_s = __shfl_sync(0xffffffffu, inc_s, 31);
  const float tot_u = __shfl_sync(0xffffffffu, inc_u, 31);

  float m[NM];
#pragma unroll
  for (int i = 0; i < NM; ++i) m[i] = 0.f;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int s = lane * Q + q;
    if (s >= nv) continue;
    const float sr = planes[P_SR * S + s], sg = planes[P_SG * S + s],
                sb = planes[P_SB * S + s];
    const float sw_only = (1.f - expf(-ts[q])) * expf(-cs);  // static-only
    if (!ENCODE_T) {
      m[0] += sw_only * sr; m[1] += sw_only * sg; m[2] += sw_only * sb;
      m[3] += sw_only * z[q];
    } else {
      const float T = expf(-cu);
      const float sw = (1.f - expf(-ts[q])) * T;
      const float tw = (1.f - expf(-tt[q])) * T;
      const float w = (1.f - expf(-u[q])) * T;
      const float tr = planes[P_TR * S + s], tg = planes[P_TG * S + s],
                  tb = planes[P_TB * S + s];
      m[0] += sw * sr + tw * tr; m[1] += sw * sg + tw * tg;
      m[2] += sw * sb + tw * tb; m[3] += w * z[q];
      m[4] += tw * tr; m[5] += tw * tg; m[6] += tw * tb; m[7] += tw;
      m[8] += sw_only * sr; m[9] += sw_only * sg; m[10] += sw_only * sb;
      m[11] += sw_only * z[q];
      if (FLOW) {
        m[12] += w * (od[0] + od[3] * z[q]);
        m[13] += w * (od[1] + od[4] * z[q]);
        m[14] += w * (od[2] + od[5] * z[q]);
        const bool far = z[q] > A.z_far;
#pragma unroll
        for (int c = 0; c < 6; ++c)
          m[15 + c] += far ? 0.f : w * planes[(P_FW0 + c) * S + s];
      }
    }
    cs += ts[q];
    cu += u[q];
  }
  const int n_used = ENCODE_T ? (FLOW ? 21 : 12) : 4;
#pragma unroll
  for (int i = 0; i < NM; ++i) {
    if (i < n_used) {
      const float v = warp_sum(m[i]);
      if (lane == 0) macc[i] = tile == 0 ? v : macc[i] + v;
    }
  }
  if (lane == 0) {
    carry[0] = tile == 0 ? tot_s : carry[0] + tot_s;
    carry[1] = tile == 0 ? tot_u : carry[1] + tot_u;
  }
  __syncwarp();
  if (!last) return;
  float* orow = A.out + size_t(ray) * A.n_map;
  if (lane < n_used) orow[lane] = macc[lane];
  for (int i = n_used + lane; i < A.n_map; i += 32) orow[i] = 0.f;
}

template <bool ENCODE_T, bool FLOW>
__global__ void __launch_bounds__(wg::NTHR, 1)
planar_eval_comp_kernel(const __grid_constant__ Params P) {
  // the dynamic shared memory starts 1024-byte aligned (the swizzle atoms
  // and TMA boxes need it); pointers derived from it stay in the shared
  // space, so the compiler emits shared loads and stores
  extern __shared__ __align__(1024) unsigned char sm[];
  if ((wg::saddr(sm) & 1023u) != 0) __trap();
  const Args& A = P.a;
  const uint32_t ring = wg::saddr(sm + wg::OFF_RING);
  const uint32_t bars = wg::saddr(sm + wg::OFF_BAR);
  const int tid = threadIdx.x;
  WG_STAMP(0);
  if (tid == 0) wg::init_ring(bars);
  __syncthreads();

  const int ray = blockIdx.x;
  const int n_tiles = tiles_of(A.n_samples);  // run-time: any S >= 1
  float* ray_b = reinterpret_cast<float*>(sm + wg::OFF_RAYB);
  const wg::Staged st = wg::staged(sm);

  if (tid >= wg::NCONS) {
    // ---- producer warpgroup: one thread streams the weight slabs, three
    // warps stage the parameters and the ray's static_dir bias ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == wg::NCONS) {
      wg::produce(P.maps, ring, bars, true, A.use_viewdir != 0, ENCODE_T, n_tiles);
    } else if (tid >= wg::HELP0) {
      const int h = tid - wg::HELP0;
      wg::stage_params(st, A.W, A.B, FLOW ? 10 : 4, h);
      if (h == 0) WG_STAMP_ANY(10);
      wg::bar_arrive(wg::BAR_PARAMS, wg::NCONS + wg::NHELP);
      if (A.use_viewdir) {
        wg::dir_bias(A.W[W_SDIR], A.B[W_SDIR], A.dir + size_t(ray) * A.dir_w,
                     A.dir_w, A.encode_a ? A.a + size_t(ray) * A.n_a : nullptr,
                     A.n_a, ray_b, h);
        if (h == 0) WG_STAMP_ANY(11);
        wg::bar_arrive(wg::BAR_DIR, wg::NCONS + wg::NHELP);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  float* planes = reinterpret_cast<float*>(sm + wg::OFF_PLANES);
  // per-ray inputs: a tile's depths (+ the next tile's first), visibility,
  // o and d, the map sums and the prefixes carried across tiles
  float* zsh = reinterpret_cast<float*>(sm + wg::OFF_EXTRA);
  float* vsh = zsh + S + 4;
  float* od = vsh + S;
  float* macc = od + 8;
  float* carry = macc + NM;
  static_assert((2 * S + 12 + NM + 2) * 4 <= wg::EXTRA_BYTES, "the ray's inputs fit");
  unsigned char* act = sm + wg::OFF_ACT;
  unsigned char* pe = sm + wg::OFF_PE;
  const int g = tid >> 7;
  const uint32_t pe_g = wg::saddr(pe) + g * wg::WG_ROWS_BYTES;
  const uint32_t act_g = wg::saddr(act) + g * wg::WG_ROWS_BYTES;
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  wg::Pipe p;

  // One tile of the ray. The first runs as its own instance, which waits
  // for the staged parameters and the dir bias (BAR_PARAMS, BAR_DIR) where
  // it first reads them; the others run in a loop of a run-time count
  // without those waits: a wait under a run-time condition inside the loop
  // made ptxas serialize every wgmma of the kernel (C7520).
  auto run_tile = [&](int tile, auto first) {
    constexpr bool FIRST = decltype(first)::value;
    const int s0 = tile * S;
    const bool last = tile == n_tiles - 1;
    const int nv = min(S, A.n_samples - s0);  // real samples of the tile
    const size_t zr = size_t(ray) * A.n_samples + s0;
    if (tid < S) {
      const size_t r = zr + min(tid, nv - 1);  // rows past the ray repeat its last
      zsh[tid] = A.zs[r];
      vsh[tid] = A.vis_in ? A.vis[r] : 1.f;
    } else if (tid == S) {
      zsh[S] = last ? 0.f : A.zs[zr + S];
    } else if (FIRST && tid <= S + 6) {
      const int c = tid - S - 1;
      od[c] = c < 3 ? A.o[ray * 3 + c] : A.d[ray * 3 + c - 3];
    }
    wg::consumers_sync();
    WG_STAMP(8);

    // ---- posenc tile (+ time latent lanes for the transient tower; the
    // static tower's padded weight rows there are zero) ----
    wg::posenc_tile<wg::PE_RAY>(pe, A.freqs, A.xyz_w,
                                ENCODE_T ? A.t + size_t(ray) * A.n_tau : nullptr, A.n_tau,
                                nullptr, od, zsh);
    WG_STAMP(9);
    wg::fence_async_smem();
    wg::consumers_sync();
    if constexpr (FIRST) wg::bar_sync(wg::BAR_PARAMS, wg::NCONS + wg::NHELP);
    WG_STAMP(1);

    // ---- static tower + sigma (layer 7's epilogue), final, dir, rgb ----
    wg::tower<true>(d, p, ring, bars, pe_g, act_g, act, g, st.tower_bias(false),
                        st.w_sig(), st.hb, planes + P_SSIG * S);
    wg::mma_layer(d, p, ring, bars, pe_g, 0, act_g, WID);
    if (A.use_viewdir) {
      // static_xyz_final (linear), bf16-rounded, in place
      wg::epilogue<false, true, 0>(d, st.tower_bias(false) + 8 * WID, act, g, nullptr,
                                   nullptr, nullptr);
      wg::mma_layer(d, p, ring, bars, pe_g, 0, act_g, WID);
      if constexpr (FIRST) wg::bar_sync(wg::BAR_DIR, wg::NCONS + wg::NHELP);
      wg::epilogue<true, false, 3>(d, ray_b, act, g, st.w_rgb(), st.hb + 1,
                                   planes + P_SR * S);
    } else {
      wg::epilogue<false, false, 3>(d, st.tower_bias(false) + 8 * WID, act, g,
                                    st.w_rgb(), st.hb + 1, planes + P_SR * S);
    }

    WG_STAMP(2);
    // ---- transient tower + packed heads [sigma, rgb(3), fw(3), bw(3)] ----
    if (ENCODE_T) {
      wg::tower<false>(d, p, ring, bars, pe_g, act_g, act, g, st.tower_bias(true),
                           nullptr, nullptr, nullptr);
      wg::mma_layer(d, p, ring, bars, pe_g, 0, act_g, WID);
      wg::epilogue<false, false, FLOW ? 10 : 4>(d, st.tower_bias(true) + 8 * WID, act,
                                                 g, st.w_th(), st.hb + 4,
                                                 planes + P_TSIG * S);
    }
    wg::wg_sync(g);
    WG_STAMP(3);
    // head activations on this warpgroup's rows
    const int t = tid & 127;
    if (t < 64) {
      const int s = 64 * g + t;
#pragma unroll
      for (int c = 0; c < 3; ++c) planes[(P_SR + c) * S + s] = sigmoid(planes[(P_SR + c) * S + s]);
      if (ENCODE_T) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          planes[(P_TR + c) * S + s] = sigmoid(planes[(P_TR + c) * S + s]);
        if (FLOW) {
#pragma unroll
          for (int c = 0; c < 6; ++c)
            planes[(P_FW0 + c) * S + s] = A.flow_scale * tanhf(planes[(P_FW0 + c) * S + s]);
        }
      }
    }
    wg::consumers_sync();

    if (tid < 32)
      composite<ENCODE_T, FLOW>(A, planes, zsh, vsh, od, macc, carry, ray, tile, nv, last);
    wg::consumers_sync();  // the tile's planes and depths are read
  };
  run_tile(0, std::true_type{});
#pragma unroll 1
  for (int tile = 1; tile < n_tiles; ++tile) run_tile(tile, std::false_type{});

  WG_STAMP(4);
}

cudaError_t launch_variant(const Params& P, bool encode_t, bool flow, cudaStream_t s) {
  const int n = P.a.n_rays;
  if (!encode_t) return wg::launch(planar_eval_comp_kernel<false, false>, P, n, s);
  if (flow) return wg::launch(planar_eval_comp_kernel<true, true>, P, n, s);
  return wg::launch(planar_eval_comp_kernel<true, false>, P, n, s);
}

}  // namespace

extern "C" int nsff_planar_eval_comp(
    const void* o, const void* d, const void* zs, const void* vis,
    const void* dir, const void* a, const void* t,
    const void* const* w, const void* const* b, void* out,
    int n_rays, int n_samples, int xyz_w, int dir_w, int n_a,
    const float* freqs, int n_freqs,
    int encode_t, int flow, int use_viewdir, int encode_a, int vis_in,
    float z_far, float flow_scale, int n_tau, int n_map, void* stream) {
  if (n_samples < 1 || n_freqs > MAXF ||
      n_map < (encode_t ? (flow ? 21 : 12) : 4))
    return int(cudaErrorInvalidValue);
  Params P;
  memset(&P, 0, sizeof(P));
  Args& A = P.a;
  A.o = static_cast<const float*>(o);
  A.d = static_cast<const float*>(d);
  A.zs = static_cast<const float*>(zs);
  A.vis = static_cast<const float*>(vis);
  A.dir = static_cast<const float*>(dir);
  A.a = static_cast<const float*>(a);
  A.t = static_cast<const float*>(t);
  for (int i = 0; i < NSLOT; ++i) {
    A.W[i] = static_cast<const bf16*>(w[i]);
    A.B[i] = static_cast<const float*>(b[i]);
  }
  if (!encode_t)
    for (int i = W_T0; i < NSLOT; ++i) A.W[i] = nullptr;  // no transient maps
  if (!use_viewdir) A.W[W_SDIR] = nullptr;
  A.out = static_cast<float*>(out);
  A.n_rays = n_rays; A.n_samples = n_samples;
  A.xyz_w = xyz_w; A.dir_w = dir_w; A.n_a = n_a;
  A.n_tau = n_tau; A.n_map = n_map;
  A.use_viewdir = use_viewdir; A.encode_a = encode_a; A.vis_in = vis_in;
  A.z_far = z_far; A.flow_scale = flow_scale;
  for (int i = 0; i < MAXF; ++i) A.freqs[i] = i < n_freqs ? freqs[i] : 0.f;
  if (!wg::encode_maps(P.maps, A.W)) return int(cudaErrorInvalidValue);
  return int(launch_variant(P, encode_t != 0, flow != 0,
                            static_cast<cudaStream_t>(stream)));
}

#ifdef WG_PROFILE
extern "C" int nsff_prof_read(void* host, int n) {
  return int(cudaMemcpyFromSymbol(host, wg::wg_prof, size_t(n) * 8));
}
extern "C" int nsff_prof_clear() {
  static unsigned long long zero[4096 * 16];
  return int(cudaMemcpyToSymbol(wg::wg_prof, zero, sizeof(zero)));
}
#endif
