// Composited no-grad NSFF evaluator for Hopper (sm_90a).
//
// Replaces nsff_pl_tpu/ops/raymarch_kernel.py::make_planar_nerf_eval_comp
// (the Pallas TPU kernel of the test-time render). For every ray: posenc of
// xyz = o + d*z at its S = 128 samples, the static and transient 8x256 ReLU
// towers (skip at layer 4; per-ray viewdir/appearance/time conditioning), the
// sigma/rgb/flow heads, and the volume compositing; it writes one row of
// n_map floats per ray. The layout of the maps row is comp_map_cols in
// ops/raymarch_kernel.py, whose planar_eval_comp_ref is the plain version.
//
// Bound: operations. A sample costs ~1.2 M bf16 MACs across both towers,
// against ~1 KB of input per ray, so the tensor cores and not memory bound
// it. Design (the tower blocks are shared with the train kernels,
// planar_tower.cuh): one CTA (8 warps) per ray; the ray's 128 samples are
// the M dimension of every layer. The (128, 128) posenc tile and two (128, 256)
// activation tiles stay in shared memory as bf16 (ping-pong), so no
// activation touches device memory. Weights (segment-padded (in, out) bf16,
// ~2.6 MB) stream from L2 straight into wmma fragments: each warp owns two
// 16-column strips of every layer, so a CTA reads each weight once, and
// holds both strips' accumulators (128 registers) so that every A fragment
// read from shared memory feeds two products. Matmuls are nvcuda::wmma
// bf16 16x16x16 with f32 accumulation; activations round to bf16 after each
// ReLU as on the TPU. Compositing (exclusive cumsum of tau
// over the 128 samples) runs in one warp with shuffles.
// wgmma, TMA-staged weights and several rays per CTA are later work.
//
// Plain C interface (loaded with ctypes); launches on the given stream and
// returns the cudaError_t of the launch.

#include "planar_tower.cuh"

using namespace planar;

namespace {

// per-sample head outputs kept in shared memory, one (S,) plane each
enum {
  P_SR = 0, P_SG, P_SB, P_SSIG, P_TSIG, P_TR, P_TG, P_TB,
  P_FW0, P_FW1, P_FW2, P_BW0, P_BW1, P_BW2, NPLANE
};

struct Args {
  const float* o; const float* d; const float* zs; const float* vis;
  const float* dir; const float* a; const float* t;
  const bf16* W[NSLOT]; const float* B[NSLOT];
  float* out;
  int n_rays, xyz_w, dir_w, n_a, n_tau, n_map;
  int use_viewdir, encode_a, vis_in;
  float z_far, flow_scale;
  float freqs[MAXF];
};

constexpr size_t SMEM_X = size_t(S) * LDX * sizeof(bf16);
constexpr size_t SMEM_H = size_t(S) * LDH * sizeof(bf16);
constexpr size_t SMEM_STAGE = size_t(NWARPS) * 256 * sizeof(float);
constexpr size_t SMEM_BYTES = SMEM_X + 2 * SMEM_H + SMEM_STAGE
    + WID * sizeof(float) + size_t(NPLANE) * S * sizeof(float)
    + 2 * S * sizeof(float);

template <bool ENCODE_T, bool FLOW>
__global__ void __launch_bounds__(NTHREADS, 1)
planar_eval_comp_kernel(const Args A) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xin = reinterpret_cast<bf16*>(smem);
  bf16* h0 = reinterpret_cast<bf16*>(smem + SMEM_X);
  bf16* h1 = reinterpret_cast<bf16*>(smem + SMEM_X + SMEM_H);
  float* stage = reinterpret_cast<float*>(smem + SMEM_X + 2 * SMEM_H);
  float* ray_b = stage + NWARPS * 256;
  float* planes = ray_b + WID;
  float* zsh = planes + NPLANE * S;
  float* vsh = zsh + S;

  const int ray = blockIdx.x;
  const int tid = threadIdx.x;
  const float o0 = A.o[ray * 3 + 0], o1 = A.o[ray * 3 + 1], o2 = A.o[ray * 3 + 2];
  const float d0 = A.d[ray * 3 + 0], d1 = A.d[ray * 3 + 1], d2 = A.d[ray * 3 + 2];
  const float* zrow = A.zs + size_t(ray) * S;
  for (int s = tid; s < S; s += NTHREADS) {
    zsh[s] = zrow[s];
    vsh[s] = A.vis_in ? A.vis[size_t(ray) * S + s] : 1.f;
  }
  __syncthreads();

  // ---- posenc tile (+ time latent lanes for the transient tower; the
  // static tower's padded weight rows there are zero) ----
  const float od[6] = {o0, o1, o2, d0, d1, d2};
  for (int e = tid; e < S * SEG; e += NTHREADS) {
    const int s = e / SEG, j = e % SEG;
    float v = 0.f;
    if (j < A.xyz_w) {
      v = posenc_val(A.freqs, od, nullptr, zsh[s], j);
    } else if (ENCODE_T && j < A.xyz_w + A.n_tau) {
      v = A.t[size_t(ray) * A.n_tau + (j - A.xyz_w)];
    }
    xin[s * LDX + j] = __float2bfloat16_rn(v);
  }
  // ---- per-ray viewdir/appearance bias of the static_dir layer ----
  if (A.use_viewdir)
    static_dir_bias(A.W[W_SDIR], A.B[W_SDIR], A.dir + size_t(ray) * A.dir_w,
                    A.dir_w, A.encode_a ? A.a + size_t(ray) * A.n_a : nullptr,
                    A.n_a, ray_b);
  __syncthreads();

  // ---- static tower + heads ----
  bf16* h = tower_fwd(A.W, A.B, W_S0, xin, h0, h1, stage, nullptr, 0);
  bf16* other = (h == h0) ? h1 : h0;
  head<1>(h, A.W[W_SSIG], A.B[W_SSIG], planes + P_SSIG * S);
  dense_fwd(h, A.W[W_SFIN], A.B[W_SFIN], false, other, nullptr,
            stage);  // static_xyz_final (linear), bf16-rounded
  __syncthreads();
  bf16* feat = other;
  if (A.use_viewdir) {
    dense_fwd(other, A.W[W_SDIR], ray_b, true, h, nullptr, stage);
    __syncthreads();
    feat = h;
  }
  head<3>(feat, A.W[W_SRGB], A.B[W_SRGB], planes + P_SR * S);
  __syncthreads();
  for (int e = tid; e < 3 * S; e += NTHREADS)
    planes[P_SR * S + e] = sigmoid(planes[P_SR * S + e]);

  // ---- transient tower + packed heads [sigma, rgb(3), fw(3), bw(3)] ----
  if (ENCODE_T) {
    __syncthreads();
    h = tower_fwd(A.W, A.B, W_T0, xin, h0, h1, stage, nullptr, 0);
    other = (h == h0) ? h1 : h0;
    dense_fwd(h, A.W[W_TFIN], A.B[W_TFIN], false, other, nullptr, stage);
    __syncthreads();
    head<FLOW ? 10 : 4>(other, A.W[W_THEAD], A.B[W_THEAD], planes + P_TSIG * S);
    __syncthreads();
    for (int e = tid; e < 3 * S; e += NTHREADS)
      planes[P_TR * S + e] = sigmoid(planes[P_TR * S + e]);
    if (FLOW)
      for (int e = tid; e < 6 * S; e += NTHREADS)
        planes[P_FW0 * S + e] = A.flow_scale * tanhf(planes[P_FW0 * S + e]);
  }
  __syncthreads();

  // ---- compositing: warp 0, lane l owns samples 4l..4l+3 ----
  if (tid >= 32) return;
  const int lane = tid;
  constexpr int Q = S / 32;
  float z[Q], ts[Q], tt[Q], u[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int s = lane * Q + q;
    z[q] = zsh[s];
    const float dz = (s < S - 1) ? zsh[s + 1] - zsh[s] : 0.f;
    const float ds = (s < S - 1) ? dz : 100.f;
    const float dt = (s < S - 1) ? dz : 1e-3f;
    ts[q] = ds * softplus(planes[P_SSIG * S + s]);
    if (ENCODE_T) {
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

  constexpr int NM = 21;
  float m[NM];
#pragma unroll
  for (int i = 0; i < NM; ++i) m[i] = 0.f;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int s = lane * Q + q;
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
        m[12] += w * (o0 + d0 * z[q]);
        m[13] += w * (o1 + d1 * z[q]);
        m[14] += w * (o2 + d2 * z[q]);
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
  float* orow = A.out + size_t(ray) * A.n_map;
#pragma unroll
  for (int i = 0; i < NM; ++i) {
    if (i < n_used) {
      const float v = warp_sum(m[i]);
      if (lane == 0) orow[i] = v;
    }
  }
  for (int i = n_used + lane; i < A.n_map; i += 32) orow[i] = 0.f;
}

template <bool ENCODE_T, bool FLOW>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kern = planar_eval_comp_kernel<ENCODE_T, FLOW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  kern<<<a.n_rays, NTHREADS, SMEM_BYTES, stream>>>(a);
  return cudaGetLastError();
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
  if (n_samples != S || n_freqs > MAXF || n_map < (encode_t ? (flow ? 21 : 12) : 4))
    return int(cudaErrorInvalidValue);
  Args A;
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
  A.out = static_cast<float*>(out);
  A.n_rays = n_rays; A.xyz_w = xyz_w; A.dir_w = dir_w; A.n_a = n_a;
  A.n_tau = n_tau; A.n_map = n_map;
  A.use_viewdir = use_viewdir; A.encode_a = encode_a; A.vis_in = vis_in;
  A.z_far = z_far; A.flow_scale = flow_scale;
  for (int i = 0; i < MAXF; ++i) A.freqs[i] = i < n_freqs ? freqs[i] : 0.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!encode_t) return int(launch<false, false>(A, s));
  if (flow) return int(launch<true, true>(A, s));
  return int(launch<true, false>(A, s));
}
