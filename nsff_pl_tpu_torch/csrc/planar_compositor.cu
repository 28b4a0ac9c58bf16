// Fused three-way planar compositor for Hopper (sm_90a): forward and adjoint.
//
// Replaces nsff_pl_tpu/ops/compositing_planar_kernel.py::make_planar_compositor
// (two Pallas TPU kernels). The planar train path composites the main
// evaluation and the two warped evaluations together; they share the
// static optical thickness tau_s = delta_s * softplus(sigma_s + noise). For
// each composite c, u_c = tau_s + tau_c and T_c = exp(-exclusive_cumsum(u_c)).
// The forward writes five weight planes and an (N, 16) maps tile; the
// adjoint is the TPU kernel's: the cotangent of u_c is the direct alpha
// terms minus the reverse exclusive cumsum of g_T * T (no 1/(1 - alpha)
// division), and softplus' = sigmoid. The plain versions are
// planar_compositor_fwd_ref / planar_compositor_bwd_ref in
// ops/compositing_planar_kernel.py.
//
// Bound: bytes. A few dozen flops per sample against 21 input planes (and
// 16 cotangent planes out); each plane is read or written once. Design:
// one warp per ray, S / 32 consecutive samples per lane (a template over
// 2, 4, 6 and 8 for S = 64, 128, 192 and 256; 16- or 8-byte loads and
// stores), the scans over the ray's samples as warp shuffles.
// The kernels are a few microseconds long, so what bounds them is the
// latency of their loads: each starts every load it needs before any
// arithmetic (the forward all 21 planes, read-only loads), so a ray pays
// one round trip to memory and not one per phase.
//
// Plain C interface (loaded with ctypes); launches on the given stream and
// returns the cudaError_t of the launch.

#include "warp_ray.cuh"

using namespace warp_ray;

namespace {

constexpr int NIN = 21, NOUT = 5, NMAP = 16, NGRAD = 16;
constexpr int RAYS_PER_BLOCK = 4;

enum {
  I_ZS = 0, I_SSIG, I_TSIG, I_TSIG1, I_TSIG2, I_NS, I_NT, I_NW1, I_NW2,
  I_SRGB = 9, I_TRGB = 12, I_TRGB1 = 15, I_TRGB2 = 18
};

struct Args {
  const float* in[NIN];
  const float* g[NOUT];  // null = zero cotangent
  const float* gmap;     // null = zero cotangent
  float* out[NGRAD];     // forward: NOUT weight planes; adjoint: NGRAD planes
  float* maps;
  int n_rays;
};


// the planes of the forward quantities, loaded at once
template <int QQ>
struct In {
  RowT<QQ> z, sg[4], nz[4];  // sigma, noise: static, transient, two warps
};

template <int QQ>
__device__ __forceinline__ In<QQ> load_in(const Args& A, size_t base) {
  In<QQ> x;
  x.z = load_q<QQ, true>(A.in[I_ZS], base);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x.sg[i] = load_q<QQ, true>(A.in[I_SSIG + i], base);
    x.nz[i] = load_q<QQ, true>(A.in[I_NS + i], base);
  }
  return x;
}

// the forward quantities both kernels need
template <int QQ>
struct Core {
  RowT<QQ> z, ds, dt, a_s;
  RowT<QQ> T[3], a[3], alpha[3];
};

template <int QQ>
__device__ __forceinline__ Core<QQ> core(const In<QQ>& x, int lane) {
  Core<QQ> k;
  k.z = x.z;
  RowT<QQ> sp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < QQ; ++q) sp[i].v[q] = softplus(x.sg[i].v[q] + x.nz[i].v[q]);
  deltas(k.z, lane, k.ds, k.dt);
  RowT<QQ> tau_s, tau[3];
#pragma unroll
  for (int q = 0; q < QQ; ++q) {
    tau_s.v[q] = k.ds.v[q] * sp[0].v[q];
    k.a_s.v[q] = 1.f - expf(-tau_s.v[q]);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    RowT<QQ> u;
#pragma unroll
    for (int q = 0; q < QQ; ++q) {
      tau[c].v[q] = k.dt.v[q] * sp[1 + c].v[q];
      u.v[q] = tau_s.v[q] + tau[c].v[q];
      k.a[c].v[q] = 1.f - expf(-tau[c].v[q]);
      k.alpha[c].v[q] = 1.f - expf(-u.v[q]);
    }
    const RowT<QQ> cu = excl_cumsum(u, lane);
#pragma unroll
    for (int q = 0; q < QQ; ++q) k.T[c].v[q] = expf(-cu.v[q]);
  }
  return k;
}

template <int QQ>
__global__ void __launch_bounds__(32 * RAYS_PER_BLOCK)
comp_fwd_kernel(const Args A) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * RAYS_PER_BLOCK + (threadIdx.x >> 5);
  if (ray >= A.n_rays) return;
  const size_t base = size_t(ray) * (32 * QQ) + lane * QQ;
  // every load first: the 9 planes of the scans and the 12 rgb planes
  const In<QQ> x = load_in<QQ>(A, base);
  RowT<QQ> rgb[4][3];  // static, transient, two warps
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    rgb[0][c] = load_q<QQ, true>(A.in[I_SRGB + c], base);
    rgb[1][c] = load_q<QQ, true>(A.in[I_TRGB + c], base);
    rgb[2][c] = load_q<QQ, true>(A.in[I_TRGB1 + c], base);
    rgb[3][c] = load_q<QQ, true>(A.in[I_TRGB2 + c], base);
  }
  const Core<QQ> k = core<QQ>(x, lane);
  RowT<QQ> w[NOUT], sw1, sw2;
#pragma unroll
  for (int q = 0; q < QQ; ++q) {
    w[0].v[q] = k.a_s.v[q] * k.T[0].v[q];
    w[1].v[q] = k.a[0].v[q] * k.T[0].v[q];
    w[2].v[q] = k.alpha[0].v[q] * k.T[0].v[q];
    w[3].v[q] = k.a[1].v[q] * k.T[1].v[q];
    w[4].v[q] = k.a[2].v[q] * k.T[2].v[q];
    sw1.v[q] = k.a_s.v[q] * k.T[1].v[q];
    sw2.v[q] = k.a_s.v[q] * k.T[2].v[q];
  }
#pragma unroll
  for (int i = 0; i < NOUT; ++i) store(A.out[i], base, w[i]);
  float m[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) m[i] = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const RowT<QQ> &sr = rgb[0][c], &tr = rgb[1][c], &t1 = rgb[2][c], &t2 = rgb[3][c];
#pragma unroll
    for (int q = 0; q < QQ; ++q) {
      m[c] += w[0].v[q] * sr.v[q] + w[1].v[q] * tr.v[q];
      m[4 + c] += sw1.v[q] * sr.v[q] + w[3].v[q] * t1.v[q];
      m[7 + c] += sw2.v[q] * sr.v[q] + w[4].v[q] * t2.v[q];
    }
  }
#pragma unroll
  for (int q = 0; q < QQ; ++q) m[3] += w[2].v[q] * k.z.v[q];
  float* row = A.maps + size_t(ray) * NMAP;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const float v = warp_sum(m[i]);
    if (lane == 0) row[i] = v;
  }
  if (lane < NMAP - 10) row[10 + lane] = 0.f;
}

template <int QQ>
__global__ void __launch_bounds__(32 * RAYS_PER_BLOCK)
comp_bwd_kernel(const Args A) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * RAYS_PER_BLOCK + (threadIdx.x >> 5);
  if (ray >= A.n_rays) return;
  const size_t base = size_t(ray) * (32 * QQ) + lane * QQ;
  const In<QQ> x = load_in<QQ>(A, base);
  RowT<QQ> g_sw = load_q<QQ>(A.g[0], base), g_tw = load_q<QQ>(A.g[1], base);
  RowT<QQ> g_w = load_q<QQ>(A.g[2], base), g_tww1 = load_q<QQ>(A.g[3], base);
  RowT<QQ> g_tww2 = load_q<QQ>(A.g[4], base), g_sww1, g_sww2;
  float gm[NMAP];
#pragma unroll
  for (int i = 0; i < NMAP; ++i)
    gm[i] = A.gmap != nullptr ? A.gmap[size_t(ray) * NMAP + i] : 0.f;
  const Core<QQ> k = core<QQ>(x, lane);

  // map adjoints fold into the weight-plane cotangents + rgb cotangents
#pragma unroll
  for (int q = 0; q < QQ; ++q) {
    g_w.v[q] = g_w.v[q] + gm[3] * k.z.v[q];
    g_sww1.v[q] = 0.f;
    g_sww2.v[q] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const RowT<QQ> sr = load_q<QQ>(A.in[I_SRGB + c], base), tr = load_q<QQ>(A.in[I_TRGB + c], base);
    const RowT<QQ> t1 = load_q<QQ>(A.in[I_TRGB1 + c], base), t2 = load_q<QQ>(A.in[I_TRGB2 + c], base);
    const float g0 = gm[c], g1 = gm[4 + c], g2 = gm[7 + c];
    RowT<QQ> dsr, dtr, dt1, dt2;
#pragma unroll
    for (int q = 0; q < QQ; ++q) {
      g_sw.v[q] = g_sw.v[q] + g0 * sr.v[q];
      g_tw.v[q] = g_tw.v[q] + g0 * tr.v[q];
      g_sww1.v[q] = g_sww1.v[q] + g1 * sr.v[q];
      g_tww1.v[q] = g_tww1.v[q] + g1 * t1.v[q];
      g_sww2.v[q] = g_sww2.v[q] + g2 * sr.v[q];
      g_tww2.v[q] = g_tww2.v[q] + g2 * t2.v[q];
      const float sw = k.a_s.v[q] * k.T[0].v[q];
      const float sw1 = k.a_s.v[q] * k.T[1].v[q];
      const float sw2 = k.a_s.v[q] * k.T[2].v[q];
      dsr.v[q] = g0 * sw + g1 * sw1 + g2 * sw2;
      dtr.v[q] = g0 * (k.a[0].v[q] * k.T[0].v[q]);
      dt1.v[q] = g1 * (k.a[1].v[q] * k.T[1].v[q]);
      dt2.v[q] = g2 * (k.a[2].v[q] * k.T[2].v[q]);
    }
    store(A.out[4 + c], base, dsr);
    store(A.out[7 + c], base, dtr);
    store(A.out[10 + c], base, dt1);
    store(A.out[13 + c], base, dt2);
  }

  // per-composite transmittance adjoints (additive exp form)
  RowT<QQ> g_tau_s;
#pragma unroll
  for (int q = 0; q < QQ; ++q) g_tau_s.v[q] = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const RowT<QQ>& gs = c == 0 ? g_sw : (c == 1 ? g_sww1 : g_sww2);
    const RowT<QQ>& gt = c == 0 ? g_tw : (c == 1 ? g_tww1 : g_tww2);
    RowT<QQ> gT, gu;
#pragma unroll
    for (int q = 0; q < QQ; ++q) {
      gT.v[q] = gs.v[q] * k.a_s.v[q] + gt.v[q] * k.a[c].v[q];
      gu.v[q] = 0.f;
      if (c == 0) {
        gT.v[q] = gT.v[q] + g_w.v[q] * k.alpha[c].v[q];
        gu.v[q] = g_w.v[q] * k.T[c].v[q] * (1.f - k.alpha[c].v[q]);
      }
      gT.v[q] = gT.v[q] * k.T[c].v[q];
    }
    const RowT<QQ> rc = rev_excl_cumsum(gT, lane);
    RowT<QQ> dsig;
    const RowT<QQ> &sg = x.sg[1 + c], &nz = x.nz[1 + c];
#pragma unroll
    for (int q = 0; q < QQ; ++q) {
      const float u = gu.v[q] - rc.v[q];
      g_tau_s.v[q] = g_tau_s.v[q] + u + gs.v[q] * k.T[c].v[q] * (1.f - k.a_s.v[q]);
      const float gtau = u + gt.v[q] * k.T[c].v[q] * (1.f - k.a[c].v[q]);
      dsig.v[q] = gtau * k.dt.v[q] * sigmoid(sg.v[q] + nz.v[q]);
    }
    store(A.out[1 + c], base, dsig);
  }
  RowT<QQ> dss;
#pragma unroll
  for (int q = 0; q < QQ; ++q)
    dss.v[q] = g_tau_s.v[q] * k.ds.v[q] * sigmoid(x.sg[0].v[q] + x.nz[0].v[q]);
  store(A.out[0], base, dss);
}

}  // namespace

// launch the forward or the adjoint at QQ = n_samples / 32 samples a lane
template <int QQ>
static int launch(bool fwd, const Args& A, cudaStream_t s) {
  const int blocks = (A.n_rays + RAYS_PER_BLOCK - 1) / RAYS_PER_BLOCK;
  if (fwd)
    comp_fwd_kernel<QQ><<<blocks, 32 * RAYS_PER_BLOCK, 0, s>>>(A);
  else
    comp_bwd_kernel<QQ><<<blocks, 32 * RAYS_PER_BLOCK, 0, s>>>(A);
  return int(cudaGetLastError());
}

static int launch_samples(bool fwd, const Args& A, int n_samples, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_samples) {
    case 64: return launch<2>(fwd, A, s);
    case 128: return launch<4>(fwd, A, s);
    case 192: return launch<6>(fwd, A, s);
    case 256: return launch<8>(fwd, A, s);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" int nsff_planar_comp_fwd(const void* const* ins,
                                    void* const* outs, void* maps,
                                    int n_rays, int n_samples, void* stream) {
  Args A = {};
  for (int i = 0; i < NIN; ++i) A.in[i] = static_cast<const float*>(ins[i]);
  for (int i = 0; i < NOUT; ++i) A.out[i] = static_cast<float*>(outs[i]);
  A.maps = static_cast<float*>(maps);
  A.n_rays = n_rays;
  return launch_samples(true, A, n_samples, stream);
}

extern "C" int nsff_planar_comp_bwd(const void* const* ins,
                                    const void* const* g,
                                    void* const* douts, const void* gmap,
                                    int n_rays, int n_samples, void* stream) {
  Args A = {};
  for (int i = 0; i < NIN; ++i) A.in[i] = static_cast<const float*>(ins[i]);
  for (int i = 0; i < NOUT; ++i) A.g[i] = static_cast<const float*>(g[i]);
  for (int i = 0; i < NGRAD; ++i) A.out[i] = static_cast<float*>(douts[i]);
  A.gmap = static_cast<const float*>(gmap);
  A.n_rays = n_rays;
  return launch_samples(false, A, n_samples, stream);
}
