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
// 16 cotangent planes out); each plane is read or written once.
//
// Design, for any S >= 1: one warp per ray, which takes the ray in chunks
// of 32 QQ samples, QQ consecutive samples a lane, with nk = ceil(S / 256)
// chunks of QQ = ceil(S / (32 nk)) samples a lane (a template over QQ =
// 1..8, the access width and whether the ray is one whole chunk, which
// runs without masks or carries; S = 64, 128, 192 and 256 are one whole
// chunk of 2, 4, 6 and 8, S = 320 two of 5). Registers bound QQ, so a longer ray loops over chunks rather than
// holding more samples a lane. A lane's samples past the ray's last are
// masked: they read as zero, get zero deltas (so no optical thickness, no
// weight, no term in a scan or a sum) and are never stored. Loads and
// stores are 16 bytes when S and QQ are multiples of 4 and the planes are
// so aligned, 8 bytes when both are even, else 4 (warp_ray::access_width):
// a row of S = 33 or 100 floats does not keep 16-byte alignment. The
// scans along the ray are warp shuffles, carried from chunk to chunk: the
// forward takes the chunks in order with the prefix sums of u_c and the
// map sums carried in registers. The adjoint's reverse cumsum runs from
// the ray's end, but a chunk's transmittance needs the prefix of the
// chunks before it: with several chunks a first pass over them in order
// computes each chunk's prefix (the nine scan planes only) and keeps it in
// the chunk's first entry of the three transient-sigma cotangent planes;
// the second pass, from the last chunk down, reads it back before it
// overwrites those entries, and carries the trailing sums of g_T T down.
// The kernels are a few microseconds long at the training batch, so what
// bounds them is the latency of their loads: each starts every load of a
// chunk before any arithmetic (the forward all 21 planes, read-only
// loads), so a chunk pays one round trip to memory and not one per phase.
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
  int n_rays, n_samples;
};

// where a lane's QQ samples of chunk k of a ray lie
struct Lane {
  size_t base;  // its first sample in the (N, S) planes
  int s0;       // that sample's index on the ray
  int nv;       // its real samples (0..QQ)
};

// FULL: the ray is one whole chunk (S = 32 QQ): no sample masked, no carry
template <int QQ, bool FULL>
__device__ __forceinline__ Lane lane_of(const Args& A, int ray, int k, int lane) {
  Lane L;
  L.s0 = (32 * k + lane) * QQ;
  L.base = size_t(ray) * A.n_samples + L.s0;
  L.nv = FULL ? QQ : max(0, min(QQ, A.n_samples - L.s0));
  return L;
}

template <int QQ>
__device__ __forceinline__ int n_chunks(const Args& A) {
  return (A.n_samples + 32 * QQ - 1) / (32 * QQ);
}

// the planes of the forward quantities, loaded at once
template <int QQ>
struct In {
  RowT<QQ> z, sg[4], nz[4];  // sigma, noise: static, transient, two warps
  float z_next;              // the depth after the lane's last sample
};

template <int QQ, int VW>
__device__ __forceinline__ In<QQ> load_in(const Args& A, const Lane& L, int lane) {
  In<QQ> x;
  // lane 31's next depth is the next chunk's first: its load goes out with
  // the others, so that a chunk still pays one round trip to memory
  const float z_far = lane == 31 && L.s0 + QQ < A.n_samples
                          ? __ldg(A.in[I_ZS] + L.base + QQ) : 0.f;
  x.z = load_q<QQ, VW, true>(A.in[I_ZS], L.base, L.nv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x.sg[i] = load_q<QQ, VW, true>(A.in[I_SSIG + i], L.base, L.nv);
    x.nz[i] = load_q<QQ, VW, true>(A.in[I_NS + i], L.base, L.nv);
  }
  // the next lane's first depth
  const float z_next = __shfl_down_sync(0xffffffffu, x.z.v[0], 1);
  x.z_next = lane == 31 ? z_far : z_next;
  return x;
}

// the forward quantities both kernels need
template <int QQ>
struct Core {
  RowT<QQ> z, ds, dt, a_s;
  RowT<QQ> T[3], a[3], alpha[3];
};

// `cu`: the prefix sums of u_c over the ray's earlier chunks, advanced
// past this one
template <int QQ, bool FULL>
__device__ __forceinline__ Core<QQ> core(const Args& A, const In<QQ>& x, const Lane& L,
                                         int lane, float (&cu)[3]) {
  Core<QQ> k;
  k.z = x.z;
  // the spacings: to the next depth, the far deltas at the ray's last
  // sample, 0 past it (masked). A whole chunk's last sample is known at
  // compile time: comparing with the run-time count instead made the
  // adjoint at S = 128 15% slower on an H100 (scripts/time_compositing.py)
#pragma unroll
  for (int q = 0; q < QQ; ++q) {
    const int s = L.s0 + q;
    const float dz = (q < QQ - 1 ? k.z.v[q + 1] : x.z_next) - k.z.v[q];
    const bool far = s == (FULL ? 32 * QQ : A.n_samples) - 1;
    const bool real = FULL || s < A.n_samples;
    k.ds.v[q] = far ? STATIC_FAR_DELTA : (real ? dz : 0.f);
    k.dt.v[q] = far ? TRANSIENT_FAR_DELTA : (real ? dz : 0.f);
  }
  RowT<QQ> sp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < QQ; ++q) sp[i].v[q] = softplus(x.sg[i].v[q] + x.nz[i].v[q]);
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
    const RowT<QQ> cs = excl_cumsum(u, lane, cu[c]);
#pragma unroll
    for (int q = 0; q < QQ; ++q) k.T[c].v[q] = expf(-cs.v[q]);
  }
  return k;
}

template <int QQ, int VW, bool FULL>
__global__ void __launch_bounds__(32 * RAYS_PER_BLOCK)
comp_fwd_kernel(const Args A) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * RAYS_PER_BLOCK + (threadIdx.x >> 5);
  if (ray >= A.n_rays) return;
  float cu[3] = {0.f, 0.f, 0.f};
  float m[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) m[i] = 0.f;
  const int nk = FULL ? 1 : n_chunks<QQ>(A);
  for (int kc = 0; kc < nk; ++kc) {
    const Lane L = lane_of<QQ, FULL>(A, ray, kc, lane);
    // every load first: the 9 planes of the scans and the 12 rgb planes
    const In<QQ> x = load_in<QQ, VW>(A, L, lane);
    RowT<QQ> rgb[4][3];  // static, transient, two warps
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      rgb[0][c] = load_q<QQ, VW, true>(A.in[I_SRGB + c], L.base, L.nv);
      rgb[1][c] = load_q<QQ, VW, true>(A.in[I_TRGB + c], L.base, L.nv);
      rgb[2][c] = load_q<QQ, VW, true>(A.in[I_TRGB1 + c], L.base, L.nv);
      rgb[3][c] = load_q<QQ, VW, true>(A.in[I_TRGB2 + c], L.base, L.nv);
    }
    const Core<QQ> k = core<QQ, FULL>(A, x, L, lane, cu);
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
    for (int i = 0; i < NOUT; ++i) store<QQ, VW>(A.out[i], L.base, w[i], L.nv);
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
  }
  float* row = A.maps + size_t(ray) * NMAP;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const float v = warp_sum(m[i]);
    if (lane == 0) row[i] = v;
  }
  if (lane < NMAP - 10) row[10 + lane] = 0.f;
}

template <int QQ, int VW, bool FULL>
__global__ void __launch_bounds__(32 * RAYS_PER_BLOCK)
comp_bwd_kernel(const Args A) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * RAYS_PER_BLOCK + (threadIdx.x >> 5);
  if (ray >= A.n_rays) return;
  const int nk = FULL ? 1 : n_chunks<QQ>(A);
  // pass 1 (several chunks): each chunk's prefix of u_c over the chunks
  // before it, kept by lane 0 in the chunk's first entry of out[1 + c]
  float cu[3] = {0.f, 0.f, 0.f};
  if (nk > 1) {
    for (int kc = 0; kc < nk; ++kc) {
      const Lane L = lane_of<QQ, FULL>(A, ray, kc, lane);
      if (lane == 0)
        for (int c = 0; c < 3; ++c) A.out[1 + c][L.base] = cu[c];
      const In<QQ> x = load_in<QQ, VW>(A, L, lane);
      core<QQ, FULL>(A, x, L, lane, cu);
    }
  }
  float gm[NMAP];
#pragma unroll
  for (int i = 0; i < NMAP; ++i)
    gm[i] = A.gmap != nullptr ? A.gmap[size_t(ray) * NMAP + i] : 0.f;
  // pass 2, from the last chunk down: the trailing sums of g_T T carried
  float trail[3] = {0.f, 0.f, 0.f};
  for (int kc = nk - 1; kc >= 0; --kc) {
    const Lane L = lane_of<QQ, FULL>(A, ray, kc, lane);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      cu[c] = nk > 1 ? __shfl_sync(0xffffffffu, lane == 0 ? A.out[1 + c][L.base] : 0.f, 0)
                     : 0.f;
    const In<QQ> x = load_in<QQ, VW>(A, L, lane);
    RowT<QQ> g_sw = load_q<QQ, VW>(A.g[0], L.base, L.nv);
    RowT<QQ> g_tw = load_q<QQ, VW>(A.g[1], L.base, L.nv);
    RowT<QQ> g_w = load_q<QQ, VW>(A.g[2], L.base, L.nv);
    RowT<QQ> g_tww1 = load_q<QQ, VW>(A.g[3], L.base, L.nv);
    RowT<QQ> g_tww2 = load_q<QQ, VW>(A.g[4], L.base, L.nv), g_sww1, g_sww2;
    const Core<QQ> k = core<QQ, FULL>(A, x, L, lane, cu);

    // map adjoints fold into the weight-plane cotangents + rgb cotangents
#pragma unroll
    for (int q = 0; q < QQ; ++q) {
      g_w.v[q] = g_w.v[q] + gm[3] * k.z.v[q];
      g_sww1.v[q] = 0.f;
      g_sww2.v[q] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const RowT<QQ> sr = load_q<QQ, VW>(A.in[I_SRGB + c], L.base, L.nv);
      const RowT<QQ> tr = load_q<QQ, VW>(A.in[I_TRGB + c], L.base, L.nv);
      const RowT<QQ> t1 = load_q<QQ, VW>(A.in[I_TRGB1 + c], L.base, L.nv);
      const RowT<QQ> t2 = load_q<QQ, VW>(A.in[I_TRGB2 + c], L.base, L.nv);
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
      store<QQ, VW>(A.out[4 + c], L.base, dsr, L.nv);
      store<QQ, VW>(A.out[7 + c], L.base, dtr, L.nv);
      store<QQ, VW>(A.out[10 + c], L.base, dt1, L.nv);
      store<QQ, VW>(A.out[13 + c], L.base, dt2, L.nv);
    }

    // per-composite transmittance adjoints (additive exp form); a masked
    // sample's g_T T is 0 (zero weights), so it adds nothing to a sum
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
      const RowT<QQ> rc = rev_excl_cumsum(gT, lane, trail[c]);
      RowT<QQ> dsig;
      const RowT<QQ> &sg = x.sg[1 + c], &nz = x.nz[1 + c];
#pragma unroll
      for (int q = 0; q < QQ; ++q) {
        const float u = gu.v[q] - rc.v[q];
        g_tau_s.v[q] = g_tau_s.v[q] + u + gs.v[q] * k.T[c].v[q] * (1.f - k.a_s.v[q]);
        const float gtau = u + gt.v[q] * k.T[c].v[q] * (1.f - k.a[c].v[q]);
        dsig.v[q] = gtau * k.dt.v[q] * sigmoid(sg.v[q] + nz.v[q]);
      }
      store<QQ, VW>(A.out[1 + c], L.base, dsig, L.nv);
    }
    RowT<QQ> dss;
#pragma unroll
    for (int q = 0; q < QQ; ++q)
      dss.v[q] = g_tau_s.v[q] * k.ds.v[q] * sigmoid(x.sg[0].v[q] + x.nz[0].v[q]);
    store<QQ, VW>(A.out[0], L.base, dss, L.nv);
  }
}

}  // namespace

// launch the forward or the adjoint at QQ samples a lane, VW floats an
// access, FULL when the ray is one whole chunk
template <int QQ, int VW, bool FULL>
static int launch(bool fwd, const Args& A, cudaStream_t s) {
  const int blocks = (A.n_rays + RAYS_PER_BLOCK - 1) / RAYS_PER_BLOCK;
  if (fwd)
    comp_fwd_kernel<QQ, VW, FULL><<<blocks, 32 * RAYS_PER_BLOCK, 0, s>>>(A);
  else
    comp_bwd_kernel<QQ, VW, FULL><<<blocks, 32 * RAYS_PER_BLOCK, 0, s>>>(A);
  return int(cudaGetLastError());
}

template <int QQ>
static int launch_q(bool fwd, const Args& A, int vw, bool full, cudaStream_t s) {
  if constexpr (QQ % 4 == 0)
    if (vw == 4)
      return full ? launch<QQ, 4, true>(fwd, A, s) : launch<QQ, 4, false>(fwd, A, s);
  if constexpr (QQ % 2 == 0)
    if (vw == 2)
      return full ? launch<QQ, 2, true>(fwd, A, s) : launch<QQ, 2, false>(fwd, A, s);
  return full ? launch<QQ, 1, true>(fwd, A, s) : launch<QQ, 1, false>(fwd, A, s);
}

// the ray in nk = ceil(S / 256) chunks of 32 QQ samples, QQ = ceil(S / (32
// nk)) <= 8; `align`: the OR of every plane's address
static int launch_samples(bool fwd, Args& A, uintptr_t align, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int S = A.n_samples;
  if (S < 1) return int(cudaErrorInvalidValue);
  const int nk = (S + 255) / 256, qq = (S + 32 * nk - 1) / (32 * nk);
  const int vw = access_width(S, qq, align);
  const bool full = S == 32 * qq;
  switch (qq) {
    case 1: return launch_q<1>(fwd, A, vw, full, s);
    case 2: return launch_q<2>(fwd, A, vw, full, s);
    case 3: return launch_q<3>(fwd, A, vw, full, s);
    case 4: return launch_q<4>(fwd, A, vw, full, s);
    case 5: return launch_q<5>(fwd, A, vw, full, s);
    case 6: return launch_q<6>(fwd, A, vw, full, s);
    case 7: return launch_q<7>(fwd, A, vw, full, s);
    case 8: return launch_q<8>(fwd, A, vw, full, s);
  }
  return int(cudaErrorInvalidValue);
}

static uintptr_t addr_or(const void* const* p, int n) {
  uintptr_t a = 0;
  for (int i = 0; i < n; ++i) a |= reinterpret_cast<uintptr_t>(p[i]);
  return a;
}

extern "C" int nsff_planar_comp_fwd(const void* const* ins,
                                    void* const* outs, void* maps,
                                    int n_rays, int n_samples, void* stream) {
  Args A = {};
  for (int i = 0; i < NIN; ++i) A.in[i] = static_cast<const float*>(ins[i]);
  for (int i = 0; i < NOUT; ++i) A.out[i] = static_cast<float*>(outs[i]);
  A.maps = static_cast<float*>(maps);
  A.n_rays = n_rays;
  A.n_samples = n_samples;
  return launch_samples(true, A, addr_or(ins, NIN) | addr_or(outs, NOUT), stream);
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
  A.n_samples = n_samples;
  return launch_samples(false, A, addr_or(ins, NIN) | addr_or(g, NOUT) |
                                      addr_or(douts, NGRAD), stream);
}
