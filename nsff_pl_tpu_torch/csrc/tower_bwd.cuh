// Backward of the port's tower evaluators, one branch (static or
// transient) per call, shared by planar_nerf_train.cu (planar layout:
// cotangent planes in, flow-plane cotangents out) and fused_nerf_train.cu
// (packed layout: a (rows, 16) cotangent in, a (rows, 3) xyz cotangent
// out, for either branch). Three launches per branch:
//  1. chain kernel, one CTA per ray: recompute the tower, writing every
//     activation tile to a global scratch buffer (one ray's nine tiles are
//     590 KB, more than a CTA's 227 KB of shared memory); backpropagate
//     through the heads and the tower with two ping-pong bf16 tiles in
//     shared memory, writing every bf16 dz tile to scratch and each
//     layer's per-ray bias-gradient partial (the column sums of the f32
//     dz); per-ray d(dir), d(a), d(t) and the point cotangents are
//     finished in the CTA. Scratch at batch 512 x 128 samples: ~0.7 GB per
//     branch call.
//  2. dW kernel: dW = A^T dz over all N*S rows for every layer, as a list
//     of GEMM jobs; 64x64 output tiles per CTA, the rows split in PSPLIT
//     parts, each part writing its own partial (no atomics).
//  3. reduction kernels: partials summed in a fixed order (split 0..P-1,
//     rays 0..N-1), so the gradients are bit-for-bit the same on every run.
#pragma once

#include "tower_ray.cuh"

namespace planar {

constexpr int LDG = 16;       // row pitch of the head-cotangent scratch
constexpr int PSPLIT = 8;     // row splits of the dW GEMMs

// backward epilogue: v = acc [+ r1g[row] * r1w[col]], zeroed where the
// forward activation mask_g[row][col] is not > 0; bf16(v) -> out_s and
// out_g; the column sums of the f32 v -> colsum_g[col] (this ray's bias
// gradient partial), in a fixed order
template <int NP>
__device__ __forceinline__ void epi_bwd(Acc (&acc)[NP][MT], int n0,
                                        const float* r1g, const bf16* r1w,
                                        const bf16* mask_g, bf16* out_s,
                                        bf16* out_g, float* colsum_g,
                                        float* stage) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* st = stage + warp * 256;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    float cs = 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      wmma::store_matrix_sync(st, acc[p][m], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = m * 16 + (e >> 4), col = n0 + p * 16 + (e & 15);
        float v = st[e];
        if (r1g != nullptr) v += r1g[row] * __bfloat162float(r1w[col]);
        if (mask_g != nullptr && !(__bfloat162float(mask_g[row * WID + col]) > 0.f))
          v = 0.f;
        const bf16 h = __float2bfloat16_rn(v);
        out_s[row * LDH + col] = h;
        out_g[row * WID + col] = h;
        cs += v;
      }
      __syncwarp();
    }
    cs += __shfl_xor_sync(0xffffffffu, cs, 16);
    if (lane < 16) colsum_g[n0 + p * 16 + lane] = cs;
  }
}

// ------------------------------- backward ------------------------------

// per-ray scratch of one branch (rows are ray-major, R = n_rays * S)
struct Scratch {
  bf16* act0;    // (R, SEG) tower input
  bf16* act;     // 8 x (R, WID): act[i] = output of layer i
  bf16* featA;   // (R, WID): static feat0b / transient tfeatb
  bf16* featB;   // (R, WID): static featb (viewdir)
  bf16* dz;      // 8 x (R, WID): bf16 cotangent of layer i's pre-activation
  bf16* dzA;     // (R, WID): static_dir's dz (viewdir)
  bf16* dzF;     // (R, WID): bf16 cotangent of the *_final output
  bf16* gh;      // (R, LDG): bf16 head cotangents (rgb | packed heads)
  bf16* ghs;     // (R, LDG): bf16 static sigma cotangent in column 0
  bf16* dirb;    // (N, SEG): bf16 direction embedding, zero-padded
  bf16* ab;      // (N, SEG): bf16 appearance embedding, zero-padded
  bf16* dzrb;    // (N, WID): bf16 per-ray sums of static_dir's dz
  float* dbp;    // NSLOT x (N, WID): per-ray bias-gradient partials
  float* part;   // PSPLIT x (dW elements): dW partials
};

struct BwdArgs {
  Common c;
  // cotangents of the branch's outputs (null = zero): sample r of slot k
  // is g[k][r * g_stride] (planes: stride 1; columns of a packed (rows, 16)
  // cotangent: stride 16). Static slots: rgb(3), sigma; transient: rgb(3),
  // sigma, fw(3), bw(3).
  const float* g[NHEAD];
  int g_stride;
  Scratch sc;
  float* ddir; float* da; float* dt;
  // cotangent of the sample points, channel c of sample r at
  // dflows[c][r * dx_stride] (null = not wanted); round_dx: bf16 operands
  // in its selector product, as the packed TPU kernel
  float* dflows[3];
  int dx_stride, round_dx;
};

// thread per column c of a (S, WID) tile: v[r][c] = sum_j gq[j][r] * W[c][j]
// with bf16 gq (NJ columns of W); masked by mask_s (bf16 tile, > 0) when
// given; bf16(v) -> out_s, out_g; returns the column sum of the f32 v
template <int NJ>
__device__ float narrow_bwd(const float* gq, const bf16* W, const bf16* mask_s,
                            bf16* out_s, bf16* out_g) {
  const int c = threadIdx.x;  // NTHREADS == WID
  float w[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) w[j] = __bfloat162float(W[c * NJ + j]);
  float cs = 0.f;
  for (int r = 0; r < S; ++r) {
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) v += gq[j * S + r] * w[j];
    if (mask_s != nullptr && !(__bfloat162float(mask_s[r * LDH + c]) > 0.f)) v = 0.f;
    const bf16 h = __float2bfloat16_rn(v);
    out_s[r * LDH + c] = h;
    out_g[r * WID + c] = h;
    cs += v;
  }
  return cs;
}

// per-ray column sums of nq per-sample planes (one warp each, fixed order)
__device__ void plane_sums(const float* q, int nq, float* dst) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = warp; k < nq; k += NWARPS) {
    float v = 0.f;
    for (int s = lane; s < S; s += 32) v += q[k * S + s];
    v = warp_sum(v);
    if (lane == 0) dst[k] = v;
  }
}

template <bool STATIC>
__global__ void __launch_bounds__(NTHREADS, 1)
train_bwd_chain_kernel(const BwdArgs G) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Common& A = G.c;
  const Scratch& X = G.sc;
  const Smem m = carve(smem);
  const int ray = blockIdx.x, tid = threadIdx.x, warp = tid >> 5;
  const size_t R = size_t(A.n_rays) * S;
  const size_t row0 = size_t(ray) * S;
  const bool viewdir = STATIC && A.use_viewdir;
  const bool with_flow = A.xyz == nullptr && A.flows[0] != nullptr;
  const bool want_dx = G.dflows[0] != nullptr;
  ray_setup(A, m, ray, !STATIC, viewdir, with_flow);

  const int w0 = STATIC ? W_S0 : W_T0;
  auto dbp = [&](int slot) { return X.dbp + (size_t(slot) * A.n_rays + ray) * WID; };
  bf16* act_r = X.act + row0 * WID;  // act[i] of this ray at act_r + i * R * WID
  bf16* dz_r = X.dz + row0 * WID;

  // cotangent planes, the tower input, the padded per-ray embeddings
  const int ng = STATIC ? 4 : NHEAD;
  for (int e = tid; e < ng * S; e += NTHREADS) {
    const int k = e / S, s = e % S;
    m.pl[k * S + s] = G.g[k] != nullptr ? G.g[k][(row0 + s) * G.g_stride] : 0.f;
  }
  for (int e = tid; e < S * SEG; e += NTHREADS)
    X.act0[row0 * SEG + e] = m.xin[(e / SEG) * LDX + e % SEG];
  if (viewdir)
    for (int j = tid; j < SEG; j += NTHREADS) {
      X.dirb[size_t(ray) * SEG + j] = __float2bfloat16_rn(
          j < A.dir_w ? A.dir[size_t(ray) * A.dir_w + j] : 0.f);
      if (A.encode_a)
        X.ab[size_t(ray) * SEG + j] = __float2bfloat16_rn(
            j < A.n_a ? A.a[size_t(ray) * A.n_a + j] : 0.f);
    }

  // ---- recompute the tower, keeping every activation in scratch ----
  bf16* h = tower_fwd(A.W, A.B, w0, m.xin, m.h0, m.h1, m.stage, act_r, R * WID);
  bf16* other = (h == m.h0) ? m.h1 : m.h0;
  const bf16* act8_r = act_r + 7 * R * WID;
  bf16* gh_r = X.gh + row0 * LDG;

  if (STATIC) {
    // feat0b = bf16(h8 @ Wfin + b); featb = bf16(relu(feat0b @ Wdir + ray_b))
    dense_fwd(h, A.W[W_SFIN], A.B[W_SFIN], false, other,
              X.featA + row0 * WID, m.stage);
    __syncthreads();
    bf16* feat = other;
    if (viewdir) {
      dense_fwd(other, A.W[W_SDIR], m.ray_b, true, h, X.featB + row0 * WID,
                m.stage);
      __syncthreads();
      feat = h;
    }
    head<3>(feat, A.W[W_SRGB], A.B[W_SRGB], m.pl + 4 * S);
    __syncthreads();
    // g_srgb = g * s * (1 - s); g_ssig; bf16 copies for the dW jobs
    for (int s = tid; s < S; s += NTHREADS) {
      for (int c = 0; c < 3; ++c) {
        const float sg = sigmoid(m.pl[(4 + c) * S + s]);
        const float gv = m.pl[c * S + s] * sg * (1.f - sg);
        m.pl[c * S + s] = gv;
        m.pl[(8 + c) * S + s] = bfr(gv);
      }
      m.r1g[s] = bfr(m.pl[3 * S + s]);
      for (int c = 0; c < LDG; ++c) {
        gh_r[s * LDG + c] = __float2bfloat16_rn(c < 3 ? m.pl[c * S + s] : 0.f);
        X.ghs[(row0 + s) * LDG + c] = __float2bfloat16_rn(c == 0 ? m.pl[3 * S + s] : 0.f);
      }
    }
    __syncthreads();
    if (warp == 0) {  // bias partials of static_rgb and static_sigma
      float* d_rgb = dbp(W_SRGB);
      float* d_sig = dbp(W_SSIG);
      for (int c = 0; c < 4; ++c) {
        float v = 0.f;
        for (int s = threadIdx.x; s < S; s += 32) v += m.pl[c * S + s];
        v = warp_sum(v);
        if (threadIdx.x == 0) (c < 3 ? d_rgb[c] : d_sig[0]) = v;
      }
    }
    // dfeat = bf16(g_srgb) @ Wrgb^T (thread per column)
    if (viewdir) {
      // dz = dfeat * (feat > 0) -> other (feat0b lives in scratch)
      const float cs = narrow_bwd<3>(m.pl + 8 * S, A.W[W_SRGB], feat, other,
                                     X.dzA + row0 * WID);
      dbp(W_SDIR)[tid] = cs;
      const float zr = bfr(cs);  // dzr = ray sum of dz, rounded
      X.dzrb[size_t(ray) * WID + tid] = __float2bfloat16_rn(cs);
      m.ray_b[tid] = zr;
      __syncthreads();
      // ddir = dzrb @ Wdir[256:256+dir_w]^T, da likewise
      const bf16* Wd = A.W[W_SDIR];
      if (tid < A.dir_w) {
        float v = 0.f;
        for (int c = 0; c < WID; ++c)
          v += m.ray_b[c] * __bfloat162float(Wd[(WID + tid) * WID + c]);
        G.ddir[size_t(ray) * A.dir_w + tid] = v;
      }
      if (A.encode_a && tid < A.n_a) {
        float v = 0.f;
        for (int c = 0; c < WID; ++c)
          v += m.ray_b[c] * __bfloat162float(Wd[(WID + SEG + tid) * WID + c]);
        G.da[size_t(ray) * A.n_a + tid] = v;
      }
      // dfeat0 = dz @ Wdir[:256]^T -> h
      Acc acc[2][MT];
      zero_acc<2>(acc);
      mma_seg<true, 2>(acc, other, LDH, WID, A.W[W_SDIR], WID, warp * 32);
      __syncthreads();
      epi_bwd<2>(acc, warp * 32, nullptr, nullptr, nullptr, h,
                 X.dzF + row0 * WID, dbp(W_SFIN), m.stage);
    } else {
      // no viewdir: feat = feat0 (unrounded); dfeat0 = dfeat -> h
      __syncthreads();
      dbp(W_SFIN)[tid] = narrow_bwd<3>(m.pl + 8 * S, A.W[W_SRGB], nullptr, h,
                                       X.dzF + row0 * WID);
    }
    __syncthreads();
    // dh8 = bf16(dfeat0) @ Wfin^T + bf16(g_ssig) Wsig^T; dz7 = dh8 * (h8 > 0)
    Acc acc[2][MT];
    zero_acc<2>(acc);
    mma_seg<true, 2>(acc, h, LDH, WID, A.W[W_SFIN], WID, warp * 32);
    epi_bwd<2>(acc, warp * 32, m.r1g, A.W[W_SSIG], act8_r, other,
               dz_r + 7 * R * WID, dbp(w0 + 7), m.stage);
  } else {
    // tfeatb = bf16(h8 @ Wtfin + b); th = tfeatb @ Wth + b
    dense_fwd(h, A.W[W_TFIN], A.B[W_TFIN], false, other, X.featA + row0 * WID,
              m.stage);
    __syncthreads();
    head<NHEAD>(other, A.W[W_THEAD], A.B[W_THEAD], m.pl + NHEAD * S);
    __syncthreads();
    // g_th = [g_tsig, g_trgb * t (1 - t), g_flow * flow_scale * (1 - tf^2)]
    for (int s = tid; s < S; s += NTHREADS) {
      float gth[NHEAD];
      gth[0] = m.pl[3 * S + s];
      for (int c = 0; c < 3; ++c) {
        const float tv = sigmoid(m.pl[(NHEAD + 1 + c) * S + s]);
        gth[1 + c] = m.pl[c * S + s] * tv * (1.f - tv);
      }
      for (int c = 4; c < NHEAD; ++c) {
        const float tf = tanhf(m.pl[(NHEAD + c) * S + s]);
        gth[c] = m.pl[c * S + s] * A.flow_scale * (1.f - tf * tf);
      }
      for (int c = 0; c < LDG; ++c)
        gh_r[s * LDG + c] = __float2bfloat16_rn(c < NHEAD ? gth[c] : 0.f);
      for (int c = 0; c < NHEAD; ++c) m.pl[c * S + s] = gth[c];
    }
    __syncthreads();
    plane_sums(m.pl, NHEAD, dbp(W_THEAD));
    for (int e = tid; e < NHEAD * S; e += NTHREADS) m.pl[NHEAD * S + e] = bfr(m.pl[e]);
    __syncthreads();
    // dtfeat = bf16(g_th) @ Wth^T -> h (h8 lives in scratch)
    dbp(W_TFIN)[tid] = narrow_bwd<NHEAD>(m.pl + NHEAD * S, A.W[W_THEAD],
                                         nullptr, h, X.dzF + row0 * WID);
    __syncthreads();
    Acc acc[2][MT];
    zero_acc<2>(acc);
    mma_seg<true, 2>(acc, h, LDH, WID, A.W[W_TFIN], WID, warp * 32);
    epi_bwd<2>(acc, warp * 32, nullptr, nullptr, act8_r, other,
               dz_r + 7 * R * WID, dbp(w0 + 7), m.stage);
  }
  __syncthreads();

  // ---- tower backward: dz_{i-1} = (dz_i @ W_i^T) * (act_i > 0) ----
  bf16* cur = other;
  bf16* nxt = h;
  for (int i = DEPTH - 1; i >= 1; --i) {
    const bf16* W = A.W[w0 + i] + (i == SKIP ? SEG * WID : 0);
    Acc acc[2][MT];
    zero_acc<2>(acc);
    mma_seg<true, 2>(acc, cur, LDH, WID, W, WID, warp * 32);
    epi_bwd<2>(acc, warp * 32, nullptr, nullptr, act_r + (i - 1) * R * WID,
               nxt, dz_r + (i - 1) * R * WID, dbp(w0 + i - 1), m.stage);
    __syncthreads();
    bf16* tmp = cur; cur = nxt; nxt = tmp;
  }
  if (STATIC && !want_dx) return;

  // ---- input cotangent dtx = dz0 @ W0^T + dz4 @ W4[:SEG]^T ----
  for (int e = tid; e < S * WID; e += NTHREADS)
    nxt[(e / WID) * LDH + e % WID] = dz_r[SKIP * R * WID + e];
  __syncthreads();
  Acc acc[1][MT];
  zero_acc<1>(acc);
  mma_seg<true, 1>(acc, cur, LDH, WID, A.W[w0], WID, warp * 16);
  mma_seg<true, 1>(acc, nxt, LDH, WID, A.W[w0 + SKIP], WID, warp * 16);
  __syncthreads();
  float* dtx = reinterpret_cast<float*>(cur);
#pragma unroll
  for (int mm = 0; mm < MT; ++mm)
    wmma::store_matrix_sync(dtx + mm * 16 * LDF + warp * 16, acc[0][mm], LDF,
                            wmma::mem_row_major);
  __syncthreads();
  // dt = bf16(ray sum of dtx) on the time-latent lanes
  if (!STATIC && tid < A.n_tau) {
    float v = 0.f;
    for (int s = 0; s < S; ++s) v += dtx[s * LDF + A.xyz_w + tid];
    G.dt[size_t(ray) * A.n_tau + tid] = bfr(v);
  }
  // dx_c = sum over the lanes j of channel c of dxs_j * f_j, with
  // dxs = dtx on identity lanes and dtx * cos(xs + phase) on sine lanes
  if (want_dx) {
    const int lane = tid & 31;
    for (int s = warp; s < S; s += NWARPS) {
      float acc3[3] = {0.f, 0.f, 0.f};
      for (int j = lane; j < A.xyz_w; j += 32) {
        bool id;
        float ph;
        const float xs = lane_xs(A, m, with_flow, s, j, id, ph);
        const float g = dtx[s * LDF + j];
        const int c = j < 3 ? j : ((j - 3) % 6) % 3;
        const float f = j < 3 ? 1.f : A.freqs[(j - 3) / 6];
        const float dxs = id ? g
            : g * sin_poly(__fadd_rn(__fadd_rn(xs, ph), 1.5707963267948966f));
        acc3[c] += G.round_dx ? bfr(dxs) * bfr(f) : dxs * f;
      }
      for (int c = 0; c < 3; ++c) {
        const float v = warp_sum(acc3[c]);
        if (lane == 0) G.dflows[c][(row0 + s) * G.dx_stride] = v;
      }
    }
  }
}

// ------------------------------ dW kernel ------------------------------

// out (ka, nb) = A[0:rows, 0:ka]^T @ B[0:rows, 0:nb]; A (rows, lda) and
// B (rows, ldb) bf16, ka a multiple of 64, lda/ldb multiples of 8
struct Job {
  const bf16* A; const bf16* B; float* out;
  int lda, ldb, ka, nb, rows;
  int tile0;          // first tile index of this job
  size_t part_off;    // offset of this job's output in a partial buffer
};
constexpr int MAXJOBS = 16;
struct Jobs {
  Job j[MAXJOBS];
  int n, n_tiles;
  size_t part_elems;  // elements of one partial buffer
  float* part;
};

constexpr int DW_T = 64;         // output tile edge
constexpr int DW_R = 32;         // rows per step
constexpr int DW_LD = DW_T + 8;  // bf16 pitch of the shared tiles

__global__ void __launch_bounds__(128)
dw_kernel(const Jobs J) {
  __shared__ __align__(128) bf16 As[DW_R * DW_LD];
  __shared__ __align__(128) bf16 Bs[DW_R * DW_LD];
  __shared__ __align__(128) float st[4][16 * 16];
  int ji = 0;
  while (ji + 1 < J.n && int(blockIdx.x) >= J.j[ji + 1].tile0) ++ji;
  const Job& jb = J.j[ji];
  const int tile = blockIdx.x - jb.tile0;
  const int n_tiles_n = (jb.nb + DW_T - 1) / DW_T;
  const int k0 = (tile / n_tiles_n) * DW_T, n0 = (tile % n_tiles_n) * DW_T;
  const int split = blockIdx.y;
  const int per = (jb.rows + PSPLIT - 1) / PSPLIT;
  const int r_begin = split * per, r_end = min(jb.rows, r_begin + per);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wk = (warp >> 1) * 32, wn = (warp & 1) * 32;  // warp's 32x32 quadrant
  Acc acc[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) wmma::fill_fragment(acc[a][b], 0.f);

  for (int r0 = r_begin; r0 < r_end; r0 += DW_R) {
    // 32 rows x 64 columns of A and of B, 8 bf16 (16 bytes) per load
    for (int e = threadIdx.x; e < 2 * DW_R * (DW_T / 8); e += blockDim.x) {
      const bool isA = e < DW_R * (DW_T / 8);
      const int q = isA ? e : e - DW_R * (DW_T / 8);
      const int r = q / (DW_T / 8), c8 = (q % (DW_T / 8)) * 8;
      const int row = r0 + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (isA) {
        if (row < r_end && k0 + c8 < jb.lda)
          v = *reinterpret_cast<const uint4*>(jb.A + size_t(row) * jb.lda + k0 + c8);
        *reinterpret_cast<uint4*>(As + r * DW_LD + c8) = v;
      } else {
        if (row < r_end && n0 + c8 < jb.ldb)
          v = *reinterpret_cast<const uint4*>(jb.B + size_t(row) * jb.ldb + n0 + c8);
        *reinterpret_cast<uint4*>(Bs + r * DW_LD + c8) = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int rk = 0; rk < DW_R; rk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfm[2];
#pragma unroll
      for (int a = 0; a < 2; ++a)  // A^T: element (k, r) at As[r][k]
        wmma::load_matrix_sync(af[a], As + rk * DW_LD + wk + 16 * a, DW_LD);
#pragma unroll
      for (int b = 0; b < 2; ++b)
        wmma::load_matrix_sync(bfm[b], Bs + rk * DW_LD + wn + 16 * b, DW_LD);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) wmma::mma_sync(acc[a][b], af[a], bfm[b], acc[a][b]);
    }
    __syncthreads();
  }
  float* part = J.part + size_t(split) * J.part_elems + jb.part_off;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      wmma::store_matrix_sync(st[warp], acc[a][b], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int k = k0 + wk + 16 * a + (e >> 4), n = n0 + wn + 16 * b + (e & 15);
        if (k < jb.ka && n < jb.nb) part[size_t(k) * jb.nb + n] = st[warp][e];
      }
      __syncwarp();
    }
}

// out = sum over the splits of the partials, split 0 first
__global__ void dw_reduce_kernel(const Jobs J) {
  for (int ji = 0; ji < J.n; ++ji) {
    const Job& jb = J.j[ji];
    const size_t n = size_t(jb.ka) * jb.nb;
    for (size_t e = blockIdx.x * size_t(blockDim.x) + threadIdx.x; e < n;
         e += size_t(gridDim.x) * blockDim.x) {
      float v = 0.f;
      for (int p = 0; p < PSPLIT; ++p) v += J.part[p * J.part_elems + jb.part_off + e];
      jb.out[e] = v;
    }
  }
}

// db[slot][c] = sum over rays (in order) of the per-ray partials
struct Biases {
  float* out[NSLOT];
  int width[NSLOT];
  const float* dbp;
  int n_rays;
};

__global__ void db_reduce_kernel(const Biases Bz) {
  const int slot = blockIdx.x, c = threadIdx.x;
  if (Bz.out[slot] == nullptr || c >= Bz.width[slot]) return;
  const float* p = Bz.dbp + size_t(slot) * Bz.n_rays * WID + c;
  float v = 0.f;
  for (int r = 0; r < Bz.n_rays; ++r) v += p[size_t(r) * WID];
  Bz.out[slot][c] = v;
}

// ------------------------------- host side -----------------------------

inline size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

// the scratch layout of one branch; with base == nullptr only the size
inline Scratch scratch_layout(unsigned char* base, bool stat, int n, int viewdir,
                       int encode_a, size_t part_elems, size_t* bytes) {
  const size_t R = size_t(n) * S;
  size_t off = 0;
  auto take = [&](size_t b) { size_t o = off; off += align256(b); return base + o; };
  Scratch X;
  X.act0 = reinterpret_cast<bf16*>(take(R * SEG * 2));
  X.act = reinterpret_cast<bf16*>(take(8 * R * WID * 2));
  X.featA = reinterpret_cast<bf16*>(take(R * WID * 2));
  X.featB = (stat && viewdir) ? reinterpret_cast<bf16*>(take(R * WID * 2)) : X.featA;
  X.dz = reinterpret_cast<bf16*>(take(8 * R * WID * 2));
  X.dzA = (stat && viewdir) ? reinterpret_cast<bf16*>(take(R * WID * 2)) : nullptr;
  X.dzF = reinterpret_cast<bf16*>(take(R * WID * 2));
  X.gh = reinterpret_cast<bf16*>(take(R * LDG * 2));
  X.ghs = stat ? reinterpret_cast<bf16*>(take(R * LDG * 2)) : nullptr;
  X.dirb = (stat && viewdir) ? reinterpret_cast<bf16*>(take(size_t(n) * SEG * 2)) : nullptr;
  X.ab = (stat && viewdir && encode_a) ? reinterpret_cast<bf16*>(take(size_t(n) * SEG * 2)) : nullptr;
  X.dzrb = (stat && viewdir) ? reinterpret_cast<bf16*>(take(size_t(n) * WID * 2)) : nullptr;
  X.dbp = reinterpret_cast<float*>(take(size_t(NSLOT) * n * WID * 4));
  X.part = reinterpret_cast<float*>(take(size_t(PSPLIT) * part_elems * 4));
  *bytes = off;
  return X;
}

// the dW jobs of one branch; out pointers may be null when only sizing
inline Jobs make_jobs(bool stat, int n, int viewdir, int encode_a, const Scratch& X,
               float* const* dw) {
  const size_t R = size_t(n) * S;
  Jobs J;
  J.n = 0; J.n_tiles = 0; J.part_elems = 0; J.part = X.part;
  auto add = [&](const bf16* A, int lda, int ka, const bf16* B, int ldb,
                 int nb, int rows, int slot, int row0) {
    Job& jb = J.j[J.n++];
    jb.A = A; jb.B = B; jb.lda = lda; jb.ldb = ldb; jb.ka = ka; jb.nb = nb;
    jb.rows = rows;
    jb.out = dw != nullptr && dw[slot] != nullptr ? dw[slot] + size_t(row0) * nb : nullptr;
    jb.tile0 = J.n_tiles;
    jb.part_off = J.part_elems;
    J.n_tiles += (ka / DW_T) * ((nb + DW_T - 1) / DW_T);
    J.part_elems += size_t(ka) * nb;
  };
  const int w0 = stat ? W_S0 : W_T0;
  auto act = [&](int i) { return X.act + size_t(i - 1) * R * WID; };  // output of layer i-1
  auto dz = [&](int i) { return X.dz + size_t(i) * R * WID; };
  const int rows = int(R);
  add(X.act0, SEG, SEG, dz(0), WID, WID, rows, w0, 0);
  for (int i = 1; i < DEPTH; ++i) {
    if (i == SKIP) {
      add(X.act0, SEG, SEG, dz(i), WID, WID, rows, w0 + i, 0);
      add(act(i), WID, WID, dz(i), WID, WID, rows, w0 + i, SEG);
    } else {
      add(act(i), WID, WID, dz(i), WID, WID, rows, w0 + i, 0);
    }
  }
  add(act(8), WID, WID, X.dzF, WID, WID, rows, stat ? W_SFIN : W_TFIN, 0);
  if (stat) {
    if (viewdir) {
      add(X.featA, WID, WID, X.dzA, WID, WID, rows, W_SDIR, 0);
      add(X.dirb, SEG, SEG, X.dzrb, WID, WID, n, W_SDIR, WID);
      if (encode_a) add(X.ab, SEG, SEG, X.dzrb, WID, WID, n, W_SDIR, WID + SEG);
    }
    add(act(8), WID, WID, X.ghs, LDG, 1, rows, W_SSIG, 0);
    add(X.featB, WID, WID, X.gh, LDG, 3, rows, W_SRGB, 0);
  } else {
    add(X.featA, WID, WID, X.gh, LDG, NHEAD, rows, W_THEAD, 0);
  }
  return J;
}

inline size_t bwd_scratch_bytes(bool stat, int n_rays, int use_viewdir, int encode_a) {
  size_t bytes = 0;
  Scratch X = scratch_layout(nullptr, stat, n_rays, use_viewdir, encode_a, 0, &bytes);
  Jobs J = make_jobs(stat, n_rays, use_viewdir, encode_a, X, nullptr);
  scratch_layout(nullptr, stat, n_rays, use_viewdir, encode_a, J.part_elems, &bytes);
  return bytes;
}

// The three launches of one branch. G.c, G.g, the output pointers and the
// strides are filled by the caller; the scratch layout is set here.
inline cudaError_t launch_branch_bwd(BwdArgs& G, bool stat, int use_viewdir,
                              int encode_a, void* scratch, void* const* dw,
                              void* const* db, cudaStream_t s) {
  const int n_rays = G.c.n_rays;
  size_t bytes = 0;
  Scratch X0 = scratch_layout(nullptr, stat, n_rays, use_viewdir, encode_a, 0, &bytes);
  const size_t part_elems =
      make_jobs(stat, n_rays, use_viewdir, encode_a, X0, nullptr).part_elems;
  G.sc = scratch_layout(static_cast<unsigned char*>(scratch), stat, n_rays,
                        use_viewdir, encode_a, part_elems, &bytes);
  cudaError_t err;
  if (stat) {
    err = big_smem(train_bwd_chain_kernel<true>);
    if (err == cudaSuccess)
      train_bwd_chain_kernel<true><<<n_rays, NTHREADS, SM_BYTES, s>>>(G);
  } else {
    err = big_smem(train_bwd_chain_kernel<false>);
    if (err == cudaSuccess)
      train_bwd_chain_kernel<false><<<n_rays, NTHREADS, SM_BYTES, s>>>(G);
  }
  if (err != cudaSuccess) return err;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  float* dwf[NSLOT];
  for (int i = 0; i < NSLOT; ++i) dwf[i] = static_cast<float*>(dw[i]);
  Jobs J = make_jobs(stat, n_rays, use_viewdir, encode_a, G.sc, dwf);
  for (int i = 0; i < J.n; ++i)
    if (J.j[i].out == nullptr) return cudaErrorInvalidValue;
  dw_kernel<<<dim3(J.n_tiles, PSPLIT), 128, 0, s>>>(J);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dw_reduce_kernel<<<264, 256, 0, s>>>(J);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  Biases Bz;
  Bz.dbp = G.sc.dbp;
  Bz.n_rays = n_rays;
  for (int i = 0; i < NSLOT; ++i) {
    Bz.out[i] = nullptr;
    Bz.width[i] = 0;
  }
  auto want = [&](int slot, int width) {
    Bz.out[slot] = static_cast<float*>(db[slot]);
    Bz.width[slot] = width;
  };
  const int w0 = stat ? W_S0 : W_T0;
  for (int i = 0; i < DEPTH; ++i) want(w0 + i, WID);
  want(stat ? W_SFIN : W_TFIN, WID);
  if (stat) {
    if (use_viewdir) want(W_SDIR, WID);
    want(W_SSIG, 1);
    want(W_SRGB, 3);
  } else {
    want(W_THEAD, NHEAD);
  }
  db_reduce_kernel<<<NSLOT, WID, 0, s>>>(Bz);
  return cudaGetLastError();
}

}  // namespace planar
