// Backward of the port's tower evaluators on Hopper (sm_90a), one branch
// (static or transient) per call, shared by planar_nerf_train.cu (planar
// layout: cotangent planes in, flow-plane cotangents out) and
// fused_nerf_train.cu (packed layout: a (rows, 16) cotangent in, a
// (rows, 3) xyz cotangent out, for either branch).
//
// Replaces the backward of nsff_pl_tpu/ops/raymarch_kernel.py (:634) and
// nsff_pl_tpu/ops/mlp_train_kernel.py (:556). The TPU kernels run a
// sequential grid over row blocks and keep every dW/db in VMEM across it;
// Hopper's CTAs run in parallel and 8 x (256 x 256) f32 of dW does not fit
// one, so the work is two passes through a global scratch buffer
// (activations and bf16 cotangents, ~0.7 GB per branch call at batch 512):
//  1. train_bwd_chain_kernel, one CTA per (ray, tile of 128 samples; a
//     ray of S samples is ceil(S / 128) tiles, the last one padded with
//     rows that repeat the ray's last sample and whose cotangent is zero,
//     so that they add nothing to dW, db or a ray's sums), in the shape of
//     tower_wgmma.cuh: two consumer warpgroups (rows 0-63 and 64-127)
//     run every product as wgmma.mma_async (bf16 in, f32 accumulators);
//     one producer thread streams weight K-slabs by TMA into a 5-stage
//     mbarrier ring. The forward recompute reads W MN-major (transpose
//     bit, 128-byte swizzle) as the evaluators do; the data gradient
//     dz_{i-1} = (dz_i @ W_i^T) * (act_{i-1} > 0) reads the same row-major
//     (K_pad, 256) packing as a K-major B operand (boxes cut along W's
//     rows, 64-byte swizzle): no second packing. Every layer's epilogue
//     writes its bf16 tile in place (stmatrix) and stores it to scratch by
//     TMA (cp.async.bulk.tensor, smem -> global); the forward keeps each
//     ReLU mask as bits in shared memory (each thread its own 128
//     accumulator elements, 4 KB a layer), and the backward epilogue
//     reads them there (re-reading them from the activations in scratch
//     was 1.3-1.4x slower on the chain, PERF.md); the dir layer's mask is
//     read from the tile, which still holds featb. Per-ray bias-gradient
//     partials are the column sums of the f32 dz: 4-row partials (one
//     shuffle), then the 32 partials in a fixed order. The per-ray sums
//     of a ray of several tiles (static_dir's dz for d(dir), d(a) and the
//     dir rows of dW; the time lanes of the input cotangent for d(t)) are
//     added over its tiles in tile order by ray_reduce_kernel, then
//     rounded as a one-tile ray's. The narrow heads
//     stay on CUDA cores: the forward heads from the bf16 tile after its
//     epilogue (two rows a thread, paired weight loads), the head products
//     of the backward inside the first backward epilogue, the sigmoid /
//     tanh adjoints, d(dir), d(a), d(t) and the posenc adjoint. After the
//     forward the posenc tile holds the cotangent planes, the head outputs
//     and the column-sum partials, which leaves room for a 5-stage ring.
//     What bounds it now: per-layer epilogues and slab waits
//     (scripts/profile_backward.py).
//  2. dw_gemm_kernel: dW[k][n] = sum_r A[r][k] dz[r][n] for every 128- or
//     256-row weight as a split-K wgmma GEMM, both operands MN-major
//     through the transpose bits, fed by TMA (128-byte swizzle) into a
//     4-stage ring; 128 x 256 output tiles on two consumer warpgroups, the
//     rows split so that tiles x splits fill the SMs, one partial per
//     split. dw_narrow_kernel does the 1-, 3- and 10-wide head jobs on
//     CUDA cores.
//  3. dw_reduce_kernel and db_reduce_kernel sum the partials in a fixed
//     order (splits in order, rays in order): the gradients are the same
//     bits on every run, and no atomics are used.
// Bound: operations (recompute, data gradient and weight gradient: ~0.24
// ms per call at 989 TFLOP/s); the scratch round trip adds ~0.2 ms of
// bytes at 3.35 TB/s.
// Rounding points are the TPU kernel's: bf16 matmul inputs, f32
// accumulation, every dz rounded to bf16 before its products, bias
// gradients from the f32 dz, the static dir layer's mask on its f32
// pre-activation, bf16 of the ray sums for d(dir), d(a), d(t), and the
// posenc adjoint with the polynomial cosine.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cstring>

#include "tower_wgmma.cuh"

namespace bw {

using planar::bf16;
using planar::DEPTH;
using planar::NHEAD;
using planar::NSLOT;
using planar::S;
using planar::SEG;
using planar::SKIP;
using planar::WID;

constexpr int NCONS = 256;               // two consumer warpgroups
constexpr int NTHR = NCONS + 128;        // + the producer warpgroup
constexpr int HELP0 = NCONS + 32;        // the producer warpgroup's helpers
constexpr int NHELP = NTHR - HELP0;
static_assert(NHELP == wg::NHELP, "helper count of wg::copy16 / dir_bias");
constexpr int ST = 5;                    // ring stages
constexpr uint32_t SLOT = 16384;         // one ring slot
constexpr uint32_t BLK = wg::BLK_BYTES;  // (128 rows, 64 cols) bf16 block
constexpr uint32_t WGR = wg::WG_ROWS_BYTES;

// scratch: NT (R, 256) bf16 tiles, R = U * S rows each (U = n_rays *
// n_tiles (ray, tile) units), in one array
enum {
  T_ACT = 0,       // T_ACT + i: output of tower layer i
  T_FA = 8,        // static feat0b / transient tfeatb
  T_DZ = 9,        // T_DZ + i: bf16 cotangent of layer i's pre-activation
  T_DZF = 17,      // cotangent of the *_final output
  T_FB = 18,       // static featb (viewdir)
  T_DZA = 19       // static_dir's dz (viewdir)
};
inline int n_tiles_of(bool stat, int viewdir) { return stat && viewdir ? 20 : 18; }

// chain kernel shared-memory carve-up (offsets from a 1024-aligned base)
constexpr uint32_t OFF_RING = 0;
constexpr uint32_t OFF_ACT = OFF_RING + ST * SLOT;         // (128, 256) tile
constexpr uint32_t OFF_PE = OFF_ACT + 4 * BLK;             // (128, 128) tile
constexpr uint32_t OFF_MASK = OFF_PE + 2 * BLK;            // 8 x 4 KB of bits
constexpr uint32_t OFF_BAR = OFF_MASK + 8 * 4096;
constexpr uint32_t OFF_RAYB = OFF_BAR + 128;
constexpr uint32_t OFF_BIAS = OFF_RAYB + WID * 4;          // 9 layer biases
constexpr uint32_t OFF_HW = OFF_BIAS + 9 * WID * 4;        // head weights
constexpr uint32_t OFF_HB = OFF_HW + WID * NHEAD * 2;
constexpr uint32_t OFF_R1G = OFF_HB + 16 * 4;
constexpr uint32_t OFF_ZS = OFF_R1G + S * 4;
constexpr uint32_t OFF_FL = OFF_ZS + S * 4;                // (S, 3) points / flows
constexpr uint32_t OFF_OD = OFF_FL + 3 * S * 4;
constexpr size_t SMEM_BYTES = OFF_OD + 8 * 4;
static_assert(SMEM_BYTES <= 232448, "fits one SM's shared memory");
constexpr int LDT = SEG + 4;  // f32 pitch of the input-cotangent tile
static_assert(S * LDT * 4 <= 6 * BLK, "dtx fits the activation + posenc tiles");
static_assert(32 * WID * 4 <= 2 * BLK, "the column-sum partials fit the posenc tile");
static_assert(OFF_PE + 4 * BLK <= OFF_BAR, "dz4 fits the posenc tile and the mask bits");
// after the forward, the posenc tile holds the cotangent planes and the
// head outputs (NHEAD planes each) beside the column-sum partials
constexpr uint32_t PE_G = 16384, PE_H = PE_G + NHEAD * S * 4;
static_assert(PE_H + NHEAD * S * 4 <= 2 * BLK, "the planes fit the posenc tile");

#ifdef WG_PROFILE
// scripts/profile_backward.py builds fused_nerf_train.cu with these: phase
// stamps (global timer, ns; slots 0-13) and cycle counts (16-24), 32
// slots per CTA
__device__ unsigned long long bw_prof[4096 * 32];
#define BW_STAMP(slot) \
  if (threadIdx.x == 0 && blockIdx.x < 4096) bw::bw_prof[blockIdx.x * 32 + (slot)] = wg::wg_now()
#define BW_ADD(slot, v) \
  if (blockIdx.x < 4096) atomicAdd(&bw::bw_prof[blockIdx.x * 32 + (slot)], (unsigned long long)(v))
#else
#define BW_STAMP(slot)
#define BW_ADD(slot, v)
#endif

// ---------------------------------------------------------------- PTX

using wg::bar_sync;
using wg::consumers_sync;
using wg::fence_async_smem;
using wg::mbar_arrive;
using wg::mbar_expect_tx;
using wg::mbar_init;
using wg::mbar_wait;
using wg::saddr;
using wg::tma_load;
using wg::wg_sync;
using wg::wgmma_commit;
using wg::wgmma_fence;
using wg::wgmma_wait;

// shared -> global TMA store of one box, in the thread's bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// the thread's bulk stores are complete in global memory
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// wgmma shared-memory descriptor, 64-byte swizzle (K-major rows of 64 B)
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(2) << 62);
}

#define BW_D8(i)                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define BW_D32(i) BW_D8(i), BW_D8(i + 8), BW_D8(i + 16), BW_D8(i + 24)

// d (+)= A (64 x 16) @ B (16 x 256); TA / TB: transpose bits (1: MN-major)
template <int TA, int TB>
__device__ __forceinline__ void mma_n256(float (&d)[128], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : BW_D32(0), BW_D32(32), BW_D32(64), BW_D32(96)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (+)= A (64 x 16, K-major) @ B (16 x 128, K-major)
__device__ __forceinline__ void mma_n128(float (&d)[64], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : BW_D32(0), BW_D32(32)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef BW_D32
#undef BW_D8

// ---------------------------------------------------------------- ring

template <int NS>
struct RingN {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == NS) {
      stage = 0;
      phase ^= 1u;
    }
  }
};
using Ring = RingN<ST>;
__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int s) { return bars + 8u * s; }
template <int NS = ST>
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int s) {
  return bars + 8u * (NS + s);
}

// one thread, before a barrier: the ring's barriers (empty: one arrival
// per consumer warpgroup) and the two warpgroups' reload barriers
__device__ __forceinline__ void init_bars(uint32_t bars) {
  for (int s = 0; s < ST; ++s) {
    mbar_init(full_bar(bars, s), 1);
    mbar_init(empty_bar(bars, s), 2);
  }
  mbar_init(bars + 8u * (2 * ST), 1);
  mbar_init(bars + 8u * (2 * ST + 1), 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Products of one layer on a consumer warpgroup, one 16 KB slab of W at a
// time from the ring; a slab goes back as soon as its products are done.
// MODE 0, forward: d = [pe | act] @ W, the first k_pe K-columns from the
//   posenc tile, the next k_act from the activation tile; a slab is 32
//   K-rows of W (MN-major, 128-byte swizzle, four (32, 64) boxes).
// MODE 1, backward: d = act @ W^T over K = 256; a slab is 32 columns of W
//   for its 256 rows (K-major, 64-byte swizzle).
// MODE 2, backward into a 64-register accumulator: d (+)= act @ W^T with
//   128 rows of W (the input cotangent); ACC keeps what d holds.
// NACC: accumulator registers (128: N = 256, 64: N = 128).
template <int MODE, bool ACC = false, int NACC>
__device__ __forceinline__ void mma_layer(float (&d)[NACC], Ring& p, uint32_t ring,
                                          uint32_t bars, uint32_t pe_g, int k_pe,
                                          uint32_t act_g, int k_act) {
  static_assert((MODE == 2) == (NACC == 64), "N = 128 products use 64 registers");
  const int n_pe = k_pe / 32;
  const bool leader = (threadIdx.x & 127) == 0;
  wgmma_fence();
  int prev = -1;
  const int n = n_pe + k_act / 32;
  for (int j = 0; j < n; ++j) {
#ifdef WG_PROFILE
    const long long t0 = clock64();
#endif
    mbar_wait(full_bar(bars, p.stage), p.phase);
    if (threadIdx.x == 0) BW_ADD(MODE == 0 ? 16 : 17, clock64() - t0);
    // K-columns 32 jj.. of a tile: 64-column block jj / 2, 64 bytes on per half
    const int jj = j < n_pe ? j : j - n_pe;
    const uint32_t a = (j < n_pe ? pe_g : act_g) + (jj >> 1) * BLK + (jj & 1) * 64;
    const uint32_t b = ring + p.stage * SLOT;
#pragma unroll
    for (int kq = 0; kq < 2; ++kq) {
      const uint64_t da = wg::sw128_desc(a + 32 * kq, 16, 1024);
      const int sd = (ACC || (j | kq) != 0) ? 1 : 0;
      if constexpr (MODE == 0)
        mma_n256<0, 1>(d, da, wg::sw128_desc(b + 2048 * kq, wg::BOX_BYTES, 1024), sd);
      else if constexpr (MODE == 1)
        mma_n256<0, 0>(d, da, sw64_desc(b + 32 * kq, 512), sd);
      else
        mma_n128(d, da, sw64_desc(b + 32 * kq, 512), sd);
    }
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      if (leader) mbar_arrive(empty_bar(bars, prev));
    }
    prev = p.stage;
    p.advance();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
  if (leader) mbar_arrive(empty_bar(bars, prev));
}

// ---------------------------------------------------------------- epilogues

// thread (warp w of the warpgroup, lane l) holds rows 16w + l/4 (+8) and
// columns 8i + 2(l%4) (+1), i < 32, of its warpgroup's 64 rows: d[4i..4i+3]
// = (r, c), (r, c+1), (r+8, c), (r+8, c+1)

// in-place bf16 store of four values of chunk pair i (stmatrix every odd i)
struct TileWriter {
  uint32_t mrow_addr;
  int mrow, m;
  uint32_t prev_lo = 0, prev_hi = 0;
  __device__ __forceinline__ TileWriter(unsigned char* act, int g) {
    const int t = threadIdx.x & 127, w = t >> 5, l = t & 31;
    m = l >> 3;
    mrow = 16 * w + 8 * (m & 1) + (l & 7);
    mrow_addr = saddr(act) + g * WGR + uint32_t(mrow) * 128u;
  }
  __device__ __forceinline__ void put(int i, uint32_t lo, uint32_t hi) {
    if (i & 1) {
      const int chunk = i - 1 + (m >> 1);
      wg::stmatrix_x4(mrow_addr + uint32_t(chunk >> 3) * BLK +
                          (uint32_t((chunk & 7) ^ (mrow & 7)) << 4),
                      prev_lo, prev_hi, lo, hi);
    } else {
      prev_lo = lo;
      prev_hi = hi;
    }
  }
};

// After a warpgroup's tile rows are written (fenced, warpgroup barrier):
// its leader stores the 64 rows, four (64, 64) boxes, to row `row` of the
// scratch map.
__device__ __forceinline__ void store_rows(const CUtensorMap* map, unsigned char* tile,
                                           int g, int nblk, int row) {
  if ((threadIdx.x & 127) != 0) return;
  for (int cb = 0; cb < nblk; ++cb)
    tma_store(map, saddr(tile) + cb * BLK + g * WGR, 64 * cb, row);
  bulk_commit();
}

// the leader's earlier stores have read the tile; then the warpgroup may
// write it
__device__ __forceinline__ void tile_free(int g) {
#ifdef WG_PROFILE
  const long long t0 = clock64();
#endif
  if ((threadIdx.x & 127) == 0) bulk_wait_read();
  wg_sync(g);
  if (threadIdx.x == 0) BW_ADD(21, clock64() - t0);
}

// Forward epilogue: v = d + bias, bf16(relu?(v)) into the activation tile
// in place and to scratch row `row` of `map`; with `mask`, the thread's
// 128 ReLU bits (the bf16 activation > 0).
template <bool RELU>
__device__ __forceinline__ void epi_fwd(const float (&d)[128], const float* bias,
                                        unsigned char* act, int g, uint4* mask,
                                        const CUtensorMap* map, int row) {
  const int q = threadIdx.x & 3;
  uint32_t bits[4] = {0u, 0u, 0u, 0u};
#ifdef WG_PROFILE
  const long long t_epi = clock64();
#endif
  tile_free(g);
  TileWriter tw(act, g);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = 8 * i + 2 * q;
    const float2 b = *reinterpret_cast<const float2*>(bias + col);
    const float v0 = d[4 * i] + b.x, v1 = d[4 * i + 1] + b.y;
    const float v2 = d[4 * i + 2] + b.x, v3 = d[4 * i + 3] + b.y;
    const uint32_t lo = RELU ? wg::pack_bf16_relu(v0, v1) : wg::pack_bf16(v0, v1);
    const uint32_t hi = RELU ? wg::pack_bf16_relu(v2, v3) : wg::pack_bf16(v2, v3);
    tw.put(i, lo, hi);
    const uint32_t mb = uint32_t((lo & 0x7FFFu) != 0) | (uint32_t((lo & 0x7FFF0000u) != 0) << 1) |
                        (uint32_t((hi & 0x7FFFu) != 0) << 2) | (uint32_t((hi & 0x7FFF0000u) != 0) << 3);
    bits[i >> 3] |= mb << ((4 * i) & 31);
  }
  if (mask != nullptr) mask[threadIdx.x] = make_uint4(bits[0], bits[1], bits[2], bits[3]);
  fence_async_smem();  // generic-proxy stores before wgmma and TMA read them
  wg_sync(g);
  store_rows(map, act, g, 4, row);
  if (threadIdx.x == 0) BW_ADD(18, clock64() - t_epi);
}

// Columns col and col + 1 (col even) of a row-major (WID, NJ) bf16 head
// matrix in shared memory, 2 NJ contiguous values: NJ / 2 8-byte loads (NJ
// even) or NJ 4-byte loads.
template <int NJ>
__device__ __forceinline__ void load_pair(const bf16* W, int col, float (&w0)[NJ],
                                          float (&w1)[NJ]) {
  bf16 v[2 * NJ];
  if constexpr (NJ % 2 == 0) {
#pragma unroll
    for (int k = 0; k < NJ / 2; ++k)
      *reinterpret_cast<uint2*>(v + 4 * k) = reinterpret_cast<const uint2*>(W + col * NJ)[k];
  } else {
#pragma unroll
    for (int k = 0; k < NJ; ++k)
      *reinterpret_cast<uint32_t*>(v + 2 * k) = reinterpret_cast<const uint32_t*>(W + col * NJ)[k];
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    w0[j] = __bfloat162float(v[j]);
    w1[j] = __bfloat162float(v[NJ + j]);
  }
}

// The NOUT-wide head of every row of the bf16 activation tile, after an
// epilogue wrote it: planes[c * S + row] = sum_k tile[row][k] Wh[k][c] +
// bh[c]. Thread t takes two rows of its own warpgroup and a quarter of the
// columns (each weight load feeds both rows); the quarters are added by
// two shuffles. Here, and not in the epilogue, the 128 accumulator
// registers are free.
template <int NOUT>
__device__ __forceinline__ void tile_heads(const unsigned char* act, const bf16* wh,
                                           const float* bh, float* planes) {
#ifdef WG_PROFILE
  const long long t0 = clock64();
#endif
  const int tl = threadIdx.x & 127, quarter = tl & 3;
  const int r0 = 64 * (threadIdx.x >> 7) + 2 * (tl >> 2);
  float h0[NOUT], h1[NOUT];
#pragma unroll
  for (int c = 0; c < NOUT; ++c) h0[c] = h1[c] = 0.f;
#pragma unroll 2
  for (int j = 0; j < 8; ++j) {
    const int chunk = 8 * quarter + j;
    const uint4 va = *reinterpret_cast<const uint4*>(act + wg::tile_off(r0, chunk));
    const uint4 vb = *reinterpret_cast<const uint4*>(act + wg::tile_off(r0 + 1, chunk));
    const uint32_t ua[4] = {va.x, va.y, va.z, va.w}, ub[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float w0[NOUT], w1[NOUT];
      load_pair<NOUT>(wh, 8 * chunk + 2 * k, w0, w1);
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ua[k]));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ub[k]));
#pragma unroll
      for (int c = 0; c < NOUT; ++c) {
        h0[c] += a.x * w0[c] + a.y * w1[c];
        h1[c] += b.x * w0[c] + b.y * w1[c];
      }
    }
  }
#pragma unroll
  for (int c = 0; c < NOUT; ++c) {
    h0[c] += __shfl_xor_sync(0xffffffffu, h0[c], 1);
    h0[c] += __shfl_xor_sync(0xffffffffu, h0[c], 2);
    h1[c] += __shfl_xor_sync(0xffffffffu, h1[c], 1);
    h1[c] += __shfl_xor_sync(0xffffffffu, h1[c], 2);
  }
  if (quarter == 0)
#pragma unroll
    for (int c = 0; c < NOUT; ++c) {
      planes[c * S + r0] = h0[c] + bh[c];
      planes[c * S + r0 + 1] = h1[c] + bh[c];
    }
  if (threadIdx.x == 0) BW_ADD(24, clock64() - t0);
}

// Backward epilogue: v = d, or with NJ > 0 the NJ-wide head product
// sum_j gq[j][row] Wn[col][j] (gq: NJ planes of S bf16-valued floats, Wn:
// (WID, NJ) bf16); [+ r1g[row] r1w[col] with R1]; zero where the ReLU mask
// is clear (MASK 1: the thread's bits in `mask`; MASK 2: the bf16 values of
// the activation tile > 0, read before it is overwritten); bf16(v) into the
// tile in place and to scratch row `row`; the f32 column sums of v over
// 4-row groups to part[warp][pair][col] (32 partials a column, each in a
// fixed order). The caller adds the 32 partials.
template <int MASK, bool R1, int NJ>
__device__ __forceinline__ void epi_bwd(float (&d)[128], const uint4* mask,
                                        const float* r1g, const bf16* r1w,
                                        const float* gq, const bf16* Wn,
                                        unsigned char* act, int g, float* part,
                                        const CUtensorMap* map, int row) {
  const int t = threadIdx.x & 127, w = t >> 5, l = t & 31, q = l & 3;
  const int r = 64 * g + 16 * w + (l >> 2);
  float ga[NJ > 0 ? NJ : 1], gb[NJ > 0 ? NJ : 1];
  if constexpr (NJ > 0) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      ga[j] = gq[j * S + r];
      gb[j] = gq[j * S + r + 8];
    }
    consumers_sync();  // every warp has read the planes the partials overwrite
  }
  uint32_t bits[4] = {0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};
  if constexpr (MASK == 1) {
    const uint4 mk = mask[threadIdx.x];
    bits[0] = mk.x; bits[1] = mk.y; bits[2] = mk.z; bits[3] = mk.w;
  } else if constexpr (MASK == 2) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const uint32_t a = *reinterpret_cast<const uint32_t*>(act + wg::tile_off(r, i) + 4 * q);
      const uint32_t b = *reinterpret_cast<const uint32_t*>(act + wg::tile_off(r + 8, i) + 4 * q);
      const uint32_t mb = uint32_t((a & 0x7FFFu) != 0) | (uint32_t((a & 0x7FFF0000u) != 0) << 1) |
                          (uint32_t((b & 0x7FFFu) != 0) << 2) | (uint32_t((b & 0x7FFF0000u) != 0) << 3);
      bits[i >> 3] = (i & 7 ? bits[i >> 3] : 0u) | (mb << ((4 * i) & 31));
    }
  }
  const float ra = R1 ? r1g[r] : 0.f;
  const float rb = R1 ? r1g[r + 8] : 0.f;
#ifdef WG_PROFILE
  const long long t_epi = clock64();
#endif
  tile_free(g);  // also: every thread has read its mask bits from the tile
  TileWriter tw(act, g);
  // column sums: per column the thread's two rows plus those of the lane
  // holding the next row pair (xor 4), stored by the even row group
  float* pw = part + ((threadIdx.x >> 5) * 4 + (l >> 3)) * WID;
  const bool even = ((l >> 2) & 1) == 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = 8 * i + 2 * q;
    float v[4];
    if constexpr (NJ > 0) {
      v[0] = v[1] = v[2] = v[3] = 0.f;
      float w0[NJ], w1[NJ];
      load_pair<NJ>(Wn, col, w0, w1);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        v[0] += ga[j] * w0[j];
        v[1] += ga[j] * w1[j];
        v[2] += gb[j] * w0[j];
        v[3] += gb[j] * w1[j];
      }
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = d[4 * i + u];
    }
    if constexpr (R1) {
      const float w0 = __bfloat162float(r1w[col]), w1 = __bfloat162float(r1w[col + 1]);
      v[0] += ra * w0;
      v[1] += ra * w1;
      v[2] += rb * w0;
      v[3] += rb * w1;
    }
    if constexpr (MASK != 0) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = ((bits[i >> 3] >> ((4 * i + u) & 31)) & 1u) ? v[u] : 0.f;
    }
    tw.put(i, wg::pack_bf16(v[0], v[1]), wg::pack_bf16(v[2], v[3]));
    float s0 = v[0] + v[2], s1 = v[1] + v[3];
    s0 += __shfl_xor_sync(0xffffffffu, s0, 4);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 4);
    if (even) {
      pw[col] = s0;
      pw[col + 1] = s1;
    }
  }
  fence_async_smem();
  wg_sync(g);
  store_rows(map, act, g, 4, row);
  if (threadIdx.x == 0) BW_ADD(19, clock64() - t_epi);
}

}  // namespace bw

// ------------------------------------------------------------ arguments

namespace planar {

constexpr int LDG = 16;  // row pitch of the head-cotangent scratch

// per-(ray, tile) scratch of one branch (rows are unit-major, R = U * S,
// U = n_rays * n_tiles)
struct Scratch {
  bf16* big;    // bw::n_tiles_of x (R, WID) bf16 tiles (bw::T_*)
  bf16* act0;   // (R, SEG): tower input
  bf16* gh;     // (R, LDG): bf16 head cotangents (rgb | packed heads)
  bf16* ghs;    // (R, LDG): bf16 static sigma cotangent in column 0
  bf16* dirb;   // (N, SEG): bf16 direction embedding, zero-padded
  bf16* ab;     // (N, SEG): bf16 appearance embedding, zero-padded
  bf16* dzrb;   // (N, WID): bf16 per-ray sums of static_dir's dz
  float* dbp;   // NSLOT x (U, WID): per-unit bias-gradient partials
  float* dtp;   // (U, SEG): per-unit f32 sums of the input cotangent (rays of several tiles)
  float* part;  // dW partials of the row splits
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

}  // namespace planar

namespace bw {

using planar::BwdArgs;
using planar::Common;
using planar::LDG;
using planar::Scratch;

// weight maps of one branch, by layer: 0..7 tower, 8 final, 9 static_dir
struct ChainParams {
  CUtensorMap fwd[10];  // (32 K-rows, 64 cols) boxes, 128-byte swizzle
  CUtensorMap bwd[10];  // (64 rows, 32 cols) boxes, 64-byte swizzle
  CUtensorMap big;      // scratch tiles, (64, 64) boxes
  CUtensorMap act0;     // scratch tower input, (64, 64) boxes
  BwdArgs G;
};
static_assert(sizeof(ChainParams) <= 4096, "kernel parameters fit 4 KB");

// ------------------------------------------------------------ chain kernel

// The producer thread: every slab in the consumers' order. Forward: the
// tower, final [, static_dir]; backward: [static_dir,] final, layers 7..1
// (the skip layer's rows SEG..SEG+256), then with dtx the skip layer's
// first SEG rows and layer 0 (two boxes a slab).
__device__ void produce(const ChainParams& P, uint32_t ring, uint32_t bars,
                        bool dir, bool dtx) {
  Ring p;
  auto fwd = [&](int m, int nslab) {
    for (int k = 0; k < nslab; ++k) {
#ifdef WG_PROFILE
      const long long t0 = clock64();
#endif
      mbar_wait(empty_bar(bars, p.stage), p.phase ^ 1u);
      BW_ADD(23, clock64() - t0);
      const uint32_t fb = full_bar(bars, p.stage), dst = ring + p.stage * SLOT;
      mbar_expect_tx(fb, SLOT);
#pragma unroll
      for (int b = 0; b < 4; ++b) tma_load(dst + b * wg::BOX_BYTES, &P.fwd[m], fb, 64 * b, 32 * k);
      p.advance();
    }
  };
  auto bwd = [&](int m, int row0, int nbox) {
    for (int k = 0; k < WID / 32; ++k) {
#ifdef WG_PROFILE
      const long long t0 = clock64();
#endif
      mbar_wait(empty_bar(bars, p.stage), p.phase ^ 1u);
      BW_ADD(23, clock64() - t0);
      const uint32_t fb = full_bar(bars, p.stage), dst = ring + p.stage * SLOT;
      mbar_expect_tx(fb, nbox * 4096u);
      for (int q = 0; q < nbox; ++q) tma_load(dst + q * 4096u, &P.bwd[m], fb, 32 * k, row0 + 64 * q);
      p.advance();
    }
  };
  for (int i = 0; i < DEPTH; ++i) fwd(i, i == 0 ? SEG / 32 : (i == SKIP ? (SEG + WID) / 32 : WID / 32));
  fwd(8, WID / 32);
  if (dir) {
    fwd(9, WID / 32);
    bwd(9, 0, 4);
  }
  bwd(8, 0, 4);
  for (int i = DEPTH - 1; i >= 1; --i) bwd(i, i == SKIP ? SEG : 0, 4);
  if (dtx) {
    bwd(SKIP, 0, 2);
    bwd(0, 0, 2);
  }
}

// The helpers: the branch's 9 layer biases, head weights (static: sigma
// (WID, 1) | rgb (WID, 3); transient: heads (WID, NHEAD)) and head biases.
__device__ void stage_branch(const Common& A, bool stat, float* bias, bf16* hw, float* hb,
                             int h) {
  using namespace planar;
  const int w0 = stat ? W_S0 : W_T0;
  for (int li = 0; li < 9; ++li)
    wg::copy16(bias + li * WID, A.B[li < 8 ? w0 + li : (stat ? W_SFIN : W_TFIN)], WID * 4, h);
  if (stat) {
    wg::copy16(hw, A.W[W_SSIG], WID * 2, h);
    wg::copy16(hw + WID, A.W[W_SRGB], WID * 3 * 2, h);
  } else {
    wg::copy16(hw, A.W[W_THEAD], WID * NHEAD * 2, h);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (stat) {
    if (h == 0) hb[0] = A.B[W_SSIG][0];
    else if (h < 4) hb[h] = A.B[W_SRGB][h - 1];
  } else if (h < NHEAD) {
    hb[h] = A.B[W_THEAD][h];
  }
}

// 16 bf16 of a row (the first nv from v, zeros after) as two 16-byte stores
__device__ __forceinline__ void store_row16(bf16* dst, const float* v, int nv) {
  uint32_t u[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    u[k] = wg::pack_bf16(2 * k < nv ? v[2 * k] : 0.f, 2 * k + 1 < nv ? v[2 * k + 1] : 0.f);
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(u[0], u[1], u[2], u[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(u[4], u[5], u[6], u[7]);
}

// column c of the 32 row-group partials, rows 0-3 first (after a barrier)
__device__ __forceinline__ float col_total(const float* part) {
  float v = 0.f;
#pragma unroll
  for (int w = 0; w < 32; ++w) v += part[w * WID + threadIdx.x];
  return v;
}

// One backward layer's epilogue, then (after a barrier) the column sums of
// its dz, warp 0 first, to this ray's bias-gradient partial dst.
template <int MASK, bool R1, int NJ>
__device__ __forceinline__ void bwd_step(float (&d)[128], const uint4* mask, const float* r1g,
                                         const bf16* r1w, const float* gq, const bf16* Wn,
                                         unsigned char* act, int g, float* part,
                                         const CUtensorMap* map, int row, float* dst) {
  epi_bwd<MASK, R1, NJ>(d, mask, r1g, r1w, gq, Wn, act, g, part, map, row);
#ifdef WG_PROFILE
  const long long t0 = clock64();
#endif
  consumers_sync();
  dst[threadIdx.x] = col_total(part);
  if (threadIdx.x == 0) BW_ADD(22, clock64() - t0);
}

// d(dir) and d(a) of a ray from ray_b = bf16 of its sum of static_dir's
// dz: warp per output, the row of Wdir read coalesced, a fixed order
__device__ __forceinline__ void dir_grads(const Common& A, const BwdArgs& G,
                                          const float* ray_b, int ray, int tid) {
  const bf16* Wd = A.W[planar::W_SDIR];
  const int warp = tid >> 5, lane = tid & 31;
  for (int j = warp; j < A.dir_w + (A.encode_a ? A.n_a : 0); j += NCONS / 32) {
    const bool is_dir = j < A.dir_w;
    const bf16* wr = Wd + size_t(is_dir ? WID + j : WID + SEG + j - A.dir_w) * WID;
    float v = 0.f;
    for (int c = lane; c < WID; c += 32) v += ray_b[c] * __bfloat162float(wr[c]);
    v = planar::warp_sum(v);
    if (lane == 0) {
      if (is_dir) G.ddir[size_t(ray) * A.dir_w + j] = v;
      else G.da[size_t(ray) * A.n_a + j - A.dir_w] = v;
    }
  }
}

// A ray of several tiles, one CTA of NCONS threads: its sums over the
// tiles, in tile order, of static_dir's column sums (the bf16 dzrb row,
// d(dir), d(a)) or of the time lanes of the input cotangent (d(t)),
// rounded as the chain kernel rounds a one-tile ray's.
__global__ void __launch_bounds__(NCONS) ray_reduce_kernel(const BwdArgs G) {
  const Common& A = G.c;
  const Scratch& X = G.sc;
  const int ray = blockIdx.x, tid = threadIdx.x, nt = A.n_tiles;
  const size_t U = size_t(A.n_rays) * nt, u0 = size_t(ray) * nt;
  __shared__ float ray_b[WID];
  if (X.dzrb != nullptr) {
    float cs = 0.f;
    for (int t = 0; t < nt; ++t) cs += X.dbp[(size_t(planar::W_SDIR) * U + u0 + t) * WID + tid];
    X.dzrb[size_t(ray) * WID + tid] = __float2bfloat16_rn(cs);
    ray_b[tid] = planar::bfr(cs);
    __syncthreads();
    dir_grads(A, G, ray_b, ray, tid);
  }
  if (X.dtp != nullptr && tid < A.n_tau) {
    float v = 0.f;
    for (int t = 0; t < nt; ++t) v += X.dtp[(u0 + t) * SEG + tid];
    G.dt[size_t(ray) * A.n_tau + tid] = planar::bfr(v);
  }
}

// STATIC: the static branch (else transient); VIEWDIR: the static_dir
// layer; DTX: the input cotangent (always for the transient branch, for
// the static one only when the point cotangent is asked for). Each is a
// template parameter so that no product sits on a run-time branch (ptxas
// serializes wgmma there).
template <bool STATIC, bool VIEWDIR, bool DTX>
__global__ void __launch_bounds__(NTHR, 1)
train_bwd_chain_kernel(const __grid_constant__ ChainParams P) {
  static_assert(STATIC || (DTX && !VIEWDIR), "the transient branch needs dtx");
  using namespace planar;
  extern __shared__ __align__(1024) unsigned char sm[];
  if ((saddr(sm) & 1023u) != 0) __trap();
  const BwdArgs& G = P.G;
  const Common& A = G.c;
  const Scratch& X = G.sc;
  const uint32_t ring = saddr(sm + OFF_RING), bars = saddr(sm + OFF_BAR);
  // unit (ray, tile): rows s0.. of the ray, nv of them real; a ray of one
  // tile writes its per-ray sums itself (whole), else ray_reduce_kernel
  const int tid = threadIdx.x, unit = blockIdx.x;
  const int ray = unit / A.n_tiles, tile = unit % A.n_tiles;
  const int s0 = tile * S, nv = min(S, A.n_samples - s0);
  const bool whole = A.n_tiles == 1;
  constexpr bool viewdir = STATIC && VIEWDIR;
  constexpr bool need_dtx = DTX;
  const bool packed = A.xyz != nullptr;
  const bool with_flow = !packed && A.flows[0] != nullptr;
  const bool want_dx = G.dflows[0] != nullptr;
  float* ray_b = reinterpret_cast<float*>(sm + OFF_RAYB);
  float* bias = reinterpret_cast<float*>(sm + OFF_BIAS);
  bf16* hw = reinterpret_cast<bf16*>(sm + OFF_HW);
  float* hb = reinterpret_cast<float*>(sm + OFF_HB);
  if (tid == 0) init_bars(bars);
  __syncthreads();

  if (tid >= NCONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == NCONS) {
      produce(P, ring, bars, viewdir, need_dtx);
    } else if (tid >= HELP0) {
      const int h = tid - HELP0;
      stage_branch(A, STATIC, bias, hw, hb, h);
      wg::bar_arrive(wg::BAR_PARAMS, NCONS + NHELP);
      if constexpr (viewdir) {
        wg::dir_bias(A.W[W_SDIR], A.B[W_SDIR], A.dir + size_t(ray) * A.dir_w, A.dir_w,
                     A.encode_a ? A.a + size_t(ray) * A.n_a : nullptr, A.n_a, ray_b, h);
        wg::bar_arrive(wg::BAR_DIR, NCONS + NHELP);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  BW_STAMP(0);
  float* r1g = reinterpret_cast<float*>(sm + OFF_R1G);
  float* zsh = reinterpret_cast<float*>(sm + OFF_ZS);
  float* fl = reinterpret_cast<float*>(sm + OFF_FL);
  float* od = reinterpret_cast<float*>(sm + OFF_OD);
  unsigned char* act = sm + OFF_ACT;
  unsigned char* pe = sm + OFF_PE;
  // after the forward: cotangent planes and head outputs (then gq) in pe
  float* gp = reinterpret_cast<float*>(pe + PE_G);
  float* hp = reinterpret_cast<float*>(pe + PE_H);
  const uint4* maskr = reinterpret_cast<const uint4*>(sm + OFF_MASK);
  uint4* maskw = reinterpret_cast<uint4*>(sm + OFF_MASK);
  // scratch rows row0.. of the unit; rows xrow0.. of the ray's planes
  const size_t U = size_t(A.n_rays) * A.n_tiles;
  const size_t R = U * S, row0 = size_t(unit) * S;
  const size_t xrow0 = size_t(ray) * A.n_samples + s0;
  const int w0 = STATIC ? W_S0 : W_T0;
  auto dbp = [&](int slot) { return X.dbp + (size_t(slot) * U + unit) * WID; };

  // ---- the ray's data and per-ray embeddings ----
  if (packed) {
    for (int e = tid; e < 3 * S; e += NCONS)
      fl[e] = A.xyz[(xrow0 + min(e / 3, nv - 1)) * 3 + e % 3];
  } else {
    if (tid < S) {
      const size_t r = xrow0 + min(tid, nv - 1);
      zsh[tid] = A.zs[r];
      if (with_flow)
        for (int c = 0; c < 3; ++c) fl[tid * 3 + c] = A.flows[c][r];
    } else if (tid < S + 6) {
      const int c = tid - S;
      od[c] = c < 3 ? A.o[ray * 3 + c] : A.d[ray * 3 + c - 3];
    }
  }
  if (viewdir && tid < SEG && tile == 0) {
    X.dirb[size_t(ray) * SEG + tid] =
        __float2bfloat16_rn(tid < A.dir_w ? A.dir[size_t(ray) * A.dir_w + tid] : 0.f);
    if (A.encode_a)
      X.ab[size_t(ray) * SEG + tid] =
          __float2bfloat16_rn(tid < A.n_a ? A.a[size_t(ray) * A.n_a + tid] : 0.f);
  }
  consumers_sync();

  // ---- posenc tile (+ the time latent for the transient tower), the
  // forward's bits (wg::posenc_tile) ----
  {
    const float* t = STATIC ? nullptr : A.t + size_t(ray) * A.n_tau;
    if (packed)
      wg::posenc_tile<wg::PE_PTS>(pe, A.freqs, A.xyz_w, t, A.n_tau, fl, nullptr, nullptr);
    else if (with_flow)
      wg::posenc_tile<wg::PE_RAY_FLOW>(pe, A.freqs, A.xyz_w, t, A.n_tau, fl, od, zsh);
    else
      wg::posenc_tile<wg::PE_RAY>(pe, A.freqs, A.xyz_w, t, A.n_tau, nullptr, od, zsh);
  }
  fence_async_smem();
  consumers_sync();
  const int g = tid >> 7;
  const int grow = int(row0) + 64 * g;  // the warpgroup's first row in a tile
  auto trow = [&](int t) { return t * int(R) + grow; };
  store_rows(&P.act0, pe, g, 2, grow);
  bar_sync(wg::BAR_PARAMS, NCONS + NHELP);
  BW_STAMP(1);

  const uint32_t pe_g = saddr(pe) + g * WGR, act_g = saddr(act) + g * WGR;
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  Ring p;

  // ---- forward recompute: every activation to scratch, ReLU bits kept ----
  for (int i = 0; i < DEPTH; ++i) {
    mma_layer<0>(d, p, ring, bars, pe_g, (i == 0 || i == SKIP) ? SEG : 0, act_g,
                 i == 0 ? 0 : WID);
    epi_fwd<true>(d, bias + i * WID, act, g, maskw + i * NCONS, &P.big, trow(T_ACT + i));
  }
  BW_STAMP(2);
  mma_layer<0>(d, p, ring, bars, pe_g, 0, act_g, WID);
  BW_STAMP(3);
  if constexpr (STATIC) {
    if constexpr (viewdir) {
      // feat0b = bf16(h8 @ Wfin + b); featb = bf16(relu(feat0b @ Wdir + ray_b))
      epi_fwd<false>(d, bias + 8 * WID, act, g, nullptr, &P.big, trow(T_FA));
      BW_STAMP(4);
      mma_layer<0>(d, p, ring, bars, pe_g, 0, act_g, WID);
      bar_sync(wg::BAR_DIR, NCONS + NHELP);
      BW_STAMP(5);
      // featb stays in the tile: the first backward epilogue reads its mask
      epi_fwd<true>(d, ray_b, act, g, nullptr, &P.big, trow(T_FB));
    } else {
      epi_fwd<false>(d, bias + 8 * WID, act, g, nullptr, &P.big, trow(T_FA));
      BW_STAMP(4); BW_STAMP(5);
    }
    tile_heads<3>(act, hw + WID, hb + 1, hp);  // rgb
  } else {
    epi_fwd<false>(d, bias + 8 * WID, act, g, nullptr, &P.big, trow(T_FA));
    BW_STAMP(4); BW_STAMP(5);
    tile_heads<NHEAD>(act, hw, hb, hp);
  }
  BW_STAMP(6);
  // the branch's cotangent planes
  const int ng = STATIC ? 4 : NHEAD;
  for (int e = tid; e < ng * S; e += NCONS) {
    const int k = e / S, s = e % S;
    gp[e] = G.g[k] != nullptr && s < nv ? G.g[k][(xrow0 + s) * G.g_stride] : 0.f;
  }
  consumers_sync();
  BW_STAMP(7);

  // ---- head adjoints (thread per sample): the f32 cotangents stay in gp,
  // their bf16 values go to hp (the narrow products) and scratch ----
  if (tid < S) {
    const int s = tid;
    float gv[NHEAD];
    if (STATIC) {
      for (int c = 0; c < 3; ++c) {
        const float sg = sigmoid(hp[c * S + s]);
        gv[c] = gp[c * S + s] * sg * (1.f - sg);
      }
      const float gs = gp[3 * S + s];
      r1g[s] = bfr(gs);
      store_row16(X.ghs + (row0 + s) * LDG, &gs, 1);
    } else {
      gv[0] = gp[3 * S + s];
      for (int c = 0; c < 3; ++c) {
        const float tv = sigmoid(hp[(1 + c) * S + s]);
        gv[1 + c] = gp[c * S + s] * tv * (1.f - tv);
      }
      for (int c = 4; c < NHEAD; ++c) {
        const float tf = tanhf(hp[c * S + s]);
        gv[c] = gp[c * S + s] * A.flow_scale * (1.f - tf * tf);
      }
    }
    const int nc = STATIC ? 3 : NHEAD;
    for (int c = 0; c < nc; ++c) {
      gp[c * S + s] = gv[c];
      hp[c * S + s] = bfr(gv[c]);
    }
    store_row16(X.gh + (row0 + s) * LDG, gv, nc);
  }
  consumers_sync();
  {  // head bias partials, warp per plane, a fixed order
    const int warp = tid >> 5, lane = tid & 31;
    for (int k = warp; k < ng; k += NCONS / 32) {
      float v = 0.f;
      for (int s = lane; s < S; s += 32) v += gp[k * S + s];
      v = warp_sum(v);
      if (lane == 0) {
        if (!STATIC) dbp(W_THEAD)[k] = v;
        else if (k < 3) dbp(W_SRGB)[k] = v;
        else dbp(W_SSIG)[0] = v;
      }
    }
  }

  BW_STAMP(8);
  // ---- backward: every dz to scratch, its column sums to dbp ----
  // One buffer of column-sum partials over the posenc tile: a warpgroup
  // cannot write the next layer's before the other has read this one's,
  // since it cannot finish that layer's products (8 slabs) while the other
  // still holds the ring's 5 slots. The first backward epilogue computes
  // the head product dfeat = bf16(g) @ Wh^T from the gq planes itself.
  float* const part = reinterpret_cast<float*>(pe);
  if constexpr (STATIC) {
    if constexpr (viewdir) {
      // dz = dfeat * (feat > 0), feat's mask from the tile; dzrb = bf16(ray
      // sum); ddir, da from it
      epi_bwd<2, false, 3>(d, nullptr, nullptr, nullptr, hp, hw + WID, act, g, part, &P.big,
                           trow(T_DZA));
      consumers_sync();
      const float cs = col_total(part);
      BW_STAMP(10);
      dbp(W_SDIR)[tid] = cs;
      if (whole) {
        X.dzrb[size_t(ray) * WID + tid] = __float2bfloat16_rn(cs);
        ray_b[tid] = bfr(cs);
        consumers_sync();
        dir_grads(A, G, ray_b, ray, tid);
      }
      // dfeat0 = dz @ Wdir[:256]^T
      mma_layer<1>(d, p, ring, bars, 0, 0, act_g, WID);
    }
    if constexpr (viewdir)
      bwd_step<0, false, 0>(d, nullptr, nullptr, nullptr, nullptr, nullptr, act, g, part,
                            &P.big, trow(T_DZF), dbp(W_SFIN));
    else  // no viewdir: dfeat0 = dfeat
      bwd_step<0, false, 3>(d, nullptr, nullptr, nullptr, hp, hw + WID, act, g, part,
                            &P.big, trow(T_DZF), dbp(W_SFIN));
    // dz7 = (dfeat0 @ Wfin^T + bf16(g_ssig) Wsig^T) * (h8 > 0)
    mma_layer<1>(d, p, ring, bars, 0, 0, act_g, WID);
    bwd_step<1, true, 0>(d, maskr + 7 * NCONS, r1g, hw, nullptr, nullptr, act, g, part,
                         &P.big, trow(T_DZ + 7), dbp(w0 + 7));
  } else {
    // dtfeat = bf16(g_th) @ Wth^T
    bwd_step<0, false, NHEAD>(d, nullptr, nullptr, nullptr, hp, hw, act, g, part, &P.big,
                              trow(T_DZF), dbp(W_TFIN));
    BW_STAMP(10);
    mma_layer<1>(d, p, ring, bars, 0, 0, act_g, WID);
    bwd_step<1, false, 0>(d, maskr + 7 * NCONS, nullptr, nullptr, nullptr, nullptr, act, g,
                          part, &P.big, trow(T_DZ + 7), dbp(w0 + 7));
  }
  BW_STAMP(11);
  for (int i = DEPTH - 1; i >= 1; --i) {
    mma_layer<1>(d, p, ring, bars, 0, 0, act_g, WID);
    bwd_step<1, false, 0>(d, maskr + (i - 1) * NCONS, nullptr, nullptr, nullptr, nullptr, act,
                          g, part, &P.big, trow(T_DZ + i - 1), dbp(w0 + i - 1));
  }
  BW_STAMP(12);
  const bool leader = (tid & 127) == 0;
  if constexpr (!need_dtx) {
    if (leader) bulk_wait();
    BW_STAMP(13);
    return;
  }

  // ---- input cotangent dtx = dz4 @ W4[:SEG]^T + dz0 @ W0^T (N = SEG):
  // dz4 comes back from scratch into a tile over the posenc tile and the
  // mask bits (both free now), beside dz0 in the activation tile ----
  consumers_sync();
  unsigned char* dz4t = pe;
  const uint32_t rbar = bars + 8u * (2 * ST + g);
  if (leader) {
    bulk_wait();  // this warpgroup's stores, dz4 among them, are complete
    mbar_expect_tx(rbar, 4 * WGR);
    for (int cb = 0; cb < 4; ++cb)
      tma_load(saddr(dz4t) + cb * BLK + g * WGR, &P.big, rbar, 64 * cb, trow(T_DZ + SKIP));
  }
  mbar_wait(rbar, 0);
  float e[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) e[i] = 0.f;
  mma_layer<2>(e, p, ring, bars, saddr(dz4t) + g * WGR, WID, act_g, WID);
  consumers_sync();
  float* dtx = reinterpret_cast<float*>(act);  // (S, LDT) over the act + posenc tiles
  {
    const int t = tid & 127, w = t >> 5, l = t & 31, q = l & 3;
    const int r = 64 * g + 16 * w + (l >> 2);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = 8 * i + 2 * q;
      *reinterpret_cast<float2*>(dtx + r * LDT + col) = make_float2(e[4 * i], e[4 * i + 1]);
      *reinterpret_cast<float2*>(dtx + (r + 8) * LDT + col) =
          make_float2(e[4 * i + 2], e[4 * i + 3]);
    }
  }
  consumers_sync();
  // dt = bf16(ray sum of dtx) on the time-latent lanes
  if (!STATIC) {  // warp per lane, a fixed order
    const int warp = tid >> 5, lane = tid & 31;
    for (int j = warp; j < A.n_tau; j += NCONS / 32) {
      float v = 0.f;
      for (int s = lane; s < S; s += 32) v += dtx[s * LDT + A.xyz_w + j];
      v = warp_sum(v);
      if (lane == 0) {
        if (whole) G.dt[size_t(ray) * A.n_tau + j] = bfr(v);
        else X.dtp[size_t(unit) * SEG + j] = v;
      }
    }
  }
  // dx_c = sum over the lanes j of channel c of dxs_j * f_j, with
  // dxs = dtx on identity lanes and dtx * cos(xs + phase) on sine lanes
  if (want_dx) {
    const int warp = tid >> 5, lane = tid & 31;
    for (int s = warp; s < nv; s += NCONS / 32) {
      float acc3[3] = {0.f, 0.f, 0.f};
      for (int j = lane; j < A.xyz_w; j += 32) {
        bool id;
        float ph;
        const float xs = packed ? posenc_xs_pt(A.freqs, fl + 3 * s, j, id, ph)
                                : posenc_xs(A.freqs, od, with_flow ? fl + 3 * s : nullptr,
                                            zsh[s], j, id, ph);
        const float gj = dtx[s * LDT + j];
        const int c = j < 3 ? j : ((j - 3) % 6) % 3;
        const float f = j < 3 ? 1.f : A.freqs[(j - 3) / 6];
        const float dxs =
            id ? gj : gj * sin_poly(__fadd_rn(__fadd_rn(xs, ph), 1.5707963267948966f));
        acc3[c] += G.round_dx ? bfr(dxs) * bfr(f) : dxs * f;
      }
      for (int c = 0; c < 3; ++c) {
        const float v = warp_sum(acc3[c]);
        if (lane == 0) G.dflows[c][(xrow0 + s) * G.dx_stride] = v;
      }
    }
  }
  BW_STAMP(13);
}

}  // namespace bw

// ------------------------------------------------------------ dW kernels

namespace bw {

// A wide job: out (ka, WID) = A^T dz over `rows` rows, A from map a_map at
// rows a_row0.. (columns 0..ka), dz from map b_map at rows b_row0..;
// ka / 128 output tiles of (128, WID).
struct WJob {
  float* out;
  int a_map, a_row0, b_map, b_row0, ka, rows, tile0;
  long long part_off;
};
enum { M_BIG = 0, M_ACT0, M_DIRB, M_AB, M_DZRB, NGMAPS };
constexpr int MAXW = 16;
struct GemmParams {
  CUtensorMap maps[NGMAPS];  // (64, 64) boxes, 128-byte swizzle
  WJob j[MAXW];
  int n, n_tiles, nsplit;
  float* part;
};
static_assert(sizeof(GemmParams) <= 4096, "kernel parameters fit 4 KB");

constexpr uint32_t GBOX = 8192;            // (64 rows, 64 cols) bf16
constexpr uint32_t GSTAGE = 6 * GBOX;      // A: 2 boxes, dz: 4 boxes
constexpr int GST = 4;                     // ring stages of the GEMM
constexpr size_t GSMEM = GST * GSTAGE + 64;
constexpr int GTHR = NCONS + 32;           // two consumer warpgroups + a producer warp

// One (128, WID) tile of a wide job over one row split: warpgroup g owns
// dW rows k0 + 64 g.., both operands MN-major (transpose bits) from a
// 4-stage ring of 64-row stages; the partial goes to its split's buffer.
__global__ void __launch_bounds__(GTHR, 1) dw_gemm_kernel(const __grid_constant__ GemmParams P) {
  extern __shared__ __align__(1024) unsigned char sm[];
  if ((saddr(sm) & 1023u) != 0) __trap();
  const uint32_t stages = saddr(sm), bars = saddr(sm + GST * GSTAGE);
  int ji = 0;
  while (ji + 1 < P.n && int(blockIdx.x) >= P.j[ji + 1].tile0) ++ji;
  const WJob& jb = P.j[ji];
  const int k0 = 128 * (int(blockIdx.x) - jb.tile0);
  const int split = blockIdx.y;
  const int per = ((jb.rows + P.nsplit - 1) / P.nsplit + 63) / 64 * 64;
  const int r0 = split * per, r1 = min(jb.rows, r0 + per);
  const int nst = r1 > r0 ? (r1 - r0 + 63) / 64 : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < GST; ++s) {
      mbar_init(full_bar(bars, s), 1);
      mbar_init(empty_bar<GST>(bars, s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= NCONS) {
    if (threadIdx.x == NCONS) {
      RingN<GST> p;
      for (int st = 0; st < nst; ++st) {
        mbar_wait(empty_bar<GST>(bars, p.stage), p.phase ^ 1u);
        const uint32_t fb = full_bar(bars, p.stage), dst = stages + p.stage * GSTAGE;
        mbar_expect_tx(fb, GSTAGE);
        const int ra = jb.a_row0 + r0 + 64 * st, rb = jb.b_row0 + r0 + 64 * st;
        for (int g = 0; g < 2; ++g) tma_load(dst + g * GBOX, &P.maps[jb.a_map], fb, k0 + 64 * g, ra);
        for (int q = 0; q < 4; ++q) tma_load(dst + (2 + q) * GBOX, &P.maps[jb.b_map], fb, 64 * q, rb);
        p.advance();
      }
    }
    return;
  }
  const int g = threadIdx.x >> 7;
  const bool leader = (threadIdx.x & 127) == 0;
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  RingN<GST> p;
  int prev = -1;
  wgmma_fence();
  for (int st = 0; st < nst; ++st) {
    mbar_wait(full_bar(bars, p.stage), p.phase);
    const uint32_t a = stages + p.stage * GSTAGE + g * GBOX;
    const uint32_t b = stages + p.stage * GSTAGE + 2 * GBOX;
#pragma unroll
    for (int kq = 0; kq < 4; ++kq)
      // 16 rows (the K of the product) = 2048 bytes on in both operands
      mma_n256<1, 1>(d, wg::sw128_desc(a + 2048 * kq, GBOX, 1024),
                     wg::sw128_desc(b + 2048 * kq, GBOX, 1024), 1);
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      if (leader) mbar_arrive(empty_bar<GST>(bars, prev));
    }
    prev = p.stage;
    p.advance();
  }
  wgmma_wait<0>();
  wg::fence_acc(d);
  const int t = threadIdx.x & 127, w = t >> 5, l = t & 31, q = l & 3;
  const int r = 64 * g + 16 * w + (l >> 2);
  float* pp = P.part + jb.part_off + size_t(split) * jb.ka * WID + size_t(k0) * WID;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = 8 * i + 2 * q;
    *reinterpret_cast<float2*>(pp + r * WID + col) = make_float2(d[4 * i], d[4 * i + 1]);
    *reinterpret_cast<float2*>(pp + (r + 8) * WID + col) = make_float2(d[4 * i + 2], d[4 * i + 3]);
  }
}

// A narrow job on CUDA cores: out (WID, nb) = A^T B over `rows` rows, A
// (rows, WID) and B (rows, LDG) bf16, nb <= NHEAD; thread per dW row k.
struct NJob {
  const bf16* A; const bf16* B; float* out;
  int nb, rows;
  long long part_off;
};
struct NJobs {
  NJob j[3];
  int n;
  float* part;
};
constexpr int NSPLIT_N = 512;  // row splits of the narrow jobs

// Rows in chunks of 64: the chunk's B rows staged in shared memory as f32
// (zeros past the job's nb columns and rows), then 16 rows of A loaded
// ahead at a time; every job runs NHEAD products a row.
__global__ void __launch_bounds__(WID) dw_narrow_kernel(const NJobs J) {
  __shared__ float bs[64 * NHEAD];
  const NJob& jb = J.j[blockIdx.x];
  const int split = blockIdx.y, k = threadIdx.x, nb = jb.nb;
  const int per = (jb.rows + NSPLIT_N - 1) / NSPLIT_N;
  const int r0 = split * per, r1 = min(jb.rows, r0 + per);
  float acc[NHEAD];
#pragma unroll
  for (int j = 0; j < NHEAD; ++j) acc[j] = 0.f;
  for (int rb = r0; rb < r1; rb += 64) {
    const int nr = min(64, r1 - rb);
    __syncthreads();
    for (int e = threadIdx.x; e < 64 * NHEAD; e += WID) {
      const int rr = e / NHEAD, j = e % NHEAD;
      bs[e] = rr < nr && j < nb ? __bfloat162float(jb.B[size_t(rb + rr) * LDG + j]) : 0.f;
    }
    __syncthreads();
    const bf16* a_col = jb.A + size_t(rb) * WID + k;
#pragma unroll 16
    for (int rr = 0; rr < 64; ++rr) {
      const float a = rr < nr ? __bfloat162float(a_col[size_t(rr) * WID]) : 0.f;
#pragma unroll
      for (int j = 0; j < NHEAD; ++j) acc[j] += a * bs[rr * NHEAD + j];
    }
  }
  // partials split-minor: element e of split s at e * NSPLIT_N + s
  float* pp = J.part + jb.part_off + split;
  for (int j = 0; j < nb; ++j) pp[size_t(k * nb + j) * NSPLIT_N] = acc[j];
}

// out[e] = sum over the splits s of the partials at off + s * s_stride +
// e * e_stride: split 0 first (few splits: thread per element), or as a
// fixed tree over the lanes of a warp (many splits: warp per element)
struct Red {
  float* out;
  long long off;
  int nsplit, elems, s_stride, e_stride;
};
struct Reds {
  Red r[MAXW + 3];
  int n;
  const float* part;
};

__global__ void dw_reduce_kernel(const Reds Z) {
  const int lane = threadIdx.x & 31;
  const int gwarp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int nwarps = gridDim.x * blockDim.x / 32;
  for (int ri = 0; ri < Z.n; ++ri) {
    const Red& rd = Z.r[ri];
    const float* p = Z.part + rd.off;
    if (rd.nsplit < 32) {
      for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < rd.elems;
           e += gridDim.x * blockDim.x) {
        float v = 0.f;
        for (int s = 0; s < rd.nsplit; ++s) v += p[size_t(s) * rd.s_stride + size_t(e) * rd.e_stride];
        rd.out[e] = v;
      }
    } else {
      for (int e = gwarp; e < rd.elems; e += nwarps) {
        float v = 0.f;
        for (int s = lane; s < rd.nsplit; s += 32) v += p[size_t(s) * rd.s_stride + size_t(e) * rd.e_stride];
        v = planar::warp_sum(v);
        if (lane == 0) rd.out[e] = v;
      }
    }
  }
}

// db[slot][c] = sum over (ray, tile) units (in order) of their partials
struct Biases {
  float* out[NSLOT];
  int width[NSLOT];
  const float* dbp;
  int n_units;
};

__global__ void db_reduce_kernel(const Biases Bz) {
  const int slot = blockIdx.x, c = threadIdx.x;
  if (Bz.out[slot] == nullptr || c >= Bz.width[slot]) return;
  const float* p = Bz.dbp + size_t(slot) * Bz.n_units * WID + c;
  float v = 0.f;
  for (int r = 0; r < Bz.n_units; ++r) v += p[size_t(r) * WID];
  Bz.out[slot][c] = v;
}

// ------------------------------------------------------------ host side

inline size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

inline bool encode2d(CUtensorMap* m, const void* p, int cols, size_t rows, int box_c, int box_r,
                     CUtensorMapSwizzle sw) {
  cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  cuuint64_t strides[1] = {cuuint64_t(cols) * 2};
  cuuint32_t box[2] = {cuuint32_t(box_c), cuuint32_t(box_r)};
  cuuint32_t estr[2] = {1, 1};
  return cuTensorMapEncodeTiled(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p),
                                dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The scratch layout of one branch for n rays of nu (ray, tile) units (the
// dW partials last); with base == nullptr only the size without the
// partials.
inline Scratch scratch_layout(unsigned char* base, bool stat, int n, int nu, int viewdir,
                              int encode_a, size_t* bytes) {
  const size_t R = size_t(nu) * S;
  const bool dir = stat && viewdir;
  size_t off = 0;
  auto take = [&](size_t b) { size_t o = off; off += align256(b); return base + o; };
  Scratch X;
  X.big = reinterpret_cast<bf16*>(take(size_t(n_tiles_of(stat, viewdir)) * R * WID * 2));
  X.act0 = reinterpret_cast<bf16*>(take(R * SEG * 2));
  X.gh = reinterpret_cast<bf16*>(take(R * LDG * 2));
  X.ghs = stat ? reinterpret_cast<bf16*>(take(R * LDG * 2)) : nullptr;
  X.dirb = dir ? reinterpret_cast<bf16*>(take(size_t(n) * SEG * 2)) : nullptr;
  X.ab = dir && encode_a ? reinterpret_cast<bf16*>(take(size_t(n) * SEG * 2)) : nullptr;
  X.dzrb = dir ? reinterpret_cast<bf16*>(take(size_t(n) * WID * 2)) : nullptr;
  X.dbp = reinterpret_cast<float*>(take(size_t(NSLOT) * nu * WID * 4));
  X.dtp = !stat && nu > n ? reinterpret_cast<float*>(take(size_t(nu) * SEG * 4)) : nullptr;
  X.part = reinterpret_cast<float*>(base + off);
  *bytes = off;
  return X;
}

inline int sm_count() {
  int dev = 0, nsm = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    nsm = 132;
  return nsm;
}

// The dW jobs of one branch (dw may be null when only sizing); returns the
// floats of all partials. Wide splits: as many as fill the SMs once.
inline size_t make_jobs(GemmParams& gp, NJobs& nj, Reds& rz, bool stat, int n, int nu,
                        int viewdir, int encode_a, const Scratch& X, float* const* dw,
                        int nsm) {
  using namespace planar;
  const int R = nu * S;
  const bool dir = stat && viewdir;
  const int w0 = stat ? W_S0 : W_T0;
  gp.n = 0;
  gp.n_tiles = 0;
  auto out = [&](int slot, int row) {
    return dw != nullptr && dw[slot] != nullptr ? dw[slot] + size_t(row) * WID : nullptr;
  };
  auto wide = [&](int slot, int row, int a_map, int a_row0, int b_map, int b_row0, int ka,
                  int rows) {
    WJob& jb = gp.j[gp.n++];
    jb.out = out(slot, row);
    jb.a_map = a_map; jb.a_row0 = a_row0; jb.b_map = b_map; jb.b_row0 = b_row0;
    jb.ka = ka; jb.rows = rows; jb.tile0 = gp.n_tiles;
    gp.n_tiles += ka / 128;
  };
  wide(w0, 0, M_ACT0, 0, M_BIG, T_DZ * R, SEG, R);
  for (int i = 1; i < DEPTH; ++i) {
    if (i == SKIP) {
      wide(w0 + i, 0, M_ACT0, 0, M_BIG, (T_DZ + i) * R, SEG, R);
      wide(w0 + i, SEG, M_BIG, (T_ACT + i - 1) * R, M_BIG, (T_DZ + i) * R, WID, R);
    } else {
      wide(w0 + i, 0, M_BIG, (T_ACT + i - 1) * R, M_BIG, (T_DZ + i) * R, WID, R);
    }
  }
  wide(stat ? W_SFIN : W_TFIN, 0, M_BIG, (T_ACT + 7) * R, M_BIG, T_DZF * R, WID, R);
  if (dir) {
    wide(W_SDIR, 0, M_BIG, T_FA * R, M_BIG, T_DZA * R, WID, R);
    wide(W_SDIR, WID, M_DIRB, 0, M_DZRB, 0, SEG, n);
    if (encode_a) wide(W_SDIR, WID + SEG, M_AB, 0, M_DZRB, 0, SEG, n);
  }
  gp.nsplit = nsm / gp.n_tiles > 1 ? nsm / gp.n_tiles : 1;
  gp.part = X.part;

  nj.n = 0;
  nj.part = X.part;
  auto narrow_job = [&](int slot, const bf16* A, const bf16* B, int nb) {
    NJob& jb = nj.j[nj.n++];
    jb.A = A; jb.B = B; jb.out = out(slot, 0); jb.nb = nb; jb.rows = R;
  };
  auto tile = [&](int t) { return X.big + size_t(t) * R * WID; };
  if (stat) {
    narrow_job(W_SSIG, tile(T_ACT + 7), X.ghs, 1);
    narrow_job(W_SRGB, tile(dir ? T_FB : T_FA), X.gh, 3);
  } else {
    narrow_job(W_THEAD, tile(T_FA), X.gh, NHEAD);
  }

  rz.n = 0;
  rz.part = X.part;
  long long off = 0;
  for (int i = 0; i < gp.n; ++i) {
    WJob& jb = gp.j[i];
    jb.part_off = off;
    rz.r[rz.n++] = {jb.out, off, gp.nsplit, jb.ka * WID, jb.ka * WID, 1};
    off += (long long)gp.nsplit * jb.ka * WID;
  }
  for (int i = 0; i < nj.n; ++i) {
    NJob& jb = nj.j[i];
    jb.part_off = off;
    rz.r[rz.n++] = {jb.out, off, NSPLIT_N, WID * jb.nb, 1, NSPLIT_N};
    off += (long long)NSPLIT_N * WID * jb.nb;
  }
  return size_t(off);
}

}  // namespace bw

namespace planar {

inline size_t bwd_scratch_bytes(bool stat, int n_rays, int n_samples, int use_viewdir,
                                int encode_a) {
  size_t bytes = 0;
  const int nu = n_rays * tiles_of(n_samples);
  Scratch X = bw::scratch_layout(nullptr, stat, n_rays, nu, use_viewdir, encode_a, &bytes);
  bw::GemmParams gp;
  bw::NJobs nj;
  bw::Reds rz;
  const size_t part = bw::make_jobs(gp, nj, rz, stat, n_rays, nu, use_viewdir, encode_a, X,
                                    nullptr, bw::sm_count());
  return bytes + part * 4;
}

// The launches of one branch: chain, dW GEMM, narrow dW, reductions. G.c,
// G.g, the output pointers and the strides are filled by the caller; the
// scratch layout and the tensor maps are set here, at each launch.
inline cudaError_t launch_branch_bwd(BwdArgs& G, bool stat, int use_viewdir, int encode_a,
                                     void* scratch, void* const* dw, void* const* db,
                                     cudaStream_t s) {
  using namespace bw;
  const int n = G.c.n_rays, nu = n * G.c.n_tiles;
  const size_t R = size_t(nu) * S;
  const bool dir = stat && use_viewdir;
  size_t bytes = 0;
  G.sc = scratch_layout(static_cast<unsigned char*>(scratch), stat, n, nu, use_viewdir,
                        encode_a, &bytes);
  float* dwf[NSLOT];
  for (int i = 0; i < NSLOT; ++i) dwf[i] = static_cast<float*>(dw[i]);

  ChainParams* cp = new ChainParams;  // ~3.6 KB: off the host stack
  memset(cp, 0, sizeof(ChainParams));
  cp->G = G;
  const int w0 = stat ? W_S0 : W_T0;
  bool ok = true;
  for (int li = 0; li < 10; ++li) {
    const int slot = li < 8 ? w0 + li : (li == 8 ? (stat ? W_SFIN : W_TFIN) : W_SDIR);
    if (li == 9 && !dir) continue;
    const bf16* w = G.c.W[slot];
    const int rows = li == 0 ? SEG : (li == SKIP ? SEG + WID : WID);
    ok = ok && w != nullptr && wg::encode_map(&cp->fwd[li], w, rows) &&
         encode2d(&cp->bwd[li], w, WID, rows, 32, 64, CU_TENSOR_MAP_SWIZZLE_64B);
  }
  const int nt = n_tiles_of(stat, use_viewdir);
  ok = ok && encode2d(&cp->big, G.sc.big, WID, size_t(nt) * R, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B) &&
       encode2d(&cp->act0, G.sc.act0, SEG, R, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);

  GemmParams* gp = new GemmParams;
  memset(gp, 0, sizeof(GemmParams));
  NJobs nj;
  Reds rz;
  make_jobs(*gp, nj, rz, stat, n, nu, use_viewdir, encode_a, G.sc, dwf, sm_count());
  for (int i = 0; i < gp->n; ++i) ok = ok && gp->j[i].out != nullptr;
  for (int i = 0; i < nj.n; ++i) ok = ok && nj.j[i].out != nullptr;
  gp->maps[M_BIG] = cp->big;
  gp->maps[M_ACT0] = cp->act0;
  if (dir) {
    ok = ok && encode2d(&gp->maps[M_DIRB], G.sc.dirb, SEG, n, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B) &&
         encode2d(&gp->maps[M_DZRB], G.sc.dzrb, WID, n, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
    if (encode_a)
      ok = ok && encode2d(&gp->maps[M_AB], G.sc.ab, SEG, n, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  cudaError_t err = ok ? cudaSuccess : cudaErrorInvalidValue;
  if (err == cudaSuccess) {
    const bool dx = G.dflows[0] != nullptr;
    auto kern = !stat ? train_bwd_chain_kernel<false, false, true>
                : dir ? (dx ? train_bwd_chain_kernel<true, true, true>
                            : train_bwd_chain_kernel<true, true, false>)
                      : (dx ? train_bwd_chain_kernel<true, false, true>
                            : train_bwd_chain_kernel<true, false, false>);
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
    if (err == cudaSuccess) {
      kern<<<nu, NTHR, SMEM_BYTES, s>>>(*cp);
      err = cudaGetLastError();
    }
  }
  if (err == cudaSuccess && nu > n && (dir || !stat)) {
    // per-ray sums over a ray's tiles, before the GEMM reads dzrb
    ray_reduce_kernel<<<n, NCONS, 0, s>>>(G);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dw_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(GSMEM));
  if (err == cudaSuccess) {
    dw_gemm_kernel<<<dim3(gp->n_tiles, gp->nsplit), GTHR, GSMEM, s>>>(*gp);
    err = cudaGetLastError();
  }
  delete cp;
  delete gp;
  if (err != cudaSuccess) return err;
  dw_narrow_kernel<<<dim3(nj.n, NSPLIT_N), WID, 0, s>>>(nj);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dw_reduce_kernel<<<264, 256, 0, s>>>(rz);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  Biases Bz;
  Bz.dbp = G.sc.dbp;
  Bz.n_units = nu;
  for (int i = 0; i < NSLOT; ++i) {
    Bz.out[i] = nullptr;
    Bz.width[i] = 0;
  }
  auto want = [&](int slot, int width) {
    Bz.out[slot] = static_cast<float*>(db[slot]);
    Bz.width[slot] = width;
  };
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
