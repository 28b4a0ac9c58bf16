// Hopper tower of the port's forward evaluators (planar_eval_comp.cu,
// fused_nerf_eval.cu and the forward of planar_nerf_train.cu): a tile of
// S = 128 samples of one ray per pass, the M rows of every product (a CTA
// holds one ray, or one tile of a longer ray, or runs a ray's tiles in
// turn), computed by two
// consumer warpgroups (warpgroup g owns rows 64g..64g+63) with
// wgmma.mma_async m64n256k16 (bf16 in, f32 accumulators in registers). In
// the third (producer) warpgroup one thread streams the weight K-slabs of
// every layer, in the fixed order of the towers, through TMA into a 6-stage
// mbarrier ring in shared memory (4 stages beside a two-segment posenc
// tile, or beside the two buffers through which the streamed instance
// runs any number of segments), and three warps stage the biases and head
// weights in shared memory (cp.async) and compute the ray's static_dir
// bias; setmaxnreg moves the producer warpgroup's registers to the
// consumers. The posenc tile is filled by posenc_tile, which the backward's
// recompute (tower_bwd_wgmma.cuh) calls too.
//
// Layouts in shared memory (all 128-byte swizzled, the TMA/wgmma "128B"
// mode, every region 1024-byte aligned; Geo carves them):
// - activation tile (128, 256) bf16 and posenc tile (128, 128) bf16 (two
//   segments, (128, 256), in the wide packed evaluator; two one-segment
//   buffers in its streamed instance), K-major:
//   one (128 rows, 64 cols) block per 64 columns, 128 bytes a row, the 16-byte
//   chunk j of row r stored at chunk j ^ (r % 8). A layer's output is written
//   from the accumulators into the activation tile in place (stmatrix):
//   each warpgroup reads and writes only its own 64 rows.
// - ring slot (32 K-rows, 256 cols) bf16 = 16 KB: four TMA boxes of (32 rows,
//   64 cols), one per 64 output columns, straight from the packed (K_pad, 256)
//   row-major weights (pack_padded_weights); wgmma reads B MN-major through
//   its transpose bit.
// Clusters of two CTAs that share each slab by TMA multicast were slower
// on the H100 (PERF.md): the products do not wait on L2 bandwidth.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "planar_tower.cuh"

namespace wg {

using planar::bf16;
using planar::S;
using planar::SEG;
using planar::WID;

constexpr int NCONS = 256;          // two consumer warpgroups
constexpr int NTHR = NCONS + 128;   // + the producer warpgroup
constexpr int HELP0 = NCONS + 32;   // first of the producer warpgroup's helper threads
constexpr int NHELP = NTHR - HELP0;  // 96 helpers: parameters and the dir bias
constexpr int SLAB_K = 32;                                // K-rows of a slab
constexpr uint32_t BOX_BYTES = SLAB_K * 64 * 2;           // one TMA box
constexpr uint32_t SLAB_BYTES = 4 * BOX_BYTES;            // (32, 256) bf16
constexpr uint32_t BLK_BYTES = S * 128;                   // (128 rows, 64 cols) bf16
constexpr uint32_t WG_ROWS_BYTES = 64 * 128;              // a warpgroup's rows in a block
constexpr int NBIAS = 18;  // tower biases kept: static 0..7 + final, transient 0..7 + final
constexpr int NHW = WID * (1 + 3 + 10);                   // head weights (bf16)
constexpr int NPL = 14;                                // per-sample f32 planes
// head planes in OFF_PLANES: transient heads [sigma, rgb(3), fw(3), bw(3)],
// static rgb, static sigma
constexpr int PL_TH = 0, PL_SRGB = planar::NHEAD, PL_SSIG = planar::NHEAD + 3;
static_assert(PL_SSIG < NPL, "head planes fit the carve-up");
constexpr uint32_t EXTRA_BYTES = 3 * S * 4 + 64;       // per-ray inputs

// The instance whose tower input takes any number of segments (the packed
// evaluator past two): NSEG = STREAM. Its segments are not resident: at
// layer 0 and at the skip layer each consumer warpgroup fills its 64 rows
// of segment s into buffer s % 2 while the products of segment s - 1 run
// (mma_layer_stream), and the producer streams the weight slabs in the
// same K order.
constexpr int STREAM = 0;

// Shared-memory carve-up (offsets from a 1024-aligned base) of a CTA whose
// tower input, the posenc tile (+ the time latent), spans NSEG segments of
// SEG lanes: (128, NSEG * SEG) bf16. One segment keeps the 6-stage ring;
// two segments (the packed evaluator past one segment) give up two of its
// stages for the second segment's 32 KB, the one region of that size the
// carve-up can spare: every other one is read at every layer. The
// streamed instance (STREAM) keeps the two-segment carve-up, its two
// segment regions the buffers that the segments pass through.
template <int NSEG>
struct Geo {
  static_assert(NSEG == STREAM || NSEG == 1 || NSEG == 2,
                "one or two resident input segments, or the streamed instance");
  static constexpr int STAGES = NSEG == 1 ? 6 : 4;
  static constexpr int PE_SEGS = NSEG == STREAM ? 2 : NSEG;  // resident segments or buffers
  static constexpr int K_IN = NSEG * SEG;  // K-rows of the input at layers 0 and SKIP (resident)
  static constexpr uint32_t OFF_RING = 0;
  static constexpr uint32_t OFF_ACT = OFF_RING + STAGES * SLAB_BYTES;
  static constexpr uint32_t OFF_PE = OFF_ACT + 4 * BLK_BYTES;
  static constexpr uint32_t OFF_BAR = OFF_PE + 2 * PE_SEGS * BLK_BYTES;
  static constexpr uint32_t OFF_RAYB = OFF_BAR + 128;
  static constexpr uint32_t OFF_BIAS = OFF_RAYB + WID * 4;
  static constexpr uint32_t OFF_HW = OFF_BIAS + NBIAS * WID * 4;
  static constexpr uint32_t OFF_HB = OFF_HW + NHW * 2;
  static constexpr uint32_t OFF_PLANES = OFF_HB + 16 * 4;
  static constexpr uint32_t OFF_EXTRA = OFF_PLANES + NPL * S * 4;
  static constexpr size_t SMEM_BYTES = OFF_EXTRA + EXTRA_BYTES;
  static_assert(SMEM_BYTES <= 232448, "fits one SM's shared memory");
  static_assert(2 * STAGES <= 16, "ring barriers fit their 128 bytes");
};

// the one-segment carve-up's offsets that the kernels read, which every
// tower kernel but the wide packed evaluator runs
constexpr int STAGES = Geo<1>::STAGES;
constexpr uint32_t OFF_RING = Geo<1>::OFF_RING;
constexpr uint32_t OFF_ACT = Geo<1>::OFF_ACT;
constexpr uint32_t OFF_PE = Geo<1>::OFF_PE;
constexpr uint32_t OFF_BAR = Geo<1>::OFF_BAR;
constexpr uint32_t OFF_RAYB = Geo<1>::OFF_RAYB;
constexpr uint32_t OFF_PLANES = Geo<1>::OFF_PLANES;
constexpr uint32_t OFF_EXTRA = Geo<1>::OFF_EXTRA;

// tensor maps, in the producer's order of layers
enum { M_S0 = 0, M_SFIN = 8, M_SDIR = 9, M_T0 = 10, M_TFIN = 18, NMAPS = 19 };
struct Maps {
  CUtensorMap m[NMAPS];
};

// named barriers (0 is __syncthreads)
// BAR_PARAMS / BAR_DIR: the helpers arrive once the staged parameters / the
// per-ray dir bias are in shared memory, the consumers wait before their
// first use
enum { BAR_CONS = 1, BAR_WG0 = 2, BAR_PARAMS = 4, BAR_DIR = 5 };

// ---------------------------------------------------------------- PTX

#ifdef WG_PROFILE
// scripts/profile_evaluator.py builds planar_eval_comp.cu with these: phase
// stamps (global timer, ns) and cycle counts, 16 slots per CTA
__device__ unsigned long long wg_prof[4096 * 16];
__device__ __forceinline__ unsigned long long wg_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define WG_STAMP(slot)                                              \
  if (threadIdx.x == 0 && blockIdx.x < 4096)                        \
  wg::wg_prof[blockIdx.x * 16 + (slot)] = wg::wg_now()
#define WG_STAMP_ANY(slot)                                          \
  if (blockIdx.x < 4096) wg::wg_prof[blockIdx.x * 16 + (slot)] = wg::wg_now()
#define WG_ADD(slot, v)                                             \
  if (blockIdx.x < 4096)                                            \
  atomicAdd(&wg::wg_prof[blockIdx.x * 16 + (slot)], (unsigned long long)(v))
#else
#define WG_STAMP(slot)
#define WG_STAMP_ANY(slot)
#define WG_ADD(slot, v)
#endif

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void consumers_sync() { bar_sync(BAR_CONS, NCONS); }

__device__ __forceinline__ void wg_sync(int g) { bar_sync(BAR_WG0 + g, 128); }

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads across wgmma_wait
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A (64 x 16, K-major) @ B (16 x 256, MN-major / transposed)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db, int scale_d) {
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
      "%123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]),
        "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]),
        "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
        "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
        "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------- tiles

// byte offset of (row, 16-byte chunk) in a swizzled K-major tile
__device__ __forceinline__ uint32_t tile_off(int row, int chunk) {
  return uint32_t(chunk >> 3) * BLK_BYTES + uint32_t(row) * 128u +
         (uint32_t((chunk & 7) ^ (row & 7)) << 4);
}

// four 8x8 bf16 matrices from the mma fragment layout (thread l holds row
// l/4, columns 2(l%4), +1 of each) to the rows whose addresses threads
// 8m..8m+7 give for matrix m
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1,
                                            uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16(max(x, 0)) of two floats in one instruction (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16_relu(float lo, float hi) {
  uint32_t v;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(v) : "f"(hi), "f"(lo));
  return v;
}

// The posenc lanes 8c..8c+7 of a thread's 16-byte chunk c of the posenc
// tile, fixed for the ray: source channel, frequency, phase (pi/2 on cos
// lanes) and kind (0: zero, 1: identity, 2: sine, 3: the per-ray constant
// cst, the time latent in lanes [xyz_w, xyz_w + n_tau) when t is given).
struct Lanes8 {
  float f[8], ph[8], cst[8];
  int ch[8], kind[8];
};

__device__ __forceinline__ void lanes8(Lanes8& L, const float* freqs, int xyz_w,
                                       int c, const float* t, int n_tau) {
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int j = 8 * c + u;
    L.f[u] = 1.f; L.ph[u] = 0.f; L.cst[u] = 0.f; L.ch[u] = 0; L.kind[u] = 0;
    if (j < 3) {
      L.ch[u] = j; L.kind[u] = 1;
    } else if (j < xyz_w) {
      const int k = (j - 3) / 6, r = (j - 3) % 6;
      L.ch[u] = r % 3; L.f[u] = freqs[k]; L.kind[u] = 2;
      if (r >= 3) L.ph[u] = 1.5707963267948966f;
    } else if (t != nullptr && j < xyz_w + n_tau) {
      L.cst[u] = t[j - xyz_w]; L.kind[u] = 3;
    }
  }
}

// the encoding value of lane u from its pre-activation xs
__device__ __forceinline__ float lane_val(const Lanes8& L, int u, float xs) {
  const float sn = planar::sin_poly(__fadd_rn(xs, L.ph[u]));
  return L.kind[u] == 1 ? xs : (L.kind[u] == 2 ? sn : L.cst[u]);
}

// How a tile's sample points are given: as points (S, 3) (packed layout),
// or as the ray o + d z (planar layout), optionally plus a flow (S, 3).
enum { PE_PTS = 0, PE_RAY = 1, PE_RAY_FLOW = 2 };

// Chunk c (8 lanes, fixed for the ray) of the ray's posenc tile (+ the
// time latent t in lanes [xyz_w, xyz_w + n_tau) when t is given) in the
// rows tid / 16 + 16 k of the NCONS consumer threads. Pre-activations
// without fused multiply-adds: x_c f (PE_PTS, x the points pts), else
// o_c f + (d_c f) z [+ flow_c f] (od = (o, d), zsh the depths, pts the
// flows).
template <int MODE>
__device__ __forceinline__ void posenc_chunk(unsigned char* pe, const float* freqs,
                                             int xyz_w, const float* t, int n_tau,
                                             const float* pts, const float* od,
                                             const float* zsh, int c) {
  const int tid = threadIdx.x;
  Lanes8 L;
  lanes8(L, freqs, xyz_w, c, t, n_tau);
  float lo[8], ld[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    lo[u] = MODE == PE_PTS ? 0.f : __fmul_rn(od[L.ch[u]], L.f[u]);
    ld[u] = MODE == PE_PTS ? 0.f : __fmul_rn(od[3 + L.ch[u]], L.f[u]);
  }
#pragma unroll 2
  for (int k = 0; k < S / 16; ++k) {
    const int s = (tid >> 4) + 16 * k;
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float xs;
      if constexpr (MODE == PE_PTS) {
        xs = __fmul_rn(pts[3 * s + L.ch[u]], L.f[u]);
      } else {
        xs = __fadd_rn(lo[u], __fmul_rn(ld[u], zsh[s]));
        if constexpr (MODE == PE_RAY_FLOW)
          xs = __fadd_rn(xs, __fmul_rn(pts[3 * s + L.ch[u]], L.f[u]));
      }
      v[u] = lane_val(L, u, xs);
    }
    *reinterpret_cast<uint4*>(pe + tile_off(s, c)) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
}

// The ray's posenc tile of NSEG segments of SEG lanes, written by the
// NCONS consumer threads: thread tid fills chunk tid % 16 of each segment
// (posenc_chunk). Every kernel that builds a tile calls this, so a forward
// and the backward's recompute put the same bf16 bits in it.
template <int MODE, int NSEG = 1>
__device__ __forceinline__ void posenc_tile(unsigned char* pe, const float* freqs,
                                            int xyz_w, const float* t, int n_tau,
                                            const float* pts, const float* od,
                                            const float* zsh) {
#pragma unroll 1
  for (int seg = 0; seg < NSEG; ++seg)
    posenc_chunk<MODE>(pe, freqs, xyz_w, t, n_tau, pts, od, zsh,
                       (threadIdx.x & 15) + 16 * seg);
}

// The streamed instance's tower input (Geo<STREAM>): the two one-segment
// buffers, and what a segment is made from (the points, the posenc
// frequencies, the time latent in lanes [xyz_w, xyz_w + n_tau) or null),
// in nseg segments; the static tower reads the first nseg_stat of them,
// those that hold posenc lanes (its weight rows for the time latent's
// lanes are zero, so the products it skips add exact zeros).
struct PeSrc {
  unsigned char* pe;
  const float* freqs;
  const float* t;
  const float* pts;
  int xyz_w, n_tau, nseg, nseg_stat;
};

// Segment seg of the tower input (PE_PTS) in the 64 rows of warpgroup g of
// the one-segment buffer buf, written by the warpgroup's 128 threads:
// thread t fills chunk t % 16 of rows 64 g + t / 16 + 8 k. Its lanes and
// their arithmetic are posenc_chunk's, so it writes posenc_tile's bits.
__device__ __forceinline__ void posenc_rows_wg(unsigned char* buf, const PeSrc& src,
                                               int seg, int g) {
  const int t = threadIdx.x & 127, c = t & 15;
  Lanes8 L;
  lanes8(L, src.freqs, src.xyz_w, c + 16 * seg, src.t, src.n_tau);
  bool pos = false;  // a lane of the point's posenc (else time latent or zero)
#pragma unroll
  for (int u = 0; u < 8; ++u) pos |= L.kind[u] == 1 || L.kind[u] == 2;
  if (!pos) {
    // lane_val's per-ray constants: the same bits in every row
    const uint4 q = make_uint4(pack_bf16(L.cst[0], L.cst[1]), pack_bf16(L.cst[2], L.cst[3]),
                               pack_bf16(L.cst[4], L.cst[5]), pack_bf16(L.cst[6], L.cst[7]));
#pragma unroll
    for (int k = 0; k < 8; ++k)
      *reinterpret_cast<uint4*>(buf + tile_off(64 * g + (t >> 4) + 8 * k, c)) = q;
    return;
  }
#pragma unroll 2
  for (int k = 0; k < 8; ++k) {
    const int s = 64 * g + (t >> 4) + 8 * k;
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = lane_val(L, u, __fmul_rn(src.pts[3 * s + L.ch[u]], L.f[u]));
    *reinterpret_cast<uint4*>(buf + tile_off(s, c)) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
}

// ---------------------------------------------------------------- pipeline

// a position in a ring of NST stages
template <int NST = STAGES>
struct PipeN {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == NST) {
      stage = 0;
      phase ^= 1u;
    }
  }
};
using Pipe = PipeN<>;

__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int s) { return bars + 8u * s; }
template <int NST = STAGES>
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int s) {
  return bars + 8u * (NST + s);
}

// one thread: the barriers of a ring of NST stages, before a __syncthreads
template <int NST = STAGES>
__device__ __forceinline__ void init_ring(uint32_t bars) {
  for (int s = 0; s < NST; ++s) {
    mbar_init(full_bar(bars, s), 1);
    mbar_init(empty_bar<NST>(bars, s), 2);  // the consumer warpgroups
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer thread: the nslab K-slabs of weight map m into the ring,
// four TMA boxes a slot.
template <int NST>
__device__ __forceinline__ void stream_layer(const CUtensorMap* map, int nslab,
                                             PipeN<NST>& p, uint32_t ring,
                                             uint32_t bars, int k0 = 0) {
  for (int k = 0; k < nslab; ++k) {
#ifdef WG_PROFILE
    const long long t0 = clock64();
#endif
    mbar_wait(empty_bar<NST>(bars, p.stage), p.phase ^ 1u);
    WG_ADD(6, clock64() - t0);
    const uint32_t fb = full_bar(bars, p.stage);
    mbar_expect_tx(fb, SLAB_BYTES);
    const uint32_t dst = ring + p.stage * SLAB_BYTES;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      tma_load(dst + b * BOX_BYTES, map, fb, 64 * b, SLAB_K * (k0 + k));
    p.advance();
  }
}

// Every K-slab of every layer, in the consumers' order: static tower,
// static_xyz_final, static_dir rows 0..255; transient tower,
// transient_xyz_final; all of it `reps` times (a CTA that runs a ray's
// tiles one after another). Layers 0 and SKIP read NSEG input segments.
template <int NSEG = 1>
__device__ void produce(const Maps& maps, uint32_t ring, uint32_t bars,
                        bool stat, bool dir, bool trans, int reps = 1) {
  constexpr int K_IN = Geo<NSEG>::K_IN;
  PipeN<Geo<NSEG>::STAGES> p;
  auto tower = [&](int m0) {
    for (int i = 0; i < planar::DEPTH; ++i)
      stream_layer(&maps.m[m0 + i], (i == 0 ? K_IN : (i == planar::SKIP ? K_IN + WID : WID)) / SLAB_K,
                       p, ring, bars);
  };
  for (int r = 0; r < reps; ++r) {
    if (stat) {
      tower(M_S0);
      stream_layer(&maps.m[M_SFIN], WID / SLAB_K, p, ring, bars);
      if (dir) stream_layer(&maps.m[M_SDIR], WID / SLAB_K, p, ring, bars);
    }
    if (trans) {
      tower(M_T0);
      stream_layer(&maps.m[M_TFIN], WID / SLAB_K, p, ring, bars);
    }
  }
}

// produce for the streamed instance (Geo<STREAM>), one tile: layers 0 and
// SKIP read nseg input segments, the static tower's the first nseg_stat
// of them (PeSrc), its skip layer's activation rows then from row
// 128 nseg.
__device__ void produce_stream(const Maps& maps, uint32_t ring, uint32_t bars,
                               bool stat, bool dir, bool trans, int nseg,
                               int nseg_stat) {
  PipeN<Geo<STREAM>::STAGES> p;
  auto tower = [&](int m0, int k_in) {
    for (int i = 0; i < planar::DEPTH; ++i) {
      const bool in = i == 0 || i == planar::SKIP;
      stream_layer(&maps.m[m0 + i], (in ? k_in : WID) / SLAB_K, p, ring, bars);
      if (i == planar::SKIP)
        stream_layer(&maps.m[m0 + i], WID / SLAB_K, p, ring, bars, nseg * SEG / SLAB_K);
    }
  };
  if (stat) {
    tower(M_S0, nseg_stat * SEG);
    stream_layer(&maps.m[M_SFIN], WID / SLAB_K, p, ring, bars);
    if (dir) stream_layer(&maps.m[M_SDIR], WID / SLAB_K, p, ring, bars);
  }
  if (trans) {
    tower(M_T0, nseg * SEG);
    stream_layer(&maps.m[M_TFIN], WID / SLAB_K, p, ring, bars);
  }
}

// One layer of a consumer warpgroup: d = [pe | act](rows of warpgroup g)
// @ W, the first k_pe K-columns from the posenc tile, the next k_act from
// the activation tile, one SLAB_K-row slab of W at a time from the ring as
// the producer delivers it. A slab goes back to the producer as soon as
// the products that read it are done.
template <int NST>
__device__ __forceinline__ void mma_layer(float (&d)[128], PipeN<NST>& p, uint32_t ring,
                                          uint32_t bars, uint32_t pe_g, int k_pe,
                                          uint32_t act_g, int k_act) {
  const int n_pe = k_pe / SLAB_K;
  const bool leader = (threadIdx.x & 127) == 0;
  auto release = [&](int stage) {
    if (leader) mbar_arrive(empty_bar<NST>(bars, stage));
  };
  wgmma_fence();
  int prev = -1;
  const int n = n_pe + k_act / SLAB_K;
  for (int j = 0; j < n; ++j) {
#ifdef WG_PROFILE
    const long long t0 = clock64();
#endif
    mbar_wait(full_bar(bars, p.stage), p.phase);
    if (threadIdx.x == 0) WG_ADD(5, clock64() - t0);
    // K-column 32 jj of the tile: 64-column block jj / 2, 64 bytes on per
    // half block
    const int jj = j < n_pe ? j : j - n_pe;
    const uint32_t a = (j < n_pe ? pe_g : act_g) + (jj >> 1) * BLK_BYTES + (jj & 1) * 64;
    const uint32_t b = ring + p.stage * SLAB_BYTES;
#pragma unroll
    for (int kq = 0; kq < SLAB_K / 16; ++kq)
      // A: K-major, 16 K-columns = 32 bytes along the swizzled rows, 8-row
      // groups 1024 bytes apart; B: MN-major, 16 K-rows = 2048 bytes on,
      // 64-column boxes BOX_BYTES apart (leading), 8-row groups 1024 apart
      wgmma_m64n256k16(d, sw128_desc(a + 32 * kq, 16, 1024),
                       sw128_desc(b + 2048 * kq, BOX_BYTES, 1024),
                       (j | kq) != 0);
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      release(prev);
    }
    prev = p.stage;
    p.advance();
  }
  wgmma_wait<0>();
  fence_acc(d);
  release(prev);
}

// mma_layer in the streamed instance, at layer 0 (k_act = 0) and the skip
// layer (k_act = WID): the first nseg * SEG K-columns come from the
// tower input's segments, segment s filled into this warpgroup's rows of
// buffer s % 2 (posenc_rows_wg) while the products of segment s - 1 run,
// then multiplied slab by slab; then k_act K-columns of the activation
// tile. The products and their order are mma_layer's on a resident tile.
// Buffer s % 2 was last read by segment s - 2, whose products are done:
// after each commit only the newest group stays in flight.
template <int NST>
__device__ __forceinline__ void mma_layer_stream(float (&d)[128], PipeN<NST>& p,
                                                 uint32_t ring, uint32_t bars,
                                                 const PeSrc& src, int nseg, int g,
                                                 uint32_t act_g, int k_act) {
  const bool leader = (threadIdx.x & 127) == 0;
  auto release = [&](int stage) {
    if (leader) mbar_arrive(empty_bar<NST>(bars, stage));
  };
  auto slab = [&](uint32_t a_blk, int jj, bool first) {
    mbar_wait(full_bar(bars, p.stage), p.phase);
    const uint32_t a = a_blk + (jj >> 1) * BLK_BYTES + (jj & 1) * 64;
    const uint32_t b = ring + p.stage * SLAB_BYTES;
#pragma unroll
    for (int kq = 0; kq < SLAB_K / 16; ++kq)
      wgmma_m64n256k16(d, sw128_desc(a + 32 * kq, 16, 1024),
                       sw128_desc(b + 2048 * kq, BOX_BYTES, 1024), !(first && kq == 0));
    wgmma_commit();
  };
  int prev = -1;
  for (int s = 0; s < nseg; ++s) {
    unsigned char* buf = src.pe + (s & 1) * 2 * BLK_BYTES;
    wg_sync(g);  // every warp has waited out the products that read buf
    posenc_rows_wg(buf, src, s, g);
    fence_async_smem();  // generic-proxy stores before the wgmma reads
    wg_sync(g);
    wgmma_fence();
    for (int j = 0; j < SEG / SLAB_K; ++j) {
      slab(saddr(buf) + g * WG_ROWS_BYTES, j, s == 0 && j == 0);
      if (prev >= 0) {
        wgmma_wait<1>();
        release(prev);
      }
      prev = p.stage;
      p.advance();
    }
  }
  for (int j = 0; j < k_act / SLAB_K; ++j) {
    slab(act_g, j, false);
    wgmma_wait<1>();
    release(prev);
    prev = p.stage;
    p.advance();
  }
  wgmma_wait<0>();
  fence_acc(d);
  release(prev);
}

// Epilogue of a layer, from the accumulators of warpgroup g (rows 64g..):
// v = bf16(act(d + bias)); with STORE, v goes into the activation tile in
// place (the next layer's A); with NOUT > 0, the NOUT-wide head
// sum_k v[k] Wh[k][c] + bh[c] of every row goes to planes[c * S + row].
// Thread (warp w, lane l) holds rows 16w + l/4 (+8) and columns
// 8i + 2(l%4) (+1), i < 32.
template <bool RELU, bool STORE, int NOUT>
__device__ __forceinline__ void epilogue(const float (&d)[128], const float* bias,
                                         unsigned char* act, int g,
                                         const bf16* __restrict__ wh,
                                         const float* __restrict__ bh,
                                         float* planes) {
#ifdef WG_PROFILE
  const long long t_epi = clock64();
#endif
  const int t = threadIdx.x & 127, w = t >> 5, l = t & 31, q = l & 3;
  const int r = 16 * w + (l >> 2);  // row within the warpgroup
  float h0[NOUT > 0 ? NOUT : 1], h1[NOUT > 0 ? NOUT : 1];
#pragma unroll
  for (int c = 0; c < NOUT; ++c) h0[c] = h1[c] = 0.f;
#ifdef WG_PROFILE
  const long long t_sync = clock64();
#endif
  if (STORE) wg_sync(g);  // every warp's products have read the rows
  if (threadIdx.x == 0) WG_ADD(13, clock64() - t_sync);
  // stmatrix row addresses: thread l gives row 8 (m & 1) + l % 8 of
  // matrix m = l / 8, which is chunk 2j + m / 2 of pair j
  const int m = l >> 3, mrow = 16 * w + 8 * (m & 1) + (l & 7);
  const uint32_t mrow_addr = saddr(act) + g * WG_ROWS_BYTES + uint32_t(mrow) * 128u;
  uint32_t prev_lo = 0, prev_hi = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = 8 * i + 2 * q;
    const float2 b = *reinterpret_cast<const float2*>(bias + col);  // shared
    const float v0 = d[4 * i] + b.x, v1 = d[4 * i + 1] + b.y;
    const float v2 = d[4 * i + 2] + b.x, v3 = d[4 * i + 3] + b.y;
    const uint32_t lo = RELU ? pack_bf16_relu(v0, v1) : pack_bf16(v0, v1);
    const uint32_t hi = RELU ? pack_bf16_relu(v2, v3) : pack_bf16(v2, v3);
    if (STORE) {
      if (i & 1) {  // chunks i - 1 and i, rows r and r + 8 of each
        const int chunk = i - 1 + (m >> 1);
        stmatrix_x4(mrow_addr + uint32_t(chunk >> 3) * BLK_BYTES +
                        (uint32_t((chunk & 7) ^ (mrow & 7)) << 4),
                    prev_lo, prev_hi, lo, hi);
      } else {
        prev_lo = lo;
        prev_hi = hi;
      }
    }
    if (NOUT > 0) {
      const __nv_bfloat162 blo = *reinterpret_cast<const __nv_bfloat162*>(&lo);
      const __nv_bfloat162 bhi = *reinterpret_cast<const __nv_bfloat162*>(&hi);
      const float a0 = __low2float(blo), a1 = __high2float(blo);
      const float a2 = __low2float(bhi), a3 = __high2float(bhi);
      if constexpr (NOUT % 2 == 0) {  // bf16 pairs of adjacent heads
#pragma unroll
        for (int c = 0; c < NOUT; c += 2) {
          const float2 w0 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(wh + col * NOUT + c));
          const float2 w1 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(wh + (col + 1) * NOUT + c));
          h0[c] += a0 * w0.x + a1 * w1.x;
          h1[c] += a2 * w0.x + a3 * w1.x;
          h0[c + 1] += a0 * w0.y + a1 * w1.y;
          h1[c + 1] += a2 * w0.y + a3 * w1.y;
        }
      } else {
#pragma unroll
        for (int c = 0; c < NOUT; ++c) {
          const float w0 = __bfloat162float(wh[col * NOUT + c]);
          const float w1 = __bfloat162float(wh[(col + 1) * NOUT + c]);
          h0[c] += a0 * w0 + a1 * w1;
          h1[c] += a2 * w0 + a3 * w1;
        }
      }
    }
  }
  if (NOUT > 0) {
#pragma unroll
    for (int c = 0; c < NOUT; ++c) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        h0[c] += __shfl_xor_sync(0xffffffffu, h0[c], off);
        h1[c] += __shfl_xor_sync(0xffffffffu, h1[c], off);
      }
    }
    if (q == 0) {
      const int row = 64 * g + r;
#pragma unroll
      for (int c = 0; c < NOUT; ++c) {
        planes[c * S + row] = h0[c] + bh[c];
        planes[c * S + row + 8] = h1[c] + bh[c];
      }
    }
  }
  if (STORE) {
    fence_async_smem();  // generic-proxy stores before the next wgmma reads
    wg_sync(g);
  }
  if (threadIdx.x == 0) WG_ADD(7, clock64() - t_epi);
}

// The 8-layer ReLU tower of warpgroup g on the posenc tile of NSEG
// segments (biases bias[i * WID ..], skip input at layer 4); the last
// activation stays in the activation tile, and with SIG its 1-wide head
// (the static sigma) goes to planes. The streamed instance (NSEG =
// STREAM) fills its input segments from src at layers 0 and SKIP, the
// static tower (SIG) the first src->nseg_stat of them.
template <bool SIG, int NSEG = 1>
__device__ __forceinline__ void tower(float (&d)[128], PipeN<Geo<NSEG>::STAGES>& p,
                                      uint32_t ring,
                                      uint32_t bars, uint32_t pe_g, uint32_t act_g,
                                      unsigned char* act, int g, const float* bias,
                                      const bf16* wsig, const float* bsig,
                                      float* sig_plane, const PeSrc* src = nullptr) {
  for (int i = 0; i < planar::DEPTH; ++i) {
    if constexpr (NSEG == STREAM) {
      if (i == 0 || i == planar::SKIP)
        mma_layer_stream(d, p, ring, bars, *src, SIG ? src->nseg_stat : src->nseg, g, act_g,
                         i == 0 ? 0 : WID);
      else
        mma_layer(d, p, ring, bars, pe_g, 0, act_g, WID);
    } else {
      mma_layer(d, p, ring, bars, pe_g, (i == 0 || i == planar::SKIP) ? Geo<NSEG>::K_IN : 0,
                act_g, i == 0 ? 0 : WID);
    }
    if (SIG && i == planar::DEPTH - 1)
      epilogue<true, true, 1>(d, bias + i * WID, act, g, wsig, bsig, sig_plane);
    else
      epilogue<true, true, 0>(d, bias + i * WID, act, g, nullptr, nullptr, nullptr);
  }
}

// ---------------------------------------------------------------- helpers

// Shared-memory copies of the parameters the epilogues read (the per-layer
// global loads would each wait an L2 round trip): the tower biases
// (bias[li * WID], li = slot for the static layers and final, slot - 3 for
// the transient ones), the head weights [sigma (WID, 1) | rgb (WID, 3) |
// transient heads (WID, n_th)] and their biases [1 | 3 | n_th]. Helper
// threads h < NHELP; null slots are skipped.
struct Staged {
  float* bias; bf16* hw; float* hb;
  __device__ __forceinline__ const float* tower_bias(bool transient) const {
    return bias + (transient ? 9 : 0) * WID;
  }
  __device__ __forceinline__ const bf16* w_sig() const { return hw; }
  __device__ __forceinline__ const bf16* w_rgb() const { return hw + WID; }
  __device__ __forceinline__ const bf16* w_th() const { return hw + 4 * WID; }
};

template <int NSEG = 1>
__device__ __forceinline__ Staged staged(unsigned char* sm) {
  using G = Geo<NSEG>;
  return {reinterpret_cast<float*>(sm + G::OFF_BIAS), reinterpret_cast<bf16*>(sm + G::OFF_HW),
          reinterpret_cast<float*>(sm + G::OFF_HB)};
}

__device__ __forceinline__ void copy16(void* dst, const void* src, int bytes, int h) {
  for (int e = h; e < bytes / 16; e += NHELP)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     saddr(reinterpret_cast<uint4*>(dst) + e)),
                 "l"(reinterpret_cast<const uint4*>(src) + e)
                 : "memory");
}

__device__ void stage_params(const Staged& st, const bf16* const* W,
                             const float* const* B, int n_th, int h) {
  using namespace planar;
  for (int li = 0; li < NBIAS; ++li) {
    const int slot = li < 9 ? li : li + 3;
    if (W[slot] != nullptr) copy16(st.bias + li * WID, B[slot], WID * 4, h);
  }
  if (W[W_SSIG] != nullptr) {
    copy16(st.hw, W[W_SSIG], WID * 2, h);
    copy16(st.hw + WID, W[W_SRGB], WID * 3 * 2, h);
  }
  if (W[W_THEAD] != nullptr) copy16(st.hw + 4 * WID, W[W_THEAD], WID * n_th * 2, h);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (h < 4) {
    if (h == 0 && W[W_SSIG] != nullptr) st.hb[0] = B[W_SSIG][0];
    if (h > 0 && W[W_SRGB] != nullptr) st.hb[h] = B[W_SRGB][h - 1];
  } else if (h < 4 + n_th && W[W_THEAD] != nullptr) {
    st.hb[h] = B[W_THEAD][h - 4];
  }
}

// The per-ray part of the static_dir layer on the helper threads, thread
// per output column: bf16(dir) @ Wd[WID:WID+dir_w] + b [+ bf16(a) @
// Wd[a0:a0+n_a]], the appearance rows a0 after the direction's segments
// (WID + SEG where dir_w fits one; ops/raymarch_kernel.py::static_dir_rows).
__device__ void dir_bias(const bf16* Wd, const float* bd, const float* dir,
                         int dir_w, const float* a, int n_a, float* ray_b, int h) {
  using planar::bfr;
  const int a0 = WID + SEG * max(1, (dir_w + SEG - 1) / SEG);
  for (int n = h; n < WID; n += NHELP) {
    float z = 0.f;
#pragma unroll 4
    for (int k = 0; k < dir_w; ++k)
      z += bfr(dir[k]) * __bfloat162float(Wd[(WID + k) * WID + n]);
    z += bd[n];
    if (a != nullptr) {
      float za = 0.f;
#pragma unroll 4
      for (int k = 0; k < n_a; ++k)
        za += bfr(a[k]) * __bfloat162float(Wd[(a0 + k) * WID + n]);
      z += za;
    }
    ray_b[n] = z;
  }
}

// ---------------------------------------------------------------- CTA

// The producer warpgroup of a trainable evaluator (fused_nerf_eval.cu, the
// forward of planar_nerf_train.cu): thread NCONS streams the weight slabs
// of the evaluated branches; the helpers stage the parameters and, with
// dir, the ray's static_dir bias, arriving at BAR_PARAMS / BAR_DIR. The
// streamed instance's nseg input segments, the static tower's first
// nseg_stat of them: produce_stream.
template <int NSEG = 1>
__device__ __forceinline__ void producer_wg(const Maps& maps, const planar::Common& A,
                                            unsigned char* sm, int ray, bool stat,
                                            bool dir, bool trans, int nseg = NSEG,
                                            int nseg_stat = NSEG) {
  using namespace planar;
  using G = Geo<NSEG>;
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
  const int tid = threadIdx.x;
  if (tid == NCONS) {
    if constexpr (NSEG == STREAM)
      produce_stream(maps, saddr(sm + G::OFF_RING), saddr(sm + G::OFF_BAR), stat, dir, trans,
                     nseg, nseg_stat);
    else
      produce<NSEG>(maps, saddr(sm + G::OFF_RING), saddr(sm + G::OFF_BAR), stat, dir, trans);
  } else if (tid >= HELP0) {
    const int h = tid - HELP0;
    stage_params(staged<NSEG>(sm), A.W, A.B, NHEAD, h);
    bar_arrive(BAR_PARAMS, NCONS + NHELP);
    if (dir) {
      dir_bias(A.W[W_SDIR], A.B[W_SDIR], A.dir + size_t(ray) * A.dir_w, A.dir_w,
               A.encode_a ? A.a + size_t(ray) * A.n_a : nullptr, A.n_a,
               reinterpret_cast<float*>(sm + G::OFF_RAYB), h);
      bar_arrive(BAR_DIR, NCONS + NHELP);
    }
  }
}

// The towers of one ray on the consumer warpgroups, once the posenc tile
// is filled and fenced (the parameters are waited for here): with STAT,
// the static tower (its sigma head in layer 7's epilogue),
// static_xyz_final, [static_dir with the ray's dir bias] and the rgb head;
// with TRANS, the transient tower, its final layer and the NHEAD packed
// heads. The head outputs, before their activations, go to the planes of
// OFF_PLANES (PL_TH, PL_SRGB, PL_SSIG); each warpgroup writes its own rows
// and ends at its own barrier. NSEG: the input segments (Geo); the
// streamed instance fills them from src (tower).
template <bool STAT, bool TRANS, int NSEG = 1>
__device__ __forceinline__ void run_towers(unsigned char* sm, bool dir,
                                           const PeSrc* src = nullptr) {
  using planar::NHEAD;
  using G = Geo<NSEG>;
  bar_sync(BAR_PARAMS, NCONS + NHELP);
  const int g = threadIdx.x >> 7;
  const uint32_t ring = saddr(sm + G::OFF_RING), bars = saddr(sm + G::OFF_BAR);
  unsigned char* act = sm + G::OFF_ACT;
  const uint32_t pe_g = saddr(sm + G::OFF_PE) + g * WG_ROWS_BYTES;
  const uint32_t act_g = saddr(act) + g * WG_ROWS_BYTES;
  const Staged st = staged<NSEG>(sm);
  float* pl = reinterpret_cast<float*>(sm + G::OFF_PLANES);
  const float* ray_b = reinterpret_cast<const float*>(sm + G::OFF_RAYB);
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  PipeN<G::STAGES> p;
  if (STAT) {
    tower<true, NSEG>(d, p, ring, bars, pe_g, act_g, act, g, st.tower_bias(false), st.w_sig(),
                st.hb, pl + PL_SSIG * S, src);
    mma_layer(d, p, ring, bars, pe_g, 0, act_g, WID);
    if (dir) {
      // static_xyz_final (linear), bf16-rounded, in place
      epilogue<false, true, 0>(d, st.tower_bias(false) + 8 * WID, act, g, nullptr,
                               nullptr, nullptr);
      mma_layer(d, p, ring, bars, pe_g, 0, act_g, WID);
      bar_sync(BAR_DIR, NCONS + NHELP);
      epilogue<true, false, 3>(d, ray_b, act, g, st.w_rgb(), st.hb + 1, pl + PL_SRGB * S);
    } else {
      epilogue<false, false, 3>(d, st.tower_bias(false) + 8 * WID, act, g, st.w_rgb(),
                                st.hb + 1, pl + PL_SRGB * S);
    }
  }
  if (TRANS) {
    tower<false, NSEG>(d, p, ring, bars, pe_g, act_g, act, g, st.tower_bias(true), nullptr,
                       nullptr, nullptr, src);
    mma_layer(d, p, ring, bars, pe_g, 0, act_g, WID);
    epilogue<false, false, NHEAD>(d, st.tower_bias(true) + 8 * WID, act, g, st.w_th(),
                                  st.hb + 4, pl + PL_TH * S);
  }
  wg_sync(g);
}

// ---------------------------------------------------------------- host

// Tensor map of a packed (rows, 256) row-major bf16 weight, read as
// (SLAB_K rows, 64 cols) boxes with 128-byte swizzle; rows limits the map (static_dir's
// per-ray rows stay outside it). Returns false if the driver refuses it.
inline bool encode_map(CUtensorMap* m, const void* w, int rows) {
  cuuint64_t dims[2] = {cuuint64_t(WID), cuuint64_t(rows)};
  cuuint64_t strides[1] = {cuuint64_t(WID) * 2};
  cuuint32_t box[2] = {64, SLAB_K};
  cuuint32_t estr[2] = {1, 1};
  return cuTensorMapEncodeTiled(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                const_cast<void*>(w), dims, strides, box, estr,
                                CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of the slab stream from the weight slots (planar::W_*); a null
// slot (a branch that is not evaluated) leaves its map unset. Layers 0 and
// SKIP read nseg input segments.
inline bool encode_maps(Maps& maps, const bf16* const* W, int nseg = 1) {
  const int slot[NMAPS] = {0, 1, 2, 3, 4, 5, 6, 7, planar::W_SFIN, planar::W_SDIR,
                           12, 13, 14, 15, 16, 17, 18, 19, planar::W_TFIN};
  for (int i = 0; i < NMAPS; ++i) {
    if (W[slot[i]] == nullptr) continue;
    const int li = i < M_SFIN ? i : (i >= M_T0 && i < M_TFIN ? i - M_T0 : -1);
    const int rows = li == 0 ? nseg * SEG : (li == planar::SKIP ? nseg * SEG + WID : WID);
    if (!encode_map(&maps.m[i], W[slot[i]], rows)) return false;
  }
  return true;
}

// Launch kern<<<n_rays, NTHR, Geo<NSEG>::SMEM_BYTES>>>, one CTA per ray.
template <int NSEG = 1, typename P>
inline cudaError_t launch(void (*kern)(const P), const P& params, int n_rays,
                          cudaStream_t stream) {
  constexpr size_t smem = Geo<NSEG>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kern<<<n_rays, NTHR, smem, stream>>>(params);
  return cudaGetLastError();
}

}  // namespace wg
