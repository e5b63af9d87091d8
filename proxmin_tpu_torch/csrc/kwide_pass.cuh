// The very-wide tier's residual modes past K = 32 components, up to
// K = 256 (kMaxK), at any C: K1's compiled chain and split pass 1
// (nmf_pgm_wide.cu), K2's (nmf_adaprox_wide.cu) and K3 (nmf_grad.cu). The
// second passes and K beyond 256 stay on vwide_pass.cuh's body.
//
// Why not vwide_pass.cuh's body: it runs a step per (channel chunk,
// component block of 32) with two block barriers each, adds gS of every
// step into a per-group scratch in global memory (L2) and reads it back,
// loads gA's entries from the group's row in global memory and stores them
// back in every sub-tile, and reads the epilogue's column from the L2
// scratch. This body is the wide body's structure (wide_pass.cuh, its VW
// instances) with every component held on chip at once:
//
// - KB = 64 (K <= 64): sub-tiles of kSub = 256 columns, a thread's gS tile
//   16 components x 4 columns in registers (64 floats, beside the
//   residual's 8 x 4 tile); KB = 128 (K <= 128): sub-tiles of 128 columns,
//   so that the same 16 x 4 gS tile covers 128 components (8 component
//   groups of the block's 256 threads, 4 channel rows of the residual a
//   thread); KB = 256 (K <= 256): sub-tiles of 64 columns, the same 16 x 4
//   gS tile (16 component groups, 2 channel rows of the residual a
//   thread). Shape<KB> holds the three.
// - The sub-tile's S rows (all K) come once per sub-tile by bulk copies on
//   an mbarrier (bulk_ring.cuh); the channels go in chunks of 32 whose Y
//   rows a ring of two stages brings one chunk ahead, and A's block of the
//   chunk (32 x KB) comes one chunk ahead through two buffers (loaded
//   before a chunk's residual, stored after it). Per chunk: (a) the
//   residual R = A S of the chunk's rows, the exact-f32 chain A[c,0] s[0]
//   + A[c,1] s[1] + ... over k in order, D = W (R - Y) into shared memory;
//   (b) gS += A^T D over the chunk's channels in order (fmaf from 0, a
//   thread per column: gS, and with it x, S', M', V', do not depend on the
//   tiling, and equal vwide_pass.cuh's bits); (c) gA's (chunk, all K) tile
//   += D S^T over the sub-tile's columns, added in sub-tile order into the
//   group's tile of the chunk in shared memory (each entry owned by one
//   thread), written to the group's row once, at the end. Two block
//   barriers per chunk, as in the wide body: D is in, and (b) and (c) are
//   done (at KB = 64 (c)'s column parts meet in shared memory between
//   them; at KB = 128 a thread's 4 x 4 tile takes all 128 columns). W is
//   loaded where it is used: in flight through the residual beside the gS
//   tile, its 32 floats a thread spilled.
// - The epilogue's column (K x the sub-tile's columns, float32) and K2's
//   per-element step beside it overlay A's buffers, the S buffer and the
//   ring, free once the chunks are done (the next sub-tile's S, Y and A
//   come after the epilogue); the old S is read from global memory (L2)
//   there, as in vwide_pass.cuh. At SW = 128 two threads share a column,
//   each a half of the components where the work is elementwise (the
//   chain, which needs the whole column, runs on the first). The Gram (of
//   the old S in K3, before the overlay, and of S' in K1, from the column)
//   runs in blocks of 64 x 64, added sub-tile by sub-tile into the group's
//   row in global memory; K2's row sums stay in a register a thread.
// - gA's tiles of the chunks that do not fit beside the rest (past 5
//   chunks, C = 160, in float32 at KB = 128) are added into the group's
//   row in global memory per sub-tile instead, as the wide body's VW
//   instances do.
// - One block of 8 warps per SM, up to 255 registers a thread.
//
// KB = 256, for spectral-library unmixing (a pruned library of a few
// hundred spectra against every pixel). Twice KB = 128's layout does not
// fit: with sub-tiles of 128 columns A's two buffers (66 560 B), S
// (135 168 B) and the ring (33 792 B) take 235 520 B of kSmemMax's
// 231 424, and the gS tile would be 32 x 4 a thread. Sub-tiles of 64
// columns keep the 16 x 4 gS tile and take, in float32, A 66 560 B, S
// 69 632 B and the ring 17 408 B (153 600 B; with the bfloat16 store
// 187 904 B: A twice, and D apart); the column 69 632 B, K2's step
// 65 536 B beside it, K3's Gram parts in A's buffers. gA's tile is
// 32 KB a chunk: two chunks stay on chip in float32 (one with the
// bfloat16 store); past them a thread's 32 entries of the chunk are
// loaded from the group's row all at once and stored back, per sub-tile
// (at C = 224, 5 of 7 chunks: 160 KB read and written a sub-tile, with
// L2 asked to keep the row: ld_keep, st_keep). Narrower sub-tiles cost
// the residual: its 2 x 4 tile loads 6 16-byte words per 32 FMAs (4 x 4
// at KB = 128: 8 per 64). What the instance does about the rest:
//   - A's next block comes by cp.async, 4-byte copies straight into the
//     other buffer (through registers, its 32 floats a thread spilled);
//   - a warp takes 2 row groups over all 16 quads (Shape::kRowWarps), so
//     that (b)'s A loads are broadcasts (at 64 and 128 a warp's row
//     groups read A 16 floats apart, on the same banks) and whole warps
//     past K skip (b); (c)'s 8 x 4 tiles (GaTile: a warp's loads read 4
//     rows of D and 8 of S, one wavefront each) skip the components past
//     K: at K = 160, 1 of 4;
//   - the Gram's blocks at and above the diagonal only are added per
//     sub-tile, their entries loaded all at once; the blocks below are
//     copied from their mirrors once, at the end (10 of 16 blocks at
//     K = 256);
//   - the epilogue's reads of the old S (and K2's M and V) go eight at a
//     time ahead of the stores that would hold each back (by_eight).
// Timed on an NVIDIA H100 80GB HBM3 at 700 W against vwide_pass.cuh's
// body in turns (tools/k13_times.py --vwide's cases), at (128, 160,
// 250 000) and (224, 240, 250 000): K1's chain 3.46 and 6.76 ms against
// 4.29 and 9.87, its split pass 1 2.02 and 4.36 against 2.11 and 5.04; K2
// 2.85 and 5.60 against 4.16 and 8.28, its pass 1 2.38 and 4.86 against
// 2.49 and 5.61; K3 2.75 and 5.75 against 3.31 and 8.02 (bounds 0.55 and
// 1.42 ms of FMAs). Taking one piece of the body out at a time, each of
// (a), (b), (c), the Gram and the row's read-modify-writes of gA cost
// about as much as another at (224, 240, 250 000): no one piece bounds
// it.
// Past K = 256, vwide_pass.cuh's body.
//
// The group's row holds gA, the Gram (or K2's row sums) and the statistics
// as the wide body's do, summed by its finalize in double in a fixed
// order: no atomics, two launches give the same bits, the order depends on
// N, tile_n, C, K and the instance alone. Nothing goes through a scratch in
// global memory.
//
// What bounds it on an H100: the float32 FMAs, 3 C K + K (K + 1) / 2 per
// column (26 656 at C = 128, K = 64: 0.199 ms at 33.5e12 FMA/s for N =
// 250 000), against (C + 2K) N 4 bytes (0.19 ms); and, tighter, the shared
// memory's delivery of the register tiles' operands (8 x 4 tiles: 3 floats
// loaded per 8 FMAs; 4 x 4 at KB = 128: 1 per 2; the residual's 2 x 4 at
// KB = 256: 3 per 4). No tensor cores: TF32 would round the residual's
// operands.

#pragma once

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bulk_ring.cuh"
#include "prox_chain.cuh"
#include "tiers.cuh"
#include "wide_pass.cuh"

namespace {
namespace kwide {

using wide::Args;
using wide::Entries;
using wide::kChunk;
using wide::kPartFloats;
using wide::kSmemMax;
using wide::kThreads;
using wide::kWarps;

constexpr int kMinK = tier::kWideK + 1;  // below, the wide body's
constexpr int kMaxK = tier::kKwideK;     // above, vwide_pass.cuh's body
constexpr int kGramBlock = 64;

// KB = 256's (c) map: a thread's 8 x 4 tile of gA's (chunk, K) block, the
// chunk's channels r1 + S1 i by the components r2 + G2 j, over all the
// sub-tile's columns; a warp's lanes take 4 channel groups by 8 component
// groups, so that its loads of D and of S read 4 and 8 consecutive rows
// (one wavefront each; wide::PairMap's 4 x 8 tiles read 32 rows of S)
struct GaTile {
  static constexpr int kT1 = 8, kT2 = 4, S1 = 4, G2 = 64;
  static constexpr int kParts = 1, kPerThread = kT1 * kT2;
  int r1, r2;
  __device__ __forceinline__ explicit GaTile(int tid)
      : r1((tid & 31) >> 3), r2((tid >> 5) * 8 + (tid & 7)) {}
};

// The instance's shape: KB components on chip, SW columns a sub-tile; the
// thread's tiles: columns ncol .. ncol + 3 (QW quads a warp), residual rows
// rg + RG i (RR of them), gS components kb0 .. kb0 + MB - 1.
template <int KB>
struct Shape {
  static_assert(KB == 64 || KB == 128 || KB == 256, "KB is 64, 128 or 256");
  static constexpr int SW = KB == 64 ? 256 : (KB == 128 ? 128 : 64);
  static constexpr int QC = SW / 4;
  static constexpr int RG = kThreads / QC;
  static constexpr int QW = QC / kWarps;
  static constexpr int RR = kChunk / RG;
  static constexpr int MB = KB / RG;
  static constexpr int AP = KB + 4;  // A's rows (floats)
  static constexpr int PF = SW + 4;  // a float32 row (floats)
  // gA's (chunk, KB) tile: 8 x 4 tiles summed over 4 column parts at
  // KB = 64; 4 x 4 tiles over all the columns at KB = 128, 8 x 4 (GaTile)
  // at 256
  using GA = std::conditional_t<
      KB == 64, wide::PairMap<kChunk, KB, 8, 4, SW>,
      std::conditional_t<KB == 128, wide::PairMap<kChunk, KB, 4, 4, SW>,
                         GaTile>>;
  // the stride of a thread's channels in its gA tile
  static constexpr int GS1 = KB == 256 ? GaTile::S1 : 1;
  // KB = 256: a warp takes two residual row groups (and so 32 consecutive
  // gS components) over all the sub-tile's quads, so that whole warps skip
  // (b) past K; at 64 and 128 a warp's lanes take 32 / QW row groups over
  // QW quads
  static constexpr bool kRowWarps = KB == 256;
  // a 64 x 64 block of the Gram
  using GR = wide::PairMap<kGramBlock, kGramBlock, 8, 4, SW>;
  // rows of S, Y, W as stored: 16-byte aligned, rows 4 banks apart
  template <typename T>
  __host__ __device__ static constexpr int pitch() {
    return sizeof(T) == 4 ? SW + 4 : SW + 8;
  }
};

// Shared memory, byte offsets from the dynamic base: A's two buffers (in
// float32 for gS and, with the bfloat16 store, rounded to bfloat16 for the
// residual), the S buffer, the ring's two stages of Y, D (with the
// bfloat16 store; in float32 D overwrites Y), the (c) routine's parts;
// they end at `region`, which the epilogue's column (col, KB x PF floats),
// K2's step (KB x SW floats) and the Gram's or the row sums' parts
// (eparts) overlay; then gA's tiles of ga_chunks chunks.
struct Smem {
  int a_f, a_res, s, ring, stage, d, d_bytes, part, region;
  int col, step, eparts, ga, ga_chunks, total;
  bool ok;
};
template <int KB, typename ST>
__host__ __device__ inline Smem smem_layout(int mode, int C) {
  using Sh = Shape<KB>;
  constexpr bool kF32 = std::is_same<ST, float>::value;
  constexpr int PS = Sh::template pitch<ST>();
  Smem m{};
  const int a_bytes = 2 * kChunk * Sh::AP * 4;
  m.a_f = 0;
  m.a_res = kF32 ? 0 : a_bytes;
  m.s = (kF32 ? 1 : 2) * a_bytes;
  m.ring = m.s + KB * PS * (int)sizeof(ST);
  m.stage = kChunk * PS * (int)sizeof(ST);
  m.d = m.ring + 2 * m.stage;
  m.d_bytes = kChunk * Sh::PF * 4;
  m.part = m.d + (kF32 ? 0 : m.d_bytes);
  m.region = m.part + (Sh::GA::kParts > 1 ? kPartFloats * 4 : 0);
  m.col = 0;
  m.step = KB * Sh::PF * 4;
  const int gram_parts = Sh::GR::kParts * Sh::GR::kStride * 4;
  int need, limit = m.region;  // the parts end at `need`, before `limit`
  if (mode == wide::kGrad) {
    // the Gram of the old S, while S is in place: its parts in the ring,
    // or in A's buffers, before S, where the ring is too short (KB = 256)
    m.eparts = m.ring + gram_parts <= m.region ? m.ring : 0;
    need = m.eparts + gram_parts;
    if (m.eparts == 0) limit = m.s;
  } else {
    m.eparts = m.step + (mode == wide::kAda ? KB * Sh::SW * 4 : 0);
    need = m.eparts + (wide::has_gram(mode) ? gram_parts : kThreads * 4);
  }
  m.ga = m.region;
  const int tile = kChunk * KB * 4;
  const int nch = (C + kChunk - 1) / kChunk;
  const int room = kSmemMax > m.ga ? (kSmemMax - m.ga) / tile : 0;
  m.ga_chunks = nch < room ? nch : room;
  m.total = m.ga + m.ga_chunks * tile;
  m.ok = need <= limit && m.region <= kSmemMax;
  return m;
}

// Loads and stores of the group's row that ask L2 to keep its lines
// (evict_last): the row is read back every sub-tile, while Y and S stream
// past it once. At 132 groups, C = 224 and K = 240 the rows that the
// sub-tiles touch take about 40 MB of the H100's 50 MB L2.
__device__ __forceinline__ uint64_t l2_keep_policy() {
#ifdef __CUDA_ARCH__
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(p));
  return p;
#else
  return 0;
#endif
}
__device__ __forceinline__ float ld_keep(const float* p, uint64_t pol) {
#ifdef __CUDA_ARCH__
  float v;
  asm volatile("ld.global.L2::cache_hint.f32 %0, [%1], %2;"
               : "=f"(v)
               : "l"(p), "l"(pol));
  return v;
#else
  return *p;
#endif
}
__device__ __forceinline__ void st_keep(float* p, float v, uint64_t pol) {
#ifdef __CUDA_ARCH__
  asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;" ::"l"(p),
               "f"(v), "l"(pol)
               : "memory");
#else
  *p = v;
#endif
}

// One float from global to shared memory by cp.async (a zero where
// src_bytes is 0), and the wait for all of the thread's copies.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
#else
  *dst = src_bytes ? *src : 0.f;
#endif
}
__device__ __forceinline__ void cp_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;" ::: "memory");
#endif
}

// GaTile's tile: acc[i][j] += the sum over the sub-tile's SW columns, in
// order, of D[r1 + S1 i][n] Z[r2 + G2 j][n], for the components below
// G2 nz only (the rows at and past K reach entries that are not stored:
// at K = 160, 3 of 4).
template <int SW, typename ZT>
__device__ __forceinline__ void ga_tile(
    float (&acc)[GaTile::kT1][GaTile::kT2], const GaTile& g, const float* d,
    int dp, const ZT* z, int zp, int nz) {
  constexpr int T1 = GaTile::kT1, T2 = GaTile::kT2;
  const float* dr = d + g.r1 * dp;
  const ZT* zr = z + g.r2 * zp;
#pragma unroll 1
  for (int n = 0; n < SW; n += 4) {
    float4 xv[T1];
#pragma unroll
    for (int i = 0; i < T1; ++i)
      xv[i] = wide::ld4(dr + GaTile::S1 * i * dp + n);
#pragma unroll
    for (int j = 0; j < T2; ++j) {
      if (j < nz) {
        const float4 zv = wide::ld4(zr + GaTile::G2 * j * zp + n);
#pragma unroll
        for (int i = 0; i < T1; ++i) {
          float v = acc[i][j];
          v = fmaf(xv[i].x, zv.x, v);
          v = fmaf(xv[i].y, zv.y, v);
          v = fmaf(xv[i].z, zv.z, v);
          v = fmaf(xv[i].w, zv.w, v);
          acc[i][j] = v;
        }
      }
    }
  }
}

template <int KB, typename ST, typename MT, int MODE>
__device__ __forceinline__ void body(const Args<ST, MT>& a,
                                     unsigned char* smem) {
  using Sh = Shape<KB>;
  using GA = typename Sh::GA;
  using GR = typename Sh::GR;
  static_assert(wide::has_residual(MODE), "the second passes: vwide_pass");
  constexpr bool kF32 = std::is_same<ST, float>::value;
  constexpr int SW = Sh::SW, RG = Sh::RG, QW = Sh::QW, RR = Sh::RR;
  constexpr int MB = Sh::MB, AP = Sh::AP, PF = Sh::PF;
  constexpr int PS = Sh::template pitch<ST>();
  constexpr int ss = sizeof(ST);
  constexpr int kAPer = kChunk * KB / kThreads;
  // KB = 256: the next chunk's A by cp.async, straight into shared memory
  // (its 32 floats a thread in flight through the residual spilled; at 64
  // and 128 they go through registers)
  constexpr bool kAsyncA = KB == 256;
  constexpr int kGramUnroll =
      (KB == 128 && MODE == wide::kPgm) ? 1 : GR::kPerThread;
  // the residual's loop over k: unrolled twice at KB = 256, whose 2 x 4
  // tile leaves the registers (at 64 it spilled)
  constexpr int kResUnroll = KB == 256 ? 2 : 1;
  // KB = 256: the Gram's blocks (bi, bj), bi <= bj, only, added into the
  // group's row per sub-tile; the blocks below the diagonal copied from
  // their mirrors once, at the end
  constexpr bool kUpperGram = KB == 256;
  __shared__ __align__(8) uint64_t full[2];  // the ring's stages
  __shared__ __align__(8) uint64_t sfull;    // the S buffer
  __shared__ float red[kWarps][3];

  const int C = a.C, K = a.K;
  const long long N = a.N;
  const bool weighted = a.W != nullptr;
  const Smem L = smem_layout<KB, ST>(MODE, C);
  float* const Af = reinterpret_cast<float*>(smem + L.a_f);
  float* const Ares = reinterpret_cast<float*>(smem + L.a_res);
  ST* const Sr = reinterpret_cast<ST*>(smem + L.s);
  unsigned char* const ring = smem + L.ring;
  float* const parts = reinterpret_cast<float*>(smem + L.part);
  float* const gat = reinterpret_cast<float*>(smem + L.ga);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the group's columns [lo, hi): its units, consecutive (one block an SM)
  const long long G = wide::group_units(a.n_units, 1);
  const long long u0 = (long long)blockIdx.x * G;
  const long long u1 = wide::lmin(u0 + G, a.n_units) - 1;
  long long lo, hi, skip;
  wide::unit_span(u0, N, a.tile_n, lo, skip);
  wide::unit_span(u1, N, a.tile_n, skip, hi);
  const int n_sub = (int)((hi - lo + SW - 1) / SW);
  const int nch = (C + kChunk - 1) / kChunk;
  const int n_q = n_sub * nch;
  // the residual's steps: k past K adds exact zeros (A's columns and S's
  // rows there are zeros), so the chain stops at K rounded up to 4
  const int K4 = (K + 3) & ~3;

  // the group's row: the Gram (added per sub-tile) and gA's chunks past
  // the tiles zeroed; the tiles zeroed (the thread's own entries)
  const Entries e = wide::entries(MODE, C, K);
  float* const row = a.partials + (long long)blockIdx.x * e.total;
  for (int i = tid; i < e.ga + e.mid; i += kThreads) row[i] = 0.f;
  for (int i = tid; i < L.ga_chunks * kChunk * KB; i += kThreads)
    gat[i] = 0.f;
  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_init(&sfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // A's block of chunk ch, the thread's elements tid + kThreads m, loaded;
  // and put into buffer b
  auto a_of = [&](int ch, int m) {
    const int i = tid + kThreads * m;
    const int c = ch * kChunk + i / KB, k = i % KB;
    return (c < C && k < K) ? wide::ld_now(a.A + (long long)c * K + k)
                            : 0.f;
  };
  auto put_a = [&](int b, int m, float v) {
    const int i = tid + kThreads * m;
    const int at = (b * kChunk + i / KB) * AP + i % KB;
    Af[at] = v;
    if constexpr (!kF32) Ares[at] = __bfloat162float(__float2bfloat16_rn(v));
  };
  // (kAsyncA) the copies of chunk ch's block into buffer b; a_ready(b):
  // the thread's copies have landed (and, with the bfloat16 store, are
  // rounded into the residual's copy), visible to all after a barrier
  auto copy_a = [&](int ch, int b) {
#pragma unroll 4
    for (int m = 0; m < kAPer; ++m) {
      const int i = tid + kThreads * m;
      const int c = ch * kChunk + i / KB, k = i % KB;
      const bool in = c < C && k < K;
      cp_async4(Af + (b * kChunk + i / KB) * AP + k,
                in ? a.A + (long long)c * K + k : a.A, in ? 4 : 0);
    }
  };
  auto a_ready = [&](int b) {
    cp_async_wait_all();
    if constexpr (!kF32) {
#pragma unroll 4
      for (int m = 0; m < kAPer; ++m) {
        const int i = tid + kThreads * m;
        const int at = (b * kChunk + i / KB) * AP + i % KB;
        Ares[at] = __bfloat162float(__float2bfloat16_rn(Af[at]));
      }
    }
  };

  // S and Y go by bulk copies where their rows are 16-byte aligned
  const bool base_aligned =
      ((reinterpret_cast<unsigned long long>(a.S) |
        reinterpret_cast<unsigned long long>(a.Y) |
        (unsigned long long)(N * ss)) & 15ull) == 0;
  // W's rows are read with 16-byte (8-byte) loads where they are aligned
  const bool w_vec =
      weighted && ((reinterpret_cast<unsigned long long>(a.W) |
                    (unsigned long long)(N * ss) |
                    (unsigned long long)(lo * ss)) & (4 * ss - 1)) == 0;
  auto bulk_ok = [&](long long c0, int width) {
    return base_aligned && (((unsigned long long)(c0 * ss) |
                             (unsigned long long)(width * ss)) & 15ull) == 0;
  };
  auto sub_cols = [&](int t, long long& c0) {
    c0 = lo + (long long)t * SW;
    return (int)wide::lmin(SW, hi - c0);
  };
  // S of sub-tile t; every thread calls it
  auto fill_s = [&](int t) {
    long long c0;
    const int width = sub_cols(t, c0);
    wide::fill_rows<PS>(Sr, a.S, N, 0, K, c0, width, bulk_ok(c0, width),
                        &sfull);
  };
  // Y of chunk q = (sub-tile, channel chunk) into stage q & 1; every
  // thread calls it
  auto fill_y = [&](int q) {
    const int t = q / nch, ch = q - t * nch;
    long long c0;
    const int width = sub_cols(t, c0);
    const int r0 = ch * kChunk;
    wide::fill_rows<PS>(reinterpret_cast<ST*>(ring + (q & 1) * L.stage), a.Y,
                        N, r0, min(kChunk, C - r0), c0, width,
                        bulk_ok(c0, width), &full[q & 1]);
  };

  if (n_sub > 0) {
    if constexpr (kAsyncA) {
      copy_a(0, 0);
    } else {
#pragma unroll
      for (int m = 0; m < kAPer; ++m) put_a(0, m, a_of(0, m));
    }
  }
  __syncthreads();  // the barriers are initialized
  if (n_sub > 0) {
    fill_s(0);
    fill_y(0);
    if (nch > 1) fill_y(1);
  }

  const int rg = Sh::kRowWarps ? tid / Sh::QC : lane / QW;
  const int ncol = Sh::kRowWarps ? (tid % Sh::QC) * 4
                                 : warp * (QW * 4) + (lane % QW) * 4;
  const int kb0 = rg * MB;
  // the row-sum threads (K2): component rk, columns 4 rp + 4 kRowParts j
  constexpr int kRowParts = kThreads / KB;
  constexpr int kRowLen = SW / kRowParts;
  const int rk = tid / kRowParts, rp = tid % kRowParts;
  const GA pa(tid);
  uint64_t keep = 0;  // (KB = 256's read-modify-writes of the row)
  if constexpr (KB == 256) keep = l2_keep_policy();
  // KB = 256: (c)'s component groups r2 + G2 j that reach entries below K
  const int nz = (K + GA::G2 - 1) / GA::G2;
  constexpr int S1 = Sh::GS1;

  float rs = 0.f;
  float st0 = 0.f, st1 = 0.f, st2 = 0.f;

  // The Gram's blocks (bi, bj), bi <= bj, of x (rows of pitch xp) over the
  // sub-tile, added into the group's row; an entry (r, s) and its mirror
  // (s, r) sum the same products in the same order, so the block (bj, bi)
  // is this one transposed, bit for bit. pb: the parts' buffer.
  auto gram = [&](const auto* x, int xp, float* pb) {
    const GR pg(tid);
    for (int bi = 0; bi * kGramBlock < K; ++bi)
      for (int bj = bi; bj * kGramBlock < K; ++bj) {
        float acc[GR::kT1][GR::kT2];
#pragma unroll
        for (int i = 0; i < GR::kT1; ++i)
#pragma unroll
          for (int j = 0; j < GR::kT2; ++j) acc[i][j] = 0.f;
        if (bi * kGramBlock + pg.r1 < K)
          wide::pair_tile<1>(acc, pg, x + bi * kGramBlock * xp, xp,
                             x + bj * kGramBlock * xp, xp);
        wide::put_parts(pb, pg, acc);
        __syncthreads();
        float sum[GR::kPerThread];
#pragma unroll
        for (int m = 0; m < GR::kPerThread; ++m) sum[m] = 0.f;
        wide::add_parts<GR>(pb, sum);
        if constexpr (kUpperGram) {
          // the block (bi, bj) alone, eight entries loaded before any is
          // stored back (one after the other, the round trips to L2 add up;
          // all 16 in flight spilled in K3)
#pragma unroll
          for (int m0 = 0; m0 < GR::kPerThread; m0 += 8) {
            float old[8];
#pragma unroll
            for (int m = m0; m < m0 + 8; ++m) {
              const int i = tid + kThreads * m;
              const int r1 = bi * kGramBlock + i / kGramBlock;
              const int r2 = bj * kGramBlock + i % kGramBlock;
              old[m - m0] = (r1 < K && r2 < K)
                                ? ld_keep(row + e.ga + r1 * K + r2, keep)
                                : 0.f;
            }
#pragma unroll
            for (int m = m0; m < m0 + 8; ++m) {
              const int i = tid + kThreads * m;
              const int r1 = bi * kGramBlock + i / kGramBlock;
              const int r2 = bj * kGramBlock + i % kGramBlock;
              if (r1 < K && r2 < K)
                st_keep(row + e.ga + r1 * K + r2, old[m - m0] + sum[m], keep);
            }
          }
        } else {
          // (K1 at KB = 128: the row's entries one at a time; all loaded at
          // once, they spilled)
#pragma unroll(kGramUnroll)
          for (int m = 0; m < GR::kPerThread; ++m) {
            const int i = tid + kThreads * m;
            const int r1 = bi * kGramBlock + i / kGramBlock;
            const int r2 = bj * kGramBlock + i % kGramBlock;
            if (r1 < K && r2 < K) {
              row[e.ga + r1 * K + r2] += sum[m];
              if (bj != bi) row[e.ga + r2 * K + r1] += sum[m];
            }
          }
        }
        __syncthreads();  // the parts' buffer is free
      }
  };

  for (int t = 0; t < n_sub; ++t) {
    long long c0;
    const int width = sub_cols(t, c0);
    mbar_wait(&sfull, (uint32_t)(t & 1));
    if constexpr (kAsyncA) a_ready((t * nch) & 1);
    if (width < SW || K < K4) {
      // columns past the group's end and the residual's components past K
      // add zeros (the rows past K4 reach only entries past K)
      for (int i = tid; i < K4 * SW; i += kThreads) {
        const int k = i / SW, n = i % SW;
        if (k >= K || n >= width) wide::zero(Sr[k * PS + n]);
      }
    }
    __syncthreads();  // S is complete, A's first block is in

    float gs[MB][4];
#pragma unroll
    for (int i = 0; i < MB; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) gs[i][j] = 0.f;

    const int wn = min(4, width - ncol);  // the thread's columns left
    for (int ch = 0; ch < nch; ++ch) {
      const int q = t * nch + ch;
      const int rows = min(kChunk, C - ch * kChunk);
      const int arow = (q & 1) * kChunk;
      // the next chunk's block of A, in flight through the residual (its
      // buffer's last readers, chunk q - 1's (a) and (b), are behind the
      // last barrier)
      float an[kAsyncA ? 1 : kAPer];
      if (ch + 1 < nch) {
        if constexpr (kAsyncA) {
          copy_a(ch + 1, (q + 1) & 1);
        } else {
#pragma unroll
          for (int m = 0; m < kAPer; ++m) an[m] = a_of(ch + 1, m);
        }
      }
      const ST* const Ys = reinterpret_cast<const ST*>(ring + (q & 1) * L.stage);
      float* const D =
          kF32 ? reinterpret_cast<float*>(ring + (q & 1) * L.stage)
               : reinterpret_cast<float*>(smem + L.d);
      // W of the thread's row rg + RG i, loaded where it is used: in flight
      // through the residual beside the gS tile, W's tile spilled
      auto w_of = [&](int i) {
        const int c = rg + RG * i;
        const ST* p = a.W + (long long)(ch * kChunk + c) * N + c0 + ncol;
        return (c >= rows || wn <= 0)
                   ? make_float4(0.f, 0.f, 0.f, 0.f)
                   : (w_vec && wn == 4 ? wide::ld4_now(p)
                                       : wide::ld4_part(p, wn));
      };
      mbar_wait(&full[q & 1], (uint32_t)((q >> 1) & 1));
      // (a) the residual of the thread's rows rg + RG i over all K
      float r[RR][4];
      {
        const float* const ar = Ares + (arow + rg) * AP;
        const ST* const sr = Sr + ncol;
        wide::residual_steps<true, RR, KB, ST, PS, RG>(r, ar, sr, 0);
#pragma unroll(kResUnroll)
        for (int k = 4; k < K4; k += 4)
          wide::residual_steps<false, RR, KB, ST, PS, RG>(r, ar, sr, k);
      }
      // D = W (R - Y) (or R - Y), zeros past the chunk's channels and the
      // group's columns
#pragma unroll
      for (int i = 0; i < RR; ++i) {
        const int c = rg + RG * i;
        const float4 yv = wide::ld4(Ys + c * PS + ncol);
        const float y4[4] = {yv.x, yv.y, yv.z, yv.w};
        const float4 wv =
            weighted ? w_of(i) : make_float4(1.f, 1.f, 1.f, 1.f);
        const float w4[4] = {wv.x, wv.y, wv.z, wv.w};
        float d4[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float rr = r[i][j] - y4[j];
          float d = weighted ? w4[j] * rr : rr;
          if (c < rows && j < wn)
            st0 = fmaf(d, rr, st0);
          else
            d = 0.f;
          d4[j] = d;
        }
        *reinterpret_cast<float4*>(D + c * PF + ncol) =
            make_float4(d4[0], d4[1], d4[2], d4[3]);
      }
      // the next chunk's A into the other buffer
      if (!kAsyncA && ch + 1 < nch) {
#pragma unroll
        for (int m = 0; m < kAPer; ++m) put_a((q + 1) & 1, m, an[m]);
      }
      __syncthreads();  // D of the chunk and the next A are in
      // (b) gS over the chunk's channels in order (at KB = 256 whole warps
      // past K skip it: their components are not stored)
      if (!Sh::kRowWarps || kb0 < K)
        wide::grad_tile<KB, MB, PF>(gs, Af + arow * AP + kb0, D + ncol,
                                    (rows + 3) & ~3);
      // (c) gA's (chunk, all K) tile over the sub-tile's columns
      float acc[GA::kT1][GA::kT2];
#pragma unroll
      for (int i = 0; i < GA::kT1; ++i)
#pragma unroll
        for (int j = 0; j < GA::kT2; ++j) acc[i][j] = 0.f;
      // (the column loop not unrolled: unrolled twice beside the gS tile,
      // the loads spilled)
      if (pa.r1 < rows) {
        if constexpr (Sh::kRowWarps)
          ga_tile<SW>(acc, pa, D, PF, Sr, PS, nz);
        else
          wide::pair_tile<1>(acc, pa, D, PF, Sr, PS);
      }
      // (kAsyncA) the next chunk's A is in before the chunk's last barrier
      if constexpr (kAsyncA) {
        if (ch + 1 < nch) a_ready((q + 1) & 1);
      }
      const bool on_chip = ch < L.ga_chunks;
      if constexpr (GA::kParts > 1) {
        wide::put_parts(parts, pa, acc);
        __syncthreads();  // the parts' sums are in, (b) and (c) are done
        float sum[GA::kPerThread];
#pragma unroll
        for (int m = 0; m < GA::kPerThread; ++m) sum[m] = 0.f;
        wide::add_parts<GA>(parts, sum);
        // entry i = tid + kThreads m of the chunk's (c, k) tile
#pragma unroll
        for (int m = 0; m < GA::kPerThread; ++m) {
          if (on_chip) {
            gat[(ch * GA::kPerThread + m) * kThreads + tid] += sum[m];
          } else {
            const int i = tid + kThreads * m;
            const int c = ch * kChunk + i / KB, k = i % KB;
            if (c < C && k < K) row[(long long)c * K + k] += sum[m];
          }
        }
      } else if (on_chip || !Sh::kRowWarps) {
        // the thread's entries (pa.r1 + S1 i, pa.r2 + G2 j) of the tile
#pragma unroll
        for (int i = 0; i < GA::kT1; ++i)
#pragma unroll
          for (int j = 0; j < GA::kT2; ++j) {
            if (on_chip) {
              gat[(ch * GA::kPerThread + i * GA::kT2 + j) * kThreads + tid] +=
                  acc[i][j];
            } else {
              const int c = ch * kChunk + pa.r1 + S1 * i;
              const int k = pa.r2 + GA::G2 * j;
              if (c < C && k < K) row[(long long)c * K + k] += acc[i][j];
            }
          }
        __syncthreads();  // the chunk's (b) and (c) are done
      } else {
        // KB = 256, a chunk past the tiles: the thread's entries loaded
        // from the group's row all at once, then stored back
        float* const gr = row + (long long)(ch * kChunk + pa.r1) * K + pa.r2;
        auto in = [&](int i, int j) {
          return ch * kChunk + pa.r1 + S1 * i < C && pa.r2 + GA::G2 * j < K;
        };
        auto at = [&](int i, int j) { return gr + S1 * i * K + GA::G2 * j; };
        // (half the tile's rows at a time: all in flight spilled)
#pragma unroll
        for (int i0 = 0; i0 < GA::kT1; i0 += GA::kT1 / 2) {
#pragma unroll
          for (int i = i0; i < i0 + GA::kT1 / 2; ++i)
#pragma unroll
            for (int j = 0; j < GA::kT2; ++j)
              if (in(i, j)) acc[i][j] = ld_keep(at(i, j), keep) + acc[i][j];
#pragma unroll
          for (int i = i0; i < i0 + GA::kT1 / 2; ++i)
#pragma unroll
            for (int j = 0; j < GA::kT2; ++j)
              if (in(i, j)) st_keep(at(i, j), acc[i][j], keep);
        }
        __syncthreads();  // the chunk's (b) and (c) are done
      }
      // Y of the chunk after next into this chunk's stage (its D is read)
      if (ch + 2 < nch) fill_y(q + 2);
    }
    __syncthreads();  // the chunks are done: A, S and the ring are free

    // the Gram of the old S (K3), before the column overlays S
    if constexpr (MODE == wide::kGrad)
      gram(Sr, PS, reinterpret_cast<float*>(smem + L.eparts));

    // the epilogue on the column store (pitch PF): a thread per column
    // and per part of the components, kSplit threads a column (tid and
    // tid + SW at SW = 128), each a run of k where the work is elementwise;
    // the chain, which needs the whole column, by the first of them
    float* const colb = reinterpret_cast<float*>(smem + L.col);
#pragma unroll
    for (int i = 0; i < MB; ++i)
      *reinterpret_cast<float4*>(colb + (kb0 + i) * PF + ncol) =
          make_float4(gs[i][0], gs[i][1], gs[i][2], gs[i][3]);
    __syncthreads();  // gS of the sub-tile is in the column store
    constexpr int kSplit = kThreads / SW;
    const int cl = tid % SW, part = tid / SW;
    const int kq = (K + kSplit - 1) / kSplit;
    const int ka = part * kq, kz = min(K, ka + kq);
    const bool valid = cl < width;
    const long long n = c0 + cl;
    float* const x = colb + cl;
    auto s_of = [&](int k) {
      return valid ? to_f32(a.S[(long long)k * N + n]) : 0.f;
    };
    // KB = 256: the epilogue's reads from global memory (the old S, K2's
    // M and V) eight components at a time, all issued before the stores
    // they would otherwise wait behind (a load after a store through
    // another pointer cannot be moved above it)
    constexpr bool kBatchS = KB == 256;
    auto by_eight = [&](int k0, int k1, auto load, auto use) {
      for (int kb = k0; kb < k1; kb += 8) {
        decltype(load(kb)) v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (kb + j < k1) v[j] = load(kb + j);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (kb + j < k1) use(kb + j, v[j]);
      }
    };
    // the chain on whole columns, between barriers where two threads share
    // a column
    auto chain = [&](auto step_of) {
      if constexpr (kSplit > 1) __syncthreads();
      if (part == 0) apply_chain_column(a.chain, x, PF, K, step_of);
      if constexpr (kSplit > 1) __syncthreads();
    };
    if constexpr (MODE == wide::kGrad) {
      if (valid) {
#pragma unroll 4
        for (int k = ka; k < kz; ++k) a.out[(long long)k * N + n] = x[k * PF];
      }
    } else if constexpr (MODE == wide::kPgm || MODE == wide::kPgmPre) {
      const float sS = *a.step_S;
      auto x_of = [&](int k, float s) {
        const float v = s - sS * x[k * PF];
        if constexpr (MODE == wide::kPgmPre) {
          if (valid) a.pre[(long long)k * N + n] = v;
        } else {
          x[k * PF] = v;
        }
      };
      if constexpr (kBatchS) {
        by_eight(ka, kz, [&](int k) { return s_of(k); },
                 [&](int k, float s) { x_of(k, s); });
      } else {
#pragma unroll 4
        for (int k = ka; k < kz; ++k) x_of(k, s_of(k));
      }
      if constexpr (MODE == wide::kPgm) chain([&](int) { return sS; });
    } else {  // kAda, kAdaPre
      const wide::AdaSchedule h = wide::ada_schedule(a);
      // the per-element step alpha_k / Psi_safe beside the column
      float* const step = reinterpret_cast<float*>(smem + L.step) + cl;
      auto update = [&](int k, float m0, float v0) {
        const float2 r =
            wide::ada_update<MODE>(a, h, (long long)k * N + n, k, x[k * PF],
                                   s_of(k), m0, v0, valid);
        x[k * PF] = r.x;
        if constexpr (MODE == wide::kAda) step[k * SW] = r.y;
      };
      if constexpr (kBatchS) {
        // M, V and the old S of eight components loaded before any store
        by_eight(
            ka, kz,
            [&](int k) {
              const long long gi = (long long)k * N + n;
              return valid ? make_float4(to_f32(a.M[gi]), to_f32(a.V[gi]),
                                         to_f32(a.S[gi]), 0.f)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
            },
            [&](int k, float4 mvs) {
              const float2 r = wide::ada_update<MODE>(
                  a, h, (long long)k * N + n, k, x[k * PF], mvs.z, mvs.x,
                  mvs.y, valid);
              x[k * PF] = r.x;
              if constexpr (MODE == wide::kAda) step[k * SW] = r.y;
            });
      } else if constexpr (std::is_same<MT, float>::value) {
        wide::moments_by_eight(a.M, a.V, N, n, ka, kz, valid, update);
      } else {
#pragma unroll 1
        for (int k = ka; k < kz; ++k) {
          const long long gi = (long long)k * N + n;
          float m0 = 0.f, v0 = 0.f;
          if (valid) {
            m0 = to_f32(a.M[gi]);
            v0 = to_f32(a.V[gi]);
          }
          update(k, m0, v0);
        }
      }
      if constexpr (MODE == wide::kAda)
        chain([&](int k) { return step[k * SW]; });
    }
    if constexpr (wide::has_update(MODE)) {
      // store S' and keep the stored values for the sums
      if constexpr (kBatchS) {
        by_eight(ka, kz, [&](int k) { return s_of(k); },
                 [&](int k, float s) {
                   float xs = 0.f;
                   if (valid) {
                     xs = x[k * PF];
                     if (a.out != nullptr)
                       xs = store(a.out, (long long)k * N + n, xs);
                     const float dk = xs - s;
                     st1 = fmaf(dk, dk, st1);
                     st2 = fmaf(xs, xs, st2);
                   }
                   x[k * PF] = xs;
                 });
      } else {
        wide::store_column(a, x, PF, ka, kz, valid, n, s_of, st1, st2);
      }
      __syncthreads();  // S' is in the column store
      if constexpr (wide::has_gram(MODE)) {
        gram(colb, PF, reinterpret_cast<float*>(smem + L.eparts));
      } else {
        if (rk < K) {
          const float* xr = colb + rk * PF + 4 * rp;
#pragma unroll
          for (int j = 0; j < kRowLen; j += 4) {
            const float4 v = wide::ld4(xr + kRowParts * j);
            rs += v.x;
            rs += v.y;
            rs += v.z;
            rs += v.w;
          }
        }
      }
    }
    // the next sub-tile's first block of A, loaded after the Gram (in flight
    // through it, it spilled)
    const bool more = t + 1 < n_sub;
    float an0[kAsyncA ? 1 : kAPer];
    if (!kAsyncA && more) {
#pragma unroll
      for (int m = 0; m < kAPer; ++m) an0[m] = a_of(0, m);
    }
    __syncthreads();  // the column store is free: A, S, the ring
    if (more) {
      if constexpr (kAsyncA) {
        copy_a(0, ((t + 1) * nch) & 1);
      } else {
#pragma unroll
        for (int m = 0; m < kAPer; ++m)
          put_a(((t + 1) * nch) & 1, m, an0[m]);
      }
      fill_s(t + 1);
      fill_y((t + 1) * nch);
      if (nch > 1) fill_y((t + 1) * nch + 1);
    }
  }

  // KB = 256: the Gram's blocks below the diagonal, from their mirrors
  // (the same sums: an entry and its mirror add the same products in the
  // same order); the last sub-tile's blocks are behind its barriers
  if constexpr (kUpperGram && wide::has_gram(MODE)) {
    for (int i = tid; i < K * K; i += kThreads) {
      const int r1 = i / K, r2 = i % K;
      if (r1 / kGramBlock > r2 / kGramBlock)
        row[e.ga + i] = row[e.ga + r2 * K + r1];
    }
  }
  // gA's tiles into the group's row, once
  for (int ch = 0; ch < L.ga_chunks; ++ch) {
    if constexpr (GA::kParts > 1) {
#pragma unroll
      for (int m = 0; m < GA::kPerThread; ++m) {
        const int i = tid + kThreads * m;
        const int c = ch * kChunk + i / KB, k = i % KB;
        if (c < C && k < K)
          row[(long long)c * K + k] =
              gat[(ch * GA::kPerThread + m) * kThreads + tid];
      }
    } else {
#pragma unroll
      for (int i = 0; i < GA::kT1; ++i)
#pragma unroll
        for (int j = 0; j < GA::kT2; ++j) {
          const int c = ch * kChunk + pa.r1 + S1 * i;
          const int k = pa.r2 + GA::G2 * j;
          if (c < C && k < K)
            row[(long long)c * K + k] =
                gat[(ch * GA::kPerThread + i * GA::kT2 + j) * kThreads + tid];
        }
    }
  }
  // the row sums' parts, in the free column store
  if constexpr (wide::has_rowsum(MODE))
    wide::row_sums<kRowParts>(reinterpret_cast<float*>(smem + L.eparts), rs,
                              K, row + e.ga);
  // [loss] from st0, [|S' - S|^2, |S'|^2] from st1, st2
  wide::block_stats(st0, st1, st2, red, row + e.ga + e.mid, 0, e.stats);
}

// Both launches of one pass on `stream`: a block per group of units (one
// per SM), then the wide body's finalize. Returns cudaGetLastError().
template <int KB, typename ST, typename MT, int MODE, typename Kernel,
          typename Finalize>
int launch(Kernel kernel, Finalize fin, wide::LaunchCache& lc,
           const Args<ST, MT>& args, float* gA, float* mid, float* stats,
           cudaStream_t stream) {
  cudaError_t err;
  if (args.C < 1 || args.K < kMinK || args.K > KB || args.N < 1 ||
      args.tile_n < 1)
    return (int)cudaErrorInvalidValue;
  const Smem L = smem_layout<KB, ST>(MODE, args.C);
  if (!L.ok) return (int)cudaErrorInvalidValue;
  if (L.total > lc.allowed_smem) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return (int)err;
    lc.allowed_smem = L.total;
  }
  const long long groups = wide::group_count(args.n_units, 1);
  kernel<<<(unsigned)groups, kThreads, L.total, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Entries e = wide::entries(MODE, args.C, args.K);
  fin<<<(e.total + 31) / 32, wide::kFinThreads, 0, stream>>>(
      args.partials, groups, e, true, gA, mid, stats);
  return (int)cudaGetLastError();
}

}  // namespace kwide
}  // namespace
