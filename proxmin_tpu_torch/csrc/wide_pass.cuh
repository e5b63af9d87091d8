// The wide body of K1 (nmf_pgm_wide.cu), K2 (nmf_adaprox_wide.cu) and K3
// (nmf_grad.cu): one pass over the pixel columns for any C <= 256 channels
// and K <= 32 components, and the two passes of the split path, where a
// prox_S that no compiled chain covers runs in PyTorch between them. Built
// with VW, the same body serves the very-wide tier up to K = 32 at any C
// (vwide_pass.cuh): A a chunk at a time, gA's tiles in shared memory.
//
// Why the narrow body (pgm_pass.cuh) cannot just be built wider: its ring
// stage holds all C rows of Y (and W) for 256 columns, 128 KB at C = 128 in
// float32 unweighted and 256 KB weighted, against about 224 KB per block;
// and each of its threads keeps (C + K) / 8 rows of K sums in registers,
// 640 at C = 128, K = 32. Here neither grows with C.
//
// Per pixel column the work is three products over small dimensions, the
// residual R = A S - Y (C K FMAs), gS = A^T D (C K) and gA += D S^T (C K),
// plus the Gram (K K) in K1 and K3. Each is a block-level product of
// register tiles over shared-memory tiles. What bounds such products on an
// H100 is the shared memory's delivery to the registers, 128 bytes a clock
// per SM (a warp's 16-byte load costs four of them, broadcast or not),
// against 128 FMAs a clock: a thread has to do four FMAs per float it
// loads, which takes 8 x 8 tiles. The design:
//
// - Blocks of 8 warps: two per SM (at most 128 registers a thread) for the
//   passes without a residual, and for the residual at KB = 8 where the
//   shared memory fits two; one per SM (up to 255 registers) for the
//   residual at KB = 16 and 32, which spill at 128 (blocks_per_sm,
//   Smem::blocks). Where a sub-tile holds little work the second block
//   hides the first's barriers and latencies. A block takes a group of
//   consecutive work units (a unit is a part of at most kPart columns of a
//   tile of tile_n columns; a group is ceil(units / (kGroups blocks))
//   units, so at most kGroups blocks groups), fixed by N, tile_n and the
//   instance, and walks its columns in sub-tiles of kSub, one column a
//   thread in the epilogue. The sub-tile's S (K x kSub) sits in a shared
//   buffer; the channels go in chunks of kChunk whose Y rows (a stage holds
//   the rows a chunk takes) a ring of two shared stages brings in one chunk
//   ahead with 1-D cp.async.bulk copies
//   (bulk_ring.cuh, a row a lane of warp 0), and the next sub-tile's S the
//   same way into a second buffer where two fit. K2's M and V come by the
//   same copies a main loop ahead of the epilogue that reads them, pass 2's
//   P beside S. W is read straight into registers at the start of a
//   chunk's residual (with two blocks, where it is used): each of its
//   values is used once, by one thread.
//   Rows that are not 16-byte aligned (ragged N, odd offsets) are copied by
//   the threads instead.
// - (a) R: a thread holds 8 channels x 4 columns and runs k in order, each
//   step float4s of A's 8 rows and of S's 4 rows: the exact-f32 chain
//   A[c,0] s[0] + ... of the narrow body and the TPU kernel's "fma" path.
//   D = W (R - Y) (or R - Y) goes to shared memory, over Y's rows in f32.
// - (b) gS = A^T D: a thread holds KB / 4 components x the same 4 columns
//   in registers across the chunks and runs c in order (fmaf from 0, as a
//   thread that owns whole columns sums them: gS, and with it x, S', M'
//   and V', do not depend on the tiling).
// - (c) gA += D S^T: a thread holds an 8 x 4 tile of the chunk's (c, k)
//   block over one part of the sub-tile's columns, in column order; the
//   parts' sums meet in shared memory and are added in order into each
//   thread's KB / 8 entries of every chunk, kept in registers for the
//   whole group. The Gram (of S' in K1, of the old S in K3) is the same
//   routine over K x K; K2's row sums are 256 / KB threads a row.
// - The epilogue reads gS back from shared memory one column per thread
//   (the prox chain needs all K values of a column): K3 stores gS; K1 forms
//   x = s - sS gS and applies the compiled chain (prox_chain.cuh), stores
//   S' and writes the stored S' back for the Gram; K2 forms the moments,
//   Phi, Psi and x, then the chain with the per-element step alpha_k /
//   Psi_safe (kept in shared memory beside the column). The split path's
//   first pass stores x (and K2's step) in float32; its second pass takes
//   the prox's output P and gives the Gram (K1) or the row sums (K2) and
//   [|S' - S|^2, |S'|^2], storing S' rounded to bfloat16 with the bfloat16
//   store.
// - Each group writes one row of partial sums, contiguous (coalesced); a
//   second launch gives each 32 entries a block whose warps sum the group
//   rows in double in a fixed order and round once. No atomics: two
//   launches give the same bits, whatever the grid or the card, and the
//   summation order depends on N and tile_n alone.
// - Columns past N in a group's last sub-tile and components past K add
//   exact zeros: their S and D entries in shared memory are zeros.
//
// What bounds it on an H100 at C = 128, K = 32: the float32 FMAs, about
// 3 C K + K (K + 1) / 2 per pixel column (the Gram is symmetric; the body
// forms both triangles, K^2), 12.8e9 at N = 1e6, 0.38 ms at 67 TFLOP/s,
// against (C + 2K) N 4 = 0.77 GB of naive bytes, 0.23 ms at 3.35 TB/s; and,
// tighter than both, the shared-memory delivery: the 8 x 4 tiles load 3
// floats per 8 FMAs, 1.5 times the FMAs' time. No tensor cores: TF32 would
// round the residual's operands.

#pragma once

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bulk_ring.cuh"
#include "prox_chain.cuh"
#include "tiers.cuh"

namespace {
namespace wide {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 256;        // columns per sub-tile
constexpr int kPart = kSub;      // columns per work unit at most
constexpr int kChunk = 32;       // channels per chunk
constexpr int kMaxC = 256;
constexpr int kMaxK = tier::kWideK;
constexpr int kMaxChunks = kMaxC / kChunk;
// Groups of units (rows of partial sums) at most, per block an SM holds:
// one block each, so kGroups groups of blocks that run one per SM, or 2
// kGroups of blocks that run two per SM, fill the H100's 132 SMs in one
// wave. The count depends on N, tile_n and the instance (KB, the mode, C
// and the types), whatever the card.
constexpr int kGroups = 132;
constexpr int kPitchF = kSub + 4;  // pitch of a float32 row (floats)
// The dynamic shared memory a block may take beside its static arrays
// (227 KB in all), and the most two blocks of an SM may each take (228 KB
// an SM, 1 KB of it reserved per block, and the static arrays).
constexpr int kSmemMax = 226 * 1024;
constexpr int kSmemPair = 112 * 1024;
constexpr int kFinThreads = 256;
// Floats of the (c) routine's buffer of partial sums: a tile of at most 32
// sums a thread, and the padding of the parts' rows.
constexpr int kPartFloats = kThreads * 32 + kThreads;

// What a pass computes.
enum Mode {
  kGrad,      // K3: gS stored; gA, the Gram of the old S, [loss]
  kPgm,       // K1, compiled chain: S' stored; gA, the Gram of S',
              //   [loss, |S' - S|^2, |S'|^2]
  kPgmPre,    // K1 split pass 1: x = s - sS gS stored in f32; gA, [loss]
  kPgmPost,   // K1 split pass 2: from P = prox(x), the Gram of S',
              //   [|S' - S|^2, |S'|^2]; S' stored with the bfloat16 store
  kAda,       // K2, compiled chain: S', M', V' stored; gA, rowsum(S'),
              //   [loss, |S' - S|^2, |S'|^2]
  kAdaPre,    // K2 split pass 1: M', V', x and alpha / Psi_safe stored
              //   (x and the step in f32); gA, [loss]
  kAdaPost,   // K2 split pass 2: from P, rowsum(S'), [|S' - S|^2, |S'|^2]
};

__host__ __device__ constexpr bool has_residual(int m) {
  return m != kPgmPost && m != kAdaPost;
}
__host__ __device__ constexpr bool has_gram(int m) {
  return m == kGrad || m == kPgm || m == kPgmPost;
}
__host__ __device__ constexpr bool has_rowsum(int m) {
  return m == kAda || m == kAdaPost;
}
__host__ __device__ constexpr bool has_update(int m) {
  return m == kPgm || m == kPgmPost || m == kAda || m == kAdaPost;
}
// The blocks per SM an instance is built for (its __launch_bounds__): two,
// at most 128 registers a thread, where KB = 8 or the pass has no residual;
// one, up to 255 registers, for the residual at KB = 16 and 32 and for the
// very-wide instances (VW: C > 256, whose ring, A buffers and gA tiles
// never fit two). Two run where their shared memory fits (Smem::blocks).
__host__ __device__ constexpr int blocks_per_sm(int kb, int m,
                                                bool vw = false) {
  return (!vw && (kb <= 8 || !has_residual(m))) ? 2 : 1;
}

// The entries of one group's row of partial sums: gA (C K), the Gram (K K,
// both triangles) or the row sums (K), then the statistics: [loss] and/or
// [|S' - S|^2, |S'|^2].
struct Entries {
  int ga, mid, stats, total;
};
__host__ __device__ inline Entries entries(int mode, int C, int K) {
  Entries e;
  e.ga = has_residual(mode) ? C * K : 0;
  e.mid = has_gram(mode) ? K * K : (has_rowsum(mode) ? K : 0);
  e.stats = (has_residual(mode) ? 1 : 0) + (has_update(mode) ? 2 : 0);
  e.total = e.ga + e.mid + e.stats;
  return e;
}

__host__ __device__ inline long long lmin(long long x, long long y) {
  return x < y ? x : y;
}
__host__ __device__ inline long long parts_per_tile(long long tile_n) {
  return (tile_n + kPart - 1) / kPart;
}
__host__ __device__ inline long long unit_count(long long N,
                                                long long tile_n) {
  const long long n_tiles = (N + tile_n - 1) / tile_n;
  const long long last = N - (n_tiles - 1) * tile_n;
  return (n_tiles - 1) * parts_per_tile(tile_n) + (last + kPart - 1) / kPart;
}
// Unit u covers the columns [begin, end).
__host__ __device__ inline void unit_span(long long u, long long N,
                                          long long tile_n, long long& begin,
                                          long long& end) {
  const long long ppt = parts_per_tile(tile_n);
  const long long j = u / ppt, p = u % ppt;
  begin = j * tile_n + p * kPart;
  end = lmin(j * tile_n + lmin((p + 1) * kPart, tile_n), N);
}
// Units per group, and groups (blocks, rows of partial sums), for blocks
// that run `blocks` to an SM. group_count(n_units, 2) bounds every
// instance's count: the rows of partial sums to allocate.
__host__ __device__ inline long long group_units(long long n_units,
                                                 int blocks) {
  const long long cap = (long long)kGroups * blocks;
  return (n_units + cap - 1) / cap;
}
__host__ __device__ inline long long group_count(long long n_units,
                                                 int blocks) {
  const long long g = group_units(n_units, blocks);
  return (n_units + g - 1) / g;
}

template <typename ST, typename MT>
struct Args {
  const float* A;       // (C, K)
  const ST* S;          // (K, N)
  const ST* Y;          // (C, N)
  const ST* W;          // (C, N) or null
  const MT* M;          // K2: (K, N)
  const MT* V;          // K2: (K, N)
  const float* alpha;   // K2: (K,)
  const float* step_S;  // K1: the step on the card
  const float* dsc;     // K2: b1_t, bc1, bc2 on the card, or null
  float b1_t, bc1, bc2, one_minus_b2, b2, eps;  // K2, by value
  const float* P;       // pass 2: the prox's output (K, N) float32
  ProxChain chain;
  int C, K;
  long long N, tile_n, n_units;
  ST* out;              // S' (K, N), or K3's gS; null in pass 2 of f32
  MT* M_out;            // K2
  MT* V_out;            // K2
  float* pre;           // pass 1: x (K, N) float32
  float* pre_step;      // K2 pass 1: alpha / Psi_safe (K, N) float32
  float* partials;      // (group_count(n_units, blocks), entries)
};

// Pitch (elements) of a row of S, Y or W as stored: rows stay 16-byte
// aligned for the bulk copies, and rows r and r + 1 start 4 banks apart.
template <typename T>
__host__ __device__ constexpr int raw_pitch() {
  return sizeof(T) == 4 ? kSub + 4 : kSub + 8;
}

// Shared memory, byte offsets from the dynamic base.
struct Smem {
  int a_res, a_f;   // A for the residual and for gS: rows of KB + 4 floats
  int s, s_bytes;   // the S buffers (each KB rows of kPitchF floats)
  int n_s;          // 2 where two fit, else 1
  int p;            // pass 2: the prox's output P beside each S buffer
  int mv, mv_bytes; // K2: M and V of a sub-tile (each KB rows), where they
                    // fit (mv_bytes 0 otherwise: read from global memory)
  int ring, stage;  // the chunk ring: two stages of kChunk rows of Y
  int d;            // D of a chunk in float32 with the bfloat16 store (f32
                    // D overwrites Y); the epilogue's buffer in pass 2
  int part;         // the (c) routine's partial sums; without a residual
                    // they share the epilogue's buffer (the Gram reads S'
                    // there before it writes them)
  int ga, ga_chunks;  // VW: gA's (chunk) tiles of the first ga_chunks
                      // chunks, for the whole group (the rest in the
                      // group's row in global memory)
  int total;
  int blocks;       // blocks per SM: 2 where the instance is built for two
                    // and the layout fits kSmemPair, else 1
};
// VW (the very-wide instances, C > 256 with K <= 32): A no longer fits
// whole, nor gA in registers. A goes a chunk at a time through two buffers
// (the chunk's and the next one's: a_bytes is both); after the ring, D,
// the parts' sums and a second S buffer, gA's tiles of as many chunks as
// fit stay in shared memory for the whole group (at KB = 32 in float32, 13
// of C = 425's 14 chunks; the rest in the group's row), then K2's M and V
// where they fit.
template <int KB, typename ST, typename MT, bool VW = false>
__host__ __device__ inline Smem smem_layout(int mode, int C) {
  constexpr bool kF32 = std::is_same<ST, float>::value;
  const bool res = has_residual(mode);
  const int cpad = res ? (C + kChunk - 1) / kChunk * kChunk : 0;
  const int a_bytes = (VW ? 2 * kChunk : cpad) * (KB + 4) * 4;
  // the rows a chunk takes: its channels in the residual's blocks of 8,
  // at most kChunk; in float32 gS then takes the last chunk's stage (KB
  // rows)
  const int crows = res ? (C < kChunk ? (C + 7) / 8 * 8 : kChunk) : 0;
  const int drows = res ? (crows > KB ? crows : KB) : KB;
  Smem m;
  m.a_res = 0;
  m.a_f = kF32 ? 0 : a_bytes;
  m.s = kF32 ? a_bytes : 2 * a_bytes;
  m.s_bytes = KB * kPitchF * 4;
  m.stage = res ? (kF32 ? drows : crows) * raw_pitch<ST>() * (int)sizeof(ST)
                : 0;
  const int d_bytes = (res && kF32) ? 0 : drows * kPitchF * 4;
  const int p_bytes = res ? 0 : m.s_bytes;
  const int part_bytes = kPartFloats * 4;
  const int dp_bytes = res ? d_bytes + part_bytes
                           : (d_bytes > part_bytes ? d_bytes : part_bytes);
  // A, the ring, D, the parts' sums and one S buffer first; then K2's M
  // and V; then a second S buffer, each where it fits
  const int base = m.s + m.s_bytes + p_bytes + 2 * m.stage + dp_bytes;
  m.blocks = blocks_per_sm(KB, mode, VW) == 2 && base <= kSmemPair ? 2 : 1;
  const int budget = m.blocks == 2 ? kSmemPair : kSmemMax;
  const int mv =
      (mode == kAda || mode == kAdaPre)
          ? KB * raw_pitch<MT>() * (int)sizeof(MT) : 0;
  int ga_bytes = 0;
  m.ga_chunks = 0;
  if constexpr (VW) {
    // a second S buffer first (the next sub-tile's copy then runs during
    // the epilogue), then gA's tiles, then K2's M and V
    m.n_s = base + m.s_bytes <= budget ? 2 : 1;
    const int used = base + (m.n_s - 1) * m.s_bytes;
    const int tile = kChunk * KB * 4;
    const int room = budget > used ? (budget - used) / tile : 0;
    m.ga_chunks = cpad / kChunk < room ? cpad / kChunk : room;
    ga_bytes = m.ga_chunks * tile;
    m.mv_bytes = used + ga_bytes + 2 * mv <= budget ? mv : 0;
  } else {
    m.mv_bytes = base + 2 * mv <= budget ? mv : 0;
    m.n_s = base + 2 * m.mv_bytes + m.s_bytes + p_bytes <= budget ? 2 : 1;
  }
  m.p = m.s + m.n_s * m.s_bytes;
  m.mv = m.p + m.n_s * p_bytes;
  m.ring = m.mv + 2 * m.mv_bytes;
  m.d = m.ring + 2 * m.stage;
  m.part = res ? m.d + d_bytes : m.d;
  m.ga = m.d + dp_bytes;
  m.total = m.ga + ga_bytes;
  return m;
}

// Four consecutive elements as float32 (16 or 8 bytes aligned), from shared
// or global memory.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
// Four consecutive elements from global memory, loaded where the call
// stands: the volatile asm keeps the compiler from sinking the load to
// its use (W's loads are issued before a chunk's residual and used after
// it).
__device__ __forceinline__ float4 ld4_now(const float* p) {
#ifdef __CUDA_ARCH__
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
#else
  return ld4(p);
#endif
}
__device__ __forceinline__ float4 ld4_now(const __nv_bfloat16* p) {
#ifdef __CUDA_ARCH__
  uint2 u;
  asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];"
               : "=r"(u.x), "=r"(u.y)
               : "l"(p));
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
#else
  return ld4(p);
#endif
}
// One float from global memory, loaded where the call stands (the
// very-wide instances' next A block, issued before a chunk's residual and
// stored after it).
__device__ __forceinline__ float ld_now(const float* p) {
#ifdef __CUDA_ARCH__
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
#else
  return *p;
#endif
}
// 16 bytes from global to shared memory by cp.async (zeros past
// src_bytes), the commit of the thread's copies so far as a group, and the
// wait until at most kPending of its groups are in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
#else
  unsigned char* d = static_cast<unsigned char*>(dst);
  for (int i = 0; i < 16; ++i)
    d[i] = i < src_bytes ? static_cast<const unsigned char*>(src)[i] : 0;
#endif
}
__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;" ::: "memory");
#endif
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
#endif
}
// The first n < 4 of four elements (the rest 0), one by one.
template <typename T>
__device__ __forceinline__ float4 ld4_part(const T* p, int n) {
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = j < n ? to_f32(p[j]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void zero(float& v) { v = 0.f; }
__device__ __forceinline__ void zero(__nv_bfloat16& v) {
  v = __float2bfloat16_rn(0.f);
}

// Four steps k .. k + 3 of (a) for MI rows a, a + RS AP, ... of A and the
// 4 columns s of a row of S (row pitch PS): r[i][j] (+)= A[i][k'] S[k'][j];
// kFirst: the chain starts with the product A[i][0] S[0][j].
template <bool kFirst, int MI, int KB, typename ST, int PS = raw_pitch<ST>(),
          int RS = 4>
__device__ __forceinline__ void residual_steps(float (&r)[MI][4],
                                               const float* a, const ST* s,
                                               int k) {
  constexpr int AP = KB + 4;
  float4 sv[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sv[kk] = ld4(s + (k + kk) * PS);
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const float4 av =
        *reinterpret_cast<const float4*>(a + RS * i * AP + k);
    const float ak[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float sj[4] = {sv[kk].x, sv[kk].y, sv[kk].z, sv[kk].w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r[i][j] = (kFirst && kk == 0) ? ak[0] * sj[j]
                                      : fmaf(ak[kk], sj[j], r[i][j]);
    }
  }
}

// (a) for MI channel rows and 4 columns: r[i][j] = A[i][0] S[0][j] +
// A[i][1] S[1][j] + ..., an fmaf chain over k in order.
template <int MI, int KB, typename ST>
__device__ __forceinline__ void residual_tile(float (&r)[MI][4],
                                              const float* a, const ST* s) {
  residual_steps<true, MI, KB, ST>(r, a, s, 0);
#pragma unroll 1
  for (int k = 4; k < KB; k += 4)
    residual_steps<false, MI, KB, ST>(r, a, s, k);
}

// MB consecutive floats (MB = 2, 4 or 8; aligned to 8 bytes, or 16).
template <int MB>
__device__ __forceinline__ void ldv(float (&v)[MB], const float* p) {
  if constexpr (MB == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int h = 0; h < MB; h += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + h);
      v[h] = q.x;
      v[h + 1] = q.y;
      v[h + 2] = q.z;
      v[h + 3] = q.w;
    }
  }
}

// (b): g[i][j] += the sum over the chunk's channels c < depth, in order, of
// A[c][k0 + i] D[c][n_j] for MB components; a points at A[chunk row 0][k0]
// (rows of KB + 4 floats), d at D[0][n_0] (rows of DP floats).
template <int KB, int MB = KB / 4, int DP = kPitchF>
__device__ __forceinline__ void grad_tile(float (&g)[MB][4], const float* a,
                                          const float* d, int depth) {
  constexpr int AP = KB + 4;
#pragma unroll 1
  for (int c = 0; c < depth; c += 4) {
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float av[MB];
      ldv<MB>(av, a + (c + cc) * AP);
      const float4 dv = ld4(d + (c + cc) * DP);
#pragma unroll
      for (int i = 0; i < MB; ++i) {
        g[i][0] = fmaf(av[i], dv.x, g[i][0]);
        g[i][1] = fmaf(av[i], dv.y, g[i][1]);
        g[i][2] = fmaf(av[i], dv.z, g[i][2]);
        g[i][3] = fmaf(av[i], dv.w, g[i][3]);
      }
    }
  }
}

// The (c) routine: sums over a sub-tile's columns of products of the rows
// of two operands, X (R1 rows) and Z (R2 rows): gA's (c, k) block of a
// chunk (X = D, Z = S), the Gram (X = Z = S' or S). A thread holds a tile
// of T1 consecutive rows of X, r1 + i, by T2 rows of Z, r2 + G2 j, summed
// in column order over one part of a sub-tile's SW columns, [part kLen,
// (part + 1) kLen); the parts' sums go through shared memory (rows of
// kStride floats) and are added in order. A warp shares r1, so whole warps
// skip rows past a chunk's channels; its lanes take G2 consecutive rows of
// Z (rows 4 banks apart) and 32 / G2 parts, so that no 8 lanes of a
// 16-byte load, nor the 32 of a store of the parts' sums, hit one bank
// twice.
template <int R1, int R2, int T1, int T2, int SW = kSub>
struct PairMap {
  static constexpr int kT1 = T1, kT2 = T2;
  static constexpr int G1 = R1 / T1, G2 = R2 / T2;
  static constexpr int kParts = kThreads / (G1 * G2);
  static constexpr int kLen = SW / kParts;
  static constexpr int kEntries = R1 * R2;
  static constexpr int kStride = kEntries + G2;
  static constexpr int kPerThread = (kEntries + kThreads - 1) / kThreads;
  static_assert(G1 <= kWarps && G2 <= 32 && kLen % 4 == 0 &&
                    kParts * kStride <= kPartFloats,
                "a tile map that does not fit the block");
  int part, r1, r2;
  __device__ __forceinline__ explicit PairMap(int tid) {
    const int lane = tid & 31, warp = tid >> 5;
    r1 = (warp % G1) * T1;
    r2 = lane % G2;
    part = (warp / G1) * (32 / G2) + lane / G2;
  }
};

// acc += the thread's products over its part of the columns; x and z point
// at the operands' row 0, column 0, with row pitches xp and zp; the loop
// over the columns unrolled kUnroll times.
template <int kUnroll, class PM, typename XT, typename ZT>
__device__ __forceinline__ void pair_tile(float (&acc)[PM::kT1][PM::kT2],
                                          const PM& pm, const XT* x, int xp,
                                          const ZT* z, int zp) {
  constexpr int T1 = PM::kT1, T2 = PM::kT2;
  const int off = pm.part * PM::kLen;
  const XT* xr = x + pm.r1 * xp + off;
  const ZT* zr = z + pm.r2 * zp + off;
#pragma unroll(kUnroll)
  for (int n = 0; n < PM::kLen; n += 4) {
    float4 xv[T1], zv[T2];
#pragma unroll
    for (int i = 0; i < T1; ++i) xv[i] = ld4(xr + i * xp + n);
#pragma unroll
    for (int j = 0; j < T2; ++j) zv[j] = ld4(zr + j * PM::G2 * zp + n);
#pragma unroll
    for (int i = 0; i < T1; ++i) {
#pragma unroll
      for (int j = 0; j < T2; ++j) {
        float v = acc[i][j];
        v = fmaf(xv[i].x, zv[j].x, v);
        v = fmaf(xv[i].y, zv[j].y, v);
        v = fmaf(xv[i].z, zv[j].z, v);
        v = fmaf(xv[i].w, zv[j].w, v);
        acc[i][j] = v;
      }
    }
  }
}

// The thread's tile of sums into its part's row of the buffer.
template <class PM>
__device__ __forceinline__ void put_parts(float* buf, const PM& pm,
                                          const float (&acc)[PM::kT1]
                                                            [PM::kT2]) {
  float* b = buf + pm.part * PM::kStride;
#pragma unroll
  for (int i = 0; i < PM::kT1; ++i)
#pragma unroll
    for (int j = 0; j < PM::kT2; ++j)
      b[(pm.r1 + i) * (PM::G2 * PM::kT2) + pm.r2 + PM::G2 * j] = acc[i][j];
}

// out[m] += the sum over the parts, in order, of entry tid + kThreads m.
template <class PM>
__device__ __forceinline__ void add_parts(const float* buf,
                                          float (&out)[PM::kPerThread]) {
#pragma unroll
  for (int m = 0; m < PM::kPerThread; ++m) {
    const int e = threadIdx.x + kThreads * m;
    if (e < PM::kEntries) {
      float v = buf[e];
#pragma unroll 4
      for (int p = 1; p < PM::kParts; ++p) v += buf[p * PM::kStride + e];
      out[m] += v;
    }
  }
}

// The pieces the bodies share (this one, kwide_pass.cuh's and, for the
// epilogue and the statistics, vwide_pass.cuh's).

// Warp 0 issues a fill's bulk copies on `bar`, a row a lane, once lane 0
// has set the barrier's byte count; the other warps return.
template <typename CopyRow>
__device__ __forceinline__ void bulk_rows(uint64_t* bar, uint32_t bytes,
                                          int n_rows, CopyRow&& copy_row) {
  const int lane = threadIdx.x & 31;
  if ((threadIdx.x >> 5) != 0) return;
  // the buffer was last used through the generic proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  if (lane == 0) mbar_arrive_expect_tx(bar, bytes);
  __syncwarp();
  for (int r = lane; r < n_rows; r += 32) copy_row(r);
}

// Rows r0 .. r0 + rows - 1 of src (rows N elements apart), columns c0 ..
// c0 + width - 1, into dst (rows P elements apart), complete on `bar`: by
// bulk copies where `bulk` (every row's ends 16-byte aligned), else the
// threads copy them and thread 0 arrives. Every thread calls it.
template <int P, typename T>
__device__ __forceinline__ void fill_rows(T* dst, const T* src, long long N,
                                          int r0, int rows, long long c0,
                                          int width, bool bulk,
                                          uint64_t* bar) {
  constexpr int ts = sizeof(T);
  if (bulk) {
    bulk_rows(bar, (uint32_t)(rows * width * ts), rows, [&](int r) {
      bulk_load(dst + r * P, src + (long long)(r0 + r) * N + c0, width * ts,
                bar);
    });
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kWarps) {
    const long long gi = (long long)(r0 + r) * N + c0;
    for (int n = lane; n < width; n += 32) dst[r * P + n] = src[gi + n];
  }
  __syncthreads();
  if (threadIdx.x == 0) mbar_arrive(bar);
}

// K2's schedule: b1_t and the bias corrections (from the card where the
// caller gave them there), and 1 - b1_t in float32, as the TPU kernel
// computes it from its float32 scalar.
struct AdaSchedule {
  float b1_t, bc1, bc2, one_minus_b1;
};
template <typename ST, typename MT>
__device__ __forceinline__ AdaSchedule ada_schedule(const Args<ST, MT>& a) {
  AdaSchedule h{a.b1_t, a.bc1, a.bc2, 0.f};
  if (a.dsc != nullptr) {
    h.b1_t = a.dsc[0];
    h.bc1 = a.dsc[1];
    h.bc2 = a.dsc[2];
  }
  h.one_minus_b1 = __fsub_rn(1.f, h.b1_t);
  return h;
}

// K2's update of element gi (component k) from its gradient gk, its old
// value s and its old moments m0, v0: M' and V' (and split pass 1's x and
// step) stored where `valid`; returns {x, the step alpha_k / Psi_safe}.
template <int MODE, typename ST, typename MT>
__device__ __forceinline__ float2 ada_update(const Args<ST, MT>& a,
                                             const AdaSchedule& h,
                                             long long gi, int k, float gk,
                                             float s, float m0, float v0,
                                             bool valid) {
  const float m1 =
      __fadd_rn(__fmul_rn(h.one_minus_b1, gk), __fmul_rn(h.b1_t, m0));
  const float v1 = __fadd_rn(__fmul_rn(a.one_minus_b2, __fmul_rn(gk, gk)),
                             __fmul_rn(a.b2, v0));
  const float phi = __fmul_rn(m1, h.bc1);
  const float psi = __fadd_rn(__fsqrt_rn(__fmul_rn(v1, h.bc2)), a.eps);
  const float psi_safe = (psi < FLT_MIN) ? FLT_MIN : psi;  // keeps NaN
  const float al = a.alpha[k];
  const float v = __fsub_rn(s, __fmul_rn(al, __fdiv_rn(phi, psi_safe)));
  const float stp = __fdiv_rn(al, psi_safe);
  if (valid) {
    store(a.M_out, gi, m1);
    store(a.V_out, gi, v1);
    if constexpr (MODE == kAdaPre) {
      a.pre[gi] = v;
      a.pre_step[gi] = stp;
    }
  }
  return make_float2(v, stp);
}

// K2's old moments of components ka .. kz - 1 of column n from global
// memory, eight components' loads in flight at once, ahead of the stores
// that would otherwise hold each next load back; update(k, m0, v0) in
// order of k.
template <typename MT, typename Update>
__device__ __forceinline__ void moments_by_eight(const MT* M, const MT* V,
                                                 long long N, long long n,
                                                 int ka, int kz, bool valid,
                                                 Update&& update) {
  for (int k0 = ka; k0 < kz; k0 += 8) {
    float m8[8], v8[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m8[j] = v8[j] = 0.f;
      if (valid && k0 + j < kz) {
        m8[j] = to_f32(M[(long long)(k0 + j) * N + n]);
        v8[j] = to_f32(V[(long long)(k0 + j) * N + n]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (k0 + j < kz) update(k0 + j, m8[j], v8[j]);
  }
}

// S' of components ka .. kz - 1 of column n from the column x (pitch xp):
// stored where `valid` (into a.out, where given), the stored values kept in
// x for the Gram or the row sums, and |S' - S|^2, |S'|^2 added into st1,
// st2 (s_of(k): the old S).
template <typename ST, typename MT, typename SOf>
__device__ __forceinline__ void store_column(const Args<ST, MT>& a,
                                             float* x, int xp, int ka,
                                             int kz, bool valid, long long n,
                                             SOf&& s_of, float& st1,
                                             float& st2) {
#pragma unroll 4
  for (int k = ka; k < kz; ++k) {
    float xs = 0.f;
    if (valid) {
      xs = x[k * xp];
      if (a.out != nullptr) xs = store(a.out, (long long)k * a.N + n, xs);
      const float dk = xs - s_of(k);
      st1 = fmaf(dk, dk, st1);
      st2 = fmaf(xs, xs, st2);
    }
    x[k * xp] = xs;
  }
}

// K2's row sums: thread t's part rs into pb[t], then thread k < K adds row
// k's kRowParts parts in order into out[k].
template <int kRowParts>
__device__ __forceinline__ void row_sums(float* pb, float rs, int K,
                                         float* out) {
  const int tid = threadIdx.x;
  pb[tid] = rs;
  __syncthreads();
  if (tid < K) {
    float v = pb[tid * kRowParts];
#pragma unroll
    for (int p = 1; p < kRowParts; ++p) v += pb[tid * kRowParts + p];
    out[tid] = v;
  }
}

// The block's sums of the threads' statistics st0 (the loss), st1, st2
// (|S' - S|^2, |S'|^2): each warp's by shuffles, then the warps' in order;
// thread i < 3 stores its sum at out[i - first] where first <= i < first +
// n. red: kWarps x 3 floats of shared memory.
__device__ __forceinline__ void block_stats(float st0, float st1, float st2,
                                            float (*red)[3], float* out,
                                            int first, int n) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float sv[3] = {st0, st1, st2};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float v = sv[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][i] = v;
  }
  __syncthreads();
  if (tid < 3) {
    float v = red[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[w][tid];
    const int i = tid - first;
    if (tid >= first && i < n) out[i] = v;
  }
}

// VW: the very-wide instances (vwide_pass.cuh: C > 256, K <= 32), the same
// pass with A streamed a chunk ahead through two buffers and gA's tiles in
// shared memory (Smem::ga); every per-column order is the one above.
template <int KB, typename ST, typename MT, int MODE, bool VW = false>
__device__ __forceinline__ void body(const Args<ST, MT>& a,
                                     unsigned char* smem) {
  constexpr bool kF32 = std::is_same<ST, float>::value;
  constexpr bool kRes = has_residual(MODE);
  constexpr int PS = raw_pitch<ST>();
  constexpr int PF = kPitchF;
  constexpr int AP = KB + 4;
  constexpr int MB = KB / 4;
  constexpr int ss = sizeof(ST);
  // The residual's instances built for two blocks per SM fit 128 registers
  // (no spill): W is loaded where it is used, not pinned ahead of the
  // chunk's wait, and (c)'s column loop and K2's update are not unrolled.
  // The other block hides those loads.
  constexpr bool kLean = kRes && blocks_per_sm(KB, MODE, VW) == 2;
  constexpr bool kWAtUse = kLean;
  constexpr int kPairUnroll = kLean ? 1 : 2;
  constexpr int kUpdateUnroll = kLean ? 1 : 4;  // K2's update over k
  // (c)'s maps: gA's (channel, component) block of a chunk, 8 x 4 tiles;
  // the Gram's (component, component) block, 8 x 4 tiles (4 x 2 at KB = 8)
  using GA = PairMap<kChunk, KB, 8, 4>;
  using GR = PairMap<KB, KB, (KB >= 16 ? 8 : 4), (KB >= 16 ? 4 : 2)>;
  __shared__ __align__(8) uint64_t full[2];   // the chunk ring's stages
  __shared__ __align__(8) uint64_t sfull[2];  // the S buffers
  __shared__ __align__(8) uint64_t mvfull;    // K2's M and V
  __shared__ float red[kWarps][3];

  const int C = a.C, K = a.K;
  const long long N = a.N;
  const bool weighted = kRes && a.W != nullptr;
  const Smem L = smem_layout<KB, ST, MT, VW>(MODE, C);
  float* const Ares = reinterpret_cast<float*>(smem + L.a_res);
  float* const Af = reinterpret_cast<float*>(smem + L.a_f);
  unsigned char* const ring = smem + L.ring;
  float* const parts = reinterpret_cast<float*>(smem + L.part);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the group's columns [lo, hi): its units, consecutive
  const long long G = group_units(a.n_units, L.blocks);
  const long long u0 = (long long)blockIdx.x * G;
  const long long u1 = lmin(u0 + G, a.n_units) - 1;
  long long lo, hi, skip;
  unit_span(u0, N, a.tile_n, lo, skip);
  unit_span(u1, N, a.tile_n, skip, hi);
  const int n_sub = (int)((hi - lo + kSub - 1) / kSub);
  const int nch = kRes ? (C + kChunk - 1) / kChunk : 0;
  const int n_q = n_sub * nch;

  // VW: the thread's elements tid + kThreads m of A's block of chunk ch
  // (its kChunk rows by KB components), loaded, and put into buffer b
  constexpr int kAPer = kChunk * KB / kThreads;
  auto a_of = [&](int ch, int m) {
    const int i = tid + kThreads * m;
    const int c = ch * kChunk + i / KB, k = i % KB;
    return (c < C && k < K) ? ld_now(a.A + (long long)c * K + k) : 0.f;
  };
  auto put_a = [&](int b, int m, float v) {
    const int i = tid + kThreads * m;
    const int at = (b * kChunk + i / KB) * AP + i % KB;
    Af[at] = v;
    if constexpr (!kF32) Ares[at] = __bfloat162float(__float2bfloat16_rn(v));
  };
  if constexpr (kRes && VW) {
    // chunk 0's block into buffer 0; the group's row of gA's chunks past
    // the tiles zeroed, gA's tiles in shared memory zeroed (a thread's own
    // entries: no other thread reads them)
    if (nch > 0) {
#pragma unroll
      for (int m = 0; m < kAPer; ++m) put_a(0, m, a_of(0, m));
    }
    float* const gsm = reinterpret_cast<float*>(smem + L.ga);
    for (int i = 0; i < L.ga_chunks * GA::kPerThread; ++i)
      gsm[i * kThreads + tid] = 0.f;
    float* const row0 =
        a.partials + (long long)blockIdx.x * entries(MODE, C, K).total;
    for (int ch = L.ga_chunks; ch < nch; ++ch)
#pragma unroll
      for (int m = 0; m < GA::kPerThread; ++m) {
        const int i = tid + kThreads * m;
        const int c = ch * kChunk + i / KB, k = i % KB;
        if (c < C && k < K) row0[c * K + k] = 0.f;
      }
  } else if constexpr (kRes) {
    for (int i = tid; i < nch * kChunk * KB; i += kThreads) {
      const int c = i / KB, k = i % KB;
      const float v = (c < C && k < K) ? a.A[c * K + k] : 0.f;
      Af[c * AP + k] = v;
      if constexpr (!kF32)
        Ares[c * AP + k] = __bfloat162float(__float2bfloat16_rn(v));
    }
  }
  // components past K add zeros: no copy or thread writes those rows
  for (int b = 0; b < L.n_s; ++b) {
    ST* Sb = reinterpret_cast<ST*>(smem + L.s + b * L.s_bytes);
    for (int i = tid; i < (KB - K) * kSub; i += kThreads)
      zero(Sb[(K + i / kSub) * PS + i % kSub]);
  }
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&sfull[i], 1);
    }
    mbar_init(&mvfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the rows S, Y (pass 2: P) go by bulk copies where they are aligned
  constexpr int ps = kRes ? ss : 4;  // P is float32
  const bool base_aligned =
      ((reinterpret_cast<unsigned long long>(a.S) |
        (kRes ? reinterpret_cast<unsigned long long>(a.Y)
              : reinterpret_cast<unsigned long long>(a.P)) |
        (unsigned long long)(N * ss) | (unsigned long long)(N * ps)) &
       15ull) == 0;
  // W's rows are read with 16-byte (8-byte) loads where they are aligned
  const bool w_vec =
      weighted && ((reinterpret_cast<unsigned long long>(a.W) |
                    (unsigned long long)(N * ss) |
                    (unsigned long long)(lo * ss)) & (4 * ss - 1)) == 0;
  auto bulk_ok = [&](long long c0, int width) {
    return base_aligned && (((unsigned long long)(c0 * ss) |
                             (unsigned long long)(width * ss) |
                             (unsigned long long)(c0 * ps) |
                             (unsigned long long)(width * ps)) & 15ull) == 0;
  };
  auto sub_cols = [&](int t, long long& c0) {
    c0 = lo + (long long)t * kSub;
    return (int)lmin(kSub, hi - c0);
  };
  auto s_buf = [&](int t) { return L.n_s == 2 ? (t & 1) : 0; };

  // S (pass 2: and P) of sub-tile t into its buffers; every thread calls
  // it.
  auto fill_s = [&](int t) {
    long long c0;
    const int width = sub_cols(t, c0);
    const int b = s_buf(t);
    ST* dst = reinterpret_cast<ST*>(smem + L.s + b * L.s_bytes);
    float* dp = reinterpret_cast<float*>(smem + L.p + b * L.s_bytes);
    if (bulk_ok(c0, width)) {
      bulk_rows(&sfull[b], (uint32_t)(K * width * (kRes ? ss : ss + 4)), K,
                [&](int k) {
                  bulk_load(dst + k * PS, a.S + k * N + c0, width * ss,
                            &sfull[b]);
                  if constexpr (!kRes)
                    bulk_load(dp + k * PF, a.P + k * N + c0, width * 4,
                              &sfull[b]);
                });
      return;
    }
    for (int k = warp; k < K; k += kWarps)
      for (int n = lane; n < width; n += 32) {
        dst[k * PS + n] = a.S[k * N + c0 + n];
        if constexpr (!kRes) dp[k * PF + n] = a.P[k * N + c0 + n];
      }
    __syncthreads();
    if (tid == 0) mbar_arrive(&sfull[b]);
  };
  // Y of chunk q = (sub-tile, channel chunk) into stage q & 1; every
  // thread calls it.
  auto fill_y = [&](int q) {
    const int t = q / nch, ch = q - t * nch;
    long long c0;
    const int width = sub_cols(t, c0);
    const int r0 = ch * kChunk;
    fill_rows<PS>(reinterpret_cast<ST*>(ring + (q & 1) * L.stage), a.Y, N,
                  r0, min(kChunk, C - r0), c0, width, bulk_ok(c0, width),
                  &full[q & 1]);
  };

  // K2's M and V of sub-tile t into their buffers; every thread calls it.
  constexpr int ms = sizeof(MT), PM = raw_pitch<MT>();
  MT* const Mb = reinterpret_cast<MT*>(smem + L.mv);
  MT* const Vb = reinterpret_cast<MT*>(smem + L.mv + L.mv_bytes);
  const bool mv_aligned =
      ((reinterpret_cast<unsigned long long>(a.M) |
        reinterpret_cast<unsigned long long>(a.V) |
        (unsigned long long)(N * ms)) & 15ull) == 0;
  auto fill_mv = [&](int t) {
    long long c0;
    const int width = sub_cols(t, c0);
    uint64_t* bar = &mvfull;
    if (mv_aligned && (((unsigned long long)(c0 * ms) |
                        (unsigned long long)(width * ms)) & 15ull) == 0) {
      bulk_rows(bar, (uint32_t)(2 * K * width * ms), K, [&](int k) {
        bulk_load(Mb + k * PM, a.M + k * N + c0, width * ms, bar);
        bulk_load(Vb + k * PM, a.V + k * N + c0, width * ms, bar);
      });
      return;
    }
    for (int k = warp; k < K; k += kWarps)
      for (int n = lane; n < width; n += 32) {
        Mb[k * PM + n] = a.M[k * N + c0 + n];
        Vb[k * PM + n] = a.V[k * N + c0 + n];
      }
    __syncthreads();
    if (tid == 0) mbar_arrive(bar);
  };

  fill_s(0);
  if (L.n_s == 2 && n_sub > 1) fill_s(1);
  if (L.mv_bytes) fill_mv(0);
  if (n_q > 0) fill_y(0);
  if (n_q > 1) fill_y(1);

  // the thread's tiles in (a) and (b): columns ncol .. ncol + 3; channel
  // rows rg + 4 i of the chunk; components kb0 .. kb0 + MB - 1
  const int rg = lane >> 3, cg = lane & 7;
  const int ncol = warp * 32 + cg * 4;
  const int kb0 = rg * MB;
  // the row-sum threads: component rk, the columns 4 rp + 4 kRowParts j ..
  // (a quarter-warp's float4s side by side)
  constexpr int kRowParts = kThreads / KB;
  constexpr int kRowLen = kSub / kRowParts;
  const int rk = tid / kRowParts, rp = tid % kRowParts;

  // gA of every chunk in registers (VW: in shared memory, Smem::ga)
  constexpr int kGaChunks = VW ? 1 : kMaxChunks;
  float ga[kGaChunks][GA::kPerThread];
#pragma unroll
  for (int c = 0; c < kGaChunks; ++c)
#pragma unroll
    for (int m = 0; m < GA::kPerThread; ++m) ga[c][m] = 0.f;
  float gr[GR::kPerThread];
#pragma unroll
  for (int m = 0; m < GR::kPerThread; ++m) gr[m] = 0.f;
  float rs = 0.f;
  float st0 = 0.f, st1 = 0.f, st2 = 0.f;

  for (int t = 0; t < n_sub; ++t) {
    long long c0;
    const int width = sub_cols(t, c0);
    const int sb = s_buf(t);
    ST* const Sr = reinterpret_cast<ST*>(smem + L.s + sb * L.s_bytes);
    mbar_wait(&sfull[sb], (uint32_t)((L.n_s == 2 ? t >> 1 : t) & 1));
    if (width < kSub) {
      // columns past the group's end add zeros
      for (int i = tid; i < K * kSub; i += kThreads) {
        const int k = i / kSub, n = i % kSub;
        if (n >= width) zero(Sr[k * PS + n]);
      }
      __syncthreads();
    }

    float gs[MB][4];
#pragma unroll
    for (int i = 0; i < MB; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) gs[i][j] = 0.f;

    if constexpr (kRes) {
      const int wn = min(4, width - ncol);  // the thread's columns left
      for (int ch = 0; ch < nch; ++ch) {
        const int q = t * nch + ch;
        const int rows = min(kChunk, C - ch * kChunk);
        // A's rows of the chunk: VW its buffer, q & 1
        const int arow = VW ? (q & 1) * kChunk : ch * kChunk;
        // VW: the next chunk's block of A, in flight through the residual
        float an[kAPer];
        if constexpr (VW) {
          if (q + 1 < n_q) {
            const int cn = ch + 1 == nch ? 0 : ch + 1;
#pragma unroll
            for (int m = 0; m < kAPer; ++m) an[m] = a_of(cn, m);
          }
        }
        unsigned char* st = ring + (q & 1) * L.stage;
        const ST* Ys = reinterpret_cast<const ST*>(st);
        float* const D = kF32 ? reinterpret_cast<float*>(st)
                              : reinterpret_cast<float*>(smem + L.d);
        // (a) W of the thread's row rg + 4 i, from global memory: in
        // flight while the residual runs, or (kWAtUse) where it is used
        auto w_of = [&](int i) {
          const int c = rg + 4 * i;
          const ST* p = a.W + (long long)(ch * kChunk + c) * N + c0 + ncol;
          return (c >= rows || wn <= 0)
                     ? make_float4(0.f, 0.f, 0.f, 0.f)
                     : (w_vec && wn == 4 ? ld4_now(p) : ld4_part(p, wn));
        };
        float4 wv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) wv[i] = make_float4(1.f, 1.f, 1.f, 1.f);
        if (!kWAtUse && weighted) {
#pragma unroll
          for (int i = 0; i < 8; ++i) wv[i] = w_of(i);
        }
        mbar_wait(&full[q & 1], (uint32_t)((q >> 1) & 1));
        // the residual, 8 rows rg + 4 i by 4 columns: in a chunk of at
        // most 24 channels only the 8-row blocks that hold channels
        float r[8][4];
        if (rows == kChunk) {
          residual_tile<8, KB, ST>(r, Ares + (arow + rg) * AP, Sr + ncol);
        } else {
#pragma unroll
          for (int i0 = 0; i0 < 8; i0 += 2)
            if (4 * i0 < rows)
              residual_tile<2, KB, ST>(
                  reinterpret_cast<float(&)[2][4]>(r[i0]),
                  Ares + (arow + rg + 4 * i0) * AP, Sr + ncol);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (4 * (i & ~1) >= rows) continue;  // a block past the channels
          const int c = rg + 4 * i;
          const float4 yv = ld4(Ys + c * PS + ncol);
          const float y4[4] = {yv.x, yv.y, yv.z, yv.w};
          if (kWAtUse && weighted) wv[i] = w_of(i);
          const float w4[4] = {wv[i].x, wv[i].y, wv[i].z, wv[i].w};
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
        // VW: the next chunk's A into the other buffer (its last reader,
        // chunk q - 1's (b), is behind the last barrier)
        if constexpr (VW) {
          if (q + 1 < n_q) {
#pragma unroll
            for (int m = 0; m < kAPer; ++m) put_a((q + 1) & 1, m, an[m]);
          }
        }
        __syncthreads();  // D of the chunk is in shared memory
        // (b) gS over the chunk's channels in order
        grad_tile<KB>(gs, Af + arow * AP + kb0, D + ncol, (rows + 3) & ~3);
        // (c) gA of the chunk over the thread's part of the columns
        const GA pa(tid);
        if (pa.r1 < rows) {
          float acc[GA::kT1][GA::kT2];
#pragma unroll
          for (int i = 0; i < GA::kT1; ++i)
#pragma unroll
            for (int j = 0; j < GA::kT2; ++j) acc[i][j] = 0.f;
          pair_tile<kPairUnroll>(acc, pa, D, PF, Sr, PS);
          put_parts(parts, pa, acc);
        }
        __syncthreads();  // D is read, the parts' sums are in
        {
          float sum[GA::kPerThread];
#pragma unroll
          for (int m = 0; m < GA::kPerThread; ++m) sum[m] = 0.f;
          add_parts<GA>(parts, sum);
          if constexpr (VW) {
            // into the group's tile of the chunk (a thread's own entries),
            // or past the tiles into the group's row
            if (ch < L.ga_chunks) {
              float* const g = reinterpret_cast<float*>(smem + L.ga) +
                               ch * GA::kPerThread * kThreads + tid;
#pragma unroll
              for (int m = 0; m < GA::kPerThread; ++m)
                g[m * kThreads] += sum[m];
            } else {
              float* const row0 =
                  a.partials +
                  (long long)blockIdx.x * entries(MODE, C, K).total;
#pragma unroll
              for (int m = 0; m < GA::kPerThread; ++m) {
                const int i = tid + kThreads * m;
                const int c = ch * kChunk + i / KB, k = i % KB;
                if (c < C && k < K) row0[c * K + k] += sum[m];
              }
            }
          } else {
#pragma unroll
            for (int c = 0; c < kMaxChunks; ++c)
              if (c == ch)
#pragma unroll
                for (int m = 0; m < GA::kPerThread; ++m) ga[c][m] += sum[m];
          }
        }
        // in float32 the last chunk's stage takes gS for the epilogue: it
        // is refilled after it
        if (q + 2 < n_q && !(kF32 && ch == nch - 1)) fill_y(q + 2);
      }
    }

    // the Gram: of the old S in K3 (now), of S' in K1 (after the epilogue)
    auto gram = [&](const auto* x, int xp) {
      float acc[GR::kT1][GR::kT2];
#pragma unroll
      for (int i = 0; i < GR::kT1; ++i)
#pragma unroll
        for (int j = 0; j < GR::kT2; ++j) acc[i][j] = 0.f;
      const GR pg(tid);
      if (pg.r1 < K) pair_tile<kPairUnroll>(acc, pg, x, xp, x, xp);
      __syncthreads();  // the parts' buffer is free
      if (pg.r1 < K) put_parts(parts, pg, acc);
      __syncthreads();
      add_parts<GR>(parts, gr);
    };
    if constexpr (MODE == kGrad) gram(Sr, PS);

    // the epilogue, one column per thread: gS back from shared memory, in
    // the last chunk's D (pass 2: its own buffer), where S' then goes
    float* const Gs =
        kRes && kF32
            ? reinterpret_cast<float*>(ring + ((t * nch + nch - 1) & 1) *
                                                  L.stage)
            : reinterpret_cast<float*>(smem + L.d);
    const bool valid = tid < width;
    const long long n = c0 + tid;
    auto s_of = [&](int k) { return to_f32(Sr[k * PS + tid]); };
    if constexpr (kRes) {
#pragma unroll
      for (int i = 0; i < MB; ++i)
        *reinterpret_cast<float4*>(Gs + (kb0 + i) * PF + ncol) =
            make_float4(gs[i][0], gs[i][1], gs[i][2], gs[i][3]);
      __syncthreads();
    }
    // loops over k unrolled by four: the epilogue's code stays small
    float* const x = Gs + tid;  // the column, pitch PF: gS, x, then S'
    if constexpr (MODE == kGrad) {
      if (valid) {
#pragma unroll 4
        for (int k = 0; k < K; ++k) a.out[k * N + n] = x[k * PF];
      }
    } else if constexpr (MODE == kPgm || MODE == kPgmPre) {
      // the step on the card, read here (not held through the main loop)
      const float sS = *a.step_S;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float v = s_of(k) - sS * x[k * PF];
        if constexpr (MODE == kPgmPre) {
          if (valid) a.pre[k * N + n] = v;
        } else {
          x[k * PF] = v;
        }
      }
      if constexpr (MODE == kPgm) {
        // K1's chain in registers (measured faster than on the column)
        float g[KB];
#pragma unroll
        for (int k = 0; k < KB; ++k) g[k] = k < K ? x[k * PF] : 0.f;
        apply_chain<KB>(a.chain, g, K, [&](int) { return sS; });
#pragma unroll
        for (int k = 0; k < KB; ++k)
          if (k < K) x[k * PF] = g[k];
      }
    } else if constexpr (MODE == kAda || MODE == kAdaPre) {
      // the schedule, read here (not held through the main loop)
      const AdaSchedule h = ada_schedule(a);
      // the per-element step alpha_k / Psi_safe beside the column, in the
      // parts' buffer (free until the next chunk)
      float* const step = parts + tid;
      if (L.mv_bytes) mbar_wait(&mvfull, (uint32_t)(t & 1));
      // the update of component k from its old moments
      auto update = [&](int k, float m0, float v0) {
        const float2 r = ada_update<MODE>(a, h, k * N + n, k, x[k * PF],
                                          s_of(k), m0, v0, valid);
        x[k * PF] = r.x;
        step[k * kSub] = r.y;
      };
      constexpr bool kBatch = VW && std::is_same<MT, float>::value;
      if (kBatch && L.mv_bytes == 0) {
        // float32 M and V from global memory (at KB = 32 they do not fit
        // beside gA's tiles), batched (measured slower with bfloat16
        // moments, which keep the loop below)
        moments_by_eight(a.M, a.V, N, n, 0, K, valid, update);
      } else {
#pragma unroll(kUpdateUnroll)
        for (int k = 0; k < K; ++k) {
          const long long gi = k * N + n;
          float m0 = 0.f, v0 = 0.f;
          if (valid) {
            m0 = to_f32(L.mv_bytes ? Mb[k * PM + tid] : a.M[gi]);
            v0 = to_f32(L.mv_bytes ? Vb[k * PM + tid] : a.V[gi]);
          }
          const float2 r = ada_update<MODE>(a, h, gi, k, x[k * PF], s_of(k),
                                            m0, v0, valid);
          x[k * PF] = r.x;
          step[k * kSub] = r.y;
        }
      }
      if constexpr (MODE == kAda)
        apply_chain_column(a.chain, x, PF, K,
                           [&](int k) { return step[k * kSub]; });
    } else {  // kPgmPost, kAdaPost: x is the prox's output
      const float* Pb =
          reinterpret_cast<const float*>(smem + L.p + sb * L.s_bytes) + tid;
#pragma unroll 4
      for (int k = 0; k < K; ++k) x[k * PF] = valid ? Pb[k * PF] : 0.f;
    }
    if constexpr (has_update(MODE)) {
      // store S' and keep the stored values for the sums
      store_column(a, x, PF, 0, K, valid, n, s_of, st1, st2);
      __syncthreads();  // S' is in shared memory
      if constexpr (has_gram(MODE)) {
        gram(Gs, PF);
      } else {
        const float* x = Gs + rk * PF + 4 * rp;
#pragma unroll
        for (int j = 0; j < kRowLen; j += 4) {
          const float4 v = ld4(x + kRowParts * j);
          rs += v.x;
          rs += v.y;
          rs += v.z;
          rs += v.w;
        }
      }
    }
    __syncthreads();  // the S buffer and the last chunk's stage are free
    if constexpr (kRes && kF32) {
      const int q = t * nch + nch - 1;
      if (q + 2 < n_q) fill_y(q + 2);
    }
    if (t + L.n_s < n_sub) fill_s(t + L.n_s);
    if (L.mv_bytes && t + 1 < n_sub) fill_mv(t + 1);
  }

  // the group's row of partial sums
  const Entries e = entries(MODE, C, K);
  float* const row = a.partials + (long long)blockIdx.x * e.total;
  if constexpr (kRes && VW) {
    const float* const gsm = reinterpret_cast<const float*>(smem + L.ga);
    for (int ch = 0; ch < L.ga_chunks; ++ch)
#pragma unroll
      for (int m = 0; m < GA::kPerThread; ++m) {
        const int i = tid + kThreads * m;
        const int c = ch * kChunk + i / KB, k = i % KB;
        if (c < C && k < K)
          row[c * K + k] = gsm[(ch * GA::kPerThread + m) * kThreads + tid];
      }
  } else if constexpr (kRes) {
    for (int ch = 0; ch < nch; ++ch) {
      float v[GA::kPerThread];
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c)
        if (c == ch)
#pragma unroll
          for (int m = 0; m < GA::kPerThread; ++m) v[m] = ga[c][m];
#pragma unroll
      for (int m = 0; m < GA::kPerThread; ++m) {
        const int i = tid + kThreads * m;
        const int c = ch * kChunk + i / KB, k = i % KB;
        if (c < C && k < K) row[c * K + k] = v[m];
      }
    }
  }
  if constexpr (has_gram(MODE)) {
#pragma unroll
    for (int m = 0; m < GR::kPerThread; ++m) {
      const int i = tid + kThreads * m, r = i / KB, k = i % KB;
      if (i < KB * KB && r < K && k < K) row[e.ga + r * K + k] = gr[m];
    }
  }
  // (the parts' buffer is free after the last barrier)
  if constexpr (has_rowsum(MODE))
    row_sums<kRowParts>(parts, rs, K, row + e.ga);
  // [loss] from st0, [|S' - S|^2, |S'|^2] from st1, st2
  block_stats(st0, st1, st2, red, row + e.ga + e.mid,
              has_residual(MODE) ? 0 : 1, e.stats);
}

// The second launch: a block per 32 entries; warp w sums the group rows w,
// w + 8, ... of its lane's entry in order in double, then the warps' sums
// are added in order and rounded once: gA (C K), mid (the Gram K K or the
// row sums K), stats (the loss halved when `half_first`).
__device__ __forceinline__ void finalize(const float* partials,
                                         long long rows, Entries e,
                                         bool half_first, float* gA,
                                         float* mid, float* stats) {
  constexpr int kW = kFinThreads / 32;
  __shared__ double part[kW][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int p = blockIdx.x * 32 + lane;
  double v = 0.0;
  if (p < e.total)
    for (long long r = w; r < rows; r += kW)
      v += (double)partials[r * e.total + p];
  part[w][lane] = v;
  __syncthreads();
  if (w != 0 || p >= e.total) return;
#pragma unroll
  for (int i = 1; i < kW; ++i) v += part[i][lane];
  if (p < e.ga) {
    gA[p] = (float)v;
  } else if (p < e.ga + e.mid) {
    mid[p - e.ga] = (float)v;
  } else {
    const int i = p - e.ga - e.mid;
    stats[i] = (float)(i == 0 && half_first ? 0.5 * v : v);
  }
}

// Per kernel instance: the dynamic shared memory it is allowed (raised
// before the first launch that needs more than 48 KB).
struct LaunchCache {
  int allowed_smem = 0;
};

// Both launches of one pass on `stream`: a block per group of units, then
// the finalize. Returns cudaGetLastError() after them.
// VW: a very-wide instance, for any C (as the second passes, which read no
// A).
template <int KB, typename ST, typename MT, int MODE, bool VW = false,
          typename Kernel, typename Finalize>
int launch(Kernel kernel, Finalize fin, LaunchCache& lc,
           const Args<ST, MT>& args, float* gA, float* mid, float* stats,
           cudaStream_t stream) {
  cudaError_t err;
  if (args.C < 1 || (!VW && has_residual(MODE) && args.C > kMaxC) ||
      args.K < 1 || args.K > KB || args.N < 1 || args.tile_n < 1)
    return (int)cudaErrorInvalidValue;
  const Smem L = smem_layout<KB, ST, MT, VW>(MODE, args.C);
  if (L.total > kSmemMax) return (int)cudaErrorInvalidValue;
  if (L.total > lc.allowed_smem) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return (int)err;
    lc.allowed_smem = L.total;
  }
  const long long groups = group_count(args.n_units, L.blocks);
  kernel<<<(unsigned)groups, kThreads, L.total, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Entries e = entries(MODE, args.C, args.K);
  fin<<<(e.total + 31) / 32, kFinThreads, 0, stream>>>(
      args.partials, groups, e, has_residual(MODE), gA, mid, stats);
  return (int)cudaGetLastError();
}

}  // namespace wide
}  // namespace
