// The very-wide tier of K1 (nmf_pgm_wide.cu), K2 (nmf_adaprox_wide.cu) and
// K3 (nmf_grad.cu): the same passes as wide_pass.cuh for the problems its
// instances refuse, C > 256 channels or K > 32 components, with no upper
// limit on either.
//
// Why wide_pass.cuh stops at C = 256, K = 32: each thread keeps gA for
// every 32-channel chunk in registers for the whole group (8 chunks at
// most), A lives in shared memory whole (C (KB + 4) floats), the S buffers
// and gS hold KB rows, and the instances are KB = 8, 16, 32.
//
// Up to K = 32 (any C) the tier runs the wide body's own instances built
// with VW (wide::body<KB, ..., true>; KB = 8, 16, 32 as the wide body picks
// them): the ring of Y stages and the S buffers by bulk copies completing
// on mbarriers, gS in registers and the epilogue's column in the last
// chunk's stage, as there; A a chunk at a time through two buffers (the
// next chunk's block loaded during the residual, stored after it), and gA's
// (chunk) tiles of the whole group in shared memory, added to in the same
// sub-tile order and written to the group's row once (the chunks past what
// fits, past 13 chunks at KB = 32 in float32, in the row in global memory).
// One block per SM, up to 255 registers.
//
// Past K = 32, the passes with a residual run kwide_pass.cuh's body up to
// K = 256 (S, gS, gA's tiles and the epilogue's column on chip), and K1's
// and K3's panel_pass.cuh's up to K = 512 (the reductions over the pixel
// axis as products of their own). Beyond, K2's past K = 256 and every
// kernel's past K = 512 run this body (the second passes of the split path
// past K = 32 run post_pass.cuh's); nothing in it grows with C or K:
//
// - Components go in blocks of 32 (nkb = ceil(K / 32)), channels in chunks
//   of 32, columns in sub-tiles of 256 as in the wide body. Per chunk the
//   block runs 2 nkb steps: nkb residual steps, each adding one component
//   block to R = A S over the chunk's rows, so that the exact-f32 chain
//   A[c,0] s[0] + A[c,1] s[1] + ... runs over k in order across the blocks
//   (the TPU kernel's "fma" path, the wide body's order); then, with
//   D = W (R - Y) in shared memory, nkb gradient steps, each adding the
//   chunk's channels to gS of one component block (b) and forming gA's
//   (chunk, block) tile (c) with the register tiles of wide_pass.cuh.
// - A step reads the S rows of its component block and the A block (chunk,
//   component block, 32 x 32) from one of two slots; while a step runs,
//   the next step's slot is filled: S by cp.async (16-byte copies, the
//   sub-tile's columns past its end zero-filled; element copies where rows
//   are not 16-byte aligned), A through registers. A slot keeps the S
//   block it holds, so with nkb <= 2 each S block is copied once per
//   sub-tile; beyond, S blocks are copied again per step. The next chunk's
//   Y rows come by cp.async into the second of two stages, two steps ahead
//   (cp.async groups: the last step of a chunk waits for all but them).
// - gS of a column over all K is added per step into a per-group scratch
//   of KP x 256 floats in global memory (it stays in L2) in the same order
//   (fmaf from 0 over the channels in order, a thread per column). The
//   epilogue runs on that scratch column, one column per thread, with any
//   K: K3 stores gS; K1 forms x = s - sS gS and applies the compiled chain
//   on the column; K2 the moments and the chain with the per-element step
//   (kept beside the column in a second scratch of KP x 256 floats); split
//   pass 1 stores x (K2: and the step).
// - gA, the Gram ((K / 32)^2 blocks of the 32 x 32 routine, of S' in K1 and
//   of the old S in K3, both read from the column store) and K2's row sums
//   are added, sub-tile by sub-tile in a fixed order, into the group's row
//   of partial sums in global memory (C K + K K floats; every entry owned
//   by one thread), which the wide body's finalize sums in double in a
//   fixed order. No atomics: two launches give the same bits, and the
//   order depends on N, tile_n, C, K and the instance alone.
// - One block of 8 warps per SM (up to 255 registers a thread), 176 KB of shared memory in float32 (S slots 2 x 37 KB, Y
//   stages 2 x 33 KB, the (c) routine's partial sums 33 KB), 153 KB with
//   the bfloat16 store.
//
// What bounds the tier on an H100: at C = 425, K = 32, N = 1e6 the float32
// FMAs, 3 C K + K (K + 1) / 2 per column, 41.3e9 at 33.5e12 FMA/s, 1.23
// ms, against (C + 2K) N 4 bytes, 1.96 GB unweighted, 0.58 ms at 3.35
// TB/s; in practice, as in the wide body, the shared memory's delivery of
// the register tiles' operands (3 floats loaded per 8 FMAs). Every product
// is a float32 FMA chain in the orders above: no tensor cores, since TF32
// would round the residual's operands.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tiers.cuh"
#include "wide_pass.cuh"

namespace {
namespace vwide {

using wide::Args;
using wide::cp_async16;
using wide::cp_async_commit;
using wide::cp_async_wait;
using wide::kChunk;
using wide::kPartFloats;
using wide::kPitchF;
using wide::kSub;
using wide::kThreads;
using wide::kWarps;

constexpr int kKB = 32;            // components per block
constexpr int kAP = kKB + 4;       // pitch of an A block's rows (floats)
constexpr int kScratchAlign = 64;  // floats: the scratch 256-byte aligned

__host__ __device__ inline int blocks_of(int K) { return (K + kKB - 1) / kKB; }

// Floats of one group's scratch: the column store (KP x kSub), and K2's
// per-element step beside it.
__host__ __device__ inline long long scratch_floats(int mode, int K) {
  return (long long)blocks_of(K) * kKB * kSub * (mode == wide::kAda ? 2 : 1);
}
// Whether a pass goes through the scratch: beyond tier::kKwideK (below,
// kwide_pass.cuh's body runs it, all on chip).
__host__ __device__ inline bool uses_scratch(int K) {
  return K > tier::kKwideK;
}
// Floats a row of the caller's buffer holds: the row of partial sums and,
// where the pass uses it, one group's scratch and the alignment. Allocated
// as (rows, width) with the wide body's rows (group_count(n_units, 2), at
// least the groups here), the rows of partial sums come first, then every
// group's scratch.
__host__ __device__ inline long long width(int mode, int C, int K) {
  return wide::entries(mode, C, K).total +
         (uses_scratch(K) ? scratch_floats(mode, K) + kScratchAlign : 0);
}

// Shared memory, byte offsets from the dynamic base: two slots (S rows of
// a component block, and the A block in float32 and, with the bfloat16
// store, rounded to bfloat16 for the residual), two stages of a chunk's Y
// rows (in float32 D overwrites Y), D with the bfloat16 store, and the (c)
// routine's partial sums.
struct Smem {
  int slot_bytes, s, ares, af;
  int stage, stage_bytes;
  int d, part, total;
};
template <typename ST>
__host__ __device__ inline Smem smem_layout() {
  constexpr bool kF32 = std::is_same<ST, float>::value;
  constexpr int PS = wide::raw_pitch<ST>();
  Smem m{};
  const int s_bytes = kKB * PS * (int)sizeof(ST);
  const int a_bytes = kChunk * kAP * 4;
  m.s = 0;
  m.ares = s_bytes;
  m.af = kF32 ? m.ares : m.ares + a_bytes;
  m.slot_bytes = s_bytes + (kF32 ? 1 : 2) * a_bytes;
  m.stage = 2 * m.slot_bytes;
  m.stage_bytes = kChunk * PS * (int)sizeof(ST);
  m.d = m.stage + 2 * m.stage_bytes;
  m.part = m.d + (kF32 ? 0 : kChunk * kPitchF * 4);
  m.total = m.part + kPartFloats * 4;
  return m;
}

// 32 rows (nrows of them from src, row pitch N; the rest zeros) of the
// columns [c0, c0 + width) into dst (raw_pitch<T>() a row; columns past
// width zeros): 16-byte cp.async copies where `aligned`, else element
// copies. Every thread calls it.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, long long N,
                                          long long c0, int width, int nrows,
                                          bool aligned) {
  constexpr int P = wide::raw_pitch<T>();
  constexpr int E = 16 / (int)sizeof(T);
  constexpr int kPer = kSub / E;
  if (aligned) {
#pragma unroll 4
    for (int i = threadIdx.x; i < 32 * kPer; i += kThreads) {
      const int r = i / kPer, n0 = (i % kPer) * E;
      int bytes = 0;
      const T* s = src;
      if (r < nrows && n0 < width) {
        bytes = min(E, width - n0) * (int)sizeof(T);
        s = src + (long long)r * N + c0 + n0;
      }
      cp_async16(dst + r * P + n0, s, bytes);
    }
    return;
  }
  for (int i = threadIdx.x; i < 32 * kSub; i += kThreads) {
    const int r = i / kSub, n = i % kSub;
    T v;
    if (r < nrows && n < width)
      v = src[(long long)r * N + c0 + n];
    else
      wide::zero(v);
    dst[r * P + n] = v;
  }
}

template <typename ST, typename MT, int MODE>
__device__ __forceinline__ void body(const Args<ST, MT>& a,
                                     unsigned char* smem) {
  constexpr bool kF32 = std::is_same<ST, float>::value;
  constexpr int PS = wide::raw_pitch<ST>();
  constexpr int PF = kPitchF;
  constexpr int MB = kKB / 4;
  constexpr int ss = sizeof(ST);
  // (c)'s maps: gA's (channel, component) tile of a chunk and a component
  // block, and a 32 x 32 block of the Gram; 8 x 4 register tiles
  using GA = wide::PairMap<kChunk, kKB, 8, 4>;
  using GR = wide::PairMap<kKB, kKB, 8, 4>;
  __shared__ float red[kWarps][3];

  const int C = a.C, K = a.K;
  const long long N = a.N;
  const int nkb = blocks_of(K);
  const int KP = nkb * kKB;
  const bool weighted = a.W != nullptr;
  const Smem L = smem_layout<ST>();
  float* const parts = reinterpret_cast<float*>(smem + L.part);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the group's columns [lo, hi): its units, consecutive
  const long long G = wide::group_units(a.n_units, 1);
  const long long u0 = (long long)blockIdx.x * G;
  const long long u1 = wide::lmin(u0 + G, a.n_units) - 1;
  long long lo, hi, skip;
  wide::unit_span(u0, N, a.tile_n, lo, skip);
  wide::unit_span(u1, N, a.tile_n, skip, hi);
  const int n_sub = (int)((hi - lo + kSub - 1) / kSub);
  const int nch = (C + kChunk - 1) / kChunk;

  // the group's row of partial sums, zeroed (every later write adds), and
  // its scratch: the column store X (KP x kSub), K2's step beside it
  const wide::Entries e = wide::entries(MODE, C, K);
  float* const row = a.partials + (long long)blockIdx.x * e.total;
  const long long rows_all =
      wide::group_count(a.n_units, 2) * (long long)e.total;
  float* const X0 =
      a.partials +
      (rows_all + kScratchAlign - 1) / kScratchAlign * kScratchAlign +
      (long long)blockIdx.x * scratch_floats(MODE, K);
  for (int i = tid; i < e.ga + e.mid; i += kThreads) row[i] = 0.f;

  auto sub_cols = [&](int t, long long& c0) {
    c0 = lo + (long long)t * kSub;
    return (int)wide::lmin(kSub, hi - c0);
  };

  // the slots and stages
  auto slot_s = [&](int b) {
    return reinterpret_cast<ST*>(smem + b * L.slot_bytes + L.s);
  };
  auto slot_ares = [&](int b) {
    return reinterpret_cast<float*>(smem + b * L.slot_bytes + L.ares);
  };
  auto slot_af = [&](int b) {
    return reinterpret_cast<float*>(smem + b * L.slot_bytes + L.af);
  };
  auto stage_y = [&](int q) {
    return reinterpret_cast<ST*>(smem + L.stage + (q & 1) * L.stage_bytes);
  };
  // S and Y go by 16-byte copies where every row of the group is aligned
  const bool aligned =
      ((reinterpret_cast<unsigned long long>(a.S) |
        reinterpret_cast<unsigned long long>(a.Y) |
        (unsigned long long)(N * ss) | (unsigned long long)(lo * ss)) &
       15ull) == 0;
  // W's rows are read with 16-byte (8-byte) loads where they are aligned
  const bool w_vec =
      weighted && ((reinterpret_cast<unsigned long long>(a.W) |
                    (unsigned long long)(N * ss) |
                    (unsigned long long)(lo * ss)) & (4 * ss - 1)) == 0;

  // Step j of a chunk: j < nkb the residual of component block j, else the
  // gradients of block j - nkb; slot j & 1 (2 nkb steps a chunk, so the
  // parity runs on across chunks). tag[b]: the S block (t nkb + kb) slot b
  // holds.
  const int steps = 2 * nkb;
  int tag0 = -1, tag1 = -1;
  float areg[kChunk * kKB / kThreads];
  // the S block and (into registers) the A block of step j of chunk ch of
  // sub-tile t, into slot j & 1
  auto fill = [&](int t, int ch, int j) {
    const int b = j & 1, kb = j < nkb ? j : j - nkb;
    const int tg = t * nkb + kb;
    if ((b ? tag1 : tag0) != tg) {
      long long c0;
      const int width = sub_cols(t, c0);
      copy_rows<ST>(slot_s(b), a.S + (long long)kb * kKB * N, N, c0, width,
                    min(kKB, K - kb * kKB), aligned);
      if (b)
        tag1 = tg;
      else
        tag0 = tg;
    }
#pragma unroll
    for (int m = 0; m < kChunk * kKB / kThreads; ++m) {
      const int i = tid + kThreads * m, r = i / kKB, k = i % kKB;
      const int c = ch * kChunk + r, kk = kb * kKB + k;
      areg[m] = (c < C && kk < K) ? a.A[(long long)c * K + kk] : 0.f;
    }
  };
  auto put_a = [&](int j) {
    const int b = j & 1;
    float* const ar = slot_ares(b);
    float* const af = slot_af(b);
#pragma unroll
    for (int m = 0; m < kChunk * kKB / kThreads; ++m) {
      const int i = tid + kThreads * m, r = i / kKB, k = i % kKB;
      af[r * kAP + k] = areg[m];
      if constexpr (!kF32)
        ar[r * kAP + k] = __bfloat162float(__float2bfloat16_rn(areg[m]));
    }
  };
  // Y of chunk q = (sub-tile, channel chunk) into stage q & 1
  auto fill_y = [&](int q) {
    const int t = q / nch, ch = q - t * nch;
    long long c0;
    const int width = sub_cols(t, c0);
    copy_rows<ST>(stage_y(q), a.Y + (long long)ch * kChunk * N, N, c0, width,
                  min(kChunk, C - ch * kChunk), aligned);
  };

  if (n_sub > 0) {
    fill(0, 0, 0);
    fill_y(0);
    cp_async_commit();
    put_a(0);
  }

  // the thread's tiles in (a) and (b): columns ncol .. ncol + 3; channel
  // rows rg + 4 i of the chunk; components kb0 .. kb0 + 7 of a block
  const int rg = lane >> 3, cg = lane & 7;
  const int ncol = warp * 32 + cg * 4;
  const int kb0 = rg * MB;
  // the row-sum threads: component rk of a block, the columns 4 rp + 32 j
  constexpr int kRowParts = kThreads / kKB;
  const int rk = tid / kRowParts, rp = tid % kRowParts;

  float st0 = 0.f, st1 = 0.f, st2 = 0.f;

  for (int t = 0; t < n_sub; ++t) {
    long long c0;
    const int width = sub_cols(t, c0);
    // gS's tile, declared and zeroed per sub-tile: dead in the epilogue
    // (live across sub-tiles it spilled there)
    float gs[MB][4];
#pragma unroll
    for (int i = 0; i < MB; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) gs[i][jj] = 0.f;

    const int wn = min(4, width - ncol);  // the thread's columns left
    for (int ch = 0; ch < nch; ++ch) {
      const int q = t * nch + ch;
      const int rows = min(kChunk, C - ch * kChunk);
      ST* const Ys = stage_y(q);
      float* const D = kF32 ? reinterpret_cast<float*>(Ys)
                            : reinterpret_cast<float*>(smem + L.d);
      float r[8][4];
      for (int j = 0; j < steps; ++j) {
        const int b = j & 1;
        // this step's copies are in (the last step leaves the next
        // chunk's Y in flight), and every thread is done with the last
        // step: its slot and the other stage are free
        if (j == steps - 1)
          cp_async_wait<1>();
        else
          cp_async_wait<0>();
        __syncthreads();
        int nt = t, nc = ch, nj = j + 1;
        if (nj == steps) {
          nj = 0;
          if (++nc == nch) {
            nc = 0;
            ++nt;
          }
        }
        const bool more = nt < n_sub;
        if (more) fill(nt, nc, nj);
        cp_async_commit();
        if (j == steps - 2) {
          if (q + 1 < n_sub * nch) fill_y(q + 1);
          cp_async_commit();
        }
        const ST* const Sb = slot_s(b);
        if (j < nkb) {
          // (a) the residual of component block j over the chunk's rows
          const int kb = j;
          const bool last = kb == nkb - 1;
          const float* const Ab = slot_ares(b);
          // W of the thread's row rg + 4 i, from global memory, in flight
          // while the last block's residual runs
          float4 wv[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            wv[i] = make_float4(1.f, 1.f, 1.f, 1.f);
          if (last && weighted) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int c = rg + 4 * i;
              const ST* p =
                  a.W + (long long)(ch * kChunk + c) * N + c0 + ncol;
              wv[i] = (c >= rows || wn <= 0)
                          ? make_float4(0.f, 0.f, 0.f, 0.f)
                          : (w_vec && wn == 4 ? wide::ld4_now(p)
                                              : wide::ld4_part(p, wn));
            }
          }
          if (rows == kChunk) {
            if (kb == 0)
              wide::residual_steps<true, 8, kKB, ST>(r, Ab + rg * kAP,
                                                     Sb + ncol, 0);
            else
              wide::residual_steps<false, 8, kKB, ST>(r, Ab + rg * kAP,
                                                      Sb + ncol, 0);
#pragma unroll 1
            for (int k = 4; k < kKB; k += 4)
              wide::residual_steps<false, 8, kKB, ST>(r, Ab + rg * kAP,
                                                      Sb + ncol, k);
          } else {
#pragma unroll
            for (int i0 = 0; i0 < 8; i0 += 2) {
              if (4 * i0 >= rows) continue;
              float(&r2)[2][4] = reinterpret_cast<float(&)[2][4]>(r[i0]);
              const float* const a2 = Ab + (rg + 4 * i0) * kAP;
              if (kb == 0)
                wide::residual_steps<true, 2, kKB, ST>(r2, a2, Sb + ncol,
                                                       0);
              else
                wide::residual_steps<false, 2, kKB, ST>(r2, a2, Sb + ncol,
                                                        0);
#pragma unroll 1
              for (int k = 4; k < kKB; k += 4)
                wide::residual_steps<false, 2, kKB, ST>(r2, a2, Sb + ncol,
                                                        k);
            }
          }
          if (last) {
            // D = W (R - Y) (or R - Y) over Y's rows, into D
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              if (4 * (i & ~1) >= rows) continue;
              const int c = rg + 4 * i;
              const float4 yv = wide::ld4(Ys + c * PS + ncol);
              const float y4[4] = {yv.x, yv.y, yv.z, yv.w};
              const float w4[4] = {wv[i].x, wv[i].y, wv[i].z, wv[i].w};
              float d4[4];
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) {
                const float rr = r[i][jj] - y4[jj];
                float d = weighted ? w4[jj] * rr : rr;
                if (c < rows && jj < wn)
                  st0 = fmaf(d, rr, st0);
                else
                  d = 0.f;
                d4[jj] = d;
              }
              *reinterpret_cast<float4*>(D + c * PF + ncol) =
                  make_float4(d4[0], d4[1], d4[2], d4[3]);
            }
          }
        } else {
          const int kb = j - nkb;
          // the row's gA entries of this tile, loaded now and added to
          // after (c)
          float prev[GA::kPerThread];
#pragma unroll
          for (int m = 0; m < GA::kPerThread; ++m) {
            const int i = tid + kThreads * m;
            const int c = ch * kChunk + i / kKB, k = kb * kKB + i % kKB;
            prev[m] = (c < C && k < K) ? row[(long long)c * K + k] : 0.f;
          }
          // (b) gS of component block kb over the chunk's channels in
          // order: from 0 at the first chunk, in registers with one
          // block, else through the scratch column store (this body runs
          // from two blocks on; the one-block branches stay, as taking
          // them out moved ptxas's register allocation and slowed K2's
          // bfloat16 instance at (128, 64) by 14 %)
          float* const xg = X0 + (long long)(kb * kKB + kb0) * kSub + ncol;
          if (ch == 0 && nkb > 1) {
#pragma unroll
            for (int i = 0; i < MB; ++i)
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) gs[i][jj] = 0.f;
          } else if (nkb > 1) {
#pragma unroll
            for (int i = 0; i < MB; ++i) {
              const float4 v = wide::ld4(xg + i * kSub);
              gs[i][0] = v.x;
              gs[i][1] = v.y;
              gs[i][2] = v.z;
              gs[i][3] = v.w;
            }
          }
          wide::grad_tile<kKB>(gs, slot_af(b) + kb0, D + ncol,
                               (rows + 3) & ~3);
          if (nkb > 1 || ch == nch - 1) {
#pragma unroll
            for (int i = 0; i < MB; ++i)
              *reinterpret_cast<float4*>(xg + i * kSub) =
                  make_float4(gs[i][0], gs[i][1], gs[i][2], gs[i][3]);
          }
          // (c) gA's (chunk, block kb) tile over the sub-tile's columns
          const GA pa(tid);
          if (pa.r1 < rows) {
            float acc[GA::kT1][GA::kT2];
#pragma unroll
            for (int i = 0; i < GA::kT1; ++i)
#pragma unroll
              for (int jj = 0; jj < GA::kT2; ++jj) acc[i][jj] = 0.f;
            wide::pair_tile<2>(acc, pa, D, PF, Sb, PS);
            wide::put_parts(parts, pa, acc);
          }
          __syncthreads();  // the parts' sums are in
          float sum[GA::kPerThread];
#pragma unroll
          for (int m = 0; m < GA::kPerThread; ++m) sum[m] = 0.f;
          wide::add_parts<GA>(parts, sum);
#pragma unroll
          for (int m = 0; m < GA::kPerThread; ++m) {
            const int i = tid + kThreads * m;
            const int c = ch * kChunk + i / kKB, k = kb * kKB + i % kKB;
            if (c < C && k < K) row[(long long)c * K + k] = prev[m] + sum[m];
          }
        }
        if (more) put_a(nj);
      }
    }
    __syncthreads();  // gS of the sub-tile is in the column store

    // the epilogue, one column per thread, on the column store in the
    // scratch; with one component block the Gram's operand also goes to
    // shared memory (g1): the last chunk's stage in float32, D with the
    // bfloat16 store
    const bool valid = tid < width;
    const long long n = c0 + tid;
    float* const xb = X0;
    constexpr int xp = kSub;
    float* const x = xb + tid;
    float* const g1 =
        kF32 ? reinterpret_cast<float*>(stage_y(t * nch + nch - 1))
             : reinterpret_cast<float*>(smem + L.d);
    auto s_of = [&](int k) {
      return valid ? to_f32(a.S[(long long)k * N + n]) : 0.f;
    };
    if constexpr (MODE == wide::kGrad) {
      if (valid) {
#pragma unroll 4
        for (int k = 0; k < K; ++k) a.out[(long long)k * N + n] = x[k * xp];
      }
      // the Gram of the old S
      if (nkb == 1) {
#pragma unroll 4
        for (int k = 0; k < kKB; ++k) g1[k * PF + tid] = k < K ? s_of(k) : 0.f;
      } else {
#pragma unroll 4
        for (int k = 0; k < K; ++k) x[k * xp] = s_of(k);
      }
    } else if constexpr (MODE == wide::kPgm || MODE == wide::kPgmPre) {
      const float sS = *a.step_S;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float v = s_of(k) - sS * x[k * xp];
        if constexpr (MODE == wide::kPgmPre) {
          if (valid) a.pre[(long long)k * N + n] = v;
        } else {
          x[k * xp] = v;
        }
      }
      if constexpr (MODE == wide::kPgm)
        apply_chain_column(a.chain, x, xp, K, [&](int) { return sS; });
    } else if constexpr (MODE == wide::kAda || MODE == wide::kAdaPre) {
      const wide::AdaSchedule h = wide::ada_schedule(a);
      float* const step = X0 + (long long)KP * kSub + tid;
#pragma unroll 1
      for (int k = 0; k < K; ++k) {
        const long long gi = (long long)k * N + n;
        float m0 = 0.f, v0 = 0.f;
        if (valid) {
          m0 = to_f32(a.M[gi]);
          v0 = to_f32(a.V[gi]);
        }
        const float2 r = wide::ada_update<MODE>(a, h, gi, k, x[k * xp],
                                                s_of(k), m0, v0, valid);
        x[k * xp] = r.x;
        if constexpr (MODE == wide::kAda) step[k * kSub] = r.y;
      }
      if constexpr (MODE == wide::kAda)
        apply_chain_column(a.chain, x, xp, K,
                           [&](int k) { return step[k * kSub]; });
    }
    if constexpr (wide::has_update(MODE)) {
      // store S' and keep the stored values for the sums
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        float xs = 0.f;
        if (valid) {
          xs = x[k * xp];
          if (a.out != nullptr) xs = store(a.out, (long long)k * N + n, xs);
          const float dk = xs - s_of(k);
          st1 = fmaf(dk, dk, st1);
          st2 = fmaf(xs, xs, st2);
        }
        x[k * xp] = xs;
        if (wide::has_gram(MODE) && nkb == 1) g1[k * PF + tid] = xs;
      }
      if (wide::has_gram(MODE) && nkb == 1)
        for (int k = K; k < kKB; ++k) g1[k * PF + tid] = 0.f;
    }
    if constexpr (wide::has_gram(MODE)) {
      __syncthreads();  // the columns are in the store
      const GR pg(tid);
      // Beyond one component block, in float32, block bi of the column
      // store goes to g1 and block bj to g2 (the last step's slot); the
      // bfloat16 store reads the scratch in L2 where it is.
      constexpr bool kStage = kF32;
      float* const g2 = reinterpret_cast<float*>(slot_s(1));
      auto stage = [&](float* dst, int blk) {
        constexpr int kQ = kSub / 4;
        const float* src = X0 + (long long)blk * kKB * kSub;
        for (int i = tid; i < kKB * kQ; i += kThreads) {
          const int r = i / kQ, c = (i % kQ) * 4;
          *reinterpret_cast<float4*>(dst + r * PF + c) =
              wide::ld4(src + r * kSub + c);
        }
      };
      // blocks (bi, bj) with bi <= bj: an entry (r, s) and its mirror (s,
      // r) sum the same products over the same parts of the columns in the
      // same order, so the block (bj, bi) is this one transposed, bit for
      // bit
      for (int bi = 0; bi < nkb; ++bi)
        for (int bj = bi; bj < nkb; ++bj) {
          const bool staged = kStage && nkb > 1;
          if (staged) {
            if (bj == bi) stage(g1, bi);
            else stage(g2, bj);
            __syncthreads();
          }
          float acc[GR::kT1][GR::kT2];
#pragma unroll
          for (int i = 0; i < GR::kT1; ++i)
#pragma unroll
            for (int jj = 0; jj < GR::kT2; ++jj) acc[i][jj] = 0.f;
          // not unrolled: unrolled twice, the Gram's loads cost the
          // body 8 bytes of spill stores
          if (nkb == 1 || staged)
            wide::pair_tile<1>(acc, pg, g1, PF, bj == bi ? g1 : g2, PF);
          else
            wide::pair_tile<1>(acc, pg, xb + (long long)bi * kKB * xp, xp,
                               xb + (long long)bj * kKB * xp, xp);
          wide::put_parts(parts, pg, acc);
          __syncthreads();
          float sum[GR::kPerThread];
#pragma unroll
          for (int m = 0; m < GR::kPerThread; ++m) sum[m] = 0.f;
          wide::add_parts<GR>(parts, sum);
#pragma unroll
          for (int m = 0; m < GR::kPerThread; ++m) {
            const int i = tid + kThreads * m;
            const int r1 = bi * kKB + i / kKB, r2 = bj * kKB + i % kKB;
            if (r1 < K && r2 < K) {
              row[e.ga + (long long)r1 * K + r2] += sum[m];
              if (bj != bi) row[e.ga + (long long)r2 * K + r1] += sum[m];
            }
          }
          __syncthreads();  // the parts' buffer is free
        }
    } else if constexpr (wide::has_rowsum(MODE)) {
      __syncthreads();  // the columns are in the store
      for (int bk = 0; bk < nkb; ++bk) {
        const float* xr = xb + (long long)(bk * kKB + rk) * xp + 4 * rp;
        float v = 0.f;
#pragma unroll
        for (int jj = 0; jj < kSub / kRowParts; jj += 4) {
          const float4 q = wide::ld4(xr + kRowParts * jj);
          v += q.x;
          v += q.y;
          v += q.z;
          v += q.w;
        }
        parts[tid] = v;
        __syncthreads();
        if (tid < kKB && bk * kKB + tid < K) {
          float s = parts[tid * kRowParts];
#pragma unroll
          for (int p = 1; p < kRowParts; ++p) s += parts[tid * kRowParts + p];
          row[e.ga + bk * kKB + tid] += s;
        }
        __syncthreads();
      }
    }
    // every thread is done with the store and the parts' buffer
    __syncthreads();
  }

  wide::block_stats(st0, st1, st2, red, row + e.ga + e.mid, 0, e.stats);
}

// Both launches of one pass on `stream`: a block per group of units (one
// per SM), then the wide body's finalize. Returns cudaGetLastError().
template <typename ST, typename MT, int MODE, typename Kernel,
          typename Finalize>
int launch(Kernel kernel, Finalize fin, wide::LaunchCache& lc,
           const Args<ST, MT>& args, float* gA, float* mid, float* stats,
           cudaStream_t stream) {
  cudaError_t err;
  if (args.C < 1 || args.K < 1 || args.N < 1 || args.tile_n < 1)
    return (int)cudaErrorInvalidValue;
  const Smem L = smem_layout<ST>();
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
  const wide::Entries e = wide::entries(MODE, args.C, args.K);
  fin<<<(e.total + 31) / 32, wide::kFinThreads, 0, stream>>>(
      args.partials, groups, e, true, gA, mid, stats);
  return (int)cudaGetLastError();
}

}  // namespace vwide
}  // namespace
