// The second passes of the split path past K = 32 components (tiers.cuh's
// kPost body): K1's (nmf_pgm_wide.cu, mode 2) and K2's (nmf_adaprox_wide.cu,
// mode 2, built into the library nmf_adaprox_vwide), for any K and, as
// they read no A, any C.
//
// Both take the prox's output P (K, N, float32) and the old S (K, N, the
// store's type) and give S' (P itself in float32; P rounded to bfloat16,
// stored, with the bfloat16 store), [|S' - S|^2, |S'|^2] of the stored S',
// and K1 the Gram S' S'^T, K2 rowsum(S'). Neither needs the column of all K
// values a pixel that the passes with a residual keep, so neither keeps one:
//
// K1: the Gram as a symmetric rank-N update over the pixel axis. A block
// takes one tile pair (bi <= bj) of the Gram, kTB x kTB components, over a
// group of consecutive columns; its grid is the groups times the upper
// triangle's pairs, the pairs of one group adjacent, so that a panel's
// second read comes from L2. The panels (rows 64 bi .. and 64 bj .. of P
// over kCW columns) come through a ring of kStages shared-memory stages by
// 16-byte cp.async copies, or, in a ragged chunk or where a row is not
// 16-byte aligned, by the threads' element copies. The threads are column
// splits of 64: split g takes the float4 columns g, g + 4, ... of every
// stage, and its thread (ti, tj) an 8 x 8 register tile, the components
// ti + 8 i and tj + 8 j (consecutive rows across a quarter warp: no bank
// conflict), two columns at a time. A diagonal block forms only the 36
// sub-tiles ti <= tj, the entries (r, s) with r % 8 <= s % 8, which hold one
// of every mirrored pair, in six splits (216 threads). Each entry is an
// exact float32 FMA chain over its split's columns in order, from 0; the
// splits' sums are added in order through shared memory once, at the end,
// and the block writes its tile once to its slice of the group's row of
// partial sums. The diagonal pairs alone also read the old S (through the
// stage's second panel) and store S' and add the norms, so that each
// element is counted and written once; with the bfloat16 store every block
// rounds its panels in shared memory before the products, so the Gram
// takes the stored values.
//
// K2: a streaming pass over rows, with no shared-memory store. A block
// takes kRB rows over a group's columns (the blocks of one row block
// adjacent); a thread the four columns 4 t + 1024 j (16-byte loads where
// aligned, every row's loads of a j in flight at once). A row's sum is each
// thread's columns in order, then a fixed shuffle tree over the warp, then
// the warps in order, written once per (row block, group); the norms go the
// same way, and S' is stored in the same pass.
//
// The tile-pair routine also serves panel_pass.cuh (K1's and K3's passes
// with a residual past K = 256) as two products of its own, each a
// template instance (Product) with nothing of pass 2's diagonal work: the
// Gram alone (kGram: S' of K1's chain, the old S of K3, read in the store's
// type) over the same upper-triangle pairs, and gA = D S^T (kCross: the
// rows of the residual D, float32 in panel_pass.cuh's scratch with a pitch
// of cross_pitch(N), against the old S) over every (channel tile,
// component tile) pair. A float32 operand whose rows are 16-byte aligned
// comes by cp.async; a bfloat16 one, or rows that are not aligned, by the
// threads' element copies, converted to float32 in shared memory.
//
// A second launch (finalize) sums the groups' rows in double in a fixed
// order and rounds once; K1 writes both triangles of the Gram from one sum
// (bitwise symmetric) and each norm sums its tiles (row blocks) in order.
// No atomics and no library call: the summation order depends on N,
// tile_n, K and the instance alone, never on the card or the grid, and two
// launches give the same bits. The column groups are runs of the wide
// body's units (wide::unit_span), fewer than its group_count(n_units, 2)
// where a group's blocks give more than a wave (group_units), so that the
// blocks fill whole waves and the partial rows stay small.
//
// What bounds them on an H100: K2 moves 8 bytes an element (S and P read,
// or with the bfloat16 store S read and S' written at 2 bytes): 0.076 ms at
// K = 128, N = 250 000 and 3.35 TB/s. K1 the same bytes and the tile
// pairs' FMAs, 4096 a column a pair (2304 on the diagonal): at K = 128,
// 2.2e9 FMAs, 0.065 ms at 33.5e12 FMA/s. The 8 x 8 tiles load 1 float per
// 4 FMAs, as much as the shared memory delivers (128 bytes a clock an SM
// against 128 FMAs): with float4 operands and no copies the products ran at
// 37-47 % of the FMA rate. The copies are cp.async, not 1-D bulk copies:
// with a 256-byte row a copy (a row a lane of warp 0) those took as long
// as the products. No tensor cores: TF32 would round the operands.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bulk_ring.cuh"
#include "wide_pass.cuh"

namespace {
namespace post {

using wide::Args;
using wide::kThreads;
using wide::kWarps;

// K1
constexpr int kTB = 64;                   // components per tile
constexpr int kCW = 64;                   // columns per stage
constexpr int kStages = 3;                // the ring
constexpr int kF4 = kCW / 4;              // float4 columns per stage row
constexpr int kPitch = kCW + 4;           // floats per panel row
constexpr int kPanel = kTB * kPitch * 4;  // bytes per panel
constexpr int kStageBytes = 2 * kPanel;
constexpr int kSplit = kThreads / 64;     // column splits per block
constexpr int kDiagSplit = 6;             // ... on the diagonal, 36 sub-tiles
constexpr int kRedPitch = kTB + 1;        // the splits' sums in shared memory
constexpr int kSmemGram = kStages * kStageBytes;
static_assert(kDiagSplit * kTB * kRedPitch * 4 <= kSmemGram,
              "the splits' sums overlay the stages");
// Blocks the card holds at once (two of 256 threads an SM on 132 SMs), and
// the most a launch is given (four waves) before it takes fewer groups.
constexpr int kSlots = 2 * wide::kGroups;
constexpr int kMaxWaves = 4;
// K2
constexpr int kRB = 8;                    // rows per block
constexpr int kSpan = 4 * kThreads;       // columns a block's pass covers

// What a block of the tile-pair routine computes: split pass 2 (the Gram
// of P, the norms and, with the bfloat16 store, S'), the Gram of a (K, N)
// operand alone, or the product of the rows of two operands.
enum Product { kPass2, kGram, kCross };

__host__ __device__ inline int tiles_of(int K) { return (K + kTB - 1) / kTB; }
__host__ __device__ inline long long pairs_of(int K) {
  const long long t = tiles_of(K);
  return t * (t + 1) / 2;
}
// Tiles of a product's output: the Gram's upper-triangle pairs, or
// kCross's (channel tile, component tile) pairs of a (C, K) output.
__host__ __device__ inline long long product_tiles(int pr, int C, int K) {
  return pr == kCross ? (long long)tiles_of(C) * tiles_of(K) : pairs_of(K);
}
// Floats of a group's row of partial sums of a kGram or kCross product.
__host__ __device__ inline long long product_width(int pr, int C, int K) {
  return product_tiles(pr, C, K) * kTB * kTB;
}
// Pitch (floats) of kCross's first operand's rows: whole stages.
__host__ __device__ inline long long cross_pitch(long long N) {
  return (N + kCW - 1) / kCW * kCW;
}
__host__ __device__ inline int row_blocks(int K) { return (K + kRB - 1) / kRB; }

// Floats of a group's row of partial sums: K1 the pairs' tiles, then a
// diagonal tile's two norms each; K2 the row sums, then a row block's two
// norms each.
__host__ __device__ inline long long width(int mode, int K) {
  if (mode == wide::kPgmPost)
    return pairs_of(K) * kTB * kTB + 2LL * tiles_of(K);
  return (long long)K + 2LL * row_blocks(K);
}

// Blocks a group: K1's tile pairs, K2's row blocks.
__host__ __device__ inline long long blocks_per_group(int mode, int K) {
  return mode == wide::kPgmPost ? pairs_of(K) : row_blocks(K);
}
// Units per group: fewer groups than the wide body's group_count(n_units,
// 2) where a group's blocks give more than one wave, so that the blocks
// fill whole waves (at most kMaxWaves), each block takes more columns, and
// the rows of partial sums stay small.
__host__ __device__ inline long long units_per_group(long long per,
                                                     long long n_units) {
  long long cap = wide::group_count(n_units, 2);
  long long waves = per * cap / kSlots;
  waves = waves < 1 ? 1 : (waves > kMaxWaves ? kMaxWaves : waves);
  const long long fit = kSlots * waves / per;
  cap = fit < 1 ? 1 : (fit < cap ? fit : cap);
  return (n_units + cap - 1) / cap;
}
__host__ __device__ inline long long groups_of(long long per,
                                               long long n_units) {
  const long long g = units_per_group(per, n_units);
  return (n_units + g - 1) / g;
}
__host__ __device__ inline long long group_units(int mode, long long n_units,
                                                 int K) {
  return units_per_group(blocks_per_group(mode, K), n_units);
}
__host__ __device__ inline long long groups(int mode, long long n_units,
                                            int K) {
  return groups_of(blocks_per_group(mode, K), n_units);
}

// The columns [lo, hi) of group g of gu units each.
__device__ __forceinline__ void group_span(long long gu,
                                           const long long n_units,
                                           long long g, long long N,
                                           long long tile_n, long long& lo,
                                           long long& hi) {
  const long long u0 = g * gu;
  const long long u1 = wide::lmin(u0 + gu, n_units) - 1;
  long long skip;
  wide::unit_span(u0, N, tile_n, lo, skip);
  wide::unit_span(u1, N, tile_n, skip, hi);
}

// Four floats to four bfloat16 values and back.
__device__ __forceinline__ float4 round_bf16(float4 v) {
  return make_float4(__bfloat162float(__float2bfloat16_rn(v.x)),
                     __bfloat162float(__float2bfloat16_rn(v.y)),
                     __bfloat162float(__float2bfloat16_rn(v.z)),
                     __bfloat162float(__float2bfloat16_rn(v.w)));
}
// Four stored values of S' at p (16-byte or 8-byte aligned).
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ float at(const float4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

// ---------------------------------------------------------------------------
// K1 split pass 2 (PR = kPass2): the Gram of S', the norms, and S'
// stored with the bfloat16 store (or where a.out is given). kGram: the Gram
// of a.S alone. kCross: a.P's rows (C of them, pitch cross_pitch(N))
// against a.S's.

template <int PR, typename ST>
__device__ __forceinline__ void product_body(const Args<ST, float>& a,
                                             unsigned char* smem) {
  constexpr bool kF32 = std::is_same<ST, float>::value;
  constexpr bool kPass = PR == kPass2;
  constexpr int ss = sizeof(ST);
  // the old S's rows in a diagonal block's second panel: 16-byte aligned
  constexpr int PS = kF32 ? kCW + 4 : kCW + 8;
  // the products' column pairs unrolled twice in float32 (with the
  // bfloat16 store's rounding in the loop that spilled 44 bytes)
  constexpr int kColUnroll = (kF32 || !kPass) ? 2 : 1;
  __shared__ float red[kWarps][3];

  const int K = a.K;
  const long long N = a.N;
  const int tid = threadIdx.x;
  const int nt = tiles_of(K);
  const long long pairs = product_tiles(PR, a.C, K);
  const long long g = blockIdx.x / pairs;
  int bi = 0, bj = (int)(blockIdx.x - g * pairs);
  if constexpr (PR == kCross) {
    bi = bj / nt;
    bj -= bi * nt;
  } else {
    while (bj >= nt - bi) {
      bj -= nt - bi;
      ++bi;
    }
    bj += bi;
  }
  const bool diag = PR != kCross && bi == bj;
  const int ra = bi * kTB, rb = bj * kTB;
  const int rows_a = min(kTB, (PR == kCross ? a.C : K) - ra),
            rows_b = min(kTB, K - rb);
  long long lo, hi;
  group_span(units_per_group(pairs, a.n_units), a.n_units, g, N, a.tile_n,
             lo, hi);
  const int nch = (int)((hi - lo + kCW - 1) / kCW);
  float* const row =
      a.partials + g * (kPass ? width(wide::kPgmPost, K)
                              : product_width(PR, a.C, K));

  auto panel_a = [&](int s) {
    return reinterpret_cast<float*>(smem + s * kStageBytes);
  };
  auto panel_b = [&](int s) {
    return reinterpret_cast<float*>(smem + s * kStageBytes + kPanel);
  };

  // Rows past K stay zero (no copy writes them), as do the padding columns
  // a ragged chunk's element copies leave.
  for (int i = tid; i < kStages * kStageBytes / 16; i += kThreads)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // 16-byte copies of whole chunks where every row of the group starts
  // 16-byte aligned (P and, on the diagonal, S), else the threads copy
  // elements.
  const auto addr = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p);
  };
  const bool vec =
      ((addr(a.P) | (unsigned long long)(N * 4) |
        (unsigned long long)(lo * 4) |
        (diag ? (addr(a.S) | (unsigned long long)(N * ss) |
                 (unsigned long long)(lo * ss))
              : 0ull)) &
       15ull) == 0;
  // S' is stored four at a time where its rows are aligned
  const bool vec_out = a.out != nullptr &&
                       ((addr(a.out) | (unsigned long long)(N * ss) |
                         (unsigned long long)(lo * ss)) &
                        (4ull * ss - 1)) == 0;

  // kGram and kCross: rows [r0, r0 + rows) of src (pitch p) over the
  // chunk's columns into a panel, by 16-byte copies where `v` and the chunk
  // is whole, else by element copies, converted, zeros past w up to a
  // float4
  const long long xp = PR == kCross ? cross_pitch(N) : N;
  const bool vx =
      PR == kCross
          ? ((addr(a.P) | (unsigned long long)(xp * 4) |
              (unsigned long long)(lo * 4)) & 15ull) == 0
          : kF32 && ((addr(a.S) | (unsigned long long)(N * ss) |
                      (unsigned long long)(lo * ss)) & 15ull) == 0;
  const bool vz = kF32 && ((addr(a.S) | (unsigned long long)(N * ss) |
                            (unsigned long long)(lo * ss)) & 15ull) == 0;
  auto copy_panel = [&](float* dst, const auto* src, long long p, int r0,
                        int rows, long long c0, int w, bool v) {
    using T = std::remove_cv_t<std::remove_pointer_t<decltype(src)>>;
    if constexpr (std::is_same<T, float>::value) {
      if (v && w == kCW) {
        for (int i = tid; i < rows * kF4; i += kThreads) {
          const int r = i / kF4, n = (i - r * kF4) * 4;
          wide::cp_async16(dst + r * kPitch + n,
                           src + (long long)(r0 + r) * p + c0 + n, 16);
        }
        return;
      }
    }
    const int wq = (w + 3) & ~3;
    for (int i = tid; i < rows * wq; i += kThreads) {
      const int r = i / wq, n = i - r * wq;
      dst[r * kPitch + n] =
          n < w ? to_f32(src[(long long)(r0 + r) * p + c0 + n]) : 0.f;
    }
  };

  // chunk t into stage t % kStages: P's rows of tile bi, then of tile bj
  // (on the diagonal, the old S's rows of tile bi); a cp.async group each
  auto fill = [&](int t) {
    const int s = t % kStages;
    const long long c0 = lo + (long long)t * kCW;
    const int w = (int)wide::lmin(kCW, hi - c0);
    if constexpr (!kPass) {
      if constexpr (PR == kCross)
        copy_panel(panel_a(s), a.P, xp, ra, rows_a, c0, w, vx);
      else
        copy_panel(panel_a(s), a.S, N, ra, rows_a, c0, w, vx);
      if (!diag) copy_panel(panel_b(s), a.S, N, rb, rows_b, c0, w, vz);
      return;
    }
    float* const pa = panel_a(s);
    ST* const sb = reinterpret_cast<ST*>(panel_b(s));
    float* const pb = panel_b(s);
    if (vec && w == kCW) {
      // a whole chunk: kF4 16-byte pieces a row of P, kQS a row of S
      constexpr int kQS = kCW * ss / 16;
      for (int i = tid; i < rows_a * kF4; i += kThreads) {
        const int r = i / kF4, n = (i - r * kF4) * 4;
        wide::cp_async16(pa + r * kPitch + n,
                         a.P + (long long)(ra + r) * N + c0 + n, 16);
      }
      if (diag) {
        for (int i = tid; i < rows_b * kQS; i += kThreads) {
          const int r = i / kQS, n = (i - r * kQS) * (16 / ss);
          wide::cp_async16(sb + r * PS + n,
                           a.S + (long long)(ra + r) * N + c0 + n, 16);
        }
      } else {
        for (int i = tid; i < rows_b * kF4; i += kThreads) {
          const int r = i / kF4, n = (i - r * kF4) * 4;
          wide::cp_async16(pb + r * kPitch + n,
                           a.P + (long long)(rb + r) * N + c0 + n, 16);
        }
      }
      return;
    }
    // a ragged chunk, or rows that are not 16-byte aligned: the threads copy
    // elements, zeros past w up to a float4
    const int wq = (w + 3) & ~3;
    for (int i = tid; i < rows_a * wq; i += kThreads) {
      const int r = i / wq, n = i - r * wq;
      pa[r * kPitch + n] =
          n < w ? a.P[(long long)(ra + r) * N + c0 + n] : 0.f;
    }
    for (int i = tid; i < rows_b * wq; i += kThreads) {
      const int r = i / wq, n = i - r * wq;
      if (diag) {
        ST v;
        wide::zero(v);
        if (n < w) v = a.S[(long long)(ra + r) * N + c0 + n];
        sb[r * PS + n] = v;
      } else {
        pb[r * kPitch + n] =
            n < w ? a.P[(long long)(rb + r) * N + c0 + n] : 0.f;
      }
    }
  };

  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nch) fill(t);
    wide::cp_async_commit();
  }

  // The thread's tile: column split sp, components ti + 8 i of tile bi and
  // tj + 8 j of tile bj. A diagonal block forms the 36 sub-tiles ti <= tj
  // alone (the Gram's (r, s) where r % 8 <= s % 8, which holds one of each
  // mirrored pair) in kDiagSplit splits, 216 threads.
  const int nsplit = diag ? kDiagSplit : kSplit;
  int sp = tid >> 6, ti = tid & 7, tj = (tid >> 3) & 7;
  if (diag) {
    sp = tid / 36;
    ti = 0;
    tj = tid % 36;
    while (tj >= 8 - ti) {
      tj -= 8 - ti;
      ++ti;
    }
    tj += ti;
  }
  const bool active = sp < nsplit;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float st1 = 0.f, st2 = 0.f;

  for (int t = 0; t < nch; ++t) {
    const int s = t % kStages;
    const long long c0 = lo + (long long)t * kCW;
    const int w = (int)wide::lmin(kCW, hi - c0);
    // the thread's copies of chunk t are in; after the barrier everyone's
    // are, and every thread is done with chunk t - 1, whose stage takes
    // chunk t + kStages - 1
    wide::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < nch) fill(t + kStages - 1);
    wide::cp_async_commit();

    float* const pa = panel_a(s);
    float* const pb = diag ? pa : panel_b(s);
    if (!kPass) {
      // the products alone
    } else if (diag) {
      // S' of tile bi's elements: stored, counted in the norms, and (bfloat16
      // store) rounded in place for the products
      const ST* const sb = reinterpret_cast<const ST*>(panel_b(s));
      for (int i = tid; i < rows_a * kF4; i += kThreads) {
        const int r = i / kF4, c = (i - r * kF4) * 4;
        if (c >= w) continue;
        float4 x = wide::ld4(pa + r * kPitch + c);
        const float4 o = wide::ld4(sb + r * PS + c);
        if constexpr (!kF32) x = round_bf16(x);
        ST* const out =
            a.out ? a.out + (long long)(ra + r) * N + c0 + c : nullptr;
        if (out && vec_out && c + 4 <= w) st4(out, x);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (c + q >= w) break;
          const float xs = at(x, q);
          if (out && !(vec_out && c + 4 <= w)) store(out, q, xs);
          const float d = xs - at(o, q);
          st1 = fmaf(d, d, st1);
          st2 = fmaf(xs, xs, st2);
        }
        if constexpr (!kF32)
          *reinterpret_cast<float4*>(pa + r * kPitch + c) = x;
      }
      if constexpr (!kF32) __syncthreads();
    } else if constexpr (!kF32 && kPass) {
      // the stored values of both panels
      for (int i = tid; i < 2 * kTB * kF4; i += kThreads) {
        float* const p =
            (i < kTB * kF4 ? pa : pb) + (i % (kTB * kF4)) / kF4 * kPitch +
            (i % kF4) * 4;
        *reinterpret_cast<float4*>(p) = round_bf16(wide::ld4(p));
      }
      __syncthreads();
    }

    // the products: split sp's float4 columns of the stage, in order
    const int nf = active ? (w + 3) >> 2 : 0;
    const float* const xa = pa + ti * kPitch;
    const float* const xb = pb + tj * kPitch;
#pragma unroll 1
    for (int f = sp; f < nf; f += nsplit) {
      // two columns at a time (float2 operands keep the registers under
      // 128; float4's spilled), unrolled where the store leaves room
#pragma unroll kColUnroll
      for (int h = 0; h < 4; h += 2) {
        float2 va[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          va[i] = *reinterpret_cast<const float2*>(xa + 8 * i * kPitch +
                                                   4 * f + h);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 vb = *reinterpret_cast<const float2*>(
              xb + 8 * j * kPitch + 4 * f + h);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][j] = fmaf(va[i].x, vb.x, acc[i][j]);
            acc[i][j] = fmaf(va[i].y, vb.y, acc[i][j]);
          }
        }
      }
    }
  }

  // the splits' tiles through shared memory (the stages are free: no copy
  // is in flight), added in order, written once to the pair's slice of the
  // group's row (a diagonal block's lower sub-tiles are never read)
  wide::cp_async_wait<0>();
  __syncthreads();
  float* const sums = reinterpret_cast<float*>(smem);
  if (active) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sums[(sp * kTB + ti + 8 * i) * kRedPitch + tj + 8 * j] = acc[i][j];
  }
  __syncthreads();
  float* const tile = row + (blockIdx.x - g * pairs) * (kTB * kTB);
  for (int e = tid; e < kTB * kTB; e += kThreads) {
    const int r = e / kTB, c = e % kTB;
    float v = sums[r * kRedPitch + c];
    for (int p = 1; p < nsplit; ++p) v += sums[(p * kTB + r) * kRedPitch + c];
    tile[e] = v;
  }
  if (kPass && diag)
    wide::block_stats(0.f, st1, st2, red,
                      row + pairs * (kTB * kTB) + 2 * bi, 1, 2);
}

// ---------------------------------------------------------------------------
// K2 split pass 2: rowsum(S'), the norms, and S' stored.

template <typename ST>
__device__ __forceinline__ void rowsum_body(const Args<ST, float>& a) {
  constexpr int ss = sizeof(ST);
  __shared__ float red[kWarps][3];
  __shared__ float parts[kWarps][kRB];

  const int K = a.K;
  const long long N = a.N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nrb = row_blocks(K);
  const long long ng = groups(wide::kAdaPost, a.n_units, K);
  const int rb = (int)(blockIdx.x / ng);
  const long long g = blockIdx.x - rb * ng;
  const int r0 = rb * kRB, rows = min(kRB, K - r0);
  long long lo, hi;
  group_span(group_units(wide::kAdaPost, a.n_units, K), a.n_units, g, N,
             a.tile_n, lo, hi);
  float* const row = a.partials + g * width(wide::kAdaPost, K);

  const auto addr = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p);
  };
  // 16-byte loads of P (8-byte of a bfloat16 S) where every row's columns
  // 4 t + ... are aligned
  const bool vec =
      ((addr(a.P) | (unsigned long long)(N * 4) | (unsigned long long)(lo * 4)) &
       15ull) == 0 &&
      ((addr(a.S) | (a.out ? addr(a.out) : 0ull) |
        (unsigned long long)(N * ss) | (unsigned long long)(lo * ss)) &
       (4ull * ss - 1)) == 0;

  float rs[kRB];
#pragma unroll
  for (int r = 0; r < kRB; ++r) rs[r] = 0.f;
  float st1 = 0.f, st2 = 0.f;
  const float* const P0 = a.P + (long long)r0 * N;
  const ST* const S0 = a.S + (long long)r0 * N;
  ST* const O0 = a.out ? a.out + (long long)r0 * N : nullptr;
  for (long long c = lo + 4 * tid; c < hi; c += kSpan) {
    const int nq = (int)wide::lmin(4, hi - c);
    float4 x[kRB], o[kRB];
    // every row's loads first, then the sums
#pragma unroll
    for (int r = 0; r < kRB; ++r) {
      if (r >= rows) continue;
      const long long gi = (long long)r * N + c;
      if (vec && nq == 4) {
        x[r] = wide::ld4_now(P0 + gi);
        o[r] = wide::ld4_now(S0 + gi);
      } else {
        x[r] = wide::ld4_part(P0 + gi, nq);
        o[r] = wide::ld4_part(S0 + gi, nq);
      }
    }
#pragma unroll
    for (int r = 0; r < kRB; ++r) {
      if (r >= rows) continue;
      float4 xr = x[r];
      if constexpr (!std::is_same<ST, float>::value) xr = round_bf16(xr);
      const long long gi = (long long)r * N + c;
      if (O0 && vec && nq == 4) st4(O0 + gi, xr);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q >= nq) break;
        const float xs = at(xr, q);
        if (O0 && !(vec && nq == 4)) store(O0, gi + q, xs);
        rs[r] += xs;
        const float d = xs - at(o[r], q);
        st1 = fmaf(d, d, st1);
        st2 = fmaf(xs, xs, st2);
      }
    }
  }

  // each row's sum: the warp's by a shuffle tree, then the warps in order
#pragma unroll
  for (int r = 0; r < kRB; ++r) {
    float v = rs[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) parts[warp][r] = v;
  }
  __syncthreads();
  if (tid < rows) {
    float v = parts[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += parts[w][tid];
    row[r0 + tid] = v;
  }
  wide::block_stats(0.f, st1, st2, red, row + K + 2 * rb, 1, 2);
}

// ---------------------------------------------------------------------------
// The second launch: a block per 32 entries of the group's row; warp w sums
// the groups w, w + 8, ... of its lane's entry in order in double (each
// norm over its tiles or row blocks in order within a group), then the
// warps' sums in order, rounded once. K1 writes the entry (r, s), r <= s,
// of a pair's tile to the Gram's (r, s) and (s, r) (kPass2 and kGram);
// kCross the entry (r, s) of a (channel, component) tile to gA's (r, s);
// K2 the row sums.
__device__ __forceinline__ void finalize(const float* partials, long long rows,
                                         int mode, int pr, int C, int K,
                                         float* mid, float* stats) {
  constexpr int kW = wide::kFinThreads / 32;
  __shared__ double part[kW][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const bool pass = pr == kPass2;
  const bool tiled = !pass || mode == wide::kPgmPost;
  const long long wd = pass ? width(mode, K) : product_width(pr, C, K);
  const long long n_mid =
      tiled ? product_tiles(pass ? kGram : pr, C, K) * kTB * kTB : K;
  const int n_stats = pass ? 2 : 0;
  const long long p = (long long)blockIdx.x * 32 + lane;
  const int n_parts = mode == wide::kPgmPost ? tiles_of(K) : row_blocks(K);
  // the entry's cell, where it has one
  int r = 0, s = 0;
  bool keep = p < n_mid + n_stats;
  if (tiled && p < n_mid) {
    const int nt = tiles_of(K);
    int bi = 0, bj = (int)(p / (kTB * kTB));
    if (pr == kCross) {
      bi = bj / nt;
      bj -= bi * nt;
    } else {
      while (bj >= nt - bi) {
        bj -= nt - bi;
        ++bi;
      }
      bj += bi;
    }
    const int e = (int)(p % (kTB * kTB));
    r = bi * kTB + e / kTB;
    s = bj * kTB + e % kTB;
    keep = pr == kCross
               ? r < C && s < K
               : r < K && s < K &&
                     (bi < bj || (r % 8 < s % 8) ||
                      (r % 8 == s % 8 && r <= s));
  }
  double v = 0.0;
  if (keep) {
    if (p < n_mid) {
      for (long long q = w; q < rows; q += kW) v += (double)partials[q * wd + p];
    } else {
      const long long at0 = n_mid + (p - n_mid);
      for (long long q = w; q < rows; q += kW)
        for (int b = 0; b < n_parts; ++b)
          v += (double)partials[q * wd + at0 + 2 * b];
    }
  }
  part[w][lane] = v;
  __syncthreads();
  if (w != 0 || !keep) return;
#pragma unroll
  for (int i = 1; i < kW; ++i) v += part[i][lane];
  const float f = (float)v;
  if (p >= n_mid) {
    stats[p - n_mid] = f;
  } else if (pr == kCross) {
    mid[(long long)r * K + s] = f;
  } else if (tiled) {
    mid[(long long)r * K + s] = f;
    mid[(long long)s * K + r] = f;
  } else {
    mid[p] = f;
  }
}

// Both launches of a second pass (or, PR = kGram or kCross, of a product
// of panel_pass.cuh) on `stream`: the body's blocks (K1 and the products:
// the groups times the tiles, two blocks an SM; K2: the groups times the
// row blocks), then the finalize. Returns cudaGetLastError().
template <int MODE, int PR, typename ST, typename Kernel, typename Finalize>
int launch(Kernel kernel, Finalize fin, wide::LaunchCache& lc,
           const Args<ST, float>& args, float* mid, float* stats,
           cudaStream_t stream) {
  cudaError_t err;
  if (args.K < 1 || args.N < 1 || args.tile_n < 1 ||
      (PR == kCross && args.C < 1))
    return (int)cudaErrorInvalidValue;
  const long long per = PR == kPass2 ? blocks_per_group(MODE, args.K)
                                     : product_tiles(PR, args.C, args.K);
  const long long n_groups = groups_of(per, args.n_units);
  const int smem =
      (PR != kPass2 || MODE == wide::kPgmPost) ? kSmemGram : 0;
  if (smem > lc.allowed_smem) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    lc.allowed_smem = smem;
  }
  if (n_groups * per > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)(n_groups * per), kThreads, smem, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n_mid =
      PR != kPass2 ? product_width(PR, args.C, args.K)
                   : (MODE == wide::kPgmPost
                          ? pairs_of(args.K) * kTB * kTB
                          : args.K);
  const int n_stats = PR == kPass2 ? 2 : 0;
  fin<<<(unsigned)((n_mid + n_stats + 31) / 32), wide::kFinThreads, 0,
        stream>>>(args.partials, n_groups, MODE, PR, args.C, args.K, mid,
                  stats);
  return (int)cudaGetLastError();
}

}  // namespace post
}  // namespace
