// K1's (nmf_pgm_wide.cu: the compiled chain, split pass 1) and K3's
// (nmf_grad.cu) passes with a residual past tier::kKwideK = 256 components
// up to tier::kPanelK = 512, any C: spectral-library unmixing, a library of
// a few hundred reference spectra fitted to every pixel (USGS splib06's 498
// spectra against AVIRIS's 224 bands). K2 past 256, and every kernel past
// 512, stay on vwide_pass.cuh.
//
// Why not one fused pass, as kwide_pass.cuh up to K = 256: beside the
// column of K values a pixel, such a pass keeps the two reductions over
// the pixel axis, gA (C x K, 446 KB at (224, 498)) and the Gram (K x K),
// on chip, and neither fits beside the rest past K = 256; vwide_pass.cuh,
// which keeps them in the group's row in L2 and steps through blocks of 32
// components, ran at 13-15 % of its bound. The work is far above the card's
// balance point (about 94 FMAs a byte at (224, 498)): one more round trip
// of a C x N array through device memory costs 0.13 ms at N = 250 000
// against an FMA bound of 3.4 ms, and buys products shaped like a GEMM's,
// with real reuse of their operands. So the reductions over N leave the
// per-column pass:
//
// 1. prep: A^T (K x C, rounded to bfloat16 for the bfloat16 store's
//    residual) and a copy of A, both padded with zeros to whole tiles, into
//    the scratch (0.1 M elements).
// 2. The column pass: one block per SM walks column tiles of kBN = 64
//    pixels. Per tile, (a) R = A S over the channels in blocks of kBM =
//    256, each an exact float32 FMA chain over k in order (the TPU
//    kernel's "fma" path, every body's order), then D = W (R - Y) (or
//    R - Y), the loss's terms, and D (float32) to a scratch of C x
//    cross_pitch(N) floats; (b) gS = A^T D over the components in blocks of
//    256, each an FMA chain over the channels in order from 0, read back
//    from the scratch (in L2: the block wrote it); (c) the epilogue of each
//    element: K3 stores gS, split pass 1 x = s - sS gS, the chain forms x
//    into a column store of K x 64 floats in shared memory, applies the
//    compiled chain (prox_chain.cuh) on each column, and stores S' in the
//    store's type with the norms. Both products run 8 x 8 register tiles a
//    thread (two float4 of each operand per reduction step: 4 FMAs a
//    loaded float, what the shared memory delivers), their operands through
//    a ring of kStages stages of kBR = 16 reduction steps by 16-byte
//    cp.async copies (element copies where S's rows are not aligned); a
//    warp whose rows are padding (C or K short of a whole 256) skips their
//    products. The epilogues load what they read from global memory in
//    batches ahead of their stores (a load after a store through another
//    pointer would wait for it).
// 3. gA = D S^T (the old S) and the Gram (of S' in the chain, stored, and
//    read back in the store's type; of the old S in K3) as post_pass.cuh's
//    tile-pair products over groups of columns (kCross, kGram), each with
//    its finalize; the column pass's loss and norms, one row per block, by
//    a finalize of their own.
//
// Every per-column output keeps the bits of vwide_pass.cuh's body: the
// residual's chain over k in order (the padding's zero terms add exactly),
// D = W (R - Y) as there, gS's chain over c in order from 0, x = s - sS gS,
// the chain and the store as there. gA, the Gram and the statistics sum in
// another order: each a fixed one, in double across groups and blocks, that
// depends on N, tile_n, C and K alone. No atomics: two launches give the
// same bits.
//
// What bounds it on an H100: at (224, 498, 250 000) the products' float32
// FMAs, 2 C K N in the column pass (55.8e9, 1.66 ms at 33.5e12 FMA/s; the
// padding to whole tiles makes 61.5e9), C K N for gA and about K^2 N / 2
// for the Gram; the column pass moves about 1.7 GB (S and Y read, D
// written and read back, S' written), 0.5 ms at 3.35 TB/s. The 8 x 8 tiles
// load one float from shared memory per 4 FMAs, as much as it delivers (128
// bytes a clock an SM against 128 FMAs), so the products run at a fraction
// of the FMA rate; one block of 8 warps per SM hides the loads' latency by
// the 64 independent chains a thread. No tensor cores: TF32 would round
// the residual's operands.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bulk_ring.cuh"
#include "post_pass.cuh"
#include "prox_chain.cuh"
#include "tiers.cuh"
#include "wide_pass.cuh"

namespace {
namespace panel {

using wide::Args;
using wide::kThreads;
using wide::kWarps;

constexpr int kBM = 256;  // a product tile's rows: channels (a), components (b)
constexpr int kBN = 64;   // a tile's columns (pixels)
constexpr int kBR = 16;   // reduction steps a stage
constexpr int kStages = 3;
constexpr int kXBytes = kBR * kBM * 4;
constexpr int kZBytes = kBR * kBN * 4;
constexpr int kStageBytes = kXBytes + kZBytes;
constexpr int kRingBytes = kStages * kStageBytes;
// the chain's column store: K x kBN floats
constexpr int kColBytes = tier::kPanelK * kBN * 4;
// blocks of the column pass (one per SM), and floats of a block's row of
// statistics
constexpr int kBlocks = wide::kGroups;
constexpr int kStatPitch = 4;
static_assert(kBN == post::kCW, "D's rows are whole stages of the products");
static_assert(kThreads == 256, "the 8 x 8 tiles of a 256 x 64 tile");

__host__ __device__ inline long long up(long long x, long long m) {
  return (x + m - 1) / m * m;
}

// The scratch the caller allocates (float offsets, each 256-byte aligned):
// A^T (up(K, kBR) x up(C, kBM)), A (up(C, kBR) x up(K, kBM)), the column
// pass's statistics (kBlocks rows), D (C x cross_pitch(N)), gA's groups'
// rows of partial sums, the Gram's (the chain and K3).
struct Layout {
  long long at, af, stats, d, ga, gram, total;
};
__host__ __device__ inline Layout layout(int mode, int C, int K, long long N,
                                         long long n_units) {
  const long long ga_groups =
      post::groups_of(post::product_tiles(post::kCross, C, K), n_units);
  const long long gram_groups =
      wide::has_gram(mode)
          ? post::groups_of(post::product_tiles(post::kGram, C, K), n_units)
          : 0;
  Layout L;
  L.at = 0;
  L.af = up(up(K, kBR) * up(C, kBM), 64);
  L.stats = L.af + up(up(C, kBR) * up(K, kBM), 64);
  L.d = L.stats + up((long long)kBlocks * kStatPitch, 64);
  L.ga = L.d + up((long long)C * post::cross_pitch(N), 64);
  L.gram = L.ga + up(ga_groups * post::product_width(post::kCross, C, K), 64);
  L.total = L.gram + gram_groups * post::product_width(post::kGram, C, K);
  return L;
}

// Blocks of the column pass: fixed by N alone.
__host__ __device__ inline long long column_blocks(long long N) {
  return wide::lmin((N + kBN - 1) / kBN, kBlocks);
}
// Dynamic shared memory of the column pass: the ring, and the chain's
// column store.
__host__ __device__ inline int column_smem(int mode) {
  return kRingBytes + (mode == wide::kPgm ? kColBytes : 0);
}

// ---------------------------------------------------------------------------
// 1. prep: At[k][c] = A[c][k] (rounded to bfloat16 for the bfloat16 store)
// and Af[c][k] = A[c][k], zeros past C and K.

template <typename ST>
__device__ __forceinline__ void prep(const float* __restrict__ A, int C, int K,
                                     float* __restrict__ At,
                                     float* __restrict__ Af) {
  const long long cp = up(C, kBM), kp = up(K, kBM);
  const long long n_t = up(K, kBR) * cp, n_f = up(C, kBR) * kp;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n_t + n_f; i += (long long)gridDim.x * blockDim.x) {
    if (i < n_t) {
      const long long k = i / cp, c = i - k * cp;
      float v = (k < K && c < C) ? A[c * K + k] : 0.f;
      if constexpr (!std::is_same<ST, float>::value)
        v = __bfloat162float(__float2bfloat16_rn(v));
      At[i] = v;
    } else {
      const long long j = i - n_t, c = j / kp, k = j - c * kp;
      Af[j] = (c < C && k < K) ? A[c * K + k] : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. The column pass.

// kBR reduction steps of a stage: acc[i][j] += x[r][m_i] z[r][n_j] for r in
// order, the thread's rows m_i = 4 tm + i, 128 + 4 tm + i - 4 and columns
// n_j = 4 tn + j, 32 + 4 tn + j - 4 (a quarter warp shares tm: its X loads
// are one broadcast, its Z loads 128 consecutive bytes); MI = 4 the first
// four rows alone (the others padding).
template <int MI, typename ZT>
__device__ __forceinline__ void stage_products(float (&acc)[8][8],
                                               const float* x, const ZT* z,
                                               int tm, int tn) {
#pragma unroll
  for (int r = 0; r < kBR; ++r) {
    const float4 x0 = wide::ld4(x + r * kBM + 4 * tm);
    const float4 x1 = MI == 8 ? wide::ld4(x + r * kBM + 128 + 4 * tm) : x0;
    const float4 z0 = wide::ld4(z + r * kBN + 4 * tn);
    const float4 z1 = wide::ld4(z + r * kBN + 32 + 4 * tn);
    const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    const float zv[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], zv[j], acc[i][j]);
  }
}

// A product of `steps` stages over a tile of `rows` rows that are not
// padding: acc = 0, then stage t's reduction steps in order; fill(t, s)
// issues stage t's copies into ring slot s. A warp whose rows past its first
// four (or all of whose rows) are padding skips their products (the rows
// are never stored). Starts with a barrier (every thread is done with the
// ring, and what the block wrote to global memory before is visible to the
// copies).
template <typename ZT, typename Fill>
__device__ __forceinline__ void product(float (&acc)[8][8], int steps,
                                        int rows, Fill fill,
                                        unsigned char* smem, int tm, int tn) {
  // the warp's first row of each half: warp-uniform
  const int w0 = 16 * (threadIdx.x >> 5);
  const int mi = w0 >= rows ? 0 : (128 + w0 >= rows ? 4 : 8);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  __syncthreads();
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < steps) fill(t, t);
    wide::cp_async_commit();
  }
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    // stage t's copies are in; after the barrier everyone's are, and every
    // thread is done with stage t - 1, whose slot takes stage t + 2
    wide::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nt = t + kStages - 1;
    if (nt < steps) fill(nt, nt % kStages);
    wide::cp_async_commit();
    unsigned char* const st = smem + (t % kStages) * kStageBytes;
    const float* const x = reinterpret_cast<const float*>(st);
    const ZT* const z = reinterpret_cast<const ZT*>(st + kXBytes);
    if (mi == 8)
      stage_products<8>(acc, x, z, tm, tn);
    else if (mi == 4)
      stage_products<4>(acc, x, z, tm, tn);
  }
  wide::cp_async_wait<0>();
}

// kBR rows [r0, r0 + kBR) of src (pitch p elements; rows past n_rows and
// columns past n_cols zeros) over the columns [n0, n0 + kBN) into dst
// (kBN a row): 16-byte cp.async copies where `vec` (every row 16-byte
// aligned), else the threads' element copies.
template <typename T>
__device__ __forceinline__ void copy_cols(T* dst, const T* src, long long p,
                                          int r0, int n_rows, long long n0,
                                          long long n_cols, bool vec) {
  constexpr int E = 16 / (int)sizeof(T);
  constexpr int kPer = kBN / E;
  if (vec) {
    for (int i = threadIdx.x; i < kBR * kPer; i += kThreads) {
      const int r = i / kPer, e0 = (i - r * kPer) * E;
      const long long n = n0 + e0;
      int bytes = 0;
      const T* s = src;
      if (r0 + r < n_rows && n < n_cols) {
        bytes = (int)wide::lmin(E, n_cols - n) * (int)sizeof(T);
        s = src + (long long)(r0 + r) * p + n;
      }
      wide::cp_async16(dst + r * kBN + e0, s, bytes);
    }
    return;
  }
  for (int i = threadIdx.x; i < kBR * kBN; i += kThreads) {
    const int r = i / kBN, e = i - r * kBN;
    const long long n = n0 + e;
    T v;
    wide::zero(v);
    if (r0 + r < n_rows && n < n_cols) v = src[(long long)(r0 + r) * p + n];
    dst[r * kBN + e] = v;
  }
}

// Four float32 values to p (16-byte aligned where `vec`), the first nq.
__device__ __forceinline__ void put4(float* p, const float (&v)[4], int nq,
                                     bool vec) {
  if (vec && nq == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < nq) p[j] = v[j];
}
// Four elements from global memory (16 or 8 bytes aligned where `vec`), the
// first nq of them (the rest 0).
template <typename T>
__device__ __forceinline__ float4 get4(const T* p, int nq, bool vec) {
  if (vec && nq == 4) return wide::ld4(p);
  return nq > 0 ? wide::ld4_part(p, nq) : make_float4(0.f, 0.f, 0.f, 0.f);
}

template <typename ST, int MODE>
__device__ __forceinline__ void column_body(const Args<ST, float>& a,
                                            unsigned char* smem) {
  static_assert(MODE == wide::kPgm || MODE == wide::kPgmPre ||
                    MODE == wide::kGrad,
                "K1's chain and split pass 1, K3");
  constexpr int ss = sizeof(ST);
  __shared__ float red[kWarps][3];

  const int C = a.C, K = a.K;
  const long long N = a.N;
  const Layout L = layout(MODE, C, K, N, a.n_units);
  const float* const At = a.partials + L.at;
  const float* const Af = a.partials + L.af;
  float* const D = a.partials + L.d;
  const long long dp = post::cross_pitch(N);
  const int cp = (int)up(C, kBM), kp = (int)up(K, kBM);
  const int steps_a = (int)(up(K, kBR) / kBR);
  const int steps_b = (int)(up(C, kBR) / kBR);
  const bool weighted = a.W != nullptr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tn = lane & 7, tm = (warp << 2) | (lane >> 3);
  float* const col = reinterpret_cast<float*>(smem + kRingBytes);

  const auto addr = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p);
  };
  // S's rows by 16-byte copies where they are aligned (tiles start at
  // multiples of kBN columns); Y, W and the old S by four where they are
  // (16 or 8 bytes), the outputs of float32 likewise
  const bool s_vec = ((addr(a.S) | (unsigned long long)(N * ss)) & 15ull) == 0;
  const bool in_vec = ((addr(a.S) | addr(a.Y) | (weighted ? addr(a.W) : 0ull) |
                        (unsigned long long)(N * ss)) &
                       (4ull * ss - 1)) == 0;
  float* const out4 = MODE == wide::kGrad
                          ? reinterpret_cast<float*>(a.out)
                          : (MODE == wide::kPgmPre ? a.pre : nullptr);
  const bool out_vec =
      out4 != nullptr &&
      ((addr(out4) | (unsigned long long)(N * 4)) & 15ull) == 0;
  float sS = 0.f;
  if constexpr (MODE != wide::kGrad) sS = *a.step_S;

  // the thread's rows of a 256-row block and columns of a tile
  auto row_of = [&](int i) { return i < 4 ? 4 * tm + i : 124 + 4 * tm + i; };
  auto col_of = [&](int h) { return 32 * h + 4 * tn; };

  float acc[8][8];
  float st0 = 0.f, st1 = 0.f, st2 = 0.f;
  const long long n_tiles = (N + kBN - 1) / kBN;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long n0 = tile * kBN;

    // (a) R = A S, channel block cb, then D = W (R - Y) to the scratch
    for (int cb = 0; cb < cp / kBM; ++cb) {
      product<ST>(
          acc, steps_a, C - cb * kBM,
          [&](int t, int s) {
            unsigned char* const st = smem + s * kStageBytes;
            float* const x = reinterpret_cast<float*>(st);
            const float* const src =
                At + (long long)t * kBR * cp + cb * kBM;
            for (int i = tid; i < kBR * kBM / 4; i += kThreads) {
              const int r = i / (kBM / 4), c4 = (i - r * (kBM / 4)) * 4;
              wide::cp_async16(x + r * kBM + c4, src + (long long)r * cp + c4,
                               16);
            }
            copy_cols<ST>(reinterpret_cast<ST*>(st + kXBytes), a.S, N,
                          t * kBR, K, n0, N, s_vec);
          },
          smem, tm, tn);
      // four rows at a time: their Y and W loads all in flight before the
      // stores of D (a load after a store through another pointer waits)
#pragma unroll
      for (int i0 = 0; i0 < 8; i0 += 4) {
        float4 yv[4][2], wv[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = cb * kBM + row_of(i0 + i);
            const long long n = n0 + col_of(h);
            const int nq =
                c < C ? (int)wide::lmin(4, N - n > 0 ? N - n : 0) : 0;
            const long long gi = (long long)c * N + n;
            yv[i][h] = get4(a.Y + gi, nq, in_vec);
            wv[i][h] = weighted ? get4(a.W + gi, nq, in_vec)
                                : make_float4(1.f, 1.f, 1.f, 1.f);
          }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = i0 + ii;
        const int c = cb * kBM + row_of(i);
        if (c >= C) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long n = n0 + col_of(h);
          const int nq = (int)wide::lmin(4, N - n > 0 ? N - n : 0);
          const float y4[4] = {yv[ii][h].x, yv[ii][h].y, yv[ii][h].z,
                               yv[ii][h].w};
          const float w4[4] = {wv[ii][h].x, wv[ii][h].y, wv[ii][h].z,
                               wv[ii][h].w};
          float d4[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float rr = acc[i][4 * h + j] - y4[j];
            float d = weighted ? w4[j] * rr : rr;
            if (j < nq)
              st0 = fmaf(d, rr, st0);
            else
              d = 0.f;
            d4[j] = d;
          }
          *reinterpret_cast<float4*>(D + (long long)c * dp + n) =
              make_float4(d4[0], d4[1], d4[2], d4[3]);
        }
      }
      }
    }

    // (b) gS = A^T D, component block kb, and the epilogue of its elements
    for (int kb = 0; kb < kp / kBM; ++kb) {
      product<float>(
          acc, steps_b, K - kb * kBM,
          [&](int t, int s) {
            unsigned char* const st = smem + s * kStageBytes;
            float* const x = reinterpret_cast<float*>(st);
            const float* const src =
                Af + (long long)t * kBR * kp + kb * kBM;
            for (int i = tid; i < kBR * kBM / 4; i += kThreads) {
              const int r = i / (kBM / 4), c4 = (i - r * (kBM / 4)) * 4;
              wide::cp_async16(x + r * kBM + c4, src + (long long)r * kp + c4,
                               16);
            }
            copy_cols<float>(reinterpret_cast<float*>(st + kXBytes), D, dp,
                             t * kBR, C, n0, dp, true);
          },
          smem, tm, tn);
      // four rows at a time, the old S's loads in flight before the stores
#pragma unroll
      for (int i0 = 0; i0 < 8; i0 += 4) {
        float4 sv[4][2];
        if constexpr (MODE != wide::kGrad) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int k = kb * kBM + row_of(i0 + i);
              const long long n = n0 + col_of(h);
              const int nq =
                  k < K ? (int)wide::lmin(4, N - n > 0 ? N - n : 0) : 0;
              sv[i][h] = get4(a.S + (long long)k * N + n, nq, in_vec);
            }
        }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = i0 + ii;
        const int k = kb * kBM + row_of(i);
        if (k >= K) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long n = n0 + col_of(h);
          const int nq = (int)wide::lmin(4, N - n > 0 ? N - n : 0);
          const long long gi = (long long)k * N + n;
          float v[4];
          if constexpr (MODE == wide::kGrad) {
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] = acc[i][4 * h + j];
            put4(out4 + gi, v, nq, out_vec);
          } else {
            const float s4[4] = {sv[ii][h].x, sv[ii][h].y, sv[ii][h].z,
                                 sv[ii][h].w};
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] = s4[j] - sS * acc[i][4 * h + j];
            if constexpr (MODE == wide::kPgmPre)
              put4(out4 + gi, v, nq, out_vec);
            else
              *reinterpret_cast<float4*>(col + k * kBN + col_of(h)) =
                  make_float4(v[0], v[1], v[2], v[3]);
          }
        }
      }
      }
    }

    if constexpr (MODE == wide::kPgm) {
      // (c) the chain on each column, then S' stored and the norms
      __syncthreads();
      if (tid < kBN && n0 + tid < N)
        apply_chain_column(a.chain, col + tid, kBN, K,
                           [&](int) { return sS; });
      __syncthreads();
      // sixteen elements a thread at a time: the old S's loads first
      for (int i0 = tid; i0 < K * kBN; i0 += 16 * kThreads) {
        float so[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int i = i0 + q * kThreads, k = i / kBN;
          const long long n = n0 + (i - k * kBN);
          so[q] = (i < K * kBN && n < N) ? to_f32(a.S[(long long)k * N + n])
                                         : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int i = i0 + q * kThreads, k = i / kBN;
          const long long n = n0 + (i - k * kBN);
          if (i >= K * kBN || n >= N) continue;
          const float xs = store(a.out, (long long)k * N + n, col[i]);
          const float dk = xs - so[q];
          st1 = fmaf(dk, dk, st1);
          st2 = fmaf(xs, xs, st2);
        }
      }
    }
  }
  wide::block_stats(st0, st1, st2, red,
                    a.partials + L.stats + blockIdx.x * kStatPitch, 0, 3);
}

// The column pass's statistics: one block; warp w sums the blocks' rows
// w, w + 8, ... of entry `lane` < n in order in double, then the warps'
// sums in order, rounded once (the loss halved).
__device__ __forceinline__ void stats_finalize(const float* rows,
                                               long long n_rows, int n,
                                               float* stats) {
  constexpr int kW = wide::kFinThreads / 32;
  __shared__ double part[kW][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  double v = 0.0;
  if (lane < n)
    for (long long q = w; q < n_rows; q += kW)
      v += (double)rows[q * kStatPitch + lane];
  part[w][lane] = v;
  __syncthreads();
  if (w != 0 || lane >= n) return;
#pragma unroll
  for (int i = 1; i < kW; ++i) v += part[i][lane];
  stats[lane] = (float)(lane == 0 ? 0.5 * v : v);
}

// Per instance: the dynamic shared memory each kernel is allowed.
struct LaunchCaches {
  wide::LaunchCache column, cross, gram;
};

// The pass's launches on `stream`: prep, the column pass, gA's product and
// its finalize, the statistics' finalize, and (the chain, K3) the Gram's
// product and its finalize. The kernels are the source's instances of the
// bodies above and of post::product_body. Returns cudaGetLastError().
template <typename ST, int MODE, typename Prep, typename Column,
          typename Cross, typename Gram, typename Fin, typename StatFin>
int launch(Prep prep_k, Column column_k, Cross cross_k, Gram gram_k,
           Fin fin_k, StatFin stat_k, LaunchCaches& lc,
           const Args<ST, float>& a, float* gA, float* gram, float* stats,
           cudaStream_t stream) {
  cudaError_t err;
  const int C = a.C, K = a.K;
  if (C < 1 || K <= tier::kKwideK || K > tier::kPanelK || a.N < 1 ||
      a.tile_n < 1)
    return (int)cudaErrorInvalidValue;
  const Layout L = layout(MODE, C, K, a.N, a.n_units);
  float* const scratch = a.partials;
  prep_k<<<2 * kBlocks, kThreads, 0, stream>>>(a.A, C, K, scratch + L.at,
                                               scratch + L.af);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int smem = column_smem(MODE);
  if (smem > lc.column.allowed_smem) {
    err = cudaFuncSetAttribute(
        column_k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    lc.column.allowed_smem = smem;
  }
  const long long blocks = column_blocks(a.N);
  column_k<<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // gA = D S^T (the old S)
  Args<ST, float> x = a;
  x.P = scratch + L.d;
  x.out = nullptr;
  x.partials = scratch + L.ga;
  int rc = post::launch<MODE, post::kCross, ST>(cross_k, fin_k, lc.cross, x,
                                                gA, nullptr, stream);
  if (rc != 0) return rc;
  stat_k<<<1, wide::kFinThreads, 0, stream>>>(
      scratch + L.stats, blocks, wide::entries(MODE, C, K).stats, stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (wide::has_gram(MODE)) {
    // the Gram of S' (the chain: the stored values) or of the old S (K3)
    Args<ST, float> g = a;
    if constexpr (MODE == wide::kPgm) g.S = a.out;
    g.P = nullptr;
    g.out = nullptr;
    g.partials = scratch + L.gram;
    rc = post::launch<MODE, post::kGram, ST>(gram_k, fin_k, lc.gram, g, gram,
                                             nullptr, stream);
    if (rc != 0) return rc;
  }
  return (int)cudaGetLastError();
}

}  // namespace panel
}  // namespace
