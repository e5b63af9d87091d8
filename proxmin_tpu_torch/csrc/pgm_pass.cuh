// The one-pass body that K1 (nmf_pgm_step.cu) and K3 (nmf_grad.cu) share:
// per pixel column n,
//
//   R  = A S[:,n] - Y[:,n]     exact f32 K-step FMA, summed over k in order
//   D  = W[:,n] * R  (or R)
//   g  = A^T D
//   gA += D S[:,n]^T            with the OLD column of S
//   and, in K1 (kStep):  S' = prox(S[:,n] - sS g), stored: max(., 0) or the
//                        identity inline; in K1's chain instances (kChain)
//                        any compiled chain (prox_chain.cuh) once the thread
//                        holds all K values;
//                        G += S' S'^T, stats += [D.R, |S' - S|^2, |S'|^2]
//   or,  in K3:          g stored as gS[:,n];
//                        G += S S^T,   stats += [D.R]
//
// What bounds both on an H100: bytes (see each kernel's source); what held
// the kernels before this design far from that bound was latency, and what
// holds them now is latency and instructions per sub-tile (the bfloat16
// store halves the bytes and saves little time). The design:
// - A ring of shared-memory stages (bulk_ring.cuh). A stage holds one
//   sub-tile of kSub pixel columns of every input row (S: K rows, Y and W: C
//   rows each). Where the rows and the sub-tile are 16-byte aligned, one
//   thread fills a stage with 1-D cp.async.bulk copies that complete on the
//   stage's mbarrier; otherwise (ragged N, bfloat16 rows of odd N) every
//   thread copies its column and arrives. Two to four stages are in flight.
// - Consumers compute from the stage, one column per thread, store S' (K1)
//   or gS (K3) straight to global memory, coalesced, and write D and (K1)
//   the stored S' as float32 to buffers beside the ring. The code is
//   straight-line over the compiled bounds (A's zero padding makes the
//   extra terms exact zeros); gS reads its own transposed copy of A, so the
//   compiler keeps no value of A live from the residual to gS.
// - gA and the Gram are summed by warps from the buffers and the stage's
//   old S: warp w takes the rows r = w, w + 8, ... of the C + K "rows" (gA
//   row c: D[c] times S[0..K); Gram row k: G[k] times G[0..k]), so each
//   loaded D[c][n] or G[k][n] feeds up to K products. A lane walks the
//   columns 4 lane + 128 h .. + 3 with 16-byte loads (8-byte ones of
//   bfloat16 S). A thread keeps only its warp's rows: at most 16 (C, K <= 8)
//   or 24 (C <= 16) sums, so the C, K <= 8 instances fit 64 registers and
//   four blocks per SM, the C <= 16 ones two.
// - Two sets of buffers, used in turn, where they fit beside two stages:
//   one barrier per sub-tile, and a warp that finishes its sums goes on to
//   the next sub-tile's columns. Otherwise one set and a second barrier. A
//   stage is refilled after the next sub-tile's barrier, when every warp's
//   sums over it are done.
// - A persistent grid of min(units, SMs x resident blocks) blocks. A work
//   unit is a part of at most kPart columns of a tile of tile_n columns;
//   unit u is walked by block u mod gridDim.x and writes its own row of
//   partial sums in a fixed order (lanes in order, then a shuffle tree, then
//   the warps in order), so the summation order depends on N and tile_n
//   alone, whatever the grid or the card: two launches give the same bits,
//   which the exact resumes rely on. No atomics. The cursors over units and
//   sub-tiles move by additions: a division only where a unit starts.
// - A second launch gives every entry one warp: the lanes sum the unit rows
//   in double from 16-byte loads, eight in flight, then a fixed shuffle tree
//   and one rounding. The partials are stored entry-major so that those
//   loads are coalesced.
// - The arithmetic of the residual, gS and the update is the kernels'
//   before this design: fmaf over k in order for R; fmaf over c in order for
//   g; NaN survives the prox (x < 0 ? 0 : x, never fmaxf); with the
//   bfloat16 store the residual takes A rounded to bfloat16, S' is stored
//   rounded to nearest even and the Gram and the statistics take the
//   rounded S'.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bulk_ring.cuh"
#include "prox_chain.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Pixel columns per ring stage: one per thread.
constexpr int kSub = kThreads;
// Pixel columns of one work unit (a part of a tile) at most: 977 units at
// N = 1e6 with tile_n = 4096 for 528 resident blocks. Units of 512 columns
// balance the grid better and take longer: twice the per-unit sums.
constexpr int kPart = 4 * kSub;
constexpr int kMaxStages = 4;
// Resident blocks per SM an instance is built for: four for C, K <= 8 (at
// most 64 registers), two for C <= 16. The dynamic shared memory a block
// may take and still leave room for that many (228 KB per SM, 1 KB of it
// reserved per block, the static arrays under 1 KB), and the most one block
// may take beside its static shared memory (227 KB in all).
template <int CB>
constexpr int kBlocksPerSM = CB <= 8 ? 4 : 2;
constexpr int smem_per_block(int blocks) { return (228 / blocks - 2) * 1024; }
constexpr int kSmemMax = 224 * 1024;

// Entries of one unit's partial sums; entry p of unit u is stored at
// partials[p * stride(n_units) + u], each entry's rows 16-byte aligned.
template <int CB, int KB, bool kStep>
struct Layout {
  static constexpr int kGA = 0;                            // (c, k) row-major
  static constexpr int kGram = CB * KB;                    // lower triangle (k, l <= k)
  static constexpr int kStats = kGram + KB * (KB + 1) / 2;  // D.R [, |dS|^2, |S'|^2]
  static constexpr int kNStats = kStep ? 3 : 1;
  static constexpr int kP = kStats + kNStats;
  // gA rows and Gram rows per warp
  static constexpr int kRows = (CB + KB + kWarps - 1) / kWarps;
};

__host__ __device__ inline long long parts_per_tile(long long tile_n) {
  return (tile_n + kPart - 1) / kPart;
}

__host__ __device__ inline long long stride(long long n_units) {
  return (n_units + 3) & ~3ll;
}

// Work units (rows of partial sums) for N columns in tiles of tile_n.
__host__ __device__ inline long long unit_count(long long N,
                                                long long tile_n) {
  const long long n_tiles = (N + tile_n - 1) / tile_n;
  const long long last = N - (n_tiles - 1) * tile_n;
  return (n_tiles - 1) * parts_per_tile(tile_n) + (last + kPart - 1) / kPart;
}

template <typename ST>
struct PassArgs {
  const float* A;       // (C, K)
  const ST* S;          // (K, N)
  const ST* Y;          // (C, N)
  const ST* W;          // (C, N) or null
  const float* step_S;  // K1: the step on the card
  int prox_plus;        // K1: 1 = max(., 0), 0 = identity (not kChain)
  int C, K;
  long long N, tile_n, n_units;
  ST* out;              // K1: S' (K, N); K3: gS (K, N)
  float* partials;      // (kP, stride(n_units))
};

// Byte offsets of the rows of one ring stage (each row kSub elements) and
// the stage's size.
struct Ring {
  int s, y, w, bytes;
};

inline Ring ring_layout(int C, int K, int ss, bool weighted) {
  Ring r;
  r.s = 0;
  r.y = K * kSub * ss;
  r.w = r.y + C * kSub * ss;
  r.bytes = r.w + (weighted ? C * kSub * ss : 0);
  return r;
}

// One set of float32 buffers beside the ring: D (C rows) and, in K1, the
// stored S' (K rows), each kSub columns.
__host__ __device__ inline int buffer_bytes(int C, int K, bool step) {
  return (C + (step ? K : 0)) * kSub * (int)sizeof(float);
}

// Four consecutive elements as float32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// acc[j] += sum over the lane's columns of vec[n] other[j][n], j < entries,
// each sum over the columns in order.
template <int KB, typename VT, typename OT>
__device__ __forceinline__ void row_products(float (&acc)[KB],
                                             const VT* vec,
                                             const OT* other, int entries,
                                             int lane) {
  constexpr int kH = kSub / 128;
  float4 v[kH];
#pragma unroll
  for (int h = 0; h < kH; ++h) v[h] = load4(vec + 128 * h + 4 * lane);
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    if (j < entries) {
      float a = acc[j];
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        const float4 o = load4(other + j * kSub + 128 * h + 4 * lane);
        a = fmaf(v[h].x, o.x, a);
        a = fmaf(v[h].y, o.y, a);
        a = fmaf(v[h].z, o.z, a);
        a = fmaf(v[h].w, o.w, a);
      }
      acc[j] = a;
    }
  }
}

// kChain: K1 applies `chain` to the K values of a column; the chain is a
// kernel parameter of the chain instances alone, so the other instances
// keep the parameter block and the code they had.
template <int CB, int KB, typename ST, bool kStep, bool kChain = false>
__device__ __forceinline__ void pass_body(const PassArgs<ST>& a, Ring ring,
                                          int stages, int sets,
                                          unsigned char* smem,
                                          ProxChain chain = ProxChain{}) {
  using L = Layout<CB, KB, kStep>;
  constexpr bool kF32 = std::is_same<ST, float>::value;
  constexpr int ss = sizeof(ST);
  static_assert(kStep || kF32, "K3 is float32 only");
  // A as the residual product takes it: A itself in f32; with the bfloat16
  // store, A rounded to bfloat16 (bfloat16 x bfloat16 products are exact in
  // f32). gS reads the transpose AT of the f32 A: a copy of its own, so that
  // the compiler keeps no value of A live from the residual to gS.
  __shared__ float Ar[CB][KB];
  __shared__ float AT[KB][CB];
  __shared__ float red[kWarps][L::kNStats];
  __shared__ __align__(8) uint64_t full[kMaxStages];

  const int C = a.C, K = a.K;
  const long long N = a.N;
  // D and S' in one set of buffers, or two used in turn (sets == 2)
  float* const bufs = reinterpret_cast<float*>(smem + stages * ring.bytes);
  const int set = buffer_bytes(C, K, kStep) / (int)sizeof(float);
  int half = 0;
  int prev = -1;  // the stage of the previous sub-tile, refilled after a sync

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < CB * KB; i += kThreads) {
    const int c = i / KB, k = i % KB;
    const float v = (c < C && k < K) ? a.A[c * K + k] : 0.f;
    AT[k][c] = v;
    Ar[c][k] = kF32 ? v : __bfloat162float(__float2bfloat16_rn(v));
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  float sS = 0.f;
  if constexpr (kStep) sS = *a.step_S;

  const bool weighted = a.W != nullptr;
  const bool base_aligned =
      ((reinterpret_cast<unsigned long long>(a.S) |
        reinterpret_cast<unsigned long long>(a.Y) |
        reinterpret_cast<unsigned long long>(a.W) |
        (unsigned long long)(N * ss)) & 15ull) == 0;
  const long long ppt = parts_per_tile(a.tile_n);
  // unit u covers the columns [begin, end)
  auto span = [&](long long u, long long& begin, long long& end) {
    const long long j = u / ppt, p = u % ppt;
    begin = j * a.tile_n + p * kPart;
    end = min(j * a.tile_n + min((p + 1) * (long long)kPart, a.tile_n), N);
  };
  // Fill stage st with the width columns from c0; every thread arrives
  // once.
  auto fill = [&](int st, long long c0, int width) {
    unsigned char* base = smem + st * ring.bytes;
    const bool bulk =
        base_aligned && (((unsigned long long)(c0 * ss) |
                          (unsigned long long)(width * ss)) & 15ull) == 0;
    if (bulk) {
      if (tid == 0) {
        // the stage was last read through the generic proxy
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        const uint32_t rows = K + C * (weighted ? 2 : 1);
        mbar_arrive_expect_tx(&full[st], (uint32_t)width * rows * ss);
        for (int k = 0; k < K; ++k)
          bulk_load(base + ring.s + k * kSub * ss, a.S + k * N + c0,
                    width * ss, &full[st]);
        for (int c = 0; c < C; ++c) {
          bulk_load(base + ring.y + c * kSub * ss, a.Y + c * N + c0,
                    width * ss, &full[st]);
          if (weighted)
            bulk_load(base + ring.w + c * kSub * ss, a.W + c * N + c0,
                      width * ss, &full[st]);
        }
      } else {
        mbar_arrive(&full[st]);
      }
      return;
    }
    if (tid < width) {
      ST* sS_ = reinterpret_cast<ST*>(base + ring.s);
      ST* sY = reinterpret_cast<ST*>(base + ring.y);
      ST* sW = reinterpret_cast<ST*>(base + ring.w);
      for (int k = 0; k < K; ++k) sS_[k * kSub + tid] = a.S[k * N + c0 + tid];
      for (int c = 0; c < C; ++c) {
        sY[c * kSub + tid] = a.Y[c * N + c0 + tid];
        if (weighted) sW[c * kSub + tid] = a.W[c * N + c0 + tid];
      }
    }
    mbar_arrive(&full[st]);
  };

  // The producer's cursor (unit pu, next column pc, the unit's end pe)
  // runs up to `stages` sub-tiles ahead of the consumers'. Both cursors
  // move by additions; a division only where a unit starts.
  long long pu = blockIdx.x, pc = 0, pe = 0;
  if (pu < a.n_units) span(pu, pc, pe);
  auto produce = [&](int st) {
    fill(st, pc, (int)min((long long)kSub, pe - pc));
    pc += kSub;
    if (pc >= pe) {
      pu += gridDim.x;
      if (pu < a.n_units) span(pu, pc, pe);
    }
  };
  for (int st = 0; st < stages && pu < a.n_units; ++st) produce(st);

  int st = 0;           // the consumers' stage
  uint32_t phase = 0;   // and its mbarrier phase parity
  for (long long u = blockIdx.x; u < a.n_units; u += gridDim.x) {
    long long ub, ue;
    span(u, ub, ue);
    float acc[L::kRows][KB];
#pragma unroll
    for (int i = 0; i < L::kRows; ++i) {
#pragma unroll
      for (int j = 0; j < KB; ++j) acc[i][j] = 0.f;
    }
    float st0 = 0.f, st1 = 0.f, st2 = 0.f;
    for (long long c0 = ub; c0 < ue; c0 += kSub) {
      mbar_wait(&full[st], phase);
      const int width = (int)min((long long)kSub, ue - c0);
      const unsigned char* base = smem + st * ring.bytes;
      const ST* sS_ = reinterpret_cast<const ST*>(base + ring.s);
      const ST* sY = reinterpret_cast<const ST*>(base + ring.y);
      const ST* sW = reinterpret_cast<const ST*>(base + ring.w);
      float* Dsm = bufs + half * set;
      float* Sn = Dsm + C * kSub;  // K1 only
      half = sets - 1 - half;

      if (tid < width) {
        const long long n = c0 + tid;
        // Straight-line over the compiled bounds: A is zero beyond (C, K)
        // and so are s[k >= K] and d[c >= C], so those terms add exact
        // zeros; only the loads and stores are guarded.
        float s[KB], d[CB];
#pragma unroll
        for (int k = 0; k < KB; ++k) {
          s[k] = k < K ? to_f32(sS_[k * kSub + tid]) : 0.f;
        }
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          float r = Ar[c][0] * s[0];
#pragma unroll
          for (int k = 1; k < KB; ++k) r = fmaf(Ar[c][k], s[k], r);
          float dc = 0.f;
          if (c < C) {
            r -= to_f32(sY[c * kSub + tid]);
            dc = weighted ? to_f32(sW[c * kSub + tid]) * r : r;
            Dsm[c * kSub + tid] = dc;
            st0 = fmaf(dc, r, st0);
          }
          d[c] = dc;
        }
#pragma unroll
        for (int k = 0; k < KB; ++k) {
          float g = 0.f;
#pragma unroll
          for (int c = 0; c < CB; ++c) g = fmaf(AT[k][c], d[c], g);
          if (k < K) {
            if constexpr (kStep) {
              float x = s[k] - sS * g;
              if constexpr (kChain) {  // the chain runs on all K values below
                Sn[k * kSub + tid] = x;
                continue;
              }
              // keeps NaN (fmaxf would turn it into 0 and hide a divergence)
              if (a.prox_plus && x < 0.f) x = 0.f;
              x = store(a.out, k * N + n, x);
              Sn[k * kSub + tid] = x;
              const float dk = x - s[k];
              st1 = fmaf(dk, dk, st1);
              st2 = fmaf(x, x, st2);
            } else {
              store(a.out, k * N + n, g);
            }
          }
        }
        if constexpr (kStep && kChain) {
          // the compiled chain, once the thread holds all K values of x
          float x[KB];
#pragma unroll
          for (int k = 0; k < KB; ++k)
            x[k] = k < K ? Sn[k * kSub + tid] : 0.f;
          apply_chain<KB>(chain, x, K, [&](int) { return sS; });
#pragma unroll
          for (int k = 0; k < KB; ++k) {
            if (k >= K) continue;
            const float xs = store(a.out, k * N + n, x[k]);
            Sn[k * kSub + tid] = xs;
            const float dk = xs - s[k];
            st1 = fmaf(dk, dk, st1);
            st2 = fmaf(xs, xs, st2);
          }
        }
      } else {
        // a ragged sub-tile's empty columns add exact zeros to the sums
        for (int c = 0; c < C; ++c) Dsm[c * kSub + tid] = 0.f;
        for (int k = 0; k < K; ++k) {
          const_cast<ST*>(sS_)[k * kSub + tid] = ST(0.f);
          if constexpr (kStep) Sn[k * kSub + tid] = 0.f;
        }
        // the stage is written by bulk copies again later
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      }
      __syncthreads();  // D (and S') are in the buffers; the previous
                        // sub-tile's sums are done
      if (prev >= 0 && pu < a.n_units) produce(prev);
      prev = st;

      // gA += D S^T and G += G G^T over the sub-tile, a row per warp
#pragma unroll
      for (int i = 0; i < L::kRows; ++i) {
        const int r = warp + i * kWarps;
        if (r < C) {
          row_products<KB>(acc[i], Dsm + r * kSub, sS_, K, lane);
        } else if (r < C + K) {
          if constexpr (kStep)
            row_products<KB>(acc[i], Sn + (r - C) * kSub, Sn, r - C + 1,
                             lane);
          else
            row_products<KB>(acc[i], sS_ + (r - C) * kSub, sS_, r - C + 1,
                             lane);
        }
      }
      // with one set, the next sub-tile's consumers must wait for these
      // sums; with two they write the other set
      if (sets == 1) __syncthreads();
      if (++st == stages) {
        st = 0;
        phase ^= 1u;
      }
    }

    // Unit u's row of partial sums, in a fixed order: each gA and Gram
    // entry's lanes by a shuffle tree; the statistics by a shuffle tree in
    // each warp, then the warps in order.
    float* P = a.partials;
    const long long U = stride(a.n_units);
#pragma unroll
    for (int i = 0; i < L::kRows; ++i) {
      const int r = warp + i * kWarps;
      if (r < C + K) {
        const int first = r < C ? L::kGA + r * KB
                                : L::kGram + (r - C) * (r - C + 1) / 2;
        const int entries = r < C ? K : r - C + 1;
#pragma unroll
        for (int j = 0; j < KB; ++j) {
          if (j < entries) {
            float v = acc[i][j];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              v += __shfl_down_sync(0xffffffffu, v, off);
            if (lane == 0) P[(first + j) * U + u] = v;
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < L::kNStats; ++e) {
      float v = e == 0 ? st0 : (e == 1 ? st1 : st2);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][e] = v;
    }
    __syncthreads();
    if (tid < L::kNStats) {
      float v = red[0][tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += red[w][tid];
      P[(L::kStats + tid) * U + u] = v;
    }
  }
}

// The second launch: one warp per entry; lane l sums the unit rows 4 q ..
// 4 q + 3 for q = l, l + 32, ... in order (in double, 16-byte loads, eight
// in flight), then a fixed shuffle tree, and lane 0 rounds once and writes
// gA (C x K), the Gram (K x K, both triangles) and stats: K1 [loss,
// |S' - S|^2, |S'|^2], K3 [loss]. Entries outside (C, K) are never written
// and never read.
template <int CB, int KB, bool kStep>
__device__ __forceinline__ void finalize_body(const float* partials,
                                              long long n_units, int C, int K,
                                              float* gA, float* gram,
                                              float* stats) {
  using L = Layout<CB, KB, kStep>;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= L::kP) return;  // whole warps return
  int k = 0, l = 0;
  if (p < L::kGram) {
    if (p / KB >= C || p % KB >= K) return;
  } else if (p < L::kStats) {
    const int t = p - L::kGram;
    while ((k + 1) * (k + 2) / 2 <= t) ++k;
    l = t - k * (k + 1) / 2;
    if (k >= K) return;
  }
  const float* col = partials + (long long)p * stride(n_units);
  const long long quads = (n_units + 3) / 4;
  double v = 0.0;
  for (long long q0 = lane; q0 < quads; q0 += 8 * 32) {
    float4 x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long b = 4 * (q0 + 32 * i);
      if (b + 3 < n_units) {
        x[i] = *reinterpret_cast<const float4*>(col + b);
      } else {  // the last quad's rows past n_units add zeros
        x[i].x = b < n_units ? col[b] : 0.f;
        x[i].y = b + 1 < n_units ? col[b + 1] : 0.f;
        x[i].z = b + 2 < n_units ? col[b + 2] : 0.f;
        x[i].w = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v += (double)x[i].x;
      v += (double)x[i].y;
      v += (double)x[i].z;
      v += (double)x[i].w;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane != 0) return;
  if (p < L::kGram) {
    gA[(p / KB) * K + p % KB] = (float)v;
  } else if (p < L::kStats) {
    gram[k * K + l] = (float)v;
    gram[l * K + k] = (float)v;
  } else {
    const int i = p - L::kStats;
    stats[i] = (float)(i == 0 ? 0.5 * v : v);
  }
}

// Per kernel instance: the SM count, the dynamic shared memory the kernel
// is allowed (raised before the first launch that needs more than 48 KB),
// and the resident blocks per SM at the last size asked for.
struct LaunchCache {
  int sms = 0, allowed_smem = 0, smem = -1, per_sm = 0;
};

// Both launches of one pass on `stream`: the persistent grid over the
// units, then the finalize; `extra` follows the kernel's usual parameters.
// Returns cudaGetLastError() after them.
template <int CB, int KB, typename ST, bool kStep, typename Kernel,
          typename Finalize, typename... Extra>
int launch_pass(Kernel kernel, Finalize finalize, LaunchCache& lc,
                const PassArgs<ST>& args, float* gA, float* gram,
                float* stats, cudaStream_t stream, Extra... extra) {
  cudaError_t err;
  if (lc.sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    err = cudaDeviceGetAttribute(&lc.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const Ring ring =
      ring_layout(args.C, args.K, (int)sizeof(ST), args.W != nullptr);
  // two sets of buffers (one barrier per sub-tile) where they leave room
  // for two stages at the resident blocks the instance is built for, else
  // one set (two barriers)
  const int set = buffer_bytes(args.C, args.K, kStep);
  const int budget = smem_per_block(kBlocksPerSM<CB>);
  const int sets = budget - 2 * set >= 2 * ring.bytes ? 2 : 1;
  int stages = (budget - sets * set) / ring.bytes;
  stages = stages < 2 ? 2 : (stages > kMaxStages ? kMaxStages : stages);
  const int smem = stages * ring.bytes + sets * set;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > lc.allowed_smem) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    lc.allowed_smem = smem;
  }
  if (smem != lc.smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&lc.per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (lc.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    lc.smem = smem;
  }
  const long long resident = (long long)lc.sms * lc.per_sm;
  const unsigned grid =
      (unsigned)(args.n_units < resident ? args.n_units : resident);
  kernel<<<grid, kThreads, smem, stream>>>(args, ring, stages, sets,
                                           extra...);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int kFinalBlocks =
      (Layout<CB, KB, kStep>::kP + kWarps - 1) / kWarps;
  finalize<<<kFinalBlocks, kThreads, 0, stream>>>(
      args.partials, args.n_units, args.C, args.K, gA, gram, stats);
  return (int)cudaGetLastError();
}

}  // namespace
