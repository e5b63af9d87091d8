// The wide body of K1 (nmf_pgm_wide.cu), K2 (nmf_adaprox_wide.cu) and K3
// (nmf_grad.cu): one pass over the pixel columns for any C <= 256 channels
// and K <= 32 components, and the two passes of the split path, where a
// prox_S that no compiled chain covers runs in PyTorch between them.
//
// Why the narrow body (pgm_pass.cuh) cannot just be built wider: its ring
// stage holds all C rows of Y (and W) for 256 columns, 128 KB at C = 128 in
// float32 unweighted and 256 KB weighted, against about 224 KB per block;
// and each of its threads keeps (C + K) / 8 rows of K sums in registers,
// 640 at C = 128, K = 32. Here neither grows with C:
//
// - A block takes one work unit, a part of at most kPart columns of a tile
//   of tile_n columns (the narrow body's units), and walks it in sub-tiles
//   of kSub columns, one column per thread. A thread reads its column of S
//   (and of Y, W, M, V) straight from global memory, coalesced across the
//   warp, and keeps its K values of S and of the gradient gS in registers.
// - The channels are looped in chunks of kChunk: for each channel c the
//   thread forms the residual r = A[c,:] s - y (an exact-f32 FMA over k in
//   order, as the narrow body and the TPU kernel's "fma" path), d = w r (or
//   r), adds d A[c,:] to gS (fmaf over c in order) and writes d to the
//   chunk's rows of a shared-memory buffer. A is read from shared memory,
//   every thread at the same address.
// - After each chunk the block sums gA's (c, k) entries of the chunk over
//   the sub-tile's columns, D times the old S in shared memory: thread t
//   owns the entries k = t mod KB, c in KB / 8 consecutive rows, each a sum
//   over the columns in order (float4 loads; the D row is read by the whole
//   warp at one address, the S rows of a warp's lanes hit different banks).
//   A thread adds each sum into its own slot in shared memory, so a unit's
//   sums depend on the columns' order alone. The Gram (of S' in K1, of the
//   old S in K3) is one more chunk of K rows, the same routine; K2's row
//   sums of S' are eight threads per row and a fixed shuffle tree.
// - The epilogue of a column is the kernel's: K3 stores gS; K1 forms x = s
//   - sS gS for all K components and applies the compiled prox chain
//   (prox_chain.cuh), then stores S' and the rounded S' for the Gram; K2
//   forms the moments, Phi, Psi and x, then the chain with the per-element
//   step alpha_k / Psi_safe. The split path's first pass stores x (and K2's
//   step) in float32 instead; its second pass takes the prox's output P and
//   gives the Gram (K1) or the row sums (K2) and [|S' - S|^2, |S'|^2],
//   storing S' rounded to bfloat16 with the bfloat16 store.
// - Each unit writes its own row of partial sums, entry-major as the narrow
//   body's; a second launch gives every entry one warp, which sums the unit
//   rows in double in a fixed order and rounds once. No atomics: two
//   launches give the same bits, whatever the grid or the card, and the
//   summation order depends on N and tile_n alone.
// - Columns past N in a unit's last sub-tile add exact zeros: their S, D
//   and S' entries in shared memory are zeros.
//
// What bounds it on an H100 at C = 128, K = 32: the float32 FMAs, about
// (3 C K + K^2) per pixel column (the residual, gS, gA and the Gram), 13.3e9
// at N = 1e6, 0.40 ms at 67 TFLOP/s, against (C + 2K) N 4 = 0.77 GB of
// naive bytes, 0.23 ms at 3.35 TB/s. No tensor cores: TF32 would round the
// residual's operands.

#pragma once

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bulk_ring.cuh"
#include "prox_chain.cuh"

namespace {
namespace wide {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = kThreads;   // columns per sub-tile, one per thread
constexpr int kPart = 4 * kSub;  // columns per work unit at most
constexpr int kRP = kSub + 4;    // pitch of a shared row (floats)
constexpr int kChunk = 32;       // channels per chunk
constexpr int kMaxC = 256;
constexpr int kMaxK = 32;
constexpr int kSmemMax = 224 * 1024;

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

// The entries of one unit's row of partial sums: gA (C K), the Gram (K K,
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

__host__ __device__ inline long long parts_per_tile(long long tile_n) {
  return (tile_n + kPart - 1) / kPart;
}
__host__ __device__ inline long long stride(long long n_units) {
  return (n_units + 3) & ~3ll;
}
__host__ __device__ inline long long unit_count(long long N,
                                                long long tile_n) {
  const long long n_tiles = (N + tile_n - 1) / tile_n;
  const long long last = N - (n_tiles - 1) * tile_n;
  return (n_tiles - 1) * parts_per_tile(tile_n) + (last + kPart - 1) / kPart;
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
  float* partials;      // (entries, stride(n_units))
};

// Shared memory, in floats from the dynamic base.
struct Smem {
  int ar, af, s, x, slots, total;  // offsets and the size, in floats
  int n_slots;                     // slots per thread
};
template <int KB>
__host__ __device__ inline Smem smem_layout(int mode, int C, bool bf16) {
  constexpr int E = KB / 8;
  Smem m;
  const int ca = has_residual(mode) ? C * KB : 0;
  m.ar = 0;
  m.af = ca;
  m.s = m.af + (bf16 ? ca : 0);
  m.x = m.s + KB * kRP;
  m.slots = m.x + kChunk * kRP;
  const int chunks = has_residual(mode) ? (C + kChunk - 1) / kChunk : 0;
  m.n_slots = (chunks + (has_gram(mode) ? 1 : 0)) * E;
  m.total = m.slots + m.n_slots * kThreads + kMaxK;  // + the row sums
  return m;
}

// slots[j * kThreads + tid] += sum over the sub-tile's columns of
// X[r][n] Z[k][n] for the thread's entries k = tid mod KB and
// r = E (tid / KB) + j, j < E, r < rows, k < K. X and Z are rows of kRP.
template <int KB>
__device__ __forceinline__ void chunk_products(float* slots, const float* X,
                                               int rows, const float* Z,
                                               int K) {
  constexpr int E = KB / 8;
  const int tid = threadIdx.x;
  const int k = tid % KB, r0 = E * (tid / KB);
  if (k >= K || r0 >= rows) return;
  float acc[E];
#pragma unroll
  for (int j = 0; j < E; ++j) acc[j] = slots[j * kThreads + tid];
  const float* z = Z + k * kRP;
  const float* x = X + r0 * kRP;
#pragma unroll 4
  for (int n = 0; n < kSub; n += 4) {
    const float4 zv = *reinterpret_cast<const float4*>(z + n);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const float4 xv = *reinterpret_cast<const float4*>(x + j * kRP + n);
      float a = acc[j];
      a = fmaf(xv.x, zv.x, a);
      a = fmaf(xv.y, zv.y, a);
      a = fmaf(xv.z, zv.z, a);
      a = fmaf(xv.w, zv.w, a);
      acc[j] = a;
    }
  }
#pragma unroll
  for (int j = 0; j < E; ++j)
    if (r0 + j < rows) slots[j * kThreads + tid] = acc[j];
}

// rowsum[k] += the sum of row k of X over the sub-tile: eight threads per
// row, 32 columns each in order, then a fixed shuffle tree.
__device__ __forceinline__ void row_sums(float* rowsum, const float* X,
                                         int K) {
  const int tid = threadIdx.x, k = tid / 8, q = tid % 8;
  float v = 0.f;
  if (k < K) {
    const float* x = X + k * kRP + q * 32;
#pragma unroll 8
    for (int n = 0; n < 32; ++n) v += x[n];
  }
  v += __shfl_down_sync(0xffffffffu, v, 4, 8);
  v += __shfl_down_sync(0xffffffffu, v, 2, 8);
  v += __shfl_down_sync(0xffffffffu, v, 1, 8);
  if (k < K && q == 0) rowsum[k] += v;
}

template <int KB, typename ST, typename MT, int MODE>
__device__ __forceinline__ void body(const Args<ST, MT>& a, float* sm) {
  constexpr bool kF32 = std::is_same<ST, float>::value;
  constexpr int E = KB / 8;
  const int C = a.C, K = a.K;
  const long long N = a.N;
  const Smem L = smem_layout<KB>(MODE, C, !kF32);
  float* const Ar = sm + L.ar;
  float* const Af = kF32 ? Ar : sm + L.af;
  float* const Ssm = sm + L.s;
  float* const Xsm = sm + L.x;
  float* const slots = sm + L.slots;
  float* const rsum = slots + L.n_slots * kThreads;
  __shared__ float red[kWarps][3];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long u = blockIdx.x;
  if constexpr (has_residual(MODE)) {
    for (int i = tid; i < C * KB; i += kThreads) {
      const int c = i / KB, k = i % KB;
      const float v = k < K ? a.A[c * K + k] : 0.f;
      Af[i] = v;
      if constexpr (!kF32) Ar[i] = __bfloat162float(__float2bfloat16_rn(v));
    }
  }
  for (int j = 0; j < L.n_slots; ++j) slots[j * kThreads + tid] = 0.f;
  if (tid < kMaxK) rsum[tid] = 0.f;
  __syncthreads();

  float sS = 0.f;
  if constexpr (MODE == kPgm || MODE == kPgmPre) sS = *a.step_S;
  float b1_t = a.b1_t, bc1 = a.bc1, bc2 = a.bc2;
  if constexpr (MODE == kAda || MODE == kAdaPre) {
    if (a.dsc != nullptr) {
      b1_t = a.dsc[0];
      bc1 = a.dsc[1];
      bc2 = a.dsc[2];
    }
  }
  // (1 - b1_t) in f32, as the TPU kernel computes it from its f32 scalar
  const float one_minus_b1 = __fsub_rn(1.f, b1_t);

  const long long ppt = parts_per_tile(a.tile_n);
  const long long jt = u / ppt, pt = u % ppt;
  const long long ub = jt * a.tile_n + pt * kPart;
  const long long ue =
      min(jt * a.tile_n + min((pt + 1) * (long long)kPart, a.tile_n), N);
  const bool weighted = a.W != nullptr;
  float st0 = 0.f, st1 = 0.f, st2 = 0.f;

  for (long long c0 = ub; c0 < ue; c0 += kSub) {
    const bool valid = c0 + tid < ue;
    const long long n = c0 + tid;
    float s[KB], g[KB];
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      s[k] = (valid && k < K) ? to_f32(a.S[k * N + n]) : 0.f;
      Ssm[k * kRP + tid] = s[k];
      g[k] = 0.f;
    }

    if constexpr (has_residual(MODE)) {
      for (int cc = 0; cc < C; cc += kChunk) {
        const int rows = min(kChunk, C - cc);
        for (int i = 0; i < rows; i += 4) {
          float y[4], w[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool ok = valid && i + j < rows;
            const long long gi = (long long)(cc + i + j) * N + n;
            y[j] = ok ? to_f32(a.Y[gi]) : 0.f;
            w[j] = (ok && weighted) ? to_f32(a.W[gi]) : 0.f;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (i + j >= rows) break;
            const float* ar = Ar + (cc + i + j) * KB;
            const float* af = Af + (cc + i + j) * KB;
            float r = ar[0] * s[0];
#pragma unroll
            for (int k = 1; k < KB; ++k) r = fmaf(ar[k], s[k], r);
            r -= y[j];
            float d = weighted ? w[j] * r : r;
            if (!valid) d = 0.f;
            st0 = fmaf(d, r, st0);
            Xsm[(i + j) * kRP + tid] = d;
#pragma unroll
            for (int k = 0; k < KB; ++k) g[k] = fmaf(af[k], d, g[k]);
          }
        }
        __syncthreads();  // D of the chunk and S are in shared memory
        chunk_products<KB>(slots + (cc / kChunk) * E * kThreads, Xsm, rows,
                           Ssm, K);
        __syncthreads();  // the chunk's buffer is free again
      }
    }

    // the epilogue of the column: x (K values) and what is stored
    if constexpr (MODE == kGrad) {
#pragma unroll
      for (int k = 0; k < KB; ++k)
        if (valid && k < K) a.out[k * N + n] = g[k];
    } else if constexpr (MODE == kPgm || MODE == kPgmPre) {
#pragma unroll
      for (int k = 0; k < KB; ++k) g[k] = s[k] - sS * g[k];
      if constexpr (MODE == kPgmPre) {
#pragma unroll
        for (int k = 0; k < KB; ++k)
          if (valid && k < K) a.pre[k * N + n] = g[k];
      } else {
        apply_chain<KB>(a.chain, g, K, [&](int) { return sS; });
      }
    } else if constexpr (MODE == kAda || MODE == kAdaPre) {
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        if (k >= K) continue;
        const long long gi = k * N + n;
        const float m0 = valid ? to_f32(a.M[gi]) : 0.f;
        const float v0 = valid ? to_f32(a.V[gi]) : 0.f;
        const float gk = g[k];
        const float m1 = __fadd_rn(__fmul_rn(one_minus_b1, gk),
                                   __fmul_rn(b1_t, m0));
        const float v1 = __fadd_rn(__fmul_rn(a.one_minus_b2, __fmul_rn(gk, gk)),
                                   __fmul_rn(a.b2, v0));
        const float phi = __fmul_rn(m1, bc1);
        const float psi = __fadd_rn(__fsqrt_rn(__fmul_rn(v1, bc2)), a.eps);
        const float psi_safe = (psi < FLT_MIN) ? FLT_MIN : psi;  // keeps NaN
        const float al = a.alpha[k];
        g[k] = __fsub_rn(s[k], __fmul_rn(al, __fdiv_rn(phi, psi_safe)));
        const float stp = __fdiv_rn(al, psi_safe);
        if (valid) {
          store(a.M_out, gi, m1);
          store(a.V_out, gi, v1);
          if constexpr (MODE == kAdaPre) {
            a.pre[gi] = g[k];
            a.pre_step[gi] = stp;
          }
        }
        Xsm[k * kRP + tid] = stp;
      }
      if constexpr (MODE == kAda)
        apply_chain<KB>(a.chain, g, K, [&](int k) { return Xsm[k * kRP + tid]; });
    } else {  // kPgmPost, kAdaPost: x is the prox's output
#pragma unroll
      for (int k = 0; k < KB; ++k)
        g[k] = (valid && k < K) ? a.P[k * N + n] : 0.f;
    }

    if constexpr (has_update(MODE)) {
      // store S' and keep the stored values for the sums
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        if (k >= K) continue;
        float xs = 0.f;
        if (valid) {
          xs = g[k];
          if (a.out != nullptr) xs = store(a.out, k * N + n, xs);
          const float dk = xs - s[k];
          st1 = fmaf(dk, dk, st1);
          st2 = fmaf(xs, xs, st2);
        }
        Xsm[k * kRP + tid] = xs;
      }
      __syncthreads();  // S' is in shared memory
      if constexpr (has_gram(MODE))
        chunk_products<KB>(slots + (L.n_slots - E) * kThreads, Xsm, K, Xsm,
                           K);
      else
        row_sums(rsum, Xsm, K);
    } else if constexpr (MODE == kGrad) {
      chunk_products<KB>(slots + (L.n_slots - E) * kThreads, Ssm, K, Ssm, K);
    }
    __syncthreads();  // the buffers are free for the next sub-tile
  }

  // the unit's row of partial sums
  const Entries e = entries(MODE, C, K);
  float* P = a.partials;
  const long long U = stride(a.n_units);
  {
    const int k = tid % KB, r0 = E * (tid / KB);
    if (k < K) {
      const int chunks = has_residual(MODE) ? (C + kChunk - 1) / kChunk : 0;
      for (int ch = 0; ch < chunks; ++ch) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const int c = ch * kChunk + r0 + j;
          if (c < C)
            P[(long long)(c * K + k) * U + u] =
                slots[(ch * E + j) * kThreads + tid];
        }
      }
      if constexpr (has_gram(MODE)) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const int r = r0 + j;
          if (r < K)
            P[(long long)(e.ga + r * K + k) * U + u] =
                slots[(L.n_slots - E + j) * kThreads + tid];
        }
      }
    }
    if constexpr (has_rowsum(MODE)) {
      if (tid < K) P[(long long)(e.ga + tid) * U + u] = rsum[tid];
    }
  }
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
    // [loss] from st0, [|S' - S|^2, |S'|^2] from st1, st2
    const int first = has_residual(MODE) ? 0 : 1;
    const int i = tid - first;
    if (tid >= first && i < e.stats)
      P[(long long)(e.ga + e.mid + i) * U + u] = v;
  }
}

// The second launch: one warp per entry; lane l sums the unit rows l,
// l + 32, ... in order in double, then a fixed shuffle tree, and lane 0
// rounds once: gA (C K), mid (the Gram K K or the row sums K), stats (the
// loss halved when `half_first`).
__device__ __forceinline__ void finalize(const float* partials,
                                         long long n_units, Entries e,
                                         bool half_first, float* gA,
                                         float* mid, float* stats) {
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= e.total) return;  // whole warps return
  const float* col = partials + (long long)p * stride(n_units);
  double v = 0.0;
  for (long long b = lane; b < n_units; b += 32) v += (double)col[b];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane != 0) return;
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

// Both launches of one pass on `stream`: a block per unit, then the
// finalize. Returns cudaGetLastError() after them.
template <int KB, typename ST, typename MT, int MODE, typename Kernel,
          typename Finalize>
int launch(Kernel kernel, Finalize fin, LaunchCache& lc,
           const Args<ST, MT>& args, float* gA, float* mid, float* stats,
           cudaStream_t stream) {
  cudaError_t err;
  if (args.C < 1 || args.C > kMaxC || args.K < 1 || args.K > KB ||
      args.N < 1 || args.tile_n < 1)
    return (int)cudaErrorInvalidValue;
  const Smem L =
      smem_layout<KB>(MODE, args.C, !std::is_same<ST, float>::value);
  const int smem = L.total * (int)sizeof(float);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > lc.allowed_smem) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    lc.allowed_smem = smem;
  }
  if (args.n_units > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)args.n_units, kThreads, smem, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Entries e = entries(MODE, args.C, args.K);
  fin<<<(e.total + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      args.partials, args.n_units, e, has_residual(MODE), gA, mid, stats);
  return (int)cudaGetLastError();
}

// The component bound of the instance that serves K, or 0 beyond 32.
inline int kb_for(int K) {
  return K <= 8 ? 8 : (K <= 16 ? 16 : (K <= kMaxK ? 32 : 0));
}

}  // namespace wide
}  // namespace
