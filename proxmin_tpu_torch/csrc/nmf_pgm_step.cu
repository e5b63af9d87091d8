// K1: one S-side PGM-NMF iteration in a single pass over the pixel columns.
//
// Replaces the Pallas TPU kernel proxmin_tpu/ops/nmf_kernels.py:311
// (fused_nmf_pgm_step; body _pgm_step_kernel :233; residual product
// _residual_dot :63, its "fma" path :82-89). Per pixel column n:
//
//   R   = A S[:,n] - Y[:,n]          exact f32 K-step FMA, summed over k in order
//   D   = W[:,n] * R  (or R)
//   gS  = A^T D
//   S'  = max(S[:,n] - sS gS, 0)     (or S[:,n] - sS gS, the identity prox)
//   gA += D S[:,n]^T                 with the OLD column of S
//   G  += S' S'^T                    the Gram of the stored S', the next
//                                    iteration's Lipschitz input
//   stats += [D.R, |S' - S|^2, |S'|^2]   (loss = D.R / 2)
//
// S, Y and W are stored as float or as bfloat16 (the store type, a
// template parameter); compute is f32 either way. With the bfloat16 store,
// as in the TPU kernel (nmf_kernels.py:259-308): the residual multiplies A
// rounded to bfloat16 by the bfloat16 S (each product exact in f32, summed
// in f32), gS uses the f32 A, S' is stored rounded to nearest even, and the
// Gram and the statistics use the rounded S' (the values the next iteration
// reads back); gA uses the old S.
//
// What bounds it on an H100: bytes. Each iteration reads Y (C x N) and S
// (K x N) and writes S' (K x N): (C + 2K) N 4 bytes in f32, 76 MB at the
// flagship C=5, K=7, N=1e6, which is 23 us at 3.35 TB/s (plus C N 4 bytes
// when W streams); half that with the bfloat16 store (38 MB, 48 MB with W).
// The arithmetic, about 2N(3CK + K(K+1)/2) flops, is 0.26 GFLOP at the
// flagship, far below what the card's f32 units do in that time.
//
// What the design does about it:
// - Each thread takes one column at a time; a block of 256 threads walks a
//   tile of tile_n consecutive columns, neighbouring threads on
//   neighbouring columns, so every row load and store of a warp is one
//   coalesced 128-byte transaction and every byte moves once. The ragged
//   edge of N is skipped, never masked by multiplying.
// - C and K have compile-time bounds (CB, KB) so the per-column vectors and
//   the per-thread partial sums stay in registers. Rows and columns beyond
//   the runtime C and K are skipped and their sums stay exactly zero.
// - No tensor cores: the products are f32 FMAs, the TPU kernel's "fma"
//   path (a one-pass reduced-precision residual stalls the fixed-point
//   test; see proxmin_tpu/precision.py).
// - No atomics. The TPU grid runs in order and carries its sums from tile
//   to tile; CTAs here run concurrently. Each block reduces its partial
//   sums in a fixed tree order (warp shuffles, then the warps in order)
//   and writes one row to a scratch buffer; a second launch sums the rows
//   in block order. Every run gives the same bits, which the exact resume
//   relies on.
// Making it fast (vector loads, TMA, a persistent grid) is later work.

#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Row layout of one block's partial sums.
template <int CB, int KB>
struct Layout {
  static constexpr int kGA = 0;                          // (c, k) row-major
  static constexpr int kGram = CB * KB;                  // lower triangle (k, l <= k)
  static constexpr int kStats = kGram + KB * (KB + 1) / 2;  // D.R, |dS|^2, |S'|^2
  static constexpr int kP = kStats + 3;
};

__device__ __forceinline__ float load(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
// Stores v and returns the value stored, as the next iteration reads it.
__device__ __forceinline__ float store(float* p, long long i, float v) {
  p[i] = v;
  return v;
}
__device__ __forceinline__ float store(__nv_bfloat16* p, long long i,
                                       float v) {
  const __nv_bfloat16 b = __float2bfloat16_rn(v);
  p[i] = b;
  return __bfloat162float(b);
}

template <int CB, int KB, typename ST>
__global__ void __launch_bounds__(kThreads)
pgm_step_kernel(const float* __restrict__ A, const ST* __restrict__ S,
                const ST* __restrict__ Y, const ST* __restrict__ W,
                const float* __restrict__ step_S, int prox_plus, int C,
                int K, long long N, long long tile_n,
                ST* __restrict__ S_new, float* __restrict__ partials) {
  using L = Layout<CB, KB>;
  constexpr bool kF32 = std::is_same<ST, float>::value;
  __shared__ float As[CB][KB];
  // A as the residual product takes it: A itself in f32; with the bfloat16
  // store, A rounded to bfloat16 (bfloat16 x bfloat16 products are exact in
  // f32). The f32 instance reads As for both, as before the store type.
  __shared__ float A16[kF32 ? 1 : CB][KB];
  float (*Ar)[KB] = kF32 ? As : A16;
  __shared__ float red[kWarps][L::kP];

  for (int i = threadIdx.x; i < CB * KB; i += kThreads) {
    const int c = i / KB, k = i % KB;
    const float a = (c < C && k < K) ? A[c * K + k] : 0.f;
    As[c][k] = a;
    if constexpr (!kF32) A16[c][k] = __bfloat162float(__float2bfloat16_rn(a));
  }
  __syncthreads();
  const float sS = *step_S;

  float acc[L::kP];
#pragma unroll
  for (int p = 0; p < L::kP; ++p) acc[p] = 0.f;

  const long long begin = (long long)blockIdx.x * tile_n;
  const long long end = min(begin + tile_n, N);
  for (long long n = begin + threadIdx.x; n < end; n += kThreads) {
    float s[KB], d[CB], sn[KB];
#pragma unroll
    for (int k = 0; k < KB; ++k) s[k] = (k < K) ? load(S, k * N + n) : 0.f;

#pragma unroll
    for (int c = 0; c < CB; ++c) {
      float r = 0.f, dc = 0.f;
      if (c < C) {
        r = Ar[c][0] * s[0];
#pragma unroll
        for (int k = 1; k < KB; ++k) {
          if (k < K) r = fmaf(Ar[c][k], s[k], r);
        }
        r -= load(Y, c * N + n);
        dc = (W != nullptr) ? load(W, c * N + n) * r : r;
      }
      d[c] = dc;
      acc[L::kStats] = fmaf(dc, r, acc[L::kStats]);
    }

#pragma unroll
    for (int k = 0; k < KB; ++k) {
      float x = 0.f;
      if (k < K) {
        float g = 0.f;
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          if (c < C) g = fmaf(As[c][k], d[c], g);
        }
        x = s[k] - sS * g;
        // keeps NaN (fmaxf would turn it into 0 and hide a divergence)
        if (prox_plus && x < 0.f) x = 0.f;
        x = store(S_new, k * N + n, x);
      }
      sn[k] = x;
    }

#pragma unroll
    for (int c = 0; c < CB; ++c) {
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        if (c < C && k < K)
          acc[L::kGA + c * KB + k] = fmaf(d[c], s[k], acc[L::kGA + c * KB + k]);
      }
    }
#pragma unroll
    for (int k = 0; k < KB; ++k) {
#pragma unroll
      for (int l = 0; l <= k; ++l) {
        if (k < K)
          acc[L::kGram + k * (k + 1) / 2 + l] =
              fmaf(sn[k], sn[l], acc[L::kGram + k * (k + 1) / 2 + l]);
      }
      if (k < K) {
        const float dk = sn[k] - s[k];
        acc[L::kStats + 1] = fmaf(dk, dk, acc[L::kStats + 1]);
        acc[L::kStats + 2] = fmaf(sn[k], sn[k], acc[L::kStats + 2]);
      }
    }
  }

  // Fixed-order block reduction: a shuffle tree inside each warp, then the
  // warps summed in order by one thread per entry.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < L::kP; ++p) {
    float v = acc[p];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][p] = v;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < L::kP; p += kThreads) {
    float v = red[0][p];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[w][p];
    partials[(long long)blockIdx.x * L::kP + p] = v;
  }
}

// Second launch: one thread per entry sums the blocks' rows in block order
// (in double, then rounds once) and writes gA (C x K), the Gram (K x K,
// both triangles) and stats = [loss, |S' - S|^2, |S'|^2].
template <int CB, int KB>
__global__ void __launch_bounds__(kThreads)
pgm_step_finalize(const float* __restrict__ partials, long long n_blocks,
                  int C, int K, float* __restrict__ gA,
                  float* __restrict__ gram, float* __restrict__ stats) {
  using L = Layout<CB, KB>;
  static_assert(L::kP <= kThreads, "one thread per partial-sum entry");
  const int p = threadIdx.x;
  if (p >= L::kP) return;
  double v = 0.0;
  for (long long b = 0; b < n_blocks; ++b) v += (double)partials[b * L::kP + p];
  if (p < L::kGram) {
    const int c = p / KB, k = p % KB;
    if (c < C && k < K) gA[c * K + k] = (float)v;
  } else if (p < L::kStats) {
    const int t = p - L::kGram;
    int k = 0;
    while ((k + 1) * (k + 2) / 2 <= t) ++k;
    const int l = t - k * (k + 1) / 2;
    if (k < K) {
      gram[k * K + l] = (float)v;
      gram[l * K + k] = (float)v;
    }
  } else {
    const int i = p - L::kStats;
    stats[i] = (float)(i == 0 ? 0.5 * v : v);
  }
}

template <int CB, int KB, typename ST>
int launch(const float* A, const void* S, const void* Y, const void* W,
           const float* step_S, int prox_plus, int C, int K, long long N,
           long long tile_n, void* S_new, float* gA, float* gram,
           float* stats, float* partials, cudaStream_t stream) {
  const long long n_blocks = (N + tile_n - 1) / tile_n;
  pgm_step_kernel<CB, KB, ST><<<(unsigned)n_blocks, kThreads, 0, stream>>>(
      A, static_cast<const ST*>(S), static_cast<const ST*>(Y),
      static_cast<const ST*>(W), step_S, prox_plus, C, K, N, tile_n,
      static_cast<ST*>(S_new), partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pgm_step_finalize<CB, KB><<<1, kThreads, 0, stream>>>(
      partials, n_blocks, C, K, gA, gram, stats);
  return (int)cudaGetLastError();
}

template <int CB, int KB>
int launch_store(int store_bf16, const float* A, const void* S, const void* Y,
                 const void* W, const float* step_S, int prox_plus, int C,
                 int K, long long N, long long tile_n, void* S_new, float* gA,
                 float* gram, float* stats, float* partials,
                 cudaStream_t stream) {
  if (store_bf16)
    return launch<CB, KB, __nv_bfloat16>(A, S, Y, W, step_S, prox_plus, C, K,
                                         N, tile_n, S_new, gA, gram, stats,
                                         partials, stream);
  return launch<CB, KB, float>(A, S, Y, W, step_S, prox_plus, C, K, N,
                               tile_n, S_new, gA, gram, stats, partials,
                               stream);
}

}  // namespace

extern "C" {

// Width of one block's row of partial sums for a (C, K) problem, or -1
// when no compiled bound covers it. The caller allocates the scratch
// buffer as (ceil(N / tile_n), width) floats.
int nmf_pgm_step_partials_width(int C, int K) {
  if (C >= 1 && K >= 1 && C <= 8 && K <= 8) return Layout<8, 8>::kP;
  if (C >= 1 && K >= 1 && C <= 16 && K <= 8) return Layout<16, 8>::kP;
  return -1;
}

// One fused step on `stream`. All pointers are device pointers to
// contiguous row-major arrays: A (C, K), step_S (1,), gA (C, K), gram
// (K, K), stats (3,) and partials (ceil(N / tile_n), width) float32; S and
// S_new (K, N), Y and W (C, N; W may be null) float32, or bfloat16 when
// store_bf16 is 1. Returns cudaGetLastError() after the launches (0 on
// success); does not synchronize.
int nmf_pgm_step(const void* A, const void* S, const void* Y, const void* W,
                 const void* step_S, int prox_plus, int store_bf16, int C,
                 int K, long long N, long long tile_n, void* S_new, void* gA,
                 void* gram, void* stats, void* partials, void* stream) {
  if (N < 1 || tile_n < 1) return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(A);
  const float* ss = static_cast<const float*>(step_S);
  float* ga = static_cast<float*>(gA);
  float* g = static_cast<float*>(gram);
  float* st = static_cast<float*>(stats);
  float* pp = static_cast<float*>(partials);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (C >= 1 && K >= 1 && C <= 8 && K <= 8)
    return launch_store<8, 8>(store_bf16, a, S, Y, W, ss, prox_plus, C, K, N,
                              tile_n, S_new, ga, g, st, pp, strm);
  if (C >= 1 && K >= 1 && C <= 16 && K <= 8)
    return launch_store<16, 8>(store_bf16, a, S, Y, W, ss, prox_plus, C, K,
                               N, tile_n, S_new, ga, g, st, pp, strm);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
