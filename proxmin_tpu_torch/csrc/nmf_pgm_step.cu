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
// What bounds it on an H100: bytes. Each iteration reads Y (C x N) and S
// (K x N) and writes S' (K x N), all f32: (C + 2K) N 4 bytes, 76 MB at the
// flagship C=5, K=7, N=1e6, which is 23 us at 3.35 TB/s (plus C N 4 bytes
// when W streams). The arithmetic, about 2N(3CK + K(K+1)/2) flops, is
// 0.26 GFLOP at the flagship, far below what the card's f32 units do in
// that time.
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

template <int CB, int KB>
__global__ void __launch_bounds__(kThreads)
pgm_step_kernel(const float* __restrict__ A, const float* __restrict__ S,
                const float* __restrict__ Y, const float* __restrict__ W,
                const float* __restrict__ step_S, int prox_plus, int C,
                int K, long long N, long long tile_n,
                float* __restrict__ S_new, float* __restrict__ partials) {
  using L = Layout<CB, KB>;
  __shared__ float As[CB][KB];
  __shared__ float red[kWarps][L::kP];

  for (int i = threadIdx.x; i < CB * KB; i += kThreads) {
    const int c = i / KB, k = i % KB;
    As[c][k] = (c < C && k < K) ? A[c * K + k] : 0.f;
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
    for (int k = 0; k < KB; ++k) s[k] = (k < K) ? S[k * N + n] : 0.f;

#pragma unroll
    for (int c = 0; c < CB; ++c) {
      float r = 0.f, dc = 0.f;
      if (c < C) {
        r = As[c][0] * s[0];
#pragma unroll
        for (int k = 1; k < KB; ++k) {
          if (k < K) r = fmaf(As[c][k], s[k], r);
        }
        r -= Y[c * N + n];
        dc = (W != nullptr) ? W[c * N + n] * r : r;
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
        S_new[k * N + n] = x;
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

template <int CB, int KB>
int launch(const float* A, const float* S, const float* Y, const float* W,
           const float* step_S, int prox_plus, int C, int K, long long N,
           long long tile_n, float* S_new, float* gA, float* gram,
           float* stats, float* partials, cudaStream_t stream) {
  const long long n_blocks = (N + tile_n - 1) / tile_n;
  pgm_step_kernel<CB, KB><<<(unsigned)n_blocks, kThreads, 0, stream>>>(
      A, S, Y, W, step_S, prox_plus, C, K, N, tile_n, S_new, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pgm_step_finalize<CB, KB><<<1, kThreads, 0, stream>>>(
      partials, n_blocks, C, K, gA, gram, stats);
  return (int)cudaGetLastError();
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
// contiguous row-major float32 arrays: A (C, K), S and S_new (K, N), Y and
// W (C, N; W may be null), step_S (1,), gA (C, K), gram (K, K), stats (3,),
// partials (ceil(N / tile_n), width). Returns cudaGetLastError() after the
// launches (0 on success); does not synchronize.
int nmf_pgm_step_f32(const void* A, const void* S, const void* Y,
                     const void* W, const void* step_S, int prox_plus, int C,
                     int K, long long N, long long tile_n, void* S_new,
                     void* gA, void* gram, void* stats, void* partials,
                     void* stream) {
  if (N < 1 || tile_n < 1) return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(A);
  const float* s = static_cast<const float*>(S);
  const float* y = static_cast<const float*>(Y);
  const float* w = static_cast<const float*>(W);
  const float* ss = static_cast<const float*>(step_S);
  float* sn = static_cast<float*>(S_new);
  float* ga = static_cast<float*>(gA);
  float* g = static_cast<float*>(gram);
  float* st = static_cast<float*>(stats);
  float* pp = static_cast<float*>(partials);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (C >= 1 && K >= 1 && C <= 8 && K <= 8)
    return launch<8, 8>(a, s, y, w, ss, prox_plus, C, K, N, tile_n, sn, ga,
                        g, st, pp, strm);
  if (C >= 1 && K >= 1 && C <= 16 && K <= 8)
    return launch<16, 8>(a, s, y, w, ss, prox_plus, C, K, N, tile_n, sn, ga,
                         g, st, pp, strm);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
