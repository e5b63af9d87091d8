// K3: both NMF factor gradients, the S Gram and the loss in a single pass
// over the pixel columns, with the residual never stored.
//
// Replaces the Pallas TPU kernel proxmin_tpu/ops/nmf_kernels.py:653
// (fused_nmf_grad -> _fused_call :172, pallas_call :202; body _kernel :137;
// residual product _residual_dot :63, its "fma" path :82-89). Per pixel
// column n:
//
//   R    = A S[:,n] - Y[:,n]        exact f32 K-step FMA, summed over k in order
//   D    = W[:,n] * R  (or R)
//   gS[:,n] = A^T D                 written per column
//   gA  += D S[:,n]^T
//   G   += S[:,n] S[:,n]^T          the Gram S S^T (Lipschitz step input)
//   loss += D.R                     (loss = D.R / 2)
//
// What bounds it on an H100: bytes. It reads Y (C x N) and S (K x N) and
// writes gS (K x N), all f32: (C + 2K) N 4 bytes, 76 MB at the flagship
// C=5, K=7, N=1e6 (23 us at 3.35 TB/s), plus C N 4 bytes when W streams.
// The arithmetic, about 2N(2CK + K(K+1)/2) flops, is far below what the
// card's f32 units do in that time.
//
// What the design does about it: the structure of K1 (nmf_pgm_step.cu).
// - One thread per column at a time; a block of 256 threads walks a tile of
//   tile_n consecutive columns, neighbouring threads on neighbouring
//   columns, so every row load and store of a warp is coalesced and every
//   byte moves once. The ragged edge of N is skipped, never masked.
// - C and K have compile-time bounds (CB, KB) so the per-column vectors and
//   the per-thread partial sums stay in registers. Rows and columns beyond
//   the runtime C and K are skipped and their sums stay exactly zero.
// - No tensor cores: the products are f32 FMAs, the TPU kernel's "fma" path.
// - No atomics. The TPU grid runs in order and zero-initialises its
//   resident sums at the first tile (pl.when(j == 0), :155-159) before
//   adding every later tile into them; CTAs here run concurrently. Each
//   block reduces its partial sums in a fixed tree order (warp shuffles,
//   then the warps in order) and writes one row to a scratch buffer; a
//   second launch sums the rows in block order in double. Every run gives
//   the same bits.
// Making it fast (vector loads, TMA, a persistent grid) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Row layout of one block's partial sums.
template <int CB, int KB>
struct Layout {
  static constexpr int kGA = 0;                         // (c, k) row-major
  static constexpr int kGram = CB * KB;                 // lower triangle (k, l <= k)
  static constexpr int kLoss = kGram + KB * (KB + 1) / 2;  // D.R
  static constexpr int kP = kLoss + 1;
};

template <int CB, int KB>
__global__ void __launch_bounds__(kThreads)
nmf_grad_kernel(const float* __restrict__ A, const float* __restrict__ S,
                const float* __restrict__ Y, const float* __restrict__ W,
                int C, int K, long long N, long long tile_n,
                float* __restrict__ gS, float* __restrict__ partials) {
  using L = Layout<CB, KB>;
  __shared__ float As[CB][KB];
  __shared__ float red[kWarps][L::kP];

  for (int i = threadIdx.x; i < CB * KB; i += kThreads) {
    const int c = i / KB, k = i % KB;
    As[c][k] = (c < C && k < K) ? A[c * K + k] : 0.f;
  }
  __syncthreads();

  float acc[L::kP];
#pragma unroll
  for (int p = 0; p < L::kP; ++p) acc[p] = 0.f;

  const long long begin = (long long)blockIdx.x * tile_n;
  const long long end = min(begin + tile_n, N);
  for (long long n = begin + threadIdx.x; n < end; n += kThreads) {
    float s[KB], d[CB];
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
      acc[L::kLoss] = fmaf(dc, r, acc[L::kLoss]);
    }

#pragma unroll
    for (int k = 0; k < KB; ++k) {
      if (k < K) {
        float g = 0.f;
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          if (c < C) g = fmaf(As[c][k], d[c], g);
        }
        gS[k * N + n] = g;
      }
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
              fmaf(s[k], s[l], acc[L::kGram + k * (k + 1) / 2 + l]);
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
// both triangles) and the loss.
template <int CB, int KB>
__global__ void __launch_bounds__(kThreads)
nmf_grad_finalize(const float* __restrict__ partials, long long n_blocks,
                  int C, int K, float* __restrict__ gA,
                  float* __restrict__ gram, float* __restrict__ loss) {
  using L = Layout<CB, KB>;
  static_assert(L::kP <= kThreads, "one thread per partial-sum entry");
  const int p = threadIdx.x;
  if (p >= L::kP) return;
  double v = 0.0;
  for (long long b = 0; b < n_blocks; ++b) v += (double)partials[b * L::kP + p];
  if (p < L::kGram) {
    const int c = p / KB, k = p % KB;
    if (c < C && k < K) gA[c * K + k] = (float)v;
  } else if (p < L::kLoss) {
    const int t = p - L::kGram;
    int k = 0;
    while ((k + 1) * (k + 2) / 2 <= t) ++k;
    const int l = t - k * (k + 1) / 2;
    if (k < K) {
      gram[k * K + l] = (float)v;
      gram[l * K + k] = (float)v;
    }
  } else {
    *loss = (float)(0.5 * v);
  }
}

template <int CB, int KB>
int launch(const float* A, const float* S, const float* Y, const float* W,
           int C, int K, long long N, long long tile_n, float* gA, float* gS,
           float* gram, float* loss, float* partials, cudaStream_t stream) {
  const long long n_blocks = (N + tile_n - 1) / tile_n;
  nmf_grad_kernel<CB, KB><<<(unsigned)n_blocks, kThreads, 0, stream>>>(
      A, S, Y, W, C, K, N, tile_n, gS, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nmf_grad_finalize<CB, KB><<<1, kThreads, 0, stream>>>(
      partials, n_blocks, C, K, gA, gram, loss);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Width of one block's row of partial sums for a (C, K) problem, or -1
// when no compiled bound covers it. The caller allocates the scratch
// buffer as (ceil(N / tile_n), width) floats.
int nmf_grad_partials_width(int C, int K) {
  if (C >= 1 && K >= 1 && C <= 8 && K <= 8) return Layout<8, 8>::kP;
  if (C >= 1 && K >= 1 && C <= 16 && K <= 8) return Layout<16, 8>::kP;
  return -1;
}

// The fused gradients on `stream`. All pointers are device pointers to
// contiguous row-major float32 arrays: A and gA (C, K), S and gS (K, N), Y
// and W (C, N; W may be null), gram (K, K), loss (1,), partials
// (ceil(N / tile_n), width). Returns cudaGetLastError() after the launches
// (0 on success); does not synchronize.
int nmf_grad_f32(const void* A, const void* S, const void* Y, const void* W,
                 int C, int K, long long N, long long tile_n, void* gA,
                 void* gS, void* gram, void* loss, void* partials,
                 void* stream) {
  if (N < 1 || tile_n < 1) return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(A);
  const float* s = static_cast<const float*>(S);
  const float* y = static_cast<const float*>(Y);
  const float* w = static_cast<const float*>(W);
  float* ga = static_cast<float*>(gA);
  float* gs = static_cast<float*>(gS);
  float* g = static_cast<float*>(gram);
  float* l = static_cast<float*>(loss);
  float* pp = static_cast<float*>(partials);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (C >= 1 && K >= 1 && C <= 8 && K <= 8)
    return launch<8, 8>(a, s, y, w, C, K, N, tile_n, ga, gs, g, l, pp, strm);
  if (C >= 1 && K >= 1 && C <= 16 && K <= 8)
    return launch<16, 8>(a, s, y, w, C, K, N, tile_n, ga, gs, g, l, pp, strm);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
