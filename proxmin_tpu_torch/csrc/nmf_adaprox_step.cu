// K2: one S-side AdaProx (proximal Adam, scheme "adam") iteration in a
// single pass over the pixel columns.
//
// Replaces the Pallas TPU kernel proxmin_tpu/ops/nmf_kernels.py:525
// (fused_nmf_adaprox_step; body _adaprox_step_kernel :409; residual product
// _residual_dot :63, its "fma" path :82-89). Per pixel column n, with the
// per-row step alpha (K) and the host scalars b1_t, bc1 = 1/(1 - b1_t^t),
// bc2 = 1/(1 - b2^t):
//
//   R    = A S[:,n] - Y[:,n]           exact f32 K-step FMA, summed over k in order
//   D    = W[:,n] * R  (or R)
//   gS   = A^T D
//   M'   = (1 - b1_t) gS + b1_t M      the moment EMAs, in f32; M and V are
//   V'   = (1 - b2) gS^2 + b2 V        read and stored as float or bfloat16
//   Phi  = M' bc1,  Psi = sqrt(V' bc2) + eps,  Psi_safe = max(Psi, FLT_MIN)
//   S'   = prox(S - alpha (Phi / Psi_safe))   prox = max(., 0) or identity,
//                                       the closed form of the scaled prox
//   gA  += D S[:,n]^T                  with the OLD column of S
//   rowsum += S'                       the next iteration's step heuristic
//   stats  += [D.R, |S' - S|^2, |S'|^2]    (loss = D.R / 2)
//
// What bounds it on an H100: bytes. Each iteration reads Y (C x N), S, M and
// V (K x N each) and writes S', M' and V': (C + 6K) N 4 bytes with float
// moments, 188 MB at the flagship C=5, K=7, N=1e6 (56 us at 3.35 TB/s);
// (C + 2K) N 4 + 4 K N 2 = 132 MB with bfloat16 moments; C N 4 more when W
// streams. The arithmetic, about N K (6C + 20) flops, is far below what the
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
// - Moments are a template type: float, or __nv_bfloat16 read with
//   __bfloat162float and stored with __float2bfloat16_rn (round to nearest
//   even, as astype(bfloat16)). All arithmetic is f32.
// - The update is written with __fmul_rn/__fadd_rn/__fdiv_rn/__fsqrt_rn so
//   that nvcc contracts nothing into an FMA: the products round as the
//   plain PyTorch version's separate elementwise ops do, and a one-ulp
//   difference cannot flip a bfloat16 store. Build without
//   --use_fast_math.
// - NaN survives the prox and the Psi floor (x < 0 ? 0 : x, not fmaxf), so
//   the solver's divergence detection sees it.
// - No atomics. Each block reduces its partial sums in a fixed tree order
//   and writes one row to a scratch buffer; a second launch sums the rows
//   in block order in double. Every run gives the same bits, which the
//   exact resume relies on.
// Making it fast (vector loads, TMA, a persistent grid) is later work.
//
// K5, the packed-state variant, is this kernel with another layout (the
// template parameter PK). It replaces the Pallas TPU kernel
// benchmarks/stream_merge.py:105 (packed_step; body _packed_kernel :43):
// K2's unweighted iteration with prox max(., 0) on
//   kPackSMV: one (3K, N) f32 array [S; M; V] in and one out;
//   kPackMV:  S (K, N) f32 plus one (2K, N) bfloat16 array [M; V].
// The layout changes only where S, M and V are read and written (row
// offsets K and 2K), so a packed result equals K2's bit for bit on the
// same inputs and a timing compares the layouts alone. On the TPU the
// question was the count of DMA streams (7 -> 3 or 5); here each thread
// issues the same loads and stores either way, so what K5 measures on an
// H100 is whether the merged arrays' addresses change the achieved
// bandwidth. Bytes are K2's: 188 MB (smv) and 132 MB (mv) at the flagship.

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Row layout of one block's partial sums.
template <int CB, int KB>
struct Layout {
  static constexpr int kGA = 0;              // (c, k) row-major
  static constexpr int kRowsum = CB * KB;    // k
  static constexpr int kStats = kRowsum + KB;  // D.R, |dS|^2, |S'|^2
  static constexpr int kP = kStats + 3;
};

struct Scalars {
  float b1_t, bc1, bc2, one_minus_b2, b2, eps;
};

// Where S, M and V live: K2's three arrays, or K5's packed layouts.
constexpr int kSeparate = 0, kPackSMV = 1, kPackMV = 2;

__device__ __forceinline__ float load_moment(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load_moment(const __nv_bfloat16* p,
                                             long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_moment(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_moment(__nv_bfloat16* p, long long i,
                                             float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <int CB, int KB, typename MT, int PK>
__global__ void __launch_bounds__(kThreads)
adaprox_step_kernel(const float* __restrict__ S_in, const MT* __restrict__ M_in,
                    const MT* __restrict__ V_in, const float* __restrict__ A,
                    const float* __restrict__ Y, const float* __restrict__ W,
                    const float* __restrict__ alpha, Scalars sc,
                    int prox_plus, int C, int K, long long N,
                    long long tile_n, float* __restrict__ S_out,
                    MT* __restrict__ M_out, MT* __restrict__ V_out,
                    float* __restrict__ partials) {
  using L = Layout<CB, KB>;
  // the layout: K2 passes three arrays; kPackSMV passes [S; M; V] as S_in
  // and S_out; kPackMV passes [M; V] as M_in and M_out
  const long long KN = (long long)K * N;
  const float* S = S_in;
  float* S_new = S_out;
  const MT* M = PK == kPackSMV ? reinterpret_cast<const MT*>(S_in + KN) : M_in;
  MT* M_new = PK == kPackSMV ? reinterpret_cast<MT*>(S_out + KN) : M_out;
  const MT* V = PK == kSeparate ? V_in : M + KN;
  MT* V_new = PK == kSeparate ? V_out : M_new + KN;
  __shared__ float As[CB][KB];
  __shared__ float alphas[KB];
  __shared__ float red[kWarps][L::kP];

  for (int i = threadIdx.x; i < CB * KB; i += kThreads) {
    const int c = i / KB, k = i % KB;
    As[c][k] = (c < C && k < K) ? A[c * K + k] : 0.f;
  }
  for (int k = threadIdx.x; k < KB; k += kThreads)
    alphas[k] = (k < K) ? alpha[k] : 0.f;
  __syncthreads();
  // (1 - b1_t) in f32, as the TPU kernel computes it from its f32 scalar
  const float one_minus_b1 = __fsub_rn(1.f, sc.b1_t);

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
      acc[L::kStats] = fmaf(dc, r, acc[L::kStats]);
    }

#pragma unroll
    for (int k = 0; k < KB; ++k) {
      if (k < K) {
        float g = 0.f;
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          if (c < C) g = fmaf(As[c][k], d[c], g);
        }
        const long long i = k * N + n;
        const float m1 = __fadd_rn(__fmul_rn(one_minus_b1, g),
                                   __fmul_rn(sc.b1_t, load_moment(M, i)));
        const float v1 =
            __fadd_rn(__fmul_rn(sc.one_minus_b2, __fmul_rn(g, g)),
                      __fmul_rn(sc.b2, load_moment(V, i)));
        const float phi = __fmul_rn(m1, sc.bc1);
        const float psi = __fadd_rn(__fsqrt_rn(__fmul_rn(v1, sc.bc2)), sc.eps);
        const float psi_safe = (psi < FLT_MIN) ? FLT_MIN : psi;  // keeps NaN
        float x = __fsub_rn(s[k],
                            __fmul_rn(alphas[k], __fdiv_rn(phi, psi_safe)));
        // keeps NaN (fmaxf would turn it into 0 and hide a divergence)
        if (prox_plus && x < 0.f) x = 0.f;
        S_new[i] = x;
        store_moment(M_new, i, m1);
        store_moment(V_new, i, v1);
        const float dk = x - s[k];
        acc[L::kRowsum + k] += x;
        acc[L::kStats + 1] = fmaf(dk, dk, acc[L::kStats + 1]);
        acc[L::kStats + 2] = fmaf(x, x, acc[L::kStats + 2]);
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
// (in double, then rounds once) and writes gA (C x K), rowsum (K) and
// stats = [loss, |S' - S|^2, |S'|^2].
template <int CB, int KB>
__global__ void __launch_bounds__(kThreads)
adaprox_step_finalize(const float* __restrict__ partials, long long n_blocks,
                      int C, int K, float* __restrict__ gA,
                      float* __restrict__ rowsum,
                      float* __restrict__ stats) {
  using L = Layout<CB, KB>;
  static_assert(L::kP <= kThreads, "one thread per partial-sum entry");
  const int p = threadIdx.x;
  if (p >= L::kP) return;
  double v = 0.0;
  for (long long b = 0; b < n_blocks; ++b) v += (double)partials[b * L::kP + p];
  if (p < L::kRowsum) {
    const int c = p / KB, k = p % KB;
    if (c < C && k < K) gA[c * K + k] = (float)v;
  } else if (p < L::kStats) {
    const int k = p - L::kRowsum;
    if (k < K) rowsum[k] = (float)v;
  } else {
    const int i = p - L::kStats;
    stats[i] = (float)(i == 0 ? 0.5 * v : v);
  }
}

template <int CB, int KB, typename MT, int PK = kSeparate>
int launch(const float* A, const float* S, const void* M, const void* V,
           const float* Y, const float* W, const float* alpha, Scalars sc,
           int prox_plus, int C, int K, long long N, long long tile_n,
           float* S_new, void* M_new, void* V_new, float* gA, float* rowsum,
           float* stats, float* partials, cudaStream_t stream) {
  const long long n_blocks = (N + tile_n - 1) / tile_n;
  adaprox_step_kernel<CB, KB, MT, PK>
      <<<(unsigned)n_blocks, kThreads, 0, stream>>>(
          S, static_cast<const MT*>(M), static_cast<const MT*>(V), A, Y, W,
          alpha, sc, prox_plus, C, K, N, tile_n, S_new,
          static_cast<MT*>(M_new), static_cast<MT*>(V_new), partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  adaprox_step_finalize<CB, KB><<<1, kThreads, 0, stream>>>(
      partials, n_blocks, C, K, gA, rowsum, stats);
  return (int)cudaGetLastError();
}

template <int CB, int KB>
int launch_moments(int moment_bf16, const float* A, const float* S,
                   const void* M, const void* V, const float* Y,
                   const float* W, const float* alpha, Scalars sc,
                   int prox_plus, int C, int K, long long N, long long tile_n,
                   float* S_new, void* M_new, void* V_new, float* gA,
                   float* rowsum, float* stats, float* partials,
                   cudaStream_t stream) {
  if (moment_bf16)
    return launch<CB, KB, __nv_bfloat16>(A, S, M, V, Y, W, alpha, sc,
                                         prox_plus, C, K, N, tile_n, S_new,
                                         M_new, V_new, gA, rowsum, stats,
                                         partials, stream);
  return launch<CB, KB, float>(A, S, M, V, Y, W, alpha, sc, prox_plus, C, K,
                               N, tile_n, S_new, M_new, V_new, gA, rowsum,
                               stats, partials, stream);
}

}  // namespace

extern "C" {

// Width of one block's row of partial sums for a (C, K) problem, or -1
// when no compiled bound covers it. The caller allocates the scratch
// buffer as (ceil(N / tile_n), width) floats.
int nmf_adaprox_step_partials_width(int C, int K) {
  if (C >= 1 && K >= 1 && C <= 8 && K <= 8) return Layout<8, 8>::kP;
  if (C >= 1 && K >= 1 && C <= 16 && K <= 8) return Layout<16, 8>::kP;
  return -1;
}

// One fused step on `stream`. All pointers are device pointers to
// contiguous row-major arrays: A (C, K), S and S_new (K, N), Y and W (C, N;
// W may be null), alpha (K,), gA (C, K), rowsum (K,), stats (3,), partials
// (ceil(N / tile_n), width), all float32; M, V, M_new, V_new (K, N) are
// float32, or bfloat16 when moment_bf16 is 1. The scalars come by value.
// Returns cudaGetLastError() after the launches (0 on success); does not
// synchronize.
int nmf_adaprox_step(const void* A, const void* S, const void* M,
                     const void* V, const void* Y, const void* W,
                     const void* alpha, float b1_t, float bc1, float bc2,
                     float one_minus_b2, float b2, float eps, int prox_plus,
                     int moment_bf16, int C, int K, long long N,
                     long long tile_n, void* S_new, void* M_new, void* V_new,
                     void* gA, void* rowsum, void* stats, void* partials,
                     void* stream) {
  if (N < 1 || tile_n < 1) return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(A);
  const float* s = static_cast<const float*>(S);
  const float* y = static_cast<const float*>(Y);
  const float* w = static_cast<const float*>(W);
  const float* al = static_cast<const float*>(alpha);
  float* sn = static_cast<float*>(S_new);
  float* ga = static_cast<float*>(gA);
  float* rs = static_cast<float*>(rowsum);
  float* st = static_cast<float*>(stats);
  float* pp = static_cast<float*>(partials);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const Scalars sc{b1_t, bc1, bc2, one_minus_b2, b2, eps};
  if (C >= 1 && K >= 1 && C <= 8 && K <= 8)
    return launch_moments<8, 8>(moment_bf16, a, s, M, V, y, w, al, sc,
                                prox_plus, C, K, N, tile_n, sn, M_new, V_new,
                                ga, rs, st, pp, strm);
  if (C >= 1 && K >= 1 && C <= 16 && K <= 8)
    return launch_moments<16, 8>(moment_bf16, a, s, M, V, y, w, al, sc,
                                 prox_plus, C, K, N, tile_n, sn, M_new, V_new,
                                 ga, rs, st, pp, strm);
  return (int)cudaErrorInvalidValue;
}

// K5: one packed step on `stream`, K2's unweighted iteration with prox
// max(., 0). With MV null, the kPackSMV layout: SMV and SMV_new are
// (3K, N) float32 [S; M; V]. Otherwise the kPackMV layout: SMV and SMV_new
// are S and S_new (K, N) float32, MV and MV_new (2K, N) bfloat16 [M; V].
// The other pointers and the scalars are nmf_adaprox_step's. Returns
// cudaGetLastError() after the launches; does not synchronize.
int nmf_packed_step(const void* A, const void* SMV, const void* MV,
                    const void* Y, const void* alpha, float b1_t, float bc1,
                    float bc2, float one_minus_b2, float b2, float eps, int C,
                    int K, long long N, long long tile_n, void* SMV_new,
                    void* MV_new, void* gA, void* rowsum, void* stats,
                    void* partials, void* stream) {
  if (N < 1 || tile_n < 1) return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(A);
  const float* s = static_cast<const float*>(SMV);
  const float* y = static_cast<const float*>(Y);
  const float* al = static_cast<const float*>(alpha);
  float* sn = static_cast<float*>(SMV_new);
  float* ga = static_cast<float*>(gA);
  float* rs = static_cast<float*>(rowsum);
  float* st = static_cast<float*>(stats);
  float* pp = static_cast<float*>(partials);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const Scalars sc{b1_t, bc1, bc2, one_minus_b2, b2, eps};
  if (!(C >= 1 && K >= 1 && C <= 8 && K <= 8))
    return (int)cudaErrorInvalidValue;
  if (MV == nullptr)
    return launch<8, 8, float, kPackSMV>(a, s, nullptr, nullptr, y, nullptr,
                                         al, sc, 1, C, K, N, tile_n, sn,
                                         nullptr, nullptr, ga, rs, st, pp,
                                         strm);
  return launch<8, 8, __nv_bfloat16, kPackMV>(a, s, MV, nullptr, y, nullptr,
                                              al, sc, 1, C, K, N, tile_n, sn,
                                              MV_new, nullptr, ga, rs, st, pp,
                                              strm);
}

}  // extern "C"
