// K1: one S-side PGM-NMF iteration in a single pass over the pixel columns.
//
// Replaces the Pallas TPU kernel proxmin_tpu/ops/nmf_kernels.py:311
// (fused_nmf_pgm_step; body _pgm_step_kernel :233; residual product
// _residual_dot :63, its "fma" path :82-89). Per pixel column n:
//
//   R   = A S[:,n] - Y[:,n]          exact f32 K-step FMA, summed over k in order
//   D   = W[:,n] * R  (or R)
//   gS  = A^T D
//   S'  = chain(S[:,n] - sS gS)      the compiled prox chain (prox_chain.cuh):
//                                    max(., 0) and the identity inline, any
//                                    other chain on the K values of a column
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
// What the design does about it: pgm_pass.cuh, which K3 shares (a ring of
// bulk copies into shared memory, consumers one column per thread, gA and
// the Gram summed from shared memory a row per warp, a persistent grid over
// parts of tiles with a row of partial sums each, a warp-per-entry
// finalize). No tensor cores: the products are f32 FMAs, the TPU kernel's
// "fma" path (a one-pass reduced-precision residual stalls the fixed-point
// test; see proxmin_tpu/precision.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "pgm_pass.cuh"

namespace {

template <int CB, int KB, typename ST>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM<CB>)
pgm_step_kernel(PassArgs<ST> a, Ring ring, int stages,
                int sets) {
  extern __shared__ __align__(128) unsigned char smem[];
  pass_body<CB, KB, ST, true>(a, ring, stages, sets, smem);
}

// Any other compiled chain: the same body, the chain applied to the K
// values of each column.
template <int CB, int KB, typename ST>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM<CB>)
pgm_chain_kernel(PassArgs<ST> a, Ring ring, int stages, int sets,
                 ProxChain chain) {
  extern __shared__ __align__(128) unsigned char smem[];
  pass_body<CB, KB, ST, true, true>(a, ring, stages, sets, smem, chain);
}

template <int CB, int KB>
__global__ void __launch_bounds__(kThreads)
pgm_step_finalize(const float* __restrict__ partials, long long n_units,
                  int C, int K, float* __restrict__ gA,
                  float* __restrict__ gram, float* __restrict__ stats) {
  finalize_body<CB, KB, true>(partials, n_units, C, K, gA, gram, stats);
}

template <int CB, int KB, typename ST>
int launch(const float* A, const void* S, const void* Y, const void* W,
           const float* step_S, const ProxChain& chain, int C, int K,
           long long N, long long tile_n, void* S_new, float* gA,
           float* gram, float* stats, float* partials, cudaStream_t stream) {
  static LaunchCache cache, chain_cache;
  // max(., 0) and the identity run inline in pgm_step_kernel; any other
  // chain in pgm_chain_kernel
  const bool identity =
      chain.repeat == 0 || chain.n == 0 || (chain.n == 1 && chain.op[0] == kId);
  const bool plus = chain.repeat >= 1 && chain.n == 1 && chain.op[0] == kPlus;
  const PassArgs<ST> args{A, static_cast<const ST*>(S),
                          static_cast<const ST*>(Y),
                          static_cast<const ST*>(W), step_S, plus ? 1 : 0, C,
                          K, N, tile_n, unit_count(N, tile_n),
                          static_cast<ST*>(S_new), partials};
  if (identity || plus)
    return launch_pass<CB, KB, ST, true>(pgm_step_kernel<CB, KB, ST>,
                                         pgm_step_finalize<CB, KB>, cache,
                                         args, gA, gram, stats, stream);
  return launch_pass<CB, KB, ST, true>(pgm_chain_kernel<CB, KB, ST>,
                                       pgm_step_finalize<CB, KB>, chain_cache,
                                       args, gA, gram, stats, stream, chain);
}

template <int CB, int KB>
int launch_store(int store_bf16, const float* A, const void* S, const void* Y,
                 const void* W, const float* step_S, const ProxChain& chain,
                 int C, int K, long long N, long long tile_n, void* S_new,
                 float* gA, float* gram, float* stats, float* partials,
                 cudaStream_t stream) {
  if (store_bf16)
    return launch<CB, KB, __nv_bfloat16>(A, S, Y, W, step_S, chain, C, K, N,
                                         tile_n, S_new, gA, gram, stats,
                                         partials, stream);
  return launch<CB, KB, float>(A, S, Y, W, step_S, chain, C, K, N, tile_n,
                               S_new, gA, gram, stats, partials, stream);
}

}  // namespace

extern "C" {

// Width of one row of partial sums for a (C, K) problem, or -1 when no
// compiled bound covers it. The caller allocates the scratch buffer as
// (nmf_pgm_step_partials_rows(N, tile_n), width) floats.
int nmf_pgm_step_partials_width(int C, int K) {
  if (C >= 1 && K >= 1 && C <= 8 && K <= 8) return Layout<8, 8, true>::kP;
  if (C >= 1 && K >= 1 && C <= 16 && K <= 8) return Layout<16, 8, true>::kP;
  return -1;
}

// Rows of partial sums to allocate for N columns in tiles of tile_n (the
// work units, parts of tiles, rounded up to a multiple of 4), or -1 for
// N < 1 or tile_n < 1.
long long nmf_pgm_step_partials_rows(long long N, long long tile_n) {
  if (N < 1 || tile_n < 1) return -1;
  return stride(unit_count(N, tile_n));
}

// One fused step on `stream`. All pointers are device pointers to
// contiguous row-major arrays: A (C, K), step_S (1,), gA (C, K), gram
// (K, K), stats (3,) and partials (rows, width) float32; S and S_new
// (K, N), Y and W (C, N; W may be null) float32, or bfloat16 when
// store_bf16 is 1. prox_S is the chain of n_ops codes and thresholds in the
// host arrays ops and thresh (prox_chain.cuh), applied `repeat` times.
// Returns cudaGetLastError() after the launches (0 on success); does not
// synchronize.
int nmf_pgm_step(const void* A, const void* S, const void* Y, const void* W,
                 const void* step_S, int n_ops, int repeat, const int* ops,
                 const float* thresh, int store_bf16, int C, int K,
                 long long N, long long tile_n, void* S_new, void* gA,
                 void* gram, void* stats, void* partials, void* stream) {
  if (N < 1 || tile_n < 1 || n_ops < 0 || n_ops > kMaxChain || repeat < 0)
    return (int)cudaErrorInvalidValue;
  ProxChain chain{};
  chain.n = n_ops;
  chain.repeat = repeat;
  for (int i = 0; i < n_ops; ++i) {
    chain.op[i] = ops[i];
    chain.thresh[i] = thresh[i];
  }
  const float* a = static_cast<const float*>(A);
  const float* ss = static_cast<const float*>(step_S);
  float* ga = static_cast<float*>(gA);
  float* g = static_cast<float*>(gram);
  float* st = static_cast<float*>(stats);
  float* pp = static_cast<float*>(partials);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (C >= 1 && K >= 1 && C <= 8 && K <= 8)
    return launch_store<8, 8>(store_bf16, a, S, Y, W, ss, chain, C, K, N,
                              tile_n, S_new, ga, g, st, pp, strm);
  if (C >= 1 && K >= 1 && C <= 16 && K <= 8)
    return launch_store<16, 8>(store_bf16, a, S, Y, W, ss, chain, C, K, N,
                               tile_n, S_new, ga, g, st, pp, strm);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
