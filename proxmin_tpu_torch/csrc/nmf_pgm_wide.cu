// K1 on the wide body (wide_pass.cuh): one S-side PGM-NMF iteration for C
// up to 256 channels and K up to 32 components, and the two passes of the
// split path; beyond either bound, for any C and K, on the very-wide tier
// (the wide body's VW instances to K = 32; past it kwide_pass.cuh's body
// for the chain and split pass 1 up to K = 256, panel_pass.cuh's up to
// K = 512, vwide_pass.cuh's beyond, and post_pass.cuh's for split pass 2 at
// every K), every mode and both stores.
//
// Replaces, beyond the narrow instances of nmf_pgm_step.cu (C <= 16,
// K <= 8), the Pallas TPU kernel proxmin_tpu/ops/nmf_kernels.py:311
// (fused_nmf_pgm_step; body _pgm_step_kernel :233, its prox_S call :272),
// which takes any C, K and any jittable prox_S. Per pixel column n:
//
//   R   = A S[:,n] - Y[:,n]          exact f32 K-step FMA, summed over k in order
//   D   = W[:,n] * R  (or R)
//   gS  = A^T D
//   x   = S[:,n] - sS gS
//   S'  = chain(x)                   the compiled prox chain (prox_chain.cuh)
//   gA += D S[:,n]^T                 with the OLD column of S
//   G  += S' S'^T
//   stats += [D.R, |S' - S|^2, |S'|^2]   (loss = D.R / 2)
//
// A prox_S that no chain covers (a user callable, an axis-1 prox, an array
// threshold, ...) takes the split path: pass 1 (mode 1) stores x in float32
// with gA and the loss; PyTorch applies prox_S to the whole (K, N) x, as the
// plain version and the JAX package's engine="xla" do (the TPU kernel
// applies it per pixel tile, which is wrong for a prox that couples
// pixels); pass 2 (mode 2) gives the Gram of S' and [|S' - S|^2, |S'|^2]
// from the prox's output, and stores S' rounded to bfloat16 with the
// bfloat16 store.
//
// S, Y and W are float or bfloat16 (the store); compute is f32. With the
// bfloat16 store the residual takes A rounded to bfloat16, as in the TPU
// kernel, and the Gram and the statistics take the rounded S'.
//
// What bounds it on an H100: at C = 128, K = 32, N = 1e6 the float32 FMAs
// (3 C K + K (K + 1) / 2 per column, 0.38 ms at 67 TFLOP/s; the body forms
// both triangles of the Gram, K^2) over the bytes ((C + 2K)
// N 4 = 0.77 GB, 0.23 ms at 3.35 TB/s), and, tighter than both, the shared
// memory's delivery of the register tiles' operands (3 floats per 8 FMAs,
// 1.5 times the FMAs' time): the main loop runs near that, the Gram, the
// chain and the stores of S' after it, on the same warps. The design is
// wide_pass.cuh's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kwide_pass.cuh"
#include "panel_pass.cuh"
#include "post_pass.cuh"
#include "tiers.cuh"
#include "vwide_pass.cuh"
#include "wide_pass.cuh"

namespace {

using wide::Args;

// Built for two blocks of 8 warps per SM (at most 128 registers a thread)
// where KB = 8 or the pass has no residual, else, and for the very-wide
// instances (VW), for one (up to 255): wide::blocks_per_sm.
template <int KB, typename ST, int MODE, bool VW>
__global__ void __launch_bounds__(wide::kThreads,
                                  wide::blocks_per_sm(KB, MODE, VW))
pgm_wide_kernel(Args<ST, float> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  wide::body<KB, ST, float, MODE, VW>(a, smem);
}

__global__ void __launch_bounds__(wide::kFinThreads)
pgm_wide_finalize(const float* __restrict__ partials, long long rows,
                  wide::Entries e, bool half_first, float* __restrict__ gA,
                  float* __restrict__ gram, float* __restrict__ stats) {
  wide::finalize(partials, rows, e, half_first, gA, gram, stats);
}

// The very-wide body past K = 256 (vwide_pass.cuh): one block per SM, up
// to 255 registers.
template <typename ST, int MODE>
__global__ void __launch_bounds__(wide::kThreads, 1)
pgm_vwide_kernel(Args<ST, float> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  vwide::body<ST, float, MODE>(a, smem);
}

// Split pass 2 past K = 32 (post_pass.cuh): the Gram's tile pairs, two
// blocks per SM (at most 128 registers), and its finalize (also the
// finalize of panel_pass.cuh's products).
template <typename ST>
__global__ void __launch_bounds__(wide::kThreads, 2)
pgm_post_kernel(Args<ST, float> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  post::product_body<post::kPass2, ST>(a, smem);
}

__global__ void __launch_bounds__(wide::kFinThreads)
pgm_post_finalize(const float* __restrict__ partials, long long rows,
                  int mode, int pr, int C, int K, float* __restrict__ gram,
                  float* __restrict__ stats) {
  post::finalize(partials, rows, mode, pr, C, K, gram, stats);
}

// The chain and split pass 1 past K = 256 up to K = 512 (panel_pass.cuh):
// prep, the column pass (one block per SM, up to 255 registers), gA's and
// the Gram's tile-pair products (two blocks per SM) and the statistics'
// finalize.
template <typename ST>
__global__ void __launch_bounds__(wide::kThreads)
pgm_panel_prep(const float* __restrict__ A, int C, int K,
               float* __restrict__ At, float* __restrict__ Af) {
  panel::prep<ST>(A, C, K, At, Af);
}

template <typename ST, int MODE>
__global__ void __launch_bounds__(wide::kThreads, 1)
pgm_panel_kernel(Args<ST, float> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  panel::column_body<ST, MODE>(a, smem);
}

template <int PR, typename ST>
__global__ void __launch_bounds__(wide::kThreads, 2)
pgm_panel_tiles(Args<ST, float> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  post::product_body<PR, ST>(a, smem);
}

__global__ void __launch_bounds__(wide::kFinThreads)
pgm_panel_finalize(const float* __restrict__ rows, long long n_rows, int n,
                   float* __restrict__ stats) {
  panel::stats_finalize(rows, n_rows, n, stats);
}

template <typename ST, int MODE>
int launch_panel(const Args<ST, float>& args, float* gA, float* gram,
                 float* stats, cudaStream_t stream) {
  static panel::LaunchCaches caches;
  return panel::launch<ST, MODE>(
      pgm_panel_prep<ST>, pgm_panel_kernel<ST, MODE>,
      pgm_panel_tiles<post::kCross, ST>, pgm_panel_tiles<post::kGram, ST>,
      pgm_post_finalize, pgm_panel_finalize, caches, args, gA, gram, stats,
      stream);
}

// The very-wide tier's residual modes past K = 32 up to K = 256
// (kwide_pass.cuh): one block per SM, up to 255 registers.
template <int KB, typename ST, int MODE>
__global__ void __launch_bounds__(wide::kThreads, 1)
pgm_kwide_kernel(Args<ST, float> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  kwide::body<KB, ST, float, MODE>(a, smem);
}

template <int KB, typename ST, int MODE>
int launch_kwide(const Args<ST, float>& args, float* gA, float* gram,
                 float* stats, cudaStream_t stream) {
  static wide::LaunchCache cache;
  return kwide::launch<KB, ST, float, MODE>(pgm_kwide_kernel<KB, ST, MODE>,
                                            pgm_wide_finalize, cache, args,
                                            gA, gram, stats, stream);
}

template <int KB, typename ST>
int launch_kwide_modes(int mode, const Args<ST, float>& args, float* gA,
                       float* gram, float* stats, cudaStream_t stream) {
  if (mode == 0)
    return launch_kwide<KB, ST, wide::kPgm>(args, gA, gram, stats, stream);
  return launch_kwide<KB, ST, wide::kPgmPre>(args, gA, gram, stats, stream);
}

template <typename ST, int MODE>
int launch_vwide(const Args<ST, float>& args, float* gA, float* gram,
                 float* stats, cudaStream_t stream) {
  static wide::LaunchCache cache;
  return vwide::launch<ST, float, MODE>(pgm_vwide_kernel<ST, MODE>,
                                        pgm_wide_finalize, cache, args, gA,
                                        gram, stats, stream);
}

template <int KB, typename ST, int MODE, bool VW>
int launch_mode(const Args<ST, float>& args, float* gA, float* gram,
                float* stats, cudaStream_t stream) {
  static wide::LaunchCache cache;
  return wide::launch<KB, ST, float, MODE, VW>(
      pgm_wide_kernel<KB, ST, MODE, VW>, pgm_wide_finalize, cache, args, gA,
      gram, stats, stream);
}

// VW: the very-wide instances (C > 256) of the passes with a residual; the
// second pass reads no A and takes the wide instance at any C.
template <int KB, typename ST, bool VW>
int launch_modes(int mode, const Args<ST, float>& args, float* gA,
                 float* gram, float* stats, cudaStream_t stream) {
  switch (mode) {
    case 0:
      return launch_mode<KB, ST, wide::kPgm, VW>(args, gA, gram, stats,
                                                 stream);
    case 1:
      return launch_mode<KB, ST, wide::kPgmPre, VW>(args, gA, gram, stats,
                                                    stream);
    case 2:
      return launch_mode<KB, ST, wide::kPgmPost, false>(args, gA, gram,
                                                        stats, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int KB, typename ST>
int launch_kb(int mode, const Args<ST, float>& args, float* gA, float* gram,
              float* stats, cudaStream_t stream) {
  if (args.C > wide::kMaxC)
    return launch_modes<KB, ST, true>(mode, args, gA, gram, stats, stream);
  return launch_modes<KB, ST, false>(mode, args, gA, gram, stats, stream);
}

template <typename ST>
int launch_store(int mode, const Args<ST, float>& args, float* gA,
                 float* gram, float* stats, cudaStream_t stream) {
  const bool residual = mode != 2;
  const tier::Body body = tier::body_for(tier::kK1, residual, args.K);
  if (body == tier::kKwide) {
    switch (tier::kb_for(tier::kK1, residual, args.K)) {
      case 64:
        return launch_kwide_modes<64, ST>(mode, args, gA, gram, stats,
                                          stream);
      case 128:
        return launch_kwide_modes<128, ST>(mode, args, gA, gram, stats,
                                           stream);
      default:
        return launch_kwide_modes<256, ST>(mode, args, gA, gram, stats,
                                           stream);
    }
  }
  if (body == tier::kPost) {
    static wide::LaunchCache cache;
    return post::launch<wide::kPgmPost, post::kPass2, ST>(
        pgm_post_kernel<ST>, pgm_post_finalize, cache, args, gram, stats,
        stream);
  }
  if (body == tier::kPanel) {
    if (mode == 0)
      return launch_panel<ST, wide::kPgm>(args, gA, gram, stats, stream);
    return launch_panel<ST, wide::kPgmPre>(args, gA, gram, stats, stream);
  }
  if (body == tier::kVwide) {
    if (mode == 0)
      return launch_vwide<ST, wide::kPgm>(args, gA, gram, stats, stream);
    return launch_vwide<ST, wide::kPgmPre>(args, gA, gram, stats, stream);
  }
  switch (tier::kb_for(tier::kK1, residual, args.K)) {
    case 8:
      return launch_kb<8, ST>(mode, args, gA, gram, stats, stream);
    case 16:
      return launch_kb<16, ST>(mode, args, gA, gram, stats, stream);
    case 32:
      return launch_kb<32, ST>(mode, args, gA, gram, stats, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int mode_of(int mode) {
  return mode == 0 ? wide::kPgm : (mode == 1 ? wide::kPgmPre : wide::kPgmPost);
}

// Floats of one group's row of partial sums for `mode` (0 the compiled
// chain, 1 split pass 1, 2 split pass 2) and a (C, K) problem: the wide
// body's and its very-wide instances' up to K = 32; beyond, the kwide
// body's, the very-wide body's with its per-group scratch beside it, or
// split pass 2's tile pairs (post_pass.cuh); -1 for C < 1, K < 1 or a
// width past an int. 0 where panel_pass.cuh runs the pass (its scratch is
// no rows of a width).
int partials_width(int mode, int C, int K) {
  if (mode < 0 || mode > 2 || C < 1 || K < 1) return -1;
  const tier::Body body = tier::body_for(tier::kK1, mode != 2, K);
  if (body == tier::kWide) return wide::entries(mode_of(mode), C, K).total;
  if (body == tier::kPanel) return 0;
  const long long w = body == tier::kPost
                          ? post::width(mode_of(mode), K)
                          : vwide::width(mode_of(mode), C, K);
  return w > 0x7fffffffLL ? -1 : (int)w;
}

}  // namespace

extern "C" {

// Floats of the scratch buffer a pass of `mode` (0 the compiled chain, 1
// split pass 1, 2 split pass 2) on a (C, K, N) problem in tiles of tile_n
// takes: the rows of partial sums (the groups of work units, at most 264,
// the most any instance makes) of the body's width, or panel_pass.cuh's
// layout past K = 256 (its residual D, C x N floats, among them); -1 for
// C < 1, K < 1, N < 1, tile_n < 1 or a width past an int. The caller
// allocates it as that many float32 values.
long long nmf_pgm_wide_scratch_floats(int mode, int C, int K, long long N,
                                      long long tile_n) {
  const int width = partials_width(mode, C, K);
  if (width < 0 || N < 1 || tile_n < 1) return -1;
  const long long n_units = wide::unit_count(N, tile_n);
  if (tier::body_for(tier::kK1, mode != 2, K) == tier::kPanel)
    return panel::layout(mode_of(mode), C, K, N, n_units).total;
  return wide::group_count(n_units, 2) * width;
}

// One pass on `stream`. Device pointers to contiguous row-major arrays: A
// (C, K), step_S (1,), gA (C, K), gram (K, K), stats and partials float32;
// S and S_new (K, N), Y and W (C, N; W may be null) float32, or bfloat16
// when store_bf16 is 1; pre (K, N) and P (K, N) float32. The chain's
// n_ops codes and thresholds come from host arrays (ops, thresh), applied
// `repeat` times. Mode 0 reads A, S, Y, W, step_S and writes S_new, gA,
// gram, stats [loss, |S' - S|^2, |S'|^2]; mode 1 reads the same and writes
// pre (x), gA and stats [loss]; mode 2 reads S and P and writes gram, stats
// [|S' - S|^2, |S'|^2] and, with store_bf16, S_new (null in float32: S' is
// P). Returns cudaGetLastError() after the launches; does not synchronize.
int nmf_pgm_wide(int mode, const void* A, const void* S, const void* Y,
                 const void* W, const void* step_S, const void* P, int n_ops,
                 int repeat, const int* ops, const float* thresh,
                 int store_bf16, int C, int K, long long N, long long tile_n,
                 void* S_new, void* pre, void* gA, void* gram, void* stats,
                 void* partials, void* stream) {
  if (partials_width(mode, C, K) < 0 || N < 1 || tile_n < 1 ||
      n_ops < 0 || n_ops > kMaxChain || repeat < 0)
    return (int)cudaErrorInvalidValue;
  ProxChain chain{};
  chain.n = n_ops;
  chain.repeat = repeat;
  for (int i = 0; i < n_ops; ++i) {
    chain.op[i] = ops[i];
    chain.thresh[i] = thresh[i];
  }
  const long long n_units = wide::unit_count(N, tile_n);
  float* ga = static_cast<float*>(gA);
  float* g = static_cast<float*>(gram);
  float* st = static_cast<float*>(stats);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  auto fill = [&](auto& args) {
    using ST = std::remove_pointer_t<decltype(args.out)>;
    args.A = static_cast<const float*>(A);
    args.S = static_cast<const ST*>(S);
    args.Y = static_cast<const ST*>(Y);
    args.W = static_cast<const ST*>(W);
    args.step_S = static_cast<const float*>(step_S);
    args.P = static_cast<const float*>(P);
    args.chain = chain;
    args.C = C;
    args.K = K;
    args.N = N;
    args.tile_n = tile_n;
    args.n_units = n_units;
    args.out = static_cast<ST*>(S_new);
    args.pre = static_cast<float*>(pre);
    args.partials = static_cast<float*>(partials);
  };
  if (store_bf16) {
    Args<__nv_bfloat16, float> args{};
    fill(args);
    return launch_store<__nv_bfloat16>(mode, args, ga, g, st, strm);
  }
  Args<float, float> args{};
  fill(args);
  return launch_store<float>(mode, args, ga, g, st, strm);
}

}  // extern "C"
