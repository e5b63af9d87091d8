// K2 on the wide body (wide_pass.cuh): one S-side AdaProx (proximal Adam,
// scheme "adam") iteration for C up to 256 channels and K up to 32
// components, and the two passes of the split path; beyond either bound,
// for any C and K, on the very-wide tier (the wide body's VW instances to
// K = 32; past it kwide_pass.cuh's body for the chain and split pass 1 up
// to K = 256, vwide_pass.cuh's beyond, and post_pass.cuh's for split pass 2
// at every K), every mode, store and moment type, and the device-scalar
// entry.
//
// Replaces, beyond the narrow instances of nmf_adaprox_step.cu (C <= 16,
// K <= 8), the Pallas TPU kernel proxmin_tpu/ops/nmf_kernels.py:525
// (fused_nmf_adaprox_step; body _adaprox_step_kernel :409, its scaled prox
// :477-482). Per pixel column n, with the per-row step alpha (K) and the
// scalars b1_t, bc1 = 1/(1 - b1_t^t), bc2 = 1/(1 - b2^t), by value or read
// from a three-float buffer on the card:
//
//   R    = A S[:,n] - Y[:,n]           exact f32 K-step FMA, summed over k in order
//   D    = W[:,n] * R  (or R)
//   gS   = A^T D
//   M'   = (1 - b1_t) gS + b1_t M,  V' = (1 - b2) gS^2 + b2 V
//   Phi  = M' bc1,  Psi = sqrt(V' bc2) + eps,  Psi_safe = max(Psi, FLT_MIN)
//   S'   = chain(S - alpha Phi / Psi_safe)  with the per-element step
//          alpha / Psi_safe (prox_chain.cuh; the closed form of a separable
//          scaled prox)
//   gA  += D S[:,n]^T,  rowsum += S',  stats += [D.R, |S' - S|^2, |S'|^2]
//
// The split path: pass 1 (mode 1) stores M', V', x = S - alpha Phi /
// Psi_safe and the step alpha / Psi_safe, both in float32 (the step is not
// recomputed from the stored V, which bfloat16 moments round), with gA and
// the loss; PyTorch applies prox_S(x, step) to the whole (K, N) arrays;
// pass 2 (mode 2) gives rowsum(S') and [|S' - S|^2, |S'|^2] from the prox's
// output and stores S' rounded to bfloat16 with the bfloat16 store.
//
// The update is written with __fmul_rn/__fadd_rn/__fdiv_rn/__fsqrt_rn, as
// the narrow kernel's, so that nothing contracts into an FMA.
//
// What bounds it on an H100: at C = 128, K = 32 the float32 FMAs of the
// residual, gS and gA (3 C K per column) over the bytes ((C + 6K) N 4 with
// float32 moments), and, tighter than both, the shared memory's delivery
// of the register tiles' operands, as K1's; M and V come by bulk copies
// during the main loop, and the update, the chain and the stores of S',
// M', V' follow it on the same warps. The design is wide_pass.cuh's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kwide_pass.cuh"
#include "post_pass.cuh"
#include "tiers.cuh"
#include "vwide_pass.cuh"
#include "wide_pass.cuh"

namespace {

using wide::Args;

// Built three times (ops/_build.py), so that the parts compile side by
// side: as nmf_adaprox_wide with the wide body's instances (C <= 256 and
// K <= 32, and the second pass to K = 32 at any C); with K_WIDE defined as
// nmf_adaprox_kwide with the residual modes past K = 32 up to
// tier::kKwideK (kwide_pass.cuh); with VERY_WIDE defined as
// nmf_adaprox_vwide with the rest of the very-wide tier's (the wide body's
// VW instances at C > 256, K <= 32; post_pass.cuh's body for the second
// pass past K = 32, vwide_pass.cuh's for the residual modes past
// tier::kKwideK). Each library
// refuses the others' shapes (cudaErrorInvalidValue); the wrapper picks
// the library (ops.nmf_kernels._adaprox_library).
#if defined(K_WIDE)
constexpr int kPart = 2;
#elif defined(VERY_WIDE)
constexpr int kPart = 1;
#else
constexpr int kPart = 0;
#endif
constexpr bool kVeryWide = kPart == 1;

// Built for two blocks of 8 warps per SM (at most 128 registers a thread)
// where KB = 8 or the pass has no residual, else, and for the very-wide
// instances (VW), for one (up to 255): wide::blocks_per_sm.
template <int KB, typename ST, typename MT, int MODE, bool VW>
__global__ void __launch_bounds__(wide::kThreads,
                                  wide::blocks_per_sm(KB, MODE, VW))
adaprox_wide_kernel(Args<ST, MT> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  wide::body<KB, ST, MT, MODE, VW>(a, smem);
}

__global__ void __launch_bounds__(wide::kFinThreads)
adaprox_wide_finalize(const float* __restrict__ partials, long long rows,
                      wide::Entries e, bool half_first,
                      float* __restrict__ gA, float* __restrict__ rowsum,
                      float* __restrict__ stats) {
  wide::finalize(partials, rows, e, half_first, gA, rowsum, stats);
}

// The very-wide body past K = 256 (vwide_pass.cuh): one block per SM, up
// to 255 registers.
template <typename ST, typename MT, int MODE>
__global__ void __launch_bounds__(wide::kThreads, 1)
adaprox_vwide_kernel(Args<ST, MT> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  vwide::body<ST, MT, MODE>(a, smem);
}

// Split pass 2 past K = 32 (post_pass.cuh): the row sums' streaming pass,
// and its finalize.
template <typename ST>
__global__ void __launch_bounds__(wide::kThreads, 2)
adaprox_post_kernel(Args<ST, float> a) {
  post::rowsum_body<ST>(a);
}

__global__ void __launch_bounds__(wide::kFinThreads)
adaprox_post_finalize(const float* __restrict__ partials, long long rows,
                      int mode, int pr, int C, int K,
                      float* __restrict__ rowsum, float* __restrict__ stats) {
  post::finalize(partials, rows, mode, pr, C, K, rowsum, stats);
}

// The very-wide tier's residual modes past K = 32 up to K = 256
// (kwide_pass.cuh): one block per SM, up to 255 registers.
template <int KB, typename ST, typename MT, int MODE>
__global__ void __launch_bounds__(wide::kThreads, 1)
adaprox_kwide_kernel(Args<ST, MT> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  kwide::body<KB, ST, MT, MODE>(a, smem);
}

template <int KB, typename ST, typename MT>
int launch_kwide(int mode, const Args<ST, MT>& args, float* gA,
                 float* rowsum, float* stats, cudaStream_t stream) {
  static wide::LaunchCache cache[2];
  if (mode == 0)
    return kwide::launch<KB, ST, MT, wide::kAda>(
        adaprox_kwide_kernel<KB, ST, MT, wide::kAda>, adaprox_wide_finalize,
        cache[0], args, gA, rowsum, stats, stream);
  return kwide::launch<KB, ST, MT, wide::kAdaPre>(
      adaprox_kwide_kernel<KB, ST, MT, wide::kAdaPre>, adaprox_wide_finalize,
      cache[1], args, gA, rowsum, stats, stream);
}

template <typename ST, typename MT, int MODE>
int launch_vwide(const Args<ST, MT>& args, float* gA, float* rowsum,
                 float* stats, cudaStream_t stream) {
  static wide::LaunchCache cache;
  return vwide::launch<ST, MT, MODE>(adaprox_vwide_kernel<ST, MT, MODE>,
                                     adaprox_wide_finalize, cache, args, gA,
                                     rowsum, stats, stream);
}

template <int KB, typename ST, typename MT, int MODE, bool VW = false>
int launch_mode(const Args<ST, MT>& args, float* gA, float* rowsum,
                float* stats, cudaStream_t stream) {
  static wide::LaunchCache cache;
  return wide::launch<KB, ST, MT, MODE, VW>(
      adaprox_wide_kernel<KB, ST, MT, MODE, VW>, adaprox_wide_finalize, cache,
      args, gA, rowsum, stats, stream);
}

// VW: the very-wide instances (C > 256).
template <int KB, typename ST, typename MT, bool VW>
int launch_modes(int mode, const Args<ST, MT>& args, float* gA,
                 float* rowsum, float* stats, cudaStream_t stream) {
  if (mode == 0)
    return launch_mode<KB, ST, MT, wide::kAda, VW>(args, gA, rowsum, stats,
                                                   stream);
  return launch_mode<KB, ST, MT, wide::kAdaPre, VW>(args, gA, rowsum, stats,
                                                    stream);
}

template <int KB, typename ST, typename MT>
int launch_kb(int mode, const Args<ST, MT>& args, float* gA, float* rowsum,
              float* stats, cudaStream_t stream) {
  if (args.C > wide::kMaxC) {
    if constexpr (kVeryWide)
      return launch_modes<KB, ST, MT, true>(mode, args, gA, rowsum, stats,
                                            stream);
  } else if constexpr (kPart == 0) {
    return launch_modes<KB, ST, MT, false>(mode, args, gA, rowsum, stats,
                                           stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename ST, typename MT>
int launch_types(int mode, const Args<ST, MT>& args, float* gA,
                 float* rowsum, float* stats, cudaStream_t stream) {
  // modes 0 and 1: the passes with a residual
  const tier::Body body = tier::body_for(tier::kK2, true, args.K);
  if (body == tier::kKwide) {
    if constexpr (kPart == 2) {
      switch (tier::kb_for(tier::kK2, true, args.K)) {
        case 64:
          return launch_kwide<64>(mode, args, gA, rowsum, stats, stream);
        case 128:
          return launch_kwide<128>(mode, args, gA, rowsum, stats, stream);
        default:
          return launch_kwide<256>(mode, args, gA, rowsum, stats, stream);
      }
    }
    return (int)cudaErrorInvalidValue;
  }
  if constexpr (kPart == 2) return (int)cudaErrorInvalidValue;
  if (body == tier::kVwide) {
    if constexpr (kVeryWide) {
      if (mode == 0)
        return launch_vwide<ST, MT, wide::kAda>(args, gA, rowsum, stats,
                                                stream);
      return launch_vwide<ST, MT, wide::kAdaPre>(args, gA, rowsum, stats,
                                                 stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (tier::kb_for(tier::kK2, true, args.K)) {
    case 8:
      return launch_kb<8>(mode, args, gA, rowsum, stats, stream);
    case 16:
      return launch_kb<16>(mode, args, gA, rowsum, stats, stream);
    case 32:
      return launch_kb<32>(mode, args, gA, rowsum, stats, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Pass 2 reads no moments: one moment type; nor A: the wide instances at
// any C up to K = 32, post_pass.cuh's body beyond.
template <typename ST>
int launch_post(const Args<ST, float>& args, float* rowsum, float* stats,
                cudaStream_t stream) {
  const bool on_post = tier::body_for(tier::kK2, false, args.K) == tier::kPost;
  if constexpr (kVeryWide) {
    static wide::LaunchCache cache;
    if (on_post)
      return post::launch<wide::kAdaPost, post::kPass2, ST>(
          adaprox_post_kernel<ST>, adaprox_post_finalize, cache, args,
          rowsum, stats, stream);
    return (int)cudaErrorInvalidValue;
  } else if constexpr (kPart == 2) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (on_post) return (int)cudaErrorInvalidValue;
    switch (tier::kb_for(tier::kK2, false, args.K)) {
      case 8:
        return launch_mode<8, ST, float, wide::kAdaPost>(args, nullptr,
                                                         rowsum, stats,
                                                         stream);
      case 16:
        return launch_mode<16, ST, float, wide::kAdaPost>(args, nullptr,
                                                          rowsum, stats,
                                                          stream);
      case 32:
        return launch_mode<32, ST, float, wide::kAdaPost>(args, nullptr,
                                                          rowsum, stats,
                                                          stream);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
}

int mode_of(int mode) {
  return mode == 0 ? wide::kAda : (mode == 1 ? wide::kAdaPre : wide::kAdaPost);
}

}  // namespace

extern "C" {

// Floats of one row of the scratch buffer for `mode` (0 the compiled
// chain, 1 split pass 1, 2 split pass 2) and a (C, K) problem: one group's
// row of partial sums up to K = 32 (the wide body and its very-wide
// instances); beyond, the kwide body's, the very-wide body's with its
// per-group scratch beside it, or split pass 2's row sums (post_pass.cuh);
// -1 for C < 1, K < 1 or a width past an int. The caller allocates the
// scratch buffer as (nmf_adaprox_wide_partials_rows(N, tile_n), width)
// floats.
int nmf_adaprox_wide_partials_width(int mode, int C, int K) {
  if (mode < 0 || mode > 2 || C < 1 || K < 1) return -1;
  const tier::Body body = tier::body_for(tier::kK2, mode != 2, K);
  if (body == tier::kWide) return wide::entries(mode_of(mode), C, K).total;
  const long long w = body == tier::kPost
                          ? post::width(mode_of(mode), K)
                          : vwide::width(mode_of(mode), C, K);
  return w > 0x7fffffffLL ? -1 : (int)w;
}

// Rows of partial sums for N columns in tiles of tile_n (the groups of
// work units, at most 264, the most any instance makes), or -1 for N < 1
// or tile_n < 1.
long long nmf_adaprox_wide_partials_rows(long long N, long long tile_n) {
  if (N < 1 || tile_n < 1) return -1;
  return wide::group_count(wide::unit_count(N, tile_n), 2);
}

// One pass on `stream`. Device pointers to contiguous row-major arrays: A
// (C, K), alpha (K,), gA (C, K), rowsum (K,), stats and partials float32;
// S, S_new (K, N), Y and W (C, N; W may be null) float32, or bfloat16 when
// store_bf16 is 1; M, V, M_new, V_new (K, N) float32, or bfloat16 when
// moment_bf16 is 1; pre, pre_step and P (K, N) float32. The scalars b1_t,
// bc1, bc2 come by value, or from the device buffer `scalars` when it is not
// null. The chain's n_ops codes and thresholds come from host arrays,
// applied `repeat` times. Mode 0 writes S_new, M_new, V_new, gA, rowsum and
// stats [loss, |S' - S|^2, |S'|^2]; mode 1 writes M_new, V_new, pre (x),
// pre_step (alpha / Psi_safe), gA and stats [loss]; mode 2 reads S and P
// and writes rowsum, stats [|S' - S|^2, |S'|^2] and, with store_bf16, S_new
// (null in float32: S' is P). Returns cudaGetLastError() after the
// launches; does not synchronize.
int nmf_adaprox_wide(int mode, const void* A, const void* S, const void* M,
                     const void* V, const void* Y, const void* W,
                     const void* alpha, const void* scalars, float b1_t,
                     float bc1, float bc2, float one_minus_b2, float b2,
                     float eps, const void* P, int n_ops, int repeat,
                     const int* ops, const float* thresh, int store_bf16,
                     int moment_bf16, int C, int K, long long N,
                     long long tile_n, void* S_new, void* M_new, void* V_new,
                     void* pre, void* pre_step, void* gA, void* rowsum,
                     void* stats, void* partials, void* stream) {
  if (nmf_adaprox_wide_partials_width(mode, C, K) < 0 || N < 1 ||
      tile_n < 1 || n_ops < 0 || n_ops > kMaxChain || repeat < 0)
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
  float* rs = static_cast<float*>(rowsum);
  float* st = static_cast<float*>(stats);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  auto fill = [&](auto& args) {
    using ST = std::remove_pointer_t<decltype(args.out)>;
    using MT = std::remove_pointer_t<decltype(args.M_out)>;
    args.A = static_cast<const float*>(A);
    args.S = static_cast<const ST*>(S);
    args.Y = static_cast<const ST*>(Y);
    args.W = static_cast<const ST*>(W);
    args.M = static_cast<const MT*>(M);
    args.V = static_cast<const MT*>(V);
    args.alpha = static_cast<const float*>(alpha);
    args.dsc = static_cast<const float*>(scalars);
    args.b1_t = b1_t;
    args.bc1 = bc1;
    args.bc2 = bc2;
    args.one_minus_b2 = one_minus_b2;
    args.b2 = b2;
    args.eps = eps;
    args.P = static_cast<const float*>(P);
    args.chain = chain;
    args.C = C;
    args.K = K;
    args.N = N;
    args.tile_n = tile_n;
    args.n_units = n_units;
    args.out = static_cast<ST*>(S_new);
    args.M_out = static_cast<MT*>(M_new);
    args.V_out = static_cast<MT*>(V_new);
    args.pre = static_cast<float*>(pre);
    args.pre_step = static_cast<float*>(pre_step);
    args.partials = static_cast<float*>(partials);
  };
  if (mode == 2) {
    if (store_bf16) {
      Args<__nv_bfloat16, float> args{};
      fill(args);
      return launch_post<__nv_bfloat16>(args, rs, st, strm);
    }
    Args<float, float> args{};
    fill(args);
    return launch_post<float>(args, rs, st, strm);
  }
  if (store_bf16) {
    if (moment_bf16) {
      Args<__nv_bfloat16, __nv_bfloat16> args{};
      fill(args);
      return launch_types(mode, args, ga, rs, st, strm);
    }
    Args<__nv_bfloat16, float> args{};
    fill(args);
    return launch_types(mode, args, ga, rs, st, strm);
  }
  if (moment_bf16) {
    Args<float, __nv_bfloat16> args{};
    fill(args);
    return launch_types(mode, args, ga, rs, st, strm);
  }
  Args<float, float> args{};
  fill(args);
  return launch_types(mode, args, ga, rs, st, strm);
}

}  // extern "C"
