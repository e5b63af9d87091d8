// The compiled prox_S chain that K1 (nmf_pgm_step.cu, nmf_pgm_wide.cu) and
// K2 (nmf_adaprox_step.cu, nmf_adaprox_wide.cu) apply to the K values of a
// pixel column once a thread has formed all of them.
//
// Replaces the call of a jittable prox_S inside the Pallas TPU kernels
// (proxmin_tpu/ops/nmf_kernels.py:272 in _pgm_step_kernel, :477-482 in
// _adaprox_step_kernel). The library operators that act on a column alone
// are primitive codes, applied in order, the whole chain `repeat` times:
//
//   kId     x                       prox_id
//   kZero   0                       prox_zero
//   kPlus   x < 0 ? 0 : x           prox_plus (NaN survives)
//   kMin    x < t ? t : x           prox_min (floor)
//   kMax    x > t ? t : x           prox_max (ceiling)
//   kHard   |x| < t ? 0 : x         prox_hard
//   kSoft   sign(x) max(|x| - t, 0) prox_soft
//   kUnity  x / sum_k x             prox_unity along axis 0 (over K)
//
// prox_hard_plus, prox_soft_plus and prox_unity_plus are two codes each,
// and an AlternatingProjections of these its members' codes in the order it
// applies them (proxmin_tpu_torch/ops/nmf_kernels.py builds the chain). A
// threshold t is a float32 number; with kRelative it is multiplied by the
// step: K1's sS, K2's per-element alpha_k / Psi_safe, as get_thresh does.
// Every operation rounds once, as the plain PyTorch version's elementwise
// operations do; the unity sum runs over k in order.

#pragma once

#include <cfloat>

namespace {

constexpr int kMaxChain = 8;
enum ProxCode { kId = 0, kZero, kPlus, kMin, kMax, kHard, kSoft, kUnity };
constexpr int kRelative = 16;

struct ProxChain {
  int n, repeat;
  int op[kMaxChain];
  float thresh[kMaxChain];
};

// The chain on entries 0..K) of one column, the op switch written once:
// `each(f)` calls f(k) for k = 0, 1, ..., K - 1 in order, `x(k)` is entry k
// (a float&), `step(k)` its step. The unity sum starts from -0, which adds
// to x(0) exactly (x(0) + x(1) + ... in order). Its zero numerators skip
// the division, whose check sends them down its slow path: 0 / sum is the
// signed zero 0 * sum wherever sum is finite and not zero, the same bits.
template <typename Each, typename X, typename Step>
__device__ __forceinline__ void run_chain(const ProxChain& pc, Each each,
                                          X x, Step step) {
  for (int r = 0; r < pc.repeat; ++r) {
    for (int i = 0; i < pc.n; ++i) {
      const int op = pc.op[i] & (kRelative - 1);
      const bool rel = (pc.op[i] & kRelative) != 0;
      const float th = pc.thresh[i];
      // the threshold of entry k
      auto t = [&](int k) { return rel ? __fmul_rn(th, step(k)) : th; };
      switch (op) {
        case kZero:
          each([&](int k) { x(k) = 0.f; });
          break;
        case kPlus:  // keeps NaN (fmaxf would turn it into 0)
          each([&](int k) {
            float& v = x(k);
            if (v < 0.f) v = 0.f;
          });
          break;
        case kMin:
          each([&](int k) {
            float& v = x(k);
            const float tk = t(k);
            if (v < tk) v = tk;
          });
          break;
        case kMax:
          each([&](int k) {
            float& v = x(k);
            const float tk = t(k);
            if (v > tk) v = tk;
          });
          break;
        case kHard:
          each([&](int k) {
            float& v = x(k);
            if (fabsf(v) < t(k)) v = 0.f;
          });
          break;
        case kSoft:
          each([&](int k) {
            float& v = x(k);
            float a = __fsub_rn(fabsf(v), t(k));
            a = a < 0.f ? 0.f : a;  // keeps NaN
            v = v > 0.f ? a : (v < 0.f ? -a : __fmul_rn(v, a));
          });
          break;
        case kUnity: {
          float sum = -0.f;
          each([&](int k) { sum = __fadd_rn(sum, x(k)); });
          const bool plain = fabsf(sum) <= FLT_MAX && sum != 0.f;
          each([&](int k) {
            float& v = x(k);
            v = (plain && v == 0.f) ? __fmul_rn(v, sum) : __fdiv_rn(v, sum);
          });
          break;
        }
        default:  // kId
          break;
      }
    }
  }
}

// The chain on x[0..K) of a column in registers (entries K..KB stay as they
// are): loops unrolled over KB, so that x stays in registers.
template <int KB, typename Step>
__device__ __forceinline__ void apply_chain(const ProxChain& pc,
                                            float (&x)[KB], int K,
                                            Step step) {
  auto each = [&](auto f) {
#pragma unroll
    for (int k = 0; k < KB; ++k)
      if (k < K) f(k);
  };
  run_chain(pc, each, [&](int k) -> float& { return x[k]; }, step);
}

// The chain on a column of K values in shared memory, x[k * pitch] (the
// wide body's K2): loops over k unrolled by four, so that the code stays
// small beside K2's update.
template <typename Step>
__device__ __forceinline__ void apply_chain_column(const ProxChain& pc,
                                                   float* x, int pitch,
                                                   int K, Step step) {
  auto each = [&](auto f) {
#pragma unroll 4
    for (int k = 0; k < K; ++k) f(k);
  };
  run_chain(pc, each, [&](int k) -> float& { return x[k * pitch]; }, step);
}

}  // namespace
