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

namespace {

constexpr int kMaxChain = 8;
enum ProxCode { kId = 0, kZero, kPlus, kMin, kMax, kHard, kSoft, kUnity };
constexpr int kRelative = 16;

struct ProxChain {
  int n, repeat;
  int op[kMaxChain];
  float thresh[kMaxChain];
};

// Apply the chain to x[0..K) of one column (entries K..KB stay as they
// are). step(k) gives the step of entry k.
template <int KB, typename Step>
__device__ __forceinline__ void apply_chain(const ProxChain& pc,
                                            float (&x)[KB], int K,
                                            Step step) {
  for (int r = 0; r < pc.repeat; ++r) {
    for (int i = 0; i < pc.n; ++i) {
      const int op = pc.op[i] & (kRelative - 1);
      const bool rel = (pc.op[i] & kRelative) != 0;
      const float th = pc.thresh[i];
      // the threshold of entry k
      auto t = [&](int k) { return rel ? __fmul_rn(th, step(k)) : th; };
      switch (op) {
        case kZero:
#pragma unroll
          for (int k = 0; k < KB; ++k)
            if (k < K) x[k] = 0.f;
          break;
        case kPlus:  // keeps NaN (fmaxf would turn it into 0)
#pragma unroll
          for (int k = 0; k < KB; ++k)
            if (k < K && x[k] < 0.f) x[k] = 0.f;
          break;
        case kMin:
#pragma unroll
          for (int k = 0; k < KB; ++k) {
            if (k >= K) continue;
            const float tk = t(k);
            if (x[k] < tk) x[k] = tk;
          }
          break;
        case kMax:
#pragma unroll
          for (int k = 0; k < KB; ++k) {
            if (k >= K) continue;
            const float tk = t(k);
            if (x[k] > tk) x[k] = tk;
          }
          break;
        case kHard:
#pragma unroll
          for (int k = 0; k < KB; ++k)
            if (k < K && fabsf(x[k]) < t(k)) x[k] = 0.f;
          break;
        case kSoft:
#pragma unroll
          for (int k = 0; k < KB; ++k) {
            if (k >= K) continue;
            const float v = x[k];
            float a = __fsub_rn(fabsf(v), t(k));
            a = a < 0.f ? 0.f : a;  // keeps NaN
            x[k] = v > 0.f ? a : (v < 0.f ? -a : __fmul_rn(v, a));
          }
          break;
        case kUnity: {
          float sum = x[0];
#pragma unroll
          for (int k = 1; k < KB; ++k)
            if (k < K) sum = __fadd_rn(sum, x[k]);
#pragma unroll
          for (int k = 0; k < KB; ++k)
            if (k < K) x[k] = __fdiv_rn(x[k], sum);
          break;
        }
        default:  // kId
          break;
      }
    }
  }
}

}  // namespace
