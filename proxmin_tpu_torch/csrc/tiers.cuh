// Which body of K1-K3 serves a pass of K components, in one place for the
// three libraries (nmf_pgm_wide.cu, nmf_adaprox_wide.cu, nmf_grad.cu) and
// the bodies' own bounds:
//
// - up to kWideK components, the wide body (wide_pass.cuh), its instances
//   of KB = 8, 16 and 32 (at C > 256 its VW instances);
// - past kWideK, the second passes of the split path (no residual) on
//   post_pass.cuh's body, at any K;
// - past kWideK, the passes with a residual (the compiled chains, split
//   pass 1, K3) up to kKwideK on kwide_pass.cuh's body, its instances of
//   KB = 64, 128 and 256;
// - K1's and K3's passes with a residual past kKwideK up to kPanelK on
//   panel_pass.cuh's body (register-tiled products over column tiles, the
//   reductions over the pixel axis in launches of their own);
// - the rest of the residual past kKwideK (K2's, and every kernel's past
//   kPanelK) on vwide_pass.cuh's body, in blocks of 32 components.
//
// ops/nmf_kernels.py's WIDE_K, KWIDE_K and PANEL_K are these bounds on the
// host.

#pragma once

namespace {
namespace tier {

constexpr int kWideK = 32;
constexpr int kKwideK = 256;
constexpr int kPanelK = 512;

enum Kernel { kK1, kK2, kK3 };
enum Body { kWide, kKwide, kVwide, kPost, kPanel };

__host__ __device__ constexpr Body body_for(Kernel kernel, bool residual,
                                            int K) {
  return K <= kWideK
             ? kWide
             : (!residual ? kPost
                          : (K <= kKwideK
                                 ? kKwide
                                 : (kernel != kK2 && K <= kPanelK ? kPanel
                                                                  : kVwide)));
}

// The component bound of the instance that serves K on the wide and the
// kwide bodies (0 on the others: vwide_pass.cuh's blocks are 32 at every
// K, post_pass.cuh and panel_pass.cuh have one instance a store).
__host__ __device__ constexpr int kb_for(Kernel kernel, bool residual,
                                         int K) {
  return body_for(kernel, residual, K) == kWide
             ? (K <= 8 ? 8 : (K <= 16 ? 16 : 32))
             : (body_for(kernel, residual, K) == kKwide
                    ? (K <= 64 ? 64 : (K <= 128 ? 128 : 256))
                    : 0);
}

}  // namespace tier
}  // namespace
