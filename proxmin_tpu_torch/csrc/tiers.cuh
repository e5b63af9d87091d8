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
// - the residual past kKwideK on vwide_pass.cuh's body, in blocks of 32
//   components.
//
// ops/nmf_kernels.py's WIDE_K and KWIDE_K are these bounds on the host.

#pragma once

namespace {
namespace tier {

constexpr int kWideK = 32;
constexpr int kKwideK = 256;

enum Body { kWide, kKwide, kVwide, kPost };

__host__ __device__ constexpr Body body_for(bool residual, int K) {
  return K <= kWideK ? kWide
                     : (!residual ? kPost : (K <= kKwideK ? kKwide : kVwide));
}

// The component bound of the instance that serves K on the wide and the
// kwide bodies (0 on vwide_pass.cuh's, whose blocks are 32 at every K, and
// on post_pass.cuh's, which has one instance a store).
__host__ __device__ constexpr int kb_for(bool residual, int K) {
  return body_for(residual, K) == kWide
             ? (K <= 8 ? 8 : (K <= 16 ? 16 : 32))
             : (body_for(residual, K) == kKwide
                    ? (K <= 64 ? 64 : (K <= 128 ? 128 : 256))
                    : 0);
}

}  // namespace tier
}  // namespace
