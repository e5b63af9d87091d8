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
// What the design does about it: K1's (pgm_pass.cuh), with gS stored in
// place of S' and the Gram of the old S. The TPU grid runs in order and
// zero-initialises its resident sums at the first tile (pl.when(j == 0),
// :155-159) before adding every later tile into them; here each work unit
// writes its own row of partial sums and a second launch sums the rows in
// a fixed order in double, so every run gives the same bits. No tensor
// cores: the products are f32 FMAs, the TPU kernel's "fma" path.
//
// Beyond C <= 16, K <= 8 (up to C = 256, K = 32) the same function runs on
// the wide body (wide_pass.cuh, mode kGrad): the channels looped in chunks
// through shared memory, the products as register tiles over shared-memory
// tiles; there the float32 FMAs, about 3 C K + K (K + 1) / 2 per column,
// and the shared memory's delivery of the tiles' operands bound it. Beyond
// C = 256 or K = 32, for any C and K, the very-wide tier runs it: the wide
// body's VW instances to K = 32, kwide_pass.cuh's body up to K = 256,
// panel_pass.cuh's up to K = 512 (gS per column tile; gA and the Gram of
// the old S as products of their own), vwide_pass.cuh's beyond.

#include <type_traits>

#include <cuda_runtime.h>

#include "pgm_pass.cuh"
#include "kwide_pass.cuh"
#include "panel_pass.cuh"
#include "post_pass.cuh"
#include "tiers.cuh"
#include "vwide_pass.cuh"
#include "wide_pass.cuh"

namespace {

template <int CB, int KB>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM<CB>)
nmf_grad_kernel(PassArgs<float> a, Ring ring, int stages,
                int sets) {
  extern __shared__ __align__(128) unsigned char smem[];
  pass_body<CB, KB, float, false>(a, ring, stages, sets, smem);
}

template <int CB, int KB>
__global__ void __launch_bounds__(kThreads)
nmf_grad_finalize(const float* __restrict__ partials, long long n_units,
                  int C, int K, float* __restrict__ gA,
                  float* __restrict__ gram, float* __restrict__ loss) {
  finalize_body<CB, KB, false>(partials, n_units, C, K, gA, gram, loss);
}

template <int CB, int KB>
int launch(const float* A, const float* S, const float* Y, const float* W,
           int C, int K, long long N, long long tile_n, float* gA, float* gS,
           float* gram, float* loss, float* partials, cudaStream_t stream) {
  static LaunchCache cache;
  const PassArgs<float> args{A, S, Y, W, nullptr, 0, C, K, N, tile_n,
                             unit_count(N, tile_n), gS, partials};
  return launch_pass<CB, KB, float, false>(nmf_grad_kernel<CB, KB>,
                                           nmf_grad_finalize<CB, KB>, cache,
                                           args, gA, gram, loss, stream);
}

// Built for two blocks of 8 warps per SM (at most 128 registers a thread)
// where KB = 8, else, and for the very-wide instances (VW: C > 256), for
// one (up to 255): wide::blocks_per_sm.
template <int KB, bool VW>
__global__ void __launch_bounds__(wide::kThreads,
                                  wide::blocks_per_sm(KB, wide::kGrad, VW))
nmf_grad_wide_kernel(wide::Args<float, float> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  wide::body<KB, float, float, wide::kGrad, VW>(a, smem);
}

__global__ void __launch_bounds__(wide::kFinThreads)
nmf_grad_wide_finalize(const float* __restrict__ partials, long long rows,
                       wide::Entries e, bool half_first,
                       float* __restrict__ gA, float* __restrict__ gram,
                       float* __restrict__ loss) {
  wide::finalize(partials, rows, e, half_first, gA, gram, loss);
}

// The wide bodies' arguments of K3.
wide::Args<float, float> wide_args(const float* A, const float* S,
                                   const float* Y, const float* W, int C,
                                   int K, long long N, long long tile_n,
                                   float* gS, float* partials) {
  wide::Args<float, float> args{};
  args.A = A;
  args.S = S;
  args.Y = Y;
  args.W = W;
  args.C = C;
  args.K = K;
  args.N = N;
  args.tile_n = tile_n;
  args.n_units = wide::unit_count(N, tile_n);
  args.out = gS;
  args.partials = partials;
  return args;
}

template <int KB, bool VW>
int launch_wide(const float* A, const float* S, const float* Y,
                const float* W, int C, int K, long long N, long long tile_n,
                float* gA, float* gS, float* gram, float* loss,
                float* partials, cudaStream_t stream) {
  static wide::LaunchCache cache;
  const wide::Args<float, float> args =
      wide_args(A, S, Y, W, C, K, N, tile_n, gS, partials);
  return wide::launch<KB, float, float, wide::kGrad, VW>(
      nmf_grad_wide_kernel<KB, VW>, nmf_grad_wide_finalize, cache, args, gA,
      gram, loss, stream);
}

// The very-wide body beyond K = 32 (vwide_pass.cuh): one block per SM, up
// to 255 registers.
__global__ void __launch_bounds__(wide::kThreads, 1)
nmf_grad_vwide_kernel(wide::Args<float, float> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  vwide::body<float, float, wide::kGrad>(a, smem);
}

int launch_vwide(const float* A, const float* S, const float* Y,
                 const float* W, int C, int K, long long N, long long tile_n,
                 float* gA, float* gS, float* gram, float* loss,
                 float* partials, cudaStream_t stream) {
  static wide::LaunchCache cache;
  const wide::Args<float, float> args =
      wide_args(A, S, Y, W, C, K, N, tile_n, gS, partials);
  return vwide::launch<float, float, wide::kGrad>(
      nmf_grad_vwide_kernel, nmf_grad_wide_finalize, cache, args, gA, gram,
      loss, stream);
}

// The very-wide tier past K = 32 up to K = 256 (kwide_pass.cuh): one
// block per SM, up to 255 registers.
template <int KB>
__global__ void __launch_bounds__(wide::kThreads, 1)
nmf_grad_kwide_kernel(wide::Args<float, float> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  kwide::body<KB, float, float, wide::kGrad>(a, smem);
}

template <int KB>
int launch_kwide(const float* A, const float* S, const float* Y,
                 const float* W, int C, int K, long long N, long long tile_n,
                 float* gA, float* gS, float* gram, float* loss,
                 float* partials, cudaStream_t stream) {
  static wide::LaunchCache cache;
  const wide::Args<float, float> args =
      wide_args(A, S, Y, W, C, K, N, tile_n, gS, partials);
  return kwide::launch<KB, float, float, wide::kGrad>(
      nmf_grad_kwide_kernel<KB>, nmf_grad_wide_finalize, cache, args, gA,
      gram, loss, stream);
}

// Past K = 256 up to K = 512 (panel_pass.cuh): prep, the column pass (one
// block per SM, up to 255 registers), gA's and the Gram's tile-pair
// products (two blocks per SM), their finalize and the loss's.
__global__ void __launch_bounds__(wide::kThreads)
nmf_grad_panel_prep(const float* __restrict__ A, int C, int K,
                    float* __restrict__ At, float* __restrict__ Af) {
  panel::prep<float>(A, C, K, At, Af);
}

__global__ void __launch_bounds__(wide::kThreads, 1)
nmf_grad_panel_kernel(wide::Args<float, float> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  panel::column_body<float, wide::kGrad>(a, smem);
}

template <int PR>
__global__ void __launch_bounds__(wide::kThreads, 2)
nmf_grad_panel_tiles(wide::Args<float, float> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  post::product_body<PR, float>(a, smem);
}

__global__ void __launch_bounds__(wide::kFinThreads)
nmf_grad_panel_tiles_finalize(const float* __restrict__ partials,
                              long long rows, int mode, int pr, int C, int K,
                              float* __restrict__ mid,
                              float* __restrict__ stats) {
  post::finalize(partials, rows, mode, pr, C, K, mid, stats);
}

__global__ void __launch_bounds__(wide::kFinThreads)
nmf_grad_panel_finalize(const float* __restrict__ rows, long long n_rows,
                        int n, float* __restrict__ stats) {
  panel::stats_finalize(rows, n_rows, n, stats);
}

int launch_panel(const float* A, const float* S, const float* Y,
                 const float* W, int C, int K, long long N, long long tile_n,
                 float* gA, float* gS, float* gram, float* loss,
                 float* partials, cudaStream_t stream) {
  static panel::LaunchCaches caches;
  const wide::Args<float, float> args =
      wide_args(A, S, Y, W, C, K, N, tile_n, gS, partials);
  return panel::launch<float, wide::kGrad>(
      nmf_grad_panel_prep, nmf_grad_panel_kernel,
      nmf_grad_panel_tiles<post::kCross>, nmf_grad_panel_tiles<post::kGram>,
      nmf_grad_panel_tiles_finalize, nmf_grad_panel_finalize, caches, args,
      gA, gram, loss, stream);
}

bool narrow(int C, int K) { return C >= 1 && K >= 1 && C <= 16 && K <= 8; }

// Width of one row of partial sums for a (C, K) problem: the narrow
// bodies', the wide body's, and beyond K = 32 the kwide body's or the
// very-wide body's with its per-group scratch beside it; 0 where
// panel_pass.cuh runs the pass; -1 for C < 1, K < 1 or a width past an
// int.
int partials_width(int C, int K) {
  if (C < 1 || K < 1) return -1;
  if (C <= 8 && K <= 8) return Layout<8, 8, false>::kP;
  if (narrow(C, K)) return Layout<16, 8, false>::kP;
  const tier::Body body = tier::body_for(tier::kK3, true, K);
  if (body == tier::kWide) return wide::entries(wide::kGrad, C, K).total;
  if (body == tier::kPanel) return 0;
  const long long w = vwide::width(wide::kGrad, C, K);
  return w > 0x7fffffffLL ? -1 : (int)w;
}

}  // namespace

extern "C" {

// Floats of the scratch buffer for a (C, K, N) problem in tiles of
// tile_n: rows of partial sums (the narrow body's work units, parts of
// tiles, rounded up to a multiple of 4, or the most groups of units of the
// wide body, whichever are more) of the body's width, or panel_pass.cuh's
// layout past K = 256 (its residual D, C x N floats, among them); -1 for
// C < 1, K < 1, N < 1, tile_n < 1 or a width past an int. The caller
// allocates it as that many float32 values.
long long nmf_grad_scratch_floats(int C, int K, long long N,
                                  long long tile_n) {
  const int width = partials_width(C, K);
  if (width < 0 || N < 1 || tile_n < 1) return -1;
  if (!narrow(C, K) && tier::body_for(tier::kK3, true, K) == tier::kPanel)
    return panel::layout(wide::kGrad, C, K, N, wide::unit_count(N, tile_n))
        .total;
  const long long narrow_rows = stride(unit_count(N, tile_n));
  const long long groups =
      wide::group_count(wide::unit_count(N, tile_n), 2);
  return (narrow_rows > groups ? narrow_rows : groups) * width;
}

// The fused gradients on `stream`. All pointers are device pointers to
// contiguous row-major float32 arrays: A and gA (C, K), S and gS (K, N), Y
// and W (C, N; W may be null), gram (K, K), loss (1,), partials
// (nmf_grad_scratch_floats(C, K, N, tile_n) floats). Returns cudaGetLastError() after the launches (0 on
// success); does not synchronize.
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
  if (narrow(C, K))
    return launch<16, 8>(a, s, y, w, C, K, N, tile_n, ga, gs, g, l, pp, strm);
  if (C < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const tier::Body body = tier::body_for(tier::kK3, true, K);
  if (body == tier::kVwide)
    return launch_vwide(a, s, y, w, C, K, N, tile_n, ga, gs, g, l, pp, strm);
  if (body == tier::kPanel)
    return launch_panel(a, s, y, w, C, K, N, tile_n, ga, gs, g, l, pp, strm);
  if (body == tier::kKwide) {
    switch (tier::kb_for(tier::kK3, true, K)) {
      case 64:
        return launch_kwide<64>(a, s, y, w, C, K, N, tile_n, ga, gs, g, l,
                                pp, strm);
      case 128:
        return launch_kwide<128>(a, s, y, w, C, K, N, tile_n, ga, gs, g, l,
                                 pp, strm);
      default:
        return launch_kwide<256>(a, s, y, w, C, K, N, tile_n, ga, gs, g, l,
                                 pp, strm);
    }
  }
  auto wide_kb = [&](auto vw) {
    constexpr bool VW = decltype(vw)::value;
    switch (tier::kb_for(tier::kK3, true, K)) {
      case 8:
        return launch_wide<8, VW>(a, s, y, w, C, K, N, tile_n, ga, gs, g, l,
                                  pp, strm);
      case 16:
        return launch_wide<16, VW>(a, s, y, w, C, K, N, tile_n, ga, gs, g, l,
                                   pp, strm);
      default:
        return launch_wide<32, VW>(a, s, y, w, C, K, N, tile_n, ga, gs, g, l,
                                   pp, strm);
    }
  };
  if (C > wide::kMaxC) return wide_kb(std::true_type{});
  return wide_kb(std::false_type{});
}

}  // extern "C"
