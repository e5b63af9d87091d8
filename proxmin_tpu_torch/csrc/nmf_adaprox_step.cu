// K2: one S-side AdaProx (proximal Adam, scheme "adam") iteration in a
// single pass over the pixel columns.
//
// Replaces the Pallas TPU kernel proxmin_tpu/ops/nmf_kernels.py:525
// (fused_nmf_adaprox_step; body _adaprox_step_kernel :409; residual product
// _residual_dot :63, its "fma" path :82-89). Per pixel column n, with the
// per-row step alpha (K) and the scalars b1_t, bc1 = 1/(1 - b1_t^t),
// bc2 = 1/(1 - b2^t), by value or, in the device-scalar entry, read from a
// three-float buffer on the card (an exported loop computes them there from
// its iteration counter, so nothing is read back to the host):
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
// S, Y and W are stored as float or as bfloat16 (the store type ST), and M
// and V as float or bfloat16 (the moment type MT); compute is f32. With the
// bfloat16 store, as in the TPU kernel (nmf_kernels.py:451-506): the
// residual multiplies A rounded to bfloat16 by the bfloat16 S (each product
// exact in f32), gS uses the f32 A, S' is stored rounded to nearest even,
// and the row sums and the statistics use the stored S'; gA uses the old S.
//
// What bounds it on an H100: bytes. Each iteration reads Y (C x N), S, M and
// V (K x N each) and writes S', M' and V': (C + 6K) N 4 bytes with float
// moments, 188 MB at the flagship C=5, K=7, N=1e6 (56 us at 3.35 TB/s);
// (C + 2K) N 4 + 4 K N 2 = 132 MB with bfloat16 moments; 94 MB with the
// bfloat16 store as well; C N itemsize more when W streams. The arithmetic,
// about N K (6C + 20) flops, is far below what the card's f32 units do in
// that time.
//
// What the design does about it:
// - A ring of shared-memory stages. A stage holds a sub-tile of kSub pixel
//   columns of every input row (S, M, V: K rows each; Y, W: C rows each).
//   Where the row starts and the sub-tile's bytes are 16-byte aligned (the
//   flagship), one thread fills a stage with 1-D cp.async.bulk copies that
//   complete on the stage's mbarrier; otherwise (ragged N, bfloat16 rows of
//   odd N) every thread copies its column and arrives on the barrier. Two to
//   four stages are in flight, so the loads never wait on the arithmetic.
// - The consumers compute from shared memory, one column per thread, and
//   store S', M' and V' straight to global memory, coalesced. They write D
//   to shared memory beside the S sub-tile; gA = D S^T is then summed from
//   shared memory, each (c, k) entry by one warp (lanes over a fixed
//   stride of columns, unrolled over a full sub-tile). A thread keeps only
//   its share of gA, the row sums and the three statistics: at most 80
//   registers, no spills, and three blocks per SM for C, K <= 8 (two ring
//   stages at the flagship with float32 moments, up to four where the rows
//   are narrower); two blocks per SM for C <= 16.
// - A persistent grid: (SMs x resident blocks) blocks walk the tiles of
//   tile_n columns, j = blockIdx.x, blockIdx.x + gridDim.x, ... Every tile
//   writes its own row of partial sums in a fixed order (lanes, then a
//   shuffle tree, then the warps in order), so the summation order depends
//   on tile_n alone, whatever the grid or the card, and two launches give
//   the same bits, which the exact resume relies on. No atomics.
// - The finalize launch gives each entry one warp: the lanes stride over
//   the tile rows in double, then a fixed shuffle tree.
// - The update is written with __fmul_rn/__fadd_rn/__fdiv_rn/__fsqrt_rn so
//   that nvcc contracts nothing into an FMA: the products round as the
//   plain PyTorch version's separate elementwise ops do, and a one-ulp
//   difference cannot flip a bfloat16 store. Build without --use_fast_math.
// - NaN survives the prox and the Psi floor (x < 0 ? 0 : x, not fmaxf), so
//   the solver's divergence detection sees it.
//
// K5, the packed-state variant, is this kernel with another layout (the
// template parameter PK). It replaces the Pallas TPU kernel
// benchmarks/stream_merge.py:105 (packed_step; body _packed_kernel :43):
// K2's unweighted iteration with prox max(., 0) on
//   kPackSMV: one (3K, N) f32 array [S; M; V] in and one out;
//   kPackMV:  S (K, N) f32 plus one (2K, N) bfloat16 array [M; V].
// The layout changes only where S, M and V are read and written (row
// offsets K and 2K), so a packed result equals K2's bit for bit on the
// same inputs and a timing compares the layouts alone.

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bulk_ring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Pixel columns per ring stage: one per thread.
constexpr int kSub = kThreads;
constexpr int kMaxStages = 4;
// Resident blocks per SM an instance is built for: three for C, K <= 8 (at
// most 80 registers), two for C <= 16, whose wider arrays would spill at
// 80. The dynamic shared memory a block may take and still leave room for
// that many (228 KB per SM, 1 KB of it reserved per block, the static
// arrays under 1.5 KB), and the most one block may take beside its static
// shared memory (227 KB in all).
template <int CB>
constexpr int kBlocksPerSM = CB <= 8 ? 3 : 2;
constexpr int smem_per_block(int blocks) { return (228 / blocks - 2) * 1024; }
constexpr int kSmemMax = 224 * 1024;

// Row layout of one tile's partial sums.
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

// Byte offsets of the rows of one ring stage (each row kSub elements) and
// the stage's size.
struct Ring {
  int s, m, v, y, w, bytes;
};

Ring ring_layout(int C, int K, int ss, int ms, bool weighted) {
  Ring r;
  r.s = 0;
  r.m = r.s + K * kSub * ss;
  r.v = r.m + K * kSub * ms;
  r.y = r.v + K * kSub * ms;
  r.w = r.y + C * kSub * ss;
  r.bytes = r.w + (weighted ? C * kSub * ss : 0);
  return r;
}

// Where S, M and V live: K2's three arrays, or K5's packed layouts.
constexpr int kSeparate = 0, kPackSMV = 1, kPackMV = 2;

// DS: b1_t, bc1 and bc2 come from the device buffer dsc (shared memory
// holds them for the block) instead of sc; the arithmetic is the same.
template <int CB, int KB, typename ST, typename MT, int PK, bool DS>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM<CB>)
adaprox_step_kernel(const ST* __restrict__ S_in, const MT* __restrict__ M_in,
                    const MT* __restrict__ V_in, const float* __restrict__ A,
                    const ST* __restrict__ Y, const ST* __restrict__ W,
                    const float* __restrict__ alpha, Scalars sc,
                    const float* __restrict__ dsc, int prox_plus, int C, int K, long long N,
                    long long tile_n, Ring ring, int stages,
                    ST* __restrict__ S_out, MT* __restrict__ M_out,
                    MT* __restrict__ V_out, float* __restrict__ partials) {
  using L = Layout<CB, KB>;
  constexpr bool kF32 = std::is_same<ST, float>::value;
  constexpr int ss = sizeof(ST), ms = sizeof(MT);
  // gA entries per warp: entry p = warp + i kWarps of the C x K ones
  constexpr int kGAPer = (CB * KB + kWarps - 1) / kWarps;
  // the layout: K2 passes three arrays; kPackSMV passes [S; M; V] as S_in
  // and S_out; kPackMV passes [M; V] as M_in and M_out
  const long long KN = (long long)K * N;
  const ST* S = S_in;
  ST* S_new = S_out;
  const MT* M = PK == kPackSMV ? reinterpret_cast<const MT*>(S_in + KN) : M_in;
  MT* M_new = PK == kPackSMV ? reinterpret_cast<MT*>(S_out + KN) : M_out;
  const MT* V = PK == kSeparate ? V_in : M + KN;
  MT* V_new = PK == kSeparate ? V_out : M_new + KN;

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float As[CB][KB];
  // A as the residual product takes it: A itself in f32; with the bfloat16
  // store, A rounded to bfloat16 (bfloat16 x bfloat16 products are exact in
  // f32). The f32 instance reads As for both.
  __shared__ float A16[kF32 ? 1 : CB][KB];
  float(*Ar)[KB] = kF32 ? As : A16;
  __shared__ float alphas[KB];
  __shared__ float dscal[DS ? 3 : 1];
  __shared__ float red[kWarps][KB + 3];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  float* Dsm = reinterpret_cast<float*>(smem + stages * ring.bytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < CB * KB; i += kThreads) {
    const int c = i / KB, k = i % KB;
    const float a = (c < C && k < K) ? A[c * K + k] : 0.f;
    As[c][k] = a;
    if constexpr (!kF32) A16[c][k] = __bfloat162float(__float2bfloat16_rn(a));
  }
  for (int k = tid; k < KB; k += kThreads) alphas[k] = (k < K) ? alpha[k] : 0.f;
  if constexpr (DS) {
    if (tid < 3) dscal[tid] = dsc[tid];
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // (1 - b1_t) in f32, as the TPU kernel computes it from its f32 scalar
  const float one_minus_b1 = __fsub_rn(1.f, DS ? dscal[0] : sc.b1_t);

  const long long n_tiles = (N + tile_n - 1) / tile_n;
  const bool weighted = W != nullptr;
  const unsigned long long ptr_bits =
      reinterpret_cast<unsigned long long>(S) |
      reinterpret_cast<unsigned long long>(M) |
      reinterpret_cast<unsigned long long>(V) |
      reinterpret_cast<unsigned long long>(Y) |
      reinterpret_cast<unsigned long long>(W);
  const bool base_aligned =
      ((ptr_bits | (unsigned long long)(N * ss) |
        (unsigned long long)(N * ms)) & 15ull) == 0;

  auto n_subs = [&](long long j) {
    const long long w = min(tile_n, N - j * tile_n);
    return (w + kSub - 1) / kSub;
  };
  // Fill stage st with sub-tile sub of tile j; every thread arrives once.
  auto fill = [&](int st, long long j, long long sub) {
    const long long c0 = j * tile_n + sub * kSub;
    const int width = (int)min((long long)kSub, min(j * tile_n + tile_n, N) - c0);
    unsigned char* base = smem + st * ring.bytes;
    const bool bulk =
        base_aligned && (((unsigned long long)(c0 * ss) |
                          (unsigned long long)(c0 * ms) |
                          (unsigned long long)(width * ss) |
                          (unsigned long long)(width * ms)) & 15ull) == 0;
    if (bulk) {
      if (tid == 0) {
        // the stage was last read through the generic proxy
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        const uint32_t rows_s = K + C * (weighted ? 2 : 1);
        mbar_arrive_expect_tx(&full[st], (uint32_t)width *
                                             (rows_s * ss + 2u * K * ms));
        for (int k = 0; k < K; ++k) {
          const long long off = k * N + c0;
          bulk_load(base + ring.s + k * kSub * ss, S + off, width * ss,
                    &full[st]);
          bulk_load(base + ring.m + k * kSub * ms, M + off, width * ms,
                    &full[st]);
          bulk_load(base + ring.v + k * kSub * ms, V + off, width * ms,
                    &full[st]);
        }
        for (int c = 0; c < C; ++c) {
          const long long off = c * N + c0;
          bulk_load(base + ring.y + c * kSub * ss, Y + off, width * ss,
                    &full[st]);
          if (weighted)
            bulk_load(base + ring.w + c * kSub * ss, W + off, width * ss,
                      &full[st]);
        }
      } else {
        mbar_arrive(&full[st]);
      }
      return;
    }
    if (tid < width) {
      ST* sS = reinterpret_cast<ST*>(base + ring.s);
      MT* sM = reinterpret_cast<MT*>(base + ring.m);
      MT* sV = reinterpret_cast<MT*>(base + ring.v);
      ST* sY = reinterpret_cast<ST*>(base + ring.y);
      ST* sW = reinterpret_cast<ST*>(base + ring.w);
      for (int k = 0; k < K; ++k) {
        const long long i = k * N + c0 + tid;
        sS[k * kSub + tid] = S[i];
        sM[k * kSub + tid] = M[i];
        sV[k * kSub + tid] = V[i];
      }
      for (int c = 0; c < C; ++c) {
        const long long i = c * N + c0 + tid;
        sY[c * kSub + tid] = Y[i];
        if (weighted) sW[c * kSub + tid] = W[i];
      }
    }
    mbar_arrive(&full[st]);
  };

  // the producer's cursor runs `stages` sub-tiles ahead of the consumers'
  long long pj = blockIdx.x, ps = 0;
  auto advance = [&]() {
    if (++ps == n_subs(pj)) {
      ps = 0;
      pj += gridDim.x;
    }
  };
  for (int st = 0; st < stages && pj < n_tiles; ++st) {
    fill(st, pj, ps);
    advance();
  }

  long long q = 0;  // the consumers' flat sub-tile count
  for (long long j = blockIdx.x; j < n_tiles; j += gridDim.x) {
    float ga[kGAPer], rs[KB], st0 = 0.f, st1 = 0.f, st2 = 0.f;
#pragma unroll
    for (int i = 0; i < kGAPer; ++i) ga[i] = 0.f;
#pragma unroll
    for (int k = 0; k < KB; ++k) rs[k] = 0.f;
    const long long subs = n_subs(j);
    for (long long sub = 0; sub < subs; ++sub, ++q) {
      const int st = (int)(q % stages);
      mbar_wait(&full[st], (uint32_t)((q / stages) & 1));
      const long long c0 = j * tile_n + sub * kSub;
      const int width =
          (int)min((long long)kSub, min(j * tile_n + tile_n, N) - c0);
      const unsigned char* base = smem + st * ring.bytes;
      const ST* sS = reinterpret_cast<const ST*>(base + ring.s);
      const MT* sM = reinterpret_cast<const MT*>(base + ring.m);
      const MT* sV = reinterpret_cast<const MT*>(base + ring.v);
      const ST* sY = reinterpret_cast<const ST*>(base + ring.y);
      const ST* sW = reinterpret_cast<const ST*>(base + ring.w);

      if (tid < width) {
        const long long n = c0 + tid;
        float s[KB], d[CB];
#pragma unroll
        for (int k = 0; k < KB; ++k)
          s[k] = (k < K) ? to_f32(sS[k * kSub + tid]) : 0.f;
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          float dc = 0.f;
          if (c < C) {
            float r = Ar[c][0] * s[0];
#pragma unroll
            for (int k = 1; k < KB; ++k) {
              if (k < K) r = fmaf(Ar[c][k], s[k], r);
            }
            r -= to_f32(sY[c * kSub + tid]);
            dc = weighted ? to_f32(sW[c * kSub + tid]) * r : r;
            Dsm[c * kSub + tid] = dc;
            st0 = fmaf(dc, r, st0);
          }
          d[c] = dc;
        }
#pragma unroll
        for (int k = 0; k < KB; ++k) {
          if (k < K) {
            float g = 0.f;
#pragma unroll
            for (int c = 0; c < CB; ++c) {
              if (c < C) g = fmaf(As[c][k], d[c], g);
            }
            const int i = k * kSub + tid;
            const float b1_t = DS ? dscal[0] : sc.b1_t;
            const float bc1 = DS ? dscal[1] : sc.bc1;
            const float bc2 = DS ? dscal[2] : sc.bc2;
            const float m1 = __fadd_rn(__fmul_rn(one_minus_b1, g),
                                       __fmul_rn(b1_t, to_f32(sM[i])));
            const float v1 =
                __fadd_rn(__fmul_rn(sc.one_minus_b2, __fmul_rn(g, g)),
                          __fmul_rn(sc.b2, to_f32(sV[i])));
            const float phi = __fmul_rn(m1, bc1);
            const float psi =
                __fadd_rn(__fsqrt_rn(__fmul_rn(v1, bc2)), sc.eps);
            const float psi_safe = (psi < FLT_MIN) ? FLT_MIN : psi;  // keeps NaN
            float x = __fsub_rn(
                s[k], __fmul_rn(alphas[k], __fdiv_rn(phi, psi_safe)));
            // keeps NaN (fmaxf would turn it into 0 and hide a divergence)
            if (prox_plus && x < 0.f) x = 0.f;
            const long long gi = k * N + n;
            x = store(S_new, gi, x);
            store(M_new, gi, m1);
            store(V_new, gi, v1);
            const float dk = x - s[k];
            rs[k] += x;
            st1 = fmaf(dk, dk, st1);
            st2 = fmaf(x, x, st2);
          }
        }
      }
      __syncthreads();  // D of the sub-tile is in shared memory

      // gA += D S^T over the sub-tile: entry p by warp p % kWarps, lane l
      // over the columns l, l + 32, ... (unrolled for a full sub-tile, so
      // that a lane's shared-memory loads are all in flight at once)
#pragma unroll
      for (int i = 0; i < kGAPer; ++i) {
        const int p = warp + i * kWarps;
        if (p < C * K) {
          const int c = p / K, k = p % K;
          float a = ga[i];
          if (width == kSub) {
#pragma unroll
            for (int n = lane; n < kSub; n += 32)
              a = fmaf(Dsm[c * kSub + n], to_f32(sS[k * kSub + n]), a);
          } else {
            for (int n = lane; n < width; n += 32)
              a = fmaf(Dsm[c * kSub + n], to_f32(sS[k * kSub + n]), a);
          }
          ga[i] = a;
        }
      }
      __syncthreads();  // the stage and D are free again
      if (pj < n_tiles) {
        fill(st, pj, ps);
        advance();
      }
    }

    // Tile j's row of partial sums, in a fixed order: each gA entry's lanes
    // by a shuffle tree; the row sums and the statistics by a shuffle tree
    // in each warp, then the warps in order.
    float* row = partials + j * L::kP;
#pragma unroll
    for (int i = 0; i < kGAPer; ++i) {
      float v = ga[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      const int p = warp + i * kWarps;
      if (lane == 0 && p < C * K) row[L::kGA + (p / K) * KB + p % K] = v;
    }
#pragma unroll
    for (int e = 0; e < KB + 3; ++e) {
      float v = e < KB ? rs[e] : (e == KB ? st0 : (e == KB + 1 ? st1 : st2));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][e] = v;
    }
    __syncthreads();
    if (tid < KB + 3) {
      float v = red[0][tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += red[w][tid];
      row[L::kRowsum + tid] = v;
    }
  }
}

// Second launch: one warp per entry; its lanes sum the tile rows in a fixed
// stride (in double), then a fixed shuffle tree, and lane 0 rounds once and
// writes gA (C x K), rowsum (K) and stats = [loss, |S' - S|^2, |S'|^2].
// Row entries outside (C, K) are never written and never read into a
// result.
template <int CB, int KB>
__global__ void __launch_bounds__(kThreads)
adaprox_step_finalize(const float* __restrict__ partials, long long n_rows,
                      int C, int K, float* __restrict__ gA,
                      float* __restrict__ rowsum,
                      float* __restrict__ stats) {
  using L = Layout<CB, KB>;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= L::kP) return;  // whole warps return
  double v = 0.0;
  for (long long b = lane; b < n_rows; b += 32)
    v += (double)partials[b * L::kP + p];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane != 0) return;
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

template <int CB, int KB, typename ST, typename MT, int PK = kSeparate,
          bool DS = false>
int launch(const float* A, const void* S, const void* M, const void* V,
           const void* Y, const void* W, const float* alpha, Scalars sc,
           const float* dsc, int prox_plus, int C, int K, long long N, long long tile_n,
           void* S_new, void* M_new, void* V_new, float* gA, float* rowsum,
           float* stats, float* partials, cudaStream_t stream) {
  auto kernel = adaprox_step_kernel<CB, KB, ST, MT, PK, DS>;
  // per instance: the SM count, the dynamic shared memory the kernel is
  // allowed (raised before the first launch that needs more than 48 KB),
  // and the resident blocks per SM at the last size asked for
  static int sms = 0, allowed_smem = 0, cached_smem = -1, cached_per_sm = 0;
  cudaError_t err;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const Ring ring = ring_layout(C, K, sizeof(ST), sizeof(MT), W != nullptr);
  const int d_bytes = C * kSub * (int)sizeof(float);
  int stages = (smem_per_block(kBlocksPerSM<CB>) - d_bytes) / ring.bytes;
  stages = stages < 2 ? 2 : (stages > kMaxStages ? kMaxStages : stages);
  const int smem = stages * ring.bytes + d_bytes;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > allowed_smem) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed_smem = smem;
  }
  if (smem != cached_smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached_per_sm,
                                                        kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (cached_per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cached_smem = smem;
  }
  const long long n_tiles = (N + tile_n - 1) / tile_n;
  const long long resident = (long long)sms * cached_per_sm;
  const unsigned grid = (unsigned)(n_tiles < resident ? n_tiles : resident);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const ST*>(S), static_cast<const MT*>(M),
      static_cast<const MT*>(V), A, static_cast<const ST*>(Y),
      static_cast<const ST*>(W), alpha, sc, dsc, prox_plus, C, K, N, tile_n,
      ring, stages, static_cast<ST*>(S_new), static_cast<MT*>(M_new),
      static_cast<MT*>(V_new), partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int kFinalBlocks = (Layout<CB, KB>::kP + kWarps - 1) / kWarps;
  adaprox_step_finalize<CB, KB><<<kFinalBlocks, kThreads, 0, stream>>>(
      partials, n_tiles, C, K, gA, rowsum, stats);
  return (int)cudaGetLastError();
}

template <int CB, int KB, typename ST, typename MT>
int launch_scalars(const float* A, const void* S, const void* M,
                   const void* V, const void* Y, const void* W,
                   const float* alpha, Scalars sc, const float* dsc,
                   int prox_plus, int C, int K, long long N, long long tile_n,
                   void* S_new, void* M_new, void* V_new, float* gA,
                   float* rowsum, float* stats, float* partials,
                   cudaStream_t stream) {
  if (dsc != nullptr)
    return launch<CB, KB, ST, MT, kSeparate, true>(
        A, S, M, V, Y, W, alpha, sc, dsc, prox_plus, C, K, N, tile_n, S_new,
        M_new, V_new, gA, rowsum, stats, partials, stream);
  return launch<CB, KB, ST, MT>(A, S, M, V, Y, W, alpha, sc, nullptr,
                                prox_plus, C, K, N, tile_n, S_new, M_new,
                                V_new, gA, rowsum, stats, partials, stream);
}

template <int CB, int KB, typename ST>
int launch_moments(int moment_bf16, const float* A, const void* S,
                   const void* M, const void* V, const void* Y,
                   const void* W, const float* alpha, Scalars sc,
                   const float* dsc, int prox_plus, int C, int K, long long N,
                   long long tile_n, void* S_new, void* M_new, void* V_new,
                   float* gA, float* rowsum, float* stats, float* partials,
                   cudaStream_t stream) {
  if (moment_bf16)
    return launch_scalars<CB, KB, ST, __nv_bfloat16>(
        A, S, M, V, Y, W, alpha, sc, dsc, prox_plus, C, K, N, tile_n, S_new,
        M_new, V_new, gA, rowsum, stats, partials, stream);
  return launch_scalars<CB, KB, ST, float>(
      A, S, M, V, Y, W, alpha, sc, dsc, prox_plus, C, K, N, tile_n, S_new,
      M_new, V_new, gA, rowsum, stats, partials, stream);
}

template <int CB, int KB>
int launch_types(int store_bf16, int moment_bf16, const float* A,
                 const void* S, const void* M, const void* V, const void* Y,
                 const void* W, const float* alpha, Scalars sc,
                 const float* dsc, int prox_plus, int C, int K, long long N,
                 long long tile_n, void* S_new, void* M_new, void* V_new,
                 float* gA, float* rowsum, float* stats, float* partials,
                 cudaStream_t stream) {
  if (store_bf16)
    return launch_moments<CB, KB, __nv_bfloat16>(
        moment_bf16, A, S, M, V, Y, W, alpha, sc, dsc, prox_plus, C, K, N,
        tile_n, S_new, M_new, V_new, gA, rowsum, stats, partials, stream);
  return launch_moments<CB, KB, float>(
      moment_bf16, A, S, M, V, Y, W, alpha, sc, dsc, prox_plus, C, K, N,
      tile_n, S_new, M_new, V_new, gA, rowsum, stats, partials, stream);
}

// Both entries of K2: the scalars by value (dsc null) or from dsc.
int step_entry(const void* A, const void* S, const void* M, const void* V,
               const void* Y, const void* W, const void* alpha, Scalars sc,
               const float* dsc, int prox_plus, int store_bf16,
               int moment_bf16, int C, int K, long long N, long long tile_n,
               void* S_new, void* M_new, void* V_new, void* gA, void* rowsum,
               void* stats, void* partials, void* stream) {
  if (N < 1 || tile_n < 1) return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(A);
  const float* al = static_cast<const float*>(alpha);
  float* ga = static_cast<float*>(gA);
  float* rs = static_cast<float*>(rowsum);
  float* st = static_cast<float*>(stats);
  float* pp = static_cast<float*>(partials);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (C >= 1 && K >= 1 && C <= 8 && K <= 8)
    return launch_types<8, 8>(store_bf16, moment_bf16, a, S, M, V, Y, W, al,
                              sc, dsc, prox_plus, C, K, N, tile_n, S_new,
                              M_new, V_new, ga, rs, st, pp, strm);
  if (C >= 1 && K >= 1 && C <= 16 && K <= 8)
    return launch_types<16, 8>(store_bf16, moment_bf16, a, S, M, V, Y, W, al,
                               sc, dsc, prox_plus, C, K, N, tile_n, S_new,
                               M_new, V_new, ga, rs, st, pp, strm);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Width of one tile's row of partial sums for a (C, K) problem, or -1 when
// no compiled bound covers it. The caller allocates the scratch buffer as
// (ceil(N / tile_n), width) floats.
int nmf_adaprox_step_partials_width(int C, int K) {
  if (C >= 1 && K >= 1 && C <= 8 && K <= 8) return Layout<8, 8>::kP;
  if (C >= 1 && K >= 1 && C <= 16 && K <= 8) return Layout<16, 8>::kP;
  return -1;
}

// One fused step on `stream`. All pointers are device pointers to
// contiguous row-major arrays: A (C, K), alpha (K,), gA (C, K), rowsum
// (K,), stats (3,), partials (ceil(N / tile_n), width) float32; S and S_new
// (K, N), Y and W (C, N; W may be null) float32, or bfloat16 when
// store_bf16 is 1; M, V, M_new, V_new (K, N) float32, or bfloat16 when
// moment_bf16 is 1. The scalars come by value. Returns cudaGetLastError()
// after the launches (0 on success); does not synchronize.
int nmf_adaprox_step(const void* A, const void* S, const void* M,
                     const void* V, const void* Y, const void* W,
                     const void* alpha, float b1_t, float bc1, float bc2,
                     float one_minus_b2, float b2, float eps, int prox_plus,
                     int store_bf16, int moment_bf16, int C, int K,
                     long long N, long long tile_n, void* S_new, void* M_new,
                     void* V_new, void* gA, void* rowsum, void* stats,
                     void* partials, void* stream) {
  const Scalars sc{b1_t, bc1, bc2, one_minus_b2, b2, eps};
  return step_entry(A, S, M, V, Y, W, alpha, sc, nullptr, prox_plus,
                    store_bf16, moment_bf16, C, K, N, tile_n, S_new, M_new,
                    V_new, gA, rowsum, stats, partials, stream);
}

// The device-scalar entry: nmf_adaprox_step with b1_t, bc1 and bc2 read by
// the kernel from `scalars`, a device pointer to those three floats in that
// order; the other arguments are nmf_adaprox_step's.
int nmf_adaprox_step_dev(const void* A, const void* S, const void* M,
                         const void* V, const void* Y, const void* W,
                         const void* alpha, const void* scalars,
                         float one_minus_b2, float b2, float eps,
                         int prox_plus, int store_bf16, int moment_bf16,
                         int C, int K, long long N, long long tile_n,
                         void* S_new, void* M_new, void* V_new, void* gA,
                         void* rowsum, void* stats, void* partials,
                         void* stream) {
  if (scalars == nullptr) return (int)cudaErrorInvalidValue;
  const Scalars sc{0.f, 0.f, 0.f, one_minus_b2, b2, eps};
  return step_entry(A, S, M, V, Y, W, alpha, sc,
                    static_cast<const float*>(scalars), prox_plus,
                    store_bf16, moment_bf16, C, K, N, tile_n, S_new, M_new,
                    V_new, gA, rowsum, stats, partials, stream);
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
  const float* al = static_cast<const float*>(alpha);
  float* ga = static_cast<float*>(gA);
  float* rs = static_cast<float*>(rowsum);
  float* st = static_cast<float*>(stats);
  float* pp = static_cast<float*>(partials);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const Scalars sc{b1_t, bc1, bc2, one_minus_b2, b2, eps};
  if (!(C >= 1 && K >= 1 && C <= 8 && K <= 8))
    return (int)cudaErrorInvalidValue;
  if (MV == nullptr)
    return launch<8, 8, float, float, kPackSMV>(
        a, SMV, nullptr, nullptr, Y, nullptr, al, sc, nullptr, 1, C, K, N,
        tile_n, SMV_new, nullptr, nullptr, ga, rs, st, pp, strm);
  return launch<8, 8, float, __nv_bfloat16, kPackMV>(
      a, SMV, MV, nullptr, Y, nullptr, al, sc, nullptr, 1, C, K, N, tile_n,
      SMV_new, MV_new, nullptr, ga, rs, st, pp, strm);
}

}  // extern "C"
