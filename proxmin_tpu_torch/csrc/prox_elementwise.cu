// K4: the standalone proximal operators prox_plus, prox_soft, prox_hard and
// prox_unity over a 2-D tensor, in float or double.
//
// Replaces the Pallas TPU kernels of proxmin_tpu/ops/prox_kernels.py:
// _elementwise_call :68 (pallas_call :78) with the bodies _plus_kernel :95,
// _soft_kernel :99, _hard_kernel :105 and _unity_kernel :147, reached by
// prox_plus_pallas :126, prox_soft_pallas :131, prox_hard_pallas :139 and
// prox_unity_pallas :161:
//
//   plus   x < 0 ? 0 : x
//   soft   sign(x) * max(|x| - t, 0)
//   hard   |x| < t ? 0 : x
//   unity  x / sum(x) along axis 0 (per column) or axis 1 (per row)
//
// What bounds it on an H100: bytes. Each call reads X once and writes the
// result once, 2 numel itemsize bytes: 56 MB for a float32 (7, 1e6) S
// (17 us at 3.35 TB/s), 112 MB in double. There is one operation or a few
// per element.
//
// What the design does about it:
// - plus, soft and hard are one templated kernel over the flat contiguous
//   tensor, on a grid sized to the card (SMs x resident blocks). Each
//   thread issues kUnroll independent 16-byte loads (float4, double2; both
//   pointers 16-byte aligned) before its stores, then a scalar tail. The
//   vector loads and stores are streaming (__ldcs, __stcs: each byte is
//   touched once, so it is first out of L2), which is what brings the
//   kernel ahead of torch.clamp_min (PERF.md). The TPU kernel pads to
//   (8, 128) tiles; nothing is padded here.
// - One launch per call: the kernel forms the threshold itself. It comes by
//   value (a host number, already in double) or by device pointer to a
//   one-element tensor of float, double, bfloat16 or half, so a step that
//   lives on the card needs no host sync and no separate launch. A relative
//   threshold multiplies the step by the host multiplier as PyTorch's
//   step * thresh does: in the step's type (float and double), or in float
//   rounded back to bfloat16 or half for those, with the multiplier
//   converted to that arithmetic type; the result is then converted to the
//   compute type, as the plain version's torch.as_tensor does.
// - NaN propagates as in jnp.maximum, jnp.sign and jnp.where: the
//   comparisons are written so that a NaN fails them and passes through
//   (fmax would turn it into the other operand), and sign is 0 at 0 and NaN
//   at NaN. Soft rounds each operation on its own (__fsub_rn, __fmul_rn), so
//   the kernel gives the plain version's bits.
// - unity, axis 0: one thread per column sums the rows in index order and
//   then writes x / sum, so neighbouring threads touch neighbouring
//   addresses in every row. Axis 1 (the TPU wrapper transposes, :166-167)
//   is one cooperative launch of as many blocks as the card holds at once:
//   the blocks sum chunks of each row in a fixed tree (16-byte loads where
//   aligned, warp shuffles, the warps in order) into one partial per chunk;
//   after a grid barrier, one warp finishes the row's sum from the partials
//   in a fixed order (lanes over a stride of chunks, then a shuffle tree),
//   so every chunk of a row gets the same bits, and the block divides the
//   chunk. The divide walks the chunks in reverse order, so its first reads
//   find what the sums read last still in the 50 MB L2. No atomics: every
//   run gives the same bits. A zero sum gives inf or NaN, as in JAX.
// - Types: float and double (the card has an f64 datapath, so the TPU
//   wrapper's f64 guard, :50-65, is dropped). The wrapper casts other
//   float types to float and back, as the TPU wrapper does.
// Axis 0 with many rows and few columns leaves the card idle (one thread per
// column); the factors it serves are K x N with K small.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr long long kMaxBlocks = 2048;
// Row elements per item (chunk) of the axis-1 unity kernel.
constexpr long long kChunk = kThreads * 16;

enum Op { kPlus = 0, kSoft = 1, kHard = 2 };
// The type of a threshold that comes by pointer.
enum ThreshType { kTF32 = 0, kTF64 = 1, kTBF16 = 2, kTF16 = 3 };

// How the kernel forms the threshold: `value` when `ptr` is null, else the
// one element at `ptr` (of `type`), times `scale` when `scaled`.
struct Thresh {
  const void* ptr;
  int type;
  int scaled;
  double value;
  double scale;
};

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// The threshold in the compute type T, as the plain version forms it.
template <typename T>
__device__ __forceinline__ T form_threshold(const Thresh& th) {
  if (th.ptr == nullptr) return (T)th.value;
  switch (th.type) {
    case kTF32: {
      const float s = *static_cast<const float*>(th.ptr);
      return (T)(th.scaled ? __fmul_rn(s, (float)th.scale) : s);
    }
    case kTF64: {
      const double s = *static_cast<const double*>(th.ptr);
      return (T)(th.scaled ? __dmul_rn(s, th.scale) : s);
    }
    case kTBF16: {
      const float s = __bfloat162float(*static_cast<const __nv_bfloat16*>(th.ptr));
      return (T)(th.scaled
                     ? __bfloat162float(__float2bfloat16_rn(__fmul_rn(s, (float)th.scale)))
                     : s);
    }
    default: {
      const float s = __half2float(*static_cast<const __half*>(th.ptr));
      return (T)(th.scaled ? __half2float(__float2half_rn(__fmul_rn(s, (float)th.scale)))
                           : s);
    }
  }
}

template <int OP, typename T>
__device__ __forceinline__ T apply(T x, T t) {
  if (OP == kPlus) return x < T(0) ? T(0) : x;
  if (OP == kHard) return fabs(x) < t ? T(0) : x;
  const T sgn = x > T(0) ? T(1) : (x < T(0) ? T(-1) : (x != x ? x : T(0)));
  T m = sub_rn(fabs(x), t);
  m = m < T(0) ? T(0) : m;
  return mul_rn(sgn, m);
}

template <int OP>
__device__ __forceinline__ float4 apply_vec(float4 v, float t) {
  return make_float4(apply<OP>(v.x, t), apply<OP>(v.y, t),
                     apply<OP>(v.z, t), apply<OP>(v.w, t));
}
template <int OP>
__device__ __forceinline__ double2 apply_vec(double2 v, double t) {
  return make_double2(apply<OP>(v.x, t), apply<OP>(v.y, t));
}

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int n = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int n = 2; };

template <int OP, typename T>
__global__ void __launch_bounds__(kThreads)
prox_elementwise_kernel(const T* __restrict__ x, T* __restrict__ out,
                        long long n, Thresh th, int vectorized) {
  const T t = OP == kPlus ? T(0) : form_threshold<T>(th);
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long tail = 0;
  if (vectorized) {
    using V = typename Vec<T>::type;
    const long long nv = n / Vec<T>::n;
    const V* xv = reinterpret_cast<const V*>(x);
    V* ov = reinterpret_cast<V*>(out);
    // kUnroll loads in flight per thread, kThreads apart, before the stores
    const long long step = (long long)gridDim.x * kThreads * kUnroll;
    for (long long base = (long long)blockIdx.x * kThreads * kUnroll + threadIdx.x;
         base < nv; base += step) {
      V v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + u * kThreads;
        if (i < nv) v[u] = __ldcs(xv + i);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + u * kThreads;
        if (i < nv) __stcs(ov + i, apply_vec<OP>(v[u], t));
      }
    }
    tail = nv * Vec<T>::n;
  }
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = tail + first; i < n; i += stride) out[i] = apply<OP, T>(x[i], t);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
unity_cols_kernel(const T* __restrict__ x, T* __restrict__ out,
                  long long rows, long long cols) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x; j < cols;
       j += stride) {
    T s = x[j];
    for (long long r = 1; r < rows; ++r) s += x[r * cols + j];
    for (long long r = 0; r < rows; ++r) out[r * cols + j] = x[r * cols + j] / s;
  }
}

// Rows of x are 16-byte aligned when x is and the row length is a multiple
// of the vector width; then every chunk's ends are multiples of it too.
template <typename T>
__device__ __forceinline__ bool rows_vectorized(const T* x, long long cols) {
  return (reinterpret_cast<unsigned long long>(x) % 16) == 0 &&
         cols % Vec<T>::n == 0;
}

__device__ __forceinline__ float vsum(float acc, float4 v) {
  acc += v.x;
  acc += v.y;
  acc += v.z;
  return acc + v.w;
}
__device__ __forceinline__ double vsum(double acc, double2 v) {
  acc += v.x;
  return acc + v.y;
}
__device__ __forceinline__ float4 vdiv(float4 v, float s) {
  return make_float4(v.x / s, v.y / s, v.z / s, v.w / s);
}
__device__ __forceinline__ double2 vdiv(double2 v, double s) {
  return make_double2(v.x / s, v.y / s);
}

// Item b of a (rows, cols) tensor is chunk b % n_chunks of row b / n_chunks.
// The block's sum of item b's elements, in a fixed tree (a strided loop per
// thread, warp shuffles, the warps in order); valid in thread 0.
template <typename T>
__device__ __forceinline__ T chunk_sum(const T* __restrict__ x, long long cols,
                                       long long n_chunks, long long b,
                                       T* red) {
  const long long row = b / n_chunks, chunk = b % n_chunks;
  const T* xr = x + row * cols;
  const long long begin = chunk * kChunk, end = min(begin + kChunk, cols);
  T v = T(0);
  if (rows_vectorized(x, cols)) {
    using V = typename Vec<T>::type;
    constexpr int kPer = (int)(kChunk / Vec<T>::n / kThreads);
    const V* xv = reinterpret_cast<const V*>(xr);
    const long long vb = begin / Vec<T>::n, ve = end / Vec<T>::n;
    V a[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const long long i = vb + threadIdx.x + u * kThreads;
      if (i < ve) a[u] = xv[i];
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (vb + threadIdx.x + u * kThreads < ve) v = vsum(v, a[u]);
    }
  } else {
    for (long long j = begin + threadIdx.x; j < end; j += kThreads) v += xr[j];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T s = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s += red[w];
  __syncthreads();  // red is free again
  return s;
}

// Unity along axis 1 in one cooperative launch. The blocks walk the items
// and write each item's sum to partials; after the grid barrier they walk
// the items again in reverse, and for each one warp finishes the row's sum
// from its partials in a fixed order (lanes over a stride of chunks, then a
// shuffle tree), the same bits for every item of the row, and the block
// divides the item's elements by it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
unity_rows_kernel(const T* __restrict__ x, T* __restrict__ out, long long rows,
                  long long cols, long long n_chunks, T* partials) {
  __shared__ T red[kWarps];
  __shared__ T sum;
  const long long items = rows * n_chunks;
  for (long long b = blockIdx.x; b < items; b += gridDim.x) {
    const T s = chunk_sum(x, cols, n_chunks, b, red);
    if (threadIdx.x == 0) partials[b] = s;
  }
  cooperative_groups::this_grid().sync();
  const bool vec = rows_vectorized(x, cols) &&
                   (reinterpret_cast<unsigned long long>(out) % 16) == 0;
  for (long long i = blockIdx.x; i < items; i += gridDim.x) {
    // reverse order: the first items divided are those summed last, whose
    // rows the 50 MB L2 still holds
    const long long b = items - 1 - i;
    const long long row = b / n_chunks, chunk = b % n_chunks;
    if (threadIdx.x < 32) {
      // written by other blocks before the barrier: read from L2
      const T* p = partials + row * n_chunks;
      T s = T(0);
      for (long long c = threadIdx.x; c < n_chunks; c += 32) s += __ldcg(p + c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
      if (threadIdx.x == 0) sum = s;
    }
    __syncthreads();
    const T s = sum;
    const long long begin = chunk * kChunk, end = min(begin + kChunk, cols);
    const T* xr = x + row * cols;
    T* orow = out + row * cols;
    if (vec) {
      using V = typename Vec<T>::type;
      constexpr int kPer = (int)(kChunk / Vec<T>::n / kThreads);
      const V* xv = reinterpret_cast<const V*>(xr);
      V* ov = reinterpret_cast<V*>(orow);
      const long long vb = begin / Vec<T>::n, ve = end / Vec<T>::n;
      V a[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const long long j = vb + threadIdx.x + u * kThreads;
        if (j < ve) a[u] = xv[j];
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const long long j = vb + threadIdx.x + u * kThreads;
        if (j < ve) ov[j] = vdiv(a[u], s);
      }
    } else {
      for (long long j = begin + threadIdx.x; j < end; j += kThreads)
        orow[j] = xr[j] / s;
    }
    __syncthreads();  // sum is free again
  }
}

long long n_chunks(long long cols) { return (cols + kChunk - 1) / kChunk; }

unsigned grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return (unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// Blocks of Kernel that the card holds at once (SMs x resident blocks),
// computed once per kernel instance.
template <auto Kernel>
long long resident_blocks() {
  static long long blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, kThreads, 0);
    blocks = (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

template <int OP, typename T>
int elementwise_op(const T* x, T* out, long long n, const Thresh& th,
                   cudaStream_t stream) {
  constexpr auto kernel = prox_elementwise_kernel<OP, T>;
  const int vec = ((reinterpret_cast<unsigned long long>(x) |
                    reinterpret_cast<unsigned long long>(out)) % 16) == 0;
  const long long work = vec ? (n / Vec<T>::n + kUnroll - 1) / kUnroll : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = resident_blocks<kernel>();
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(x, out, n, th, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int elementwise(int op, const void* x, void* out, long long n,
                const Thresh& th, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  T* op_ = static_cast<T*>(out);
  if (op == kPlus) return elementwise_op<kPlus, T>(xp, op_, n, th, stream);
  if (op == kSoft) return elementwise_op<kSoft, T>(xp, op_, n, th, stream);
  if (op == kHard) return elementwise_op<kHard, T>(xp, op_, n, th, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int unity(int axis, const void* x, void* out, long long rows, long long cols,
          void* partials, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  T* op_ = static_cast<T*>(out);
  if (axis == 0) {
    unity_cols_kernel<T><<<grid_for(cols), kThreads, 0, stream>>>(xp, op_, rows, cols);
    return (int)cudaGetLastError();
  }
  if (axis != 1 || partials == nullptr) return (int)cudaErrorInvalidValue;
  constexpr auto kernel = unity_rows_kernel<T>;
  long long nc = n_chunks(cols);
  const long long items = rows * nc;
  const long long cap = resident_blocks<kernel>();
  const unsigned grid = (unsigned)(items < cap ? items : cap);
  T* pp = static_cast<T*>(partials);
  void* args[] = {(void*)&xp, (void*)&op_, (void*)&rows, (void*)&cols,
                  (void*)&nc, (void*)&pp};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)kernel, grid,
                                                kThreads, args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out = op(x) over n contiguous elements on `stream`; op 0 = plus, 1 = soft,
// 2 = hard; is_double selects double over float. The threshold (ignored
// by plus) is t_value when t_ptr is null, else the one element at the
// device pointer t_ptr, of type t_type (0 float, 1 double, 2 bfloat16,
// 3 half), times t_scale when t_scaled is 1; see form_threshold. Returns
// cudaGetLastError() after the launch (0 on success); does not synchronize.
int prox_elementwise(int op, int is_double, const void* x, void* out,
                     long long n, const void* t_ptr, int t_type, int t_scaled,
                     double t_value, double t_scale, void* stream) {
  if (n < 1) return n == 0 ? 0 : (int)cudaErrorInvalidValue;
  if (t_ptr != nullptr && (t_type < kTF32 || t_type > kTF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const Thresh th{t_ptr, t_type, t_scaled, t_value, t_scale};
  return is_double ? elementwise<double>(op, x, out, n, th, strm)
                   : elementwise<float>(op, x, out, n, th, strm);
}

// Elements of scratch (of the tensor's type) that prox_unity needs for a
// (rows, cols) tensor along axis 1; 0 for axis 0.
long long prox_unity_partials(int axis, long long rows, long long cols) {
  return axis == 1 ? rows * n_chunks(cols) : 0;
}

// out = x / sum(x, axis) for a contiguous row-major (rows, cols) tensor on
// `stream`; partials holds prox_unity_partials(axis, rows, cols) elements.
// Returns cudaGetLastError() after the launches; does not synchronize.
int prox_unity(int axis, int is_double, const void* x, void* out,
               long long rows, long long cols, void* partials, void* stream) {
  if (rows < 0 || cols < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return 0;
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  return is_double ? unity<double>(axis, x, out, rows, cols, partials, strm)
                   : unity<float>(axis, x, out, rows, cols, partials, strm);
}

}  // extern "C"
