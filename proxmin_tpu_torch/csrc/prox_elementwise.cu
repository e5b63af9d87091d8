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
// - plus, soft and hard are one templated grid-stride kernel over the flat
//   contiguous tensor: 16-byte loads and stores (float4, double2) where
//   both pointers are 16-byte aligned, then a scalar tail. The TPU kernel
//   pads to (8, 128) tiles; nothing is padded here.
// - NaN propagates as in jnp.maximum, jnp.sign and jnp.where: the
//   comparisons are written so that a NaN fails them and passes through
//   (fmax would turn it into the other operand), and sign is 0 at 0 and NaN
//   at NaN. Soft rounds each operation on its own (__fsub_rn, __fmul_rn), so
//   the kernel gives the plain version's bits.
// - The threshold is read from device memory, so a step that lives on the
//   card needs no host sync.
// - unity, axis 0: one thread per column sums the rows in index order and
//   then writes x / sum, so neighbouring threads touch neighbouring
//   addresses in every row. Axis 1 (the TPU wrapper transposes, :166-167):
//   the first launch sums chunks of each row in a fixed tree (a strided
//   loop per thread, warp shuffles, the warps in order) into one partial
//   per chunk; the second sums a row's partials in chunk order (every block
//   of the row the same way) and divides its chunk. No atomics: every run
//   gives the same bits. A zero sum gives inf or NaN, as in JAX.
// - Types: float and double (the card has an f64 datapath, so the TPU
//   wrapper's f64 guard, :50-65, is dropped). The wrapper casts other
//   float types to float and back, as the TPU wrapper does.
// Axis 0 with many rows and few columns leaves the card idle (one thread per
// column); the factors it serves are K x N with K small.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 2048;
// Row elements per block in the axis-1 unity kernels.
constexpr long long kChunk = kThreads * 16;

enum Op { kPlus = 0, kSoft = 1, kHard = 2 };

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

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
                        long long n, const T* __restrict__ thresh,
                        int vectorized) {
  const T t = thresh != nullptr ? *thresh : T(0);
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long tail = 0;
  if (vectorized) {
    using V = typename Vec<T>::type;
    const long long nv = n / Vec<T>::n;
    const V* xv = reinterpret_cast<const V*>(x);
    V* ov = reinterpret_cast<V*>(out);
    for (long long i = first; i < nv; i += stride) ov[i] = apply_vec<OP>(xv[i], t);
    tail = nv * Vec<T>::n;
  }
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

// Block b sums chunk b % n_chunks of row b / n_chunks.
template <typename T>
__global__ void __launch_bounds__(kThreads)
unity_rows_partials(const T* __restrict__ x, long long cols,
                    long long n_chunks, T* __restrict__ partials) {
  __shared__ T red[kWarps];
  const long long row = blockIdx.x / n_chunks, chunk = blockIdx.x % n_chunks;
  const T* xr = x + row * cols;
  const long long end = min((chunk + 1) * kChunk, cols);
  T v = T(0);
  for (long long j = chunk * kChunk + threadIdx.x; j < end; j += kThreads) v += xr[j];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    T s = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w];
    partials[blockIdx.x] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
unity_rows_divide(const T* __restrict__ x, T* __restrict__ out, long long cols,
                  long long n_chunks, const T* __restrict__ partials) {
  __shared__ T sum;
  const long long row = blockIdx.x / n_chunks, chunk = blockIdx.x % n_chunks;
  if (threadIdx.x == 0) {
    const T* p = partials + row * n_chunks;
    T s = p[0];
    for (long long c = 1; c < n_chunks; ++c) s += p[c];
    sum = s;
  }
  __syncthreads();
  const T s = sum;
  const long long end = min((chunk + 1) * kChunk, cols);
  for (long long j = chunk * kChunk + threadIdx.x; j < end; j += kThreads)
    out[row * cols + j] = x[row * cols + j] / s;
}

long long n_chunks(long long cols) { return (cols + kChunk - 1) / kChunk; }

unsigned grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return (unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <typename T>
int elementwise(int op, const void* x, void* out, long long n,
                const void* thresh, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  T* op_ = static_cast<T*>(out);
  const T* tp = static_cast<const T*>(thresh);
  const int vec = ((reinterpret_cast<unsigned long long>(x) |
                    reinterpret_cast<unsigned long long>(out)) % 16) == 0;
  const unsigned grid = grid_for(vec ? n / Vec<T>::n : n);
  if (op == kPlus)
    prox_elementwise_kernel<kPlus, T><<<grid, kThreads, 0, stream>>>(xp, op_, n, tp, vec);
  else if (op == kSoft)
    prox_elementwise_kernel<kSoft, T><<<grid, kThreads, 0, stream>>>(xp, op_, n, tp, vec);
  else if (op == kHard)
    prox_elementwise_kernel<kHard, T><<<grid, kThreads, 0, stream>>>(xp, op_, n, tp, vec);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
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
  const long long nc = n_chunks(cols);
  const long long blocks = rows * nc;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  T* pp = static_cast<T*>(partials);
  unity_rows_partials<T><<<(unsigned)blocks, kThreads, 0, stream>>>(xp, cols, nc, pp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  unity_rows_divide<T><<<(unsigned)blocks, kThreads, 0, stream>>>(xp, op_, cols, nc, pp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out = op(x) over n contiguous elements on `stream`; op 0 = plus, 1 = soft,
// 2 = hard; is_double selects double over float. thresh is a device pointer
// to one element of the same type (may be null for plus). Returns
// cudaGetLastError() after the launch (0 on success); does not synchronize.
int prox_elementwise(int op, int is_double, const void* x, void* out,
                     long long n, const void* thresh, void* stream) {
  if (n < 1) return n == 0 ? 0 : (int)cudaErrorInvalidValue;
  if (op != kPlus && thresh == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  return is_double ? elementwise<double>(op, x, out, n, thresh, strm)
                   : elementwise<float>(op, x, out, n, thresh, strm);
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
