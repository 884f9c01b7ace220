// Rational-erf GELU for Hopper (sm_90a): ops/fastgelu.py's gelu_fast.
//
// Replaces no Pallas kernel. The JAX package computes the same function
// (rtdsd_tpu/ops/fastgelu.py) in jnp, and XLA fuses it into the epilogue of
// the op that produces its input. Eager PyTorch runs it as 22 kernels, each
// a pass over float32 temporaries, about 200 bytes of device memory traffic
// an element; this kernel reads x once and writes the result once.
//
//   z = clamp(x * (1/sqrt 2), -2.92, 2.92),  u = z * z
//   P = ((P3 u + P2) u + P1) u + P0,  Q = ((Q3 u + Q2) u + Q1) u + Q0
//   y = (0.5 x) * (1 + (z P) / Q)
//
// in float32, with every step rounded as the eager chain rounds it: each
// multiply, add and divide on its own (__fmul_rn, __fadd_rn, __fdiv_rn, so
// nvcc contracts nothing into an FMA), the Python constants rounded to
// float32 as PyTorch rounds a scalar operand of a float32 tensor, the
// chain's order of operations, a clamp that passes NaN through as
// torch.clamp does, and round-to-nearest-even back to x's dtype. So the
// output is the eager chain's bit for bit.
//
// What bounds it on the H100: bytes. 2 x 2 bytes an element in bf16 or f16
// (8 in float32) over 3.35 TB/s; an FFN hidden of (40 x 199, 4096) bf16 is
// 130 MB, 39 us, where a plain copy of it (Tensor.copy_) takes 46.5 us. The
// work an element (about 30 instructions, the IEEE divide the longest part,
// one MUFU.RCP) keeps the SMs nearly as busy as the loads.
//
// Design: x and y are walked as flat arrays in memory order (the wrapper
// hands over dense tensors of one layout). Each thread loads 16 bytes (8
// bf16 or f16 values, 4 float32) kUnroll times before it computes, so each
// warp keeps two loads in flight, and stores 16 bytes each. A block takes
// one chunk of kThreads x kUnroll vectors, and the grid has a block for
// every chunk, so the hardware's block scheduler balances the SMs (one
// resident wave walking the array measured 8-14% slower); the grid-stride
// loop takes only what a grid of 2^31 - 1 blocks cannot. The elements past
// the last whole vector are done one a thread. Where x or y does not start
// on a 16-byte boundary (x a view at an odd offset) every element is loaded
// and stored on its own.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 2;
constexpr int64_t kMaxBlocks = 0x7fffffff;

// ops/fastgelu.py's _P, _Q, _ZMAX and _INV_SQRT2: Python floats (doubles)
// rounded to float32, as PyTorch rounds them
constexpr float kP0 = static_cast<float>(1.128387124150406);
constexpr float kP1 = static_cast<float>(0.15306343552001833);
constexpr float kP2 = static_cast<float>(0.04342919271314016);
constexpr float kP3 = static_cast<float>(0.0007634787181375913);
constexpr float kQ0 = static_cast<float>(1.0);
constexpr float kQ1 = static_cast<float>(0.46905443006720976);
constexpr float kQ2 = static_cast<float>(0.09462941533472911);
constexpr float kQ3 = static_cast<float>(0.009403159294456582);
constexpr float kZmax = static_cast<float>(2.92);
constexpr float kInvSqrt2 = static_cast<float>(0.7071067811865476);

__device__ __forceinline__ float gelu(float x) {
  float z = __fmul_rn(x, kInvSqrt2);
  z = isnan(z) ? z : fminf(fmaxf(z, -kZmax), kZmax);
  const float u = __fmul_rn(z, z);
  float p = __fadd_rn(__fmul_rn(kP3, u), kP2);
  p = __fadd_rn(__fmul_rn(p, u), kP1);
  p = __fadd_rn(__fmul_rn(p, u), kP0);
  float q = __fadd_rn(__fmul_rn(kQ3, u), kQ2);
  q = __fadd_rn(__fmul_rn(q, u), kQ1);
  q = __fadd_rn(__fmul_rn(q, u), kQ0);
  const float erf = __fdiv_rn(__fmul_rn(z, p), q);
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, erf));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T>
__device__ __forceinline__ uint4 gelu_vec(uint4 v) {
  constexpr int kVec = sizeof(uint4) / sizeof(T);
  T vals[kVec];
  memcpy(vals, &v, sizeof(v));
#pragma unroll
  for (int j = 0; j < kVec; ++j) vals[j] = from_float<T>(gelu(to_float(vals[j])));
  memcpy(&v, vals, sizeof(v));
  return v;
}

// x, y: n elements, 16-byte aligned; the whole vectors, kUnroll a thread an
// iteration, then the tail of n % kVec elements
template <typename T>
__global__ void __launch_bounds__(kThreads)
gelu_vec_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n) {
  constexpr int kVec = sizeof(uint4) / sizeof(T);
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x);
  uint4* __restrict__ yv = reinterpret_cast<uint4*>(y);
  const int64_t nvec = n / kVec;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kUnroll;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * kUnroll
                      + threadIdx.x;
       base < nvec; base += step) {
    uint4 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = base + k * kThreads;
      if (i < nvec) v[k] = xv[i];
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = base + k * kThreads;
      if (i < nvec) yv[i] = gelu_vec<T>(v[k]);
    }
  }
  const int64_t i = nvec * kVec + static_cast<int64_t>(blockIdx.x) * kThreads
                    + threadIdx.x;
  if (i < n) y[i] = from_float<T>(gelu(to_float(x[i])));
}

// any alignment: one element a thread an iteration
template <typename T>
__global__ void __launch_bounds__(kThreads)
gelu_scalar_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += step)
    y[i] = from_float<T>(gelu(to_float(x[i])));
}

template <typename T>
int launch(const void* xp, void* yp, int64_t n, cudaStream_t st) {
  const T* x = static_cast<const T*>(xp);
  T* y = static_cast<T*>(yp);
  const bool aligned = (reinterpret_cast<uintptr_t>(xp) % 16 == 0)
                       && (reinterpret_cast<uintptr_t>(yp) % 16 == 0);
  if (aligned) {
    constexpr int64_t kVec = sizeof(uint4) / sizeof(T);
    const int64_t chunks = (n / kVec + kThreads * kUnroll - 1)
                           / (kThreads * kUnroll);
    // the n % kVec < kThreads tail elements: block 0, one a thread
    const int64_t blocks = chunks < 1 ? 1
                           : (chunks < kMaxBlocks ? chunks : kMaxBlocks);
    gelu_vec_kernel<T><<<static_cast<int>(blocks), kThreads, 0, st>>>(x, y, n);
  } else {
    const int64_t chunks = (n + kThreads - 1) / kThreads;
    const int64_t blocks = chunks < kMaxBlocks ? chunks : kMaxBlocks;
    gelu_scalar_kernel<T><<<static_cast<int>(blocks), kThreads, 0, st>>>(x, y, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y: n elements of one dtype (0 float32, 1 bfloat16, 2 float16) in
// memory order; y may not overlap x
int gelu_fast(const void* x, void* y, long long n, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return launch<float>(x, y, n, st);
    case 1: return launch<__nv_bfloat16>(x, y, n, st);
    case 2: return launch<__half>(x, y, n, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
