// Fused wav2vec2 front-end layers for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels rtdsd_tpu/ops/pallas/convstack.py
// ln_gelu (body _ln_gelu_kernel) and conv_ln_gelu_grouped (body
// _conv_kernel). Per output frame, all in float32:
//
//   acc   = sum_{j < k, ci < Cin} x[f s + j, ci] w[j, ci, :] + bias
//           (conv_ln_gelu_grouped; ln_gelu takes acc = x[f, :])
//   h     = (acc - mean) * rsqrt(var + eps) * gamma + beta   (two-pass var)
//   out   = 0.5 h (1 + erf(h / sqrt 2))   with the rational-minimax erf of
//           ops/fastgelu.py, rounded once to the input dtype.
//
// What bounds them on the H100. ln_gelu: bytes (one read, one write of a
// (B, F, C) tensor; about 20 operations per element). conv_ln_gelu_grouped:
// operations, 2 k Cin Cout per output frame (k = 3, Cin = Cout = 512: 3.1
// MFLOP a frame) against 2 (s Cin + Cout) bytes moved; the tensor-core bound
// is far below what this first version's CUDA-core FMAs reach.
//
// ln_gelu design: one warp per row; each lane holds C / 32 values (channels
// lane + 32 i, so every load and store of the warp is contiguous), the
// mean and the variance are warp-shuffle sums.
//
// conv_ln_gelu_grouped design: one block of 256 threads per (batch row, tile
// of kTF output frames). The TPU kernel's grouped reshape and two-matmul
// split exist for Mosaic's limits and are not carried over. For each tap j
// the block stages the kTF input rows f s + j (all Cin channels, as float)
// in shared memory. Thread (ty, tx) accumulates a kFT-frame by 4-channel
// tile in registers: per group of four input channels it reads four weight
// rows (4 consecutive output channels each; neighbouring threads read
// neighbouring channels, so the warp's loads are contiguous) and kFT
// float4 broadcasts of the staged input. After the last tap the accumulated
// tile plus bias goes to shared memory, and one warp per frame applies the
// LayerNorm and GELU above and writes the frame. Only valid frames are
// computed and written: the output has exactly (t_valid - k) / s + 1 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kP0 = 1.128387124150406f, kP1 = 0.15306343552001833f,
                kP2 = 0.04342919271314016f, kP3 = 0.0007634787181375913f;
constexpr float kQ1 = 0.46905443006720976f, kQ2 = 0.09462941533472911f,
                kQ3 = 0.009403159294456582f;
constexpr float kZmax = 2.92f;
constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_rational(float h) {
  float z = fminf(fmaxf(h * kInvSqrt2, -kZmax), kZmax);
  const float u = z * z;
  const float p = ((kP3 * u + kP2) * u + kP1) * u + kP0;
  const float q = ((kQ3 * u + kQ2) * u + kQ1) * u + 1.f;
  return 0.5f * h * (1.f + z * p / q);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// Four consecutive values from device memory, as float.
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// LayerNorm + GELU of one C = 32 * VPL row held by a warp, channel
// lane + 32 i in v[i].
template <int VPL>
__device__ __forceinline__ void ln_gelu_warp(float (&v)[VPL],
                                             const float* __restrict__ gamma,
                                             const float* __restrict__ beta,
                                             int lane, float eps) {
  constexpr float kInvC = 1.f / (32 * VPL);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) s += v[i];
  const float mean = warp_sum(s) * kInvC;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const float d = v[i] - mean;
    q += d * d;
  }
  const float inv = rsqrtf(warp_sum(q) * kInvC + eps);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    v[i] = gelu_rational((v[i] - mean) * inv * gamma[c] + beta[c]);
  }
}

template <typename T, int VPL>
__global__ void __launch_bounds__(kThreads)
ln_gelu_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, T* __restrict__ out,
               long long rows, float eps) {
  constexpr int C = 32 * VPL;
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + row * C;
  float v[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) v[i] = to_float(xr[lane + 32 * i]);
  ln_gelu_warp<VPL>(v, gamma, beta, lane, eps);
  T* orow = out + row * C;
#pragma unroll
  for (int i = 0; i < VPL; ++i) orow[lane + 32 * i] = from_float<T>(v[i]);
}

template <int COUT>
struct ConvTile {
  static constexpr int kCT = 4;                        // channels a thread
  static constexpr int kFT = 16;                       // frames a thread
  static constexpr int kCols = COUT / kCT;             // thread columns
  static constexpr int kRows = kThreads / kCols;       // thread rows
  static constexpr int kTF = kFT * kRows;              // frames a block
  static_assert(kCols % 32 == 0 && kThreads % kCols == 0, "COUT");
};

template <typename T, int COUT>
__global__ void __launch_bounds__(kThreads)
conv_ln_gelu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, T* __restrict__ out,
                    int t_in, int cin, int f_out, int k, int s, float eps) {
  using Tile = ConvTile<COUT>;
  constexpr int kFT = Tile::kFT, kTF = Tile::kTF, kCT = Tile::kCT;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);   // kTF x max(cin, COUT) floats

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kTF;
  const int tx = threadIdx.x % Tile::kCols;
  const int ty = threadIdx.x / Tile::kCols;
  const int c0 = tx * kCT;
  const T* xb = x + static_cast<size_t>(b) * t_in * cin;

  float acc[kFT][kCT];
#pragma unroll
  for (int fi = 0; fi < kFT; ++fi)
#pragma unroll
    for (int c = 0; c < kCT; ++c) acc[fi][c] = 0.f;

  for (int j = 0; j < k; ++j) {
    __syncthreads();                       // the previous tap's reads are done
    for (int idx = threadIdx.x; idx < kTF * cin; idx += kThreads) {
      const int f = idx / cin;
      const int fr = f0 + f;
      sm[idx] = fr < f_out
                    ? to_float(xb[(static_cast<size_t>(fr) * s + j) * cin +
                                  (idx - f * cin)])
                    : 0.f;
    }
    __syncthreads();
    const T* wj = w + static_cast<size_t>(j) * cin * COUT + c0;
    const float* xs = sm + ty * kFT * cin;
#pragma unroll 2
    for (int ci = 0; ci < cin; ci += 4) {
      float wv[4][kCT];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        load4(wj + static_cast<size_t>(ci + u) * COUT, wv[u]);
#pragma unroll
      for (int fi = 0; fi < kFT; ++fi) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + fi * cin + ci);
#pragma unroll
        for (int c = 0; c < kCT; ++c) {
          float a = acc[fi][c];
          a = fmaf(xv.x, wv[0][c], a);
          a = fmaf(xv.y, wv[1][c], a);
          a = fmaf(xv.z, wv[2][c], a);
          a = fmaf(xv.w, wv[3][c], a);
          acc[fi][c] = a;
        }
      }
    }
  }
  __syncthreads();                         // staging buffer becomes the tile

  const float4 bv = *reinterpret_cast<const float4*>(bias + c0);
#pragma unroll
  for (int fi = 0; fi < kFT; ++fi) {
    *reinterpret_cast<float4*>(sm + (ty * kFT + fi) * COUT + c0) =
        make_float4(acc[fi][0] + bv.x, acc[fi][1] + bv.y, acc[fi][2] + bv.z,
                    acc[fi][3] + bv.w);
  }
  __syncthreads();

  constexpr int VPL = COUT / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int f = warp; f < kTF && f0 + f < f_out; f += kThreads / 32) {
    float v[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) v[i] = sm[f * COUT + lane + 32 * i];
    ln_gelu_warp<VPL>(v, gamma, beta, lane, eps);
    T* orow = out + (static_cast<size_t>(b) * f_out + f0 + f) * COUT;
#pragma unroll
    for (int i = 0; i < VPL; ++i) orow[lane + 32 * i] = from_float<T>(v[i]);
  }
}

template <typename T, int VPL>
int launch_ln_gelu(const void* x, const float* gamma, const float* beta,
                   void* out, long long rows, float eps, cudaStream_t st) {
  const long long blocks = (rows * 32 + kThreads - 1) / kThreads;
  ln_gelu_kernel<T, VPL><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<T*>(out), rows, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_ln_gelu(const void* x, const float* gamma, const float* beta,
                     void* out, long long rows, int C, float eps,
                     cudaStream_t st) {
  switch (C) {
    case 128: return launch_ln_gelu<T, 4>(x, gamma, beta, out, rows, eps, st);
    case 256: return launch_ln_gelu<T, 8>(x, gamma, beta, out, rows, eps, st);
    case 384: return launch_ln_gelu<T, 12>(x, gamma, beta, out, rows, eps, st);
    case 512: return launch_ln_gelu<T, 16>(x, gamma, beta, out, rows, eps, st);
    case 768: return launch_ln_gelu<T, 24>(x, gamma, beta, out, rows, eps, st);
    case 1024: return launch_ln_gelu<T, 32>(x, gamma, beta, out, rows, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int COUT>
int launch_conv(const void* x, const void* w, const float* bias,
                const float* gamma, const float* beta, void* out, int B,
                int t_in, int cin, int f_out, int k, int s, float eps,
                cudaStream_t st) {
  using Tile = ConvTile<COUT>;
  const size_t smem = sizeof(float) * Tile::kTF * (cin > COUT ? cin : COUT);
  static size_t allowed = 0;  // raised once per size, outside graph capture
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_ln_gelu_kernel<T, COUT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  dim3 grid((f_out + Tile::kTF - 1) / Tile::kTF, B);
  conv_ln_gelu_kernel<T, COUT><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias, gamma, beta,
      static_cast<T*>(out), t_in, cin, f_out, k, s, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_conv(const void* x, const void* w, const float* bias,
                  const float* gamma, const float* beta, void* out, int B,
                  int t_in, int cin, int cout, int f_out, int k, int s,
                  float eps, cudaStream_t st) {
  switch (cout) {
    case 128: return launch_conv<T, 128>(x, w, bias, gamma, beta, out, B, t_in, cin, f_out, k, s, eps, st);
    case 256: return launch_conv<T, 256>(x, w, bias, gamma, beta, out, B, t_in, cin, f_out, k, s, eps, st);
    case 512: return launch_conv<T, 512>(x, w, bias, gamma, beta, out, B, t_in, cin, f_out, k, s, eps, st);
    case 1024: return launch_conv<T, 1024>(x, w, bias, gamma, beta, out, B, t_in, cin, f_out, k, s, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// x, out (rows, C) contiguous in the kernel's dtype (bf16 = 1, else f32);
// gamma, beta (C) float32.
int ln_gelu(const void* x, const float* gamma, const float* beta, void* out,
            long long rows, int C, float eps, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_ln_gelu<__nv_bfloat16>(x, gamma, beta, out, rows, C, eps, st)
              : dispatch_ln_gelu<float>(x, gamma, beta, out, rows, C, eps, st);
}

// x (B, t_in, cin), w (k, cin, cout), out (B, f_out, cout): contiguous, in
// the kernel's dtype; bias, gamma, beta (cout) float32; 16-byte aligned.
int conv_ln_gelu(const void* x, const void* w, const float* bias,
                 const float* gamma, const float* beta, void* out, int B,
                 int t_in, int cin, int cout, int f_out, int k, int s,
                 float eps, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_conv<__nv_bfloat16>(x, w, bias, gamma, beta, out, B, t_in, cin, cout, f_out, k, s, eps, st)
              : dispatch_conv<float>(x, w, bias, gamma, beta, out, B, t_in, cin, cout, f_out, k, s, eps, st);
}

}  // extern "C"
