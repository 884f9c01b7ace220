// Small-T multi-head self-attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rtdsd_tpu/ops/pallas/attention.py
// (mha_small_t, body _mha_kernel). Per (batch, head): softmax(Q K^T * scale)
// in float32, normalised before p is rounded to V's dtype, then p V with
// float32 accumulation; the output is in the input dtype. Inputs are read in
// their (B, T, H, D) layout through their strides (the head dimension must
// be contiguous); the output is a contiguous (B, T, H, D) tensor.
//
// What bounds it on the H100: at the XLSR shapes (T = 199, D = 64, 16 heads)
// the work is 4 T^2 D flops per head against 4 T D bytes of bf16 I/O, about
// 200 flops per byte, so by the card's peaks it sits near the balance point
// and neither bound is far away. This first version does its arithmetic on
// the CUDA cores (no tensor cores), so in practice it is bound by shared
// memory reads and fp32 FMA issue, not by HBM.
//
// Design: one block per (batch * head, tile of 64 query rows); K and V of
// the head are staged once per block in dynamic shared memory (rows padded
// by one 32-bit word so that lanes walking different keys hit different
// banks); each of the 8 warps owns a query row at a time, keeps q in
// registers, computes its scores lane-parallel over keys into a per-warp
// shared buffer, reduces max and sum with shuffles, and accumulates p V
// lane-parallel over the head dimension. The (T, T) scores never reach HBM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerBlock = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Shared-memory row stride in elements: D plus one 32-bit word.
template <typename T> __host__ __device__ constexpr int row_stride(int d) {
  return d + 4 / static_cast<int>(sizeof(T));
}

// Two consecutive elements of a shared-memory row as floats (d even).
__device__ __forceinline__ float2 load2(const float* row, int d) {
  return make_float2(row[d], row[d + 1]);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* row, int d) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + d));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
mha_small_t_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o, int H, int seq,
                   int64_t sqb, int64_t sqt, int64_t sqh,
                   int64_t skb, int64_t skt, int64_t skh,
                   int64_t svb, int64_t svt, int64_t svh, float scale) {
  constexpr int KS = row_stride<T>(D);
  constexpr int PAIRS = D / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + static_cast<size_t>(seq) * KS;
  float* ps = reinterpret_cast<float*>(vs + static_cast<size_t>(seq) * KS);

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;
  for (int idx = threadIdx.x; idx < seq * D; idx += blockDim.x) {
    const int t = idx / D;
    const int d = idx - t * D;
    ks[t * KS + d] = kb[t * skt + d];
    vs[t * KS + d] = vb[t * svt + d];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* pw = ps + warp * seq;
  const int row_end = min(static_cast<int>(blockIdx.y + 1) * kRowsPerBlock, seq);
  for (int i = blockIdx.y * kRowsPerBlock + warp; i < row_end; i += kWarps) {
    const T* qrow = q + b * sqb + i * sqt + h * sqh;
    float qr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = to_f(qrow[d]);

    // scores for keys j = lane, lane + 32, ...; padded keys (j >= seq) are
    // never formed, which is what the -1e30 mask of the TPU kernel amounts to
    float mx = -INFINITY;
    for (int j = lane; j < seq; j += 32) {
      const T* kr = ks + j * KS;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 2) {
        const float2 kk = load2(kr, d);
        acc = fmaf(qr[d], kk.x, acc);
        acc = fmaf(qr[d + 1], kk.y, acc);
      }
      acc *= scale;
      pw[j] = acc;
      mx = fmaxf(mx, acc);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < seq; j += 32) {
      const float e = expf(pw[j] - mx);
      pw[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    // normalise first, then round p to V's dtype (as the TPU kernel does)
    for (int j = lane; j < seq; j += 32) pw[j] = to_f(from_f<T>(pw[j] / sum));
    __syncwarp();

    T* orow = o + ((static_cast<int64_t>(b) * seq + i) * H + h) * D;
    for (int pi = lane; pi < PAIRS; pi += 32) {
      const int d = 2 * pi;
      float a0 = 0.f, a1 = 0.f;
      for (int j = 0; j < seq; ++j) {
        const float p = pw[j];
        const float2 vv = load2(vs + j * KS, d);
        a0 = fmaf(p, vv.x, a0);
        a1 = fmaf(p, vv.y, a1);
      }
      orow[d] = from_f<T>(a0);
      orow[d + 1] = from_f<T>(a1);
    }
    __syncwarp();  // pw is reused by the warp's next row
  }
}

template <typename T>
size_t smem_bytes(int seq, int d) {
  return 2 * static_cast<size_t>(seq) * row_stride<T>(d) * sizeof(T) +
         static_cast<size_t>(kWarps) * seq * sizeof(float);
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int B, int seq,
             int H, const int64_t* s, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(seq, D);
  auto kern = mha_small_t_kernel<T, D>;
  // raise the dynamic shared memory limit once per size (not on every launch:
  // launches may be captured into a CUDA graph)
  static size_t allowed = 0;
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  dim3 grid(B * H, (seq + kRowsPerBlock - 1) / kRowsPerBlock);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, seq, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
      s[8], scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int seq,
           int H, int D, const int64_t* s, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, o, B, seq, H, s, scale, st);
    case 32: return launch_d<T, 32>(q, k, v, o, B, seq, H, s, scale, st);
    case 64: return launch_d<T, 64>(q, k, v, o, B, seq, H, s, scale, st);
    case 128: return launch_d<T, 128>(q, k, v, o, B, seq, H, s, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// strides: 9 element strides, (b, t, h) for q, then k, then v.
int mha_small_t_f32(const void* q, const void* k, const void* v, void* o, int B,
                    int seq, int H, int D, const int64_t* strides, float scale,
                    void* stream) {
  return launch<float>(q, k, v, o, B, seq, H, D, strides, scale, stream);
}

int mha_small_t_bf16(const void* q, const void* k, const void* v, void* o, int B,
                     int seq, int H, int D, const int64_t* strides, float scale,
                     void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, seq, H, D, strides, scale, stream);
}

}  // extern "C"
