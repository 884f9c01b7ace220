// AASIST graph-attention aggregation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels rtdsd_tpu/ops/pallas/gat.py
// fused_gat_aggregate (body _gat_kernel) and fused_htrg_gat_aggregate (body
// _htrg_kernel). For each batch row b and query node i, all in float32:
//
//   s_ij   = tanh((x_i * x_j) W + bias) . a_ij / temperature
//   att_ij = softmax_j(s_ij)                 (over the N real nodes)
//   out_i  = sum_j att_ij x_j
//
// where a_ij is w11 when i and j are both type-1 nodes (index < n1), w22
// when both are type-2, and w12 otherwise. The homogeneous layer is the
// case w11 = w22 = w12 = a, so both entry points share one body.
//
// What bounds it on the H100: operations. A launch reads x (B N D floats)
// and writes as much, but forms B N^2 pairwise projections of D * Do
// multiply-adds each (N = 66, D = Do = 64: 18 M FMAs per batch row), which
// no unfused version can keep out of HBM: the (B, N, N, Do) projection is
// 140 MB per layer at batch 128. Here it lives in registers only.
//
// Design: one block per (group of 8 query nodes, batch row). x[b] (rows
// padded by one float so that lanes on different nodes hit different
// banks), W, the bias and the edge vectors are staged in shared memory.
// Each thread takes (i, j) pairs: it forms x_i * x_j in registers, runs the
// D x Do projection against W read as a shared-memory broadcast, applies
// tanh and the dot with the edge vector, and writes one score. Then one warp
// per query does the softmax over j and the weighted sum over the nodes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQueries = 8;  // query nodes per block

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

template <int D>
__global__ void __launch_bounds__(kThreads)
gat_kernel(const float* __restrict__ x, const float* __restrict__ w,
           const float* __restrict__ bias, const float* __restrict__ a11,
           const float* __restrict__ a22, const float* __restrict__ a12,
           float* __restrict__ out, int N, int Do, int n1, float temperature) {
  constexpr int XS = D + 1;
  extern __shared__ float sm[];
  float* xs = sm;                   // N x XS
  float* ws = xs + N * XS;          // D x Do
  float* bs = ws + D * Do;          // Do
  float* e11 = bs + Do;             // Do each
  float* e22 = e11 + Do;
  float* e12 = e22 + Do;
  float* ss = e12 + Do;             // kQueries x N scores

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kQueries;
  const int nq = min(kQueries, N - i0);
  const float* xb = x + static_cast<size_t>(b) * N * D;
  for (int idx = threadIdx.x; idx < N * D; idx += blockDim.x) {
    const int j = idx / D;
    xs[j * XS + idx - j * D] = xb[idx];
  }
  for (int idx = threadIdx.x; idx < D * Do; idx += blockDim.x) ws[idx] = w[idx];
  for (int o = threadIdx.x; o < Do; o += blockDim.x) {
    bs[o] = bias[o];
    e11[o] = a11[o];
    e22[o] = a22[o];
    e12[o] = a12[o];
  }
  __syncthreads();

  for (int p = threadIdx.x; p < nq * N; p += blockDim.x) {
    const int qi = p / N;
    const int j = p - qi * N;
    const int i = i0 + qi;
    float pv[D];
#pragma unroll
    for (int d = 0; d < D; ++d) pv[d] = xs[i * XS + d] * xs[j * XS + d];
    const bool i1 = i < n1, j1 = j < n1;
    const float* e = (i1 && j1) ? e11 : ((!i1 && !j1) ? e22 : e12);
    float s = 0.f;
    for (int o = 0; o < Do; ++o) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc = fmaf(pv[d], ws[d * Do + o], acc);
      s = fmaf(tanhf(acc + bs[o]), e[o], s);
    }
    ss[qi * N + j] = s / temperature;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int qi = warp; qi < nq; qi += kThreads / 32) {
    float* sr = ss + qi * N;
    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) mx = fmaxf(mx, sr[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float ev = expf(sr[j] - mx);
      sr[j] = ev;
      sum += ev;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < N; j += 32) sr[j] = sr[j] / sum;
    __syncwarp();
    float* orow = out + (static_cast<size_t>(b) * N + i0 + qi) * D;
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc = fmaf(sr[j], xs[j * XS + d], acc);
      orow[d] = acc;
    }
  }
}

size_t smem_bytes(int N, int D, int Do) {
  return sizeof(float) * (static_cast<size_t>(N) * (D + 1) + D * Do + 4 * Do +
                          kQueries * N);
}

template <int D>
int launch_d(const float* x, const float* w, const float* bias, const float* a11,
             const float* a22, const float* a12, float* out, int B, int N, int Do,
             int n1, float temperature, cudaStream_t stream) {
  const size_t smem = smem_bytes(N, D, Do);
  static size_t allowed = 0;  // raised once per size, outside graph capture
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        gat_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  dim3 grid((N + kQueries - 1) / kQueries, B);
  gat_kernel<D><<<grid, kThreads, smem, stream>>>(x, w, bias, a11, a22, a12, out,
                                                  N, Do, n1, temperature);
  return static_cast<int>(cudaGetLastError());
}

int launch(const float* x, const float* w, const float* bias, const float* a11,
           const float* a22, const float* a12, float* out, int B, int N, int D,
           int Do, int n1, float temperature, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<16>(x, w, bias, a11, a22, a12, out, B, N, Do, n1, temperature, st);
    case 32: return launch_d<32>(x, w, bias, a11, a22, a12, out, B, N, Do, n1, temperature, st);
    case 64: return launch_d<64>(x, w, bias, a11, a22, a12, out, B, N, Do, n1, temperature, st);
    case 128: return launch_d<128>(x, w, bias, a11, a22, a12, out, B, N, Do, n1, temperature, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// x (B, N, D), w (D, Do), bias (Do), a (Do), out (B, N, D): contiguous float32.
int gat_aggregate_f32(const float* x, const float* w, const float* bias,
                      const float* a, float* out, int B, int N, int D, int Do,
                      float temperature, void* stream) {
  return launch(x, w, bias, a, a, a, out, B, N, D, Do, N, temperature, stream);
}

int htrg_gat_aggregate_f32(const float* x, const float* w, const float* bias,
                           const float* w11, const float* w22, const float* w12,
                           float* out, int B, int N, int D, int Do, int n1,
                           float temperature, void* stream) {
  return launch(x, w, bias, w11, w22, w12, out, B, N, D, Do, n1, temperature,
                stream);
}

}  // extern "C"
