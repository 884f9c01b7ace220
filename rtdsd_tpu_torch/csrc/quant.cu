// Per-column int8 quantization for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rtdsd_tpu/ops/pallas/quant.py
// quantize_int8 (body _quant_kernel). For an (R, C) float32 matrix x:
//
//   scale_c = max(max_r |x_rc|, 1e-12) * (1 / 127)
//   v_rc    = x_rc / scale_c
//   q_rc    = clip(floor(v_rc + u_rc), -128, 127)    stochastic rounding
//   q_rc    = clip(rint(v_rc), -128, 127)            round-to-nearest mode
//
// with u_rc = (bits >> 8) * 2^-24 in [0, 1). The TPU draws the bits from its
// on-chip generator; here they come from a counter-based hash of (seed, row,
// column), bits = h(h(h(seed) + row) + column) mod 2^32 with h the
// "lowbias32" integer mixer, so they do not depend on the launch geometry
// and ops/quant.py's plain version reproduces them bit for bit.
//
// What bounds it on the H100: bytes. The matrix is read twice (the second
// read mostly from L2) and written once as int8: 5 R C + 4 C bytes against
// a few integer operations per element.
//
// Design: one block per strip of kCols columns; kRows threads stride down
// the rows of each column, neighbouring threads on neighbouring columns so
// that a warp reads whole 32-byte sectors. Pass 1 takes each thread's max
// |x|, a shared-memory reduction gives the column's scale; pass 2 re-reads
// the strip and writes the int8 values. Both passes keep kUnroll loads in
// flight per thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 8;      // columns per block (one 32-byte f32 sector)
constexpr int kRows = 128;    // threads down the rows
constexpr int kUnroll = 4;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

template <bool kStochastic>
__global__ void __launch_bounds__(kCols * kRows)
quant_kernel(const float* __restrict__ x, int8_t* __restrict__ vals,
             float* __restrict__ scales, int R, int C, uint32_t seed) {
  __shared__ float red[kRows][kCols + 1];
  __shared__ float col_scale[kCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * kCols + tx;
  const bool live = col < C;

  float m = 0.f;
  for (int r0 = ty; r0 < R; r0 += kRows * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * kRows;
      v[u] = (live && r < R) ? x[static_cast<size_t>(r) * C + col] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) m = fmaxf(m, fabsf(v[u]));
  }
  red[ty][tx] = m;
  __syncthreads();
  if (ty == 0) {
    for (int i = 1; i < kRows; ++i) m = fmaxf(m, red[i][tx]);
    // times the float32 reciprocal, as XLA compiles the JAX package's
    // division by the constant 127
    const float s = fmaxf(m, 1e-12f) * (1.f / 127.f);
    col_scale[tx] = s;
    if (live) scales[col] = s;
  }
  __syncthreads();
  if (!live) return;

  const float s = col_scale[tx];
  const uint32_t key = mix32(seed);
  for (int r0 = ty; r0 < R; r0 += kRows * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * kRows;
      v[u] = r < R ? x[static_cast<size_t>(r) * C + col] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * kRows;
      if (r >= R) break;
      const float scaled = v[u] / s;
      float q;
      if (kStochastic) {
        const uint32_t bits = mix32(mix32(key + static_cast<uint32_t>(r)) +
                                    static_cast<uint32_t>(col));
        const float rnd = static_cast<float>(bits >> 8) * (1.f / 16777216.f);
        q = floorf(scaled + rnd);
      } else {
        q = rintf(scaled);
      }
      q = fminf(fmaxf(q, -128.f), 127.f);
      vals[static_cast<size_t>(r) * C + col] = static_cast<int8_t>(q);
    }
  }
}

}  // namespace

extern "C" {

// x (R, C) float32, vals (R, C) int8, scales (C) float32: contiguous.
int quantize_int8_f32(const float* x, int8_t* vals, float* scales, int R, int C,
                      unsigned int seed, int stochastic, void* stream) {
  dim3 block(kCols, kRows);
  dim3 grid((C + kCols - 1) / kCols);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stochastic)
    quant_kernel<true><<<grid, block, 0, st>>>(x, vals, scales, R, C, seed);
  else
    quant_kernel<false><<<grid, block, 0, st>>>(x, vals, scales, R, C, seed);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
