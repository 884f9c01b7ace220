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
// What bounds it on the H100: operations. A launch reads x (B N D values)
// and writes B N D floats, but forms B N^2 pairwise projections of D * Do
// multiply-adds each (N = 66, D = Do = 64: 18 M FMAs per batch row), which
// no unfused version can keep out of HBM: the (B, N, N, Do) projection is
// 140 MB per layer at batch 128. Here it lives in registers only.
//
// Two bodies, chosen by shape (tiled_fits; ops/gat.py::tiled mirrors it):
//
// gat_tiled_kernel<D, kMinBlocks>, for Do in {8, 16, ..., 256} where its
// shared memory fits. For one query i the projection over all keys j is a
// small GEMM, X_b (N x D) times diag(x_i) W (D x Do), run on the CUDA cores
// with register tiles:
// - A block owns Q query rows of one batch row, Q in {1, 2, 4, 8} from the
//   SM count (tiled_queries), so that batch 16 fills every SM and batch 1
//   spreads a row over many blocks. It stages x[b] (in its own dtype and
//   strides, widened to f32: 16-byte cp.async where it is f32 with unit
//   stride along D, else plain loads eight in flight a thread), W in the
//   nn.Linear parameter's stored (Do, D) layout (16-byte cp.async where D
//   is the unit stride), the bias and the edge vectors, into rows of D + 4
//   floats. So the wrapper launches no cast or transpose kernel.
// - Each thread owns 4 keys x 8 outputs (32 independent accumulators, not
//   one chain). Per 4 steps of d it loads x_i, 4 rows of x_j and 8 rows of
//   W as float4 (13 LDS.128), forms the A operand x_i[d] x_j[d] (16 FMUL)
//   and runs 128 FFMAs. Its outputs are o = ot + k * Do / 8: the 8 lanes of
//   a quarter-warp then read 8 consecutive W rows, whose D + 4 padding puts
//   them on distinct banks, and share their x rows (broadcast).
// - Grids of two blocks an SM or more take the instance capped at 64
//   registers (two full blocks an SM); smaller ones the instance that keeps
//   two steps of d in flight (about 124 registers).
// - Epilogue in registers: tanh(acc + b_o) a_o summed over the thread's 8
//   outputs, then over the Do / 8 lanes of the same keys by warp shuffles.
//   tanh is 1 - 2 / (2^(2 log2(e) x) + 1) with ex2.approx and a fast
//   reciprocal: within 2.4e-7 of tanhf on [-12, 12] on the H100
//   (gat_tanh_check), where the rows body calls tanhf once per
//   (pair, output).
// - Softmax over j, one warp per query row; then sum_j att_ij x_j, a thread
//   per (query, d) with four partial sums.
// Not on the tensor cores: single-pass TF32 keeps about three digits, too
// coarse for the kernel's (1e-4, 1e-5) contract with its plain version;
// 3xTF32 is left for later.
//
// gat_rows_kernel<D>, any Do: one block per (8 query nodes, batch row);
// each thread takes whole (i, j) pairs and runs the D x Do projection as
// one chain of FMAs. It takes contiguous f32 x and a contiguous (D, Do) W.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQueries = 8;  // query nodes per block of the rows body

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
gat_rows_kernel(const float* __restrict__ x, const float* __restrict__ w,
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

size_t rows_smem_bytes(int N, int D, int Do) {
  return sizeof(float) * (static_cast<size_t>(N) * (D + 1) + D * Do + 4 * Do +
                          kQueries * N);
}

// ------------------------------------------------------------ tiled body

constexpr int kMaxThreads = 512;
constexpr int kMaxTiledQueries = 8;  // query rows per block, at most
constexpr int kKeys = 4;             // keys per thread
constexpr int kOuts = 8;             // outputs per thread
constexpr int kStage = 8;            // staging loads in flight a thread
constexpr size_t kSmemLimit = 232448;

enum XType { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// tanh x = 1 - 2 / (e^(2x) + 1), e^(2x) = 2^(2 log2(e) x) in one MUFU.EX2
// (2^-22 relative); 2 / (e + 1) by a fast reciprocal. Saturates to +-1.
__device__ __forceinline__ float tanh_fast(float x) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(x * 2.8853900817779268f));
  return 1.f - __fdividef(2.f, e + 1.f);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

// x[b] (N x D, element (j, d) at xb[j sxn + d sxd]) into rows of D + 4
// floats with plain loads: kStage loads in flight a thread before the
// first is widened and stored; consecutive threads walk D where it is the
// unit stride, else the nodes (a transposed view), so the loads coalesce.
template <int D, typename T>
__device__ __forceinline__ void stage_x(float* xs, const T* __restrict__ xb,
                                        int N, long long sxn, long long sxd) {
  constexpr int XS = D + 4;
  const int total = N * D, nthreads = blockDim.x;
  const bool d_inner = sxd == 1;
  for (int base = threadIdx.x; base < total; base += kStage * nthreads) {
    T v[kStage];
    int at[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int idx = min(base + u * nthreads, total - 1);
      const int outer = d_inner ? idx / D : idx / N;
      const int inner = idx - outer * (d_inner ? D : N);
      const int j = d_inner ? outer : inner, d = d_inner ? inner : outer;
      v[u] = xb[j * sxn + d * sxd];
      at[u] = j * XS + d;
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u)
      if (base + u * nthreads < total) xs[at[u]] = to_f(v[u]);
  }
}

__host__ __device__ __forceinline__ int tiled_key_rows(int N) {
  return (N + kKeys - 1) / kKeys * kKeys;
}

size_t tiled_smem_bytes(int N, int D, int Do, int queries) {
  const size_t np = tiled_key_rows(N);
  return sizeof(float) *
         ((np + Do) * (D + 4) + 4 * static_cast<size_t>(Do) + queries * np);
}

bool tiled_fits(int N, int D, int Do) {
  const bool do_ok = Do >= kOuts && Do <= 32 * kOuts && (Do & (Do - 1)) == 0;
  return do_ok && N >= 1 &&
         tiled_smem_bytes(N, D, Do, kMaxTiledQueries) <= kSmemLimit;
}

// kMinBlocks 2 caps registers at 64 (two full blocks an SM) for grids of at
// least two blocks an SM; 1 lets each thread keep two steps of d in flight.
template <int D, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
gat_tiled_kernel(const void* __restrict__ x, int x_type, long long sxb,
                 long long sxn, long long sxd, const float* __restrict__ w,
                 long long swd, long long swo, const float* __restrict__ bias,
                 const float* __restrict__ a11, const float* __restrict__ a22,
                 const float* __restrict__ a12, float* __restrict__ out, int N,
                 int Do, int n1, float temperature, int queries) {
  constexpr int XS = D + 4;          // row stride: float4-aligned, bank-shifted
  const int NP = tiled_key_rows(N);
  const int KG = NP / kKeys;         // key groups
  const int OT = Do / kOuts;         // output tiles = lanes per key group
  extern __shared__ __align__(16) float smt[];
  float* xs = smt;                   // NP x XS, rows N.. zero
  float* ws = xs + NP * XS;          // Do x XS: W in its (Do, D) layout
  float* bs = ws + Do * XS;          // Do
  float* e11 = bs + Do;              // Do each
  float* e22 = e11 + Do;
  float* e12 = e22 + Do;
  float* ss = e12 + Do;              // queries x NP scores

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * queries;
  const int nq = min(queries, N - i0);

  // ---- stage x[b], W, the bias and the edge vectors
  const long long xoff = b * sxb;
  if (x_type == kF32 && sxd == 1 && sxn % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(static_cast<const float*>(x) + xoff) & 15) == 0) {
    const float* xb = static_cast<const float*>(x) + xoff;
    for (int idx = tid; idx < N * (D / 4); idx += nthreads) {
      const int j = idx / (D / 4), c = 4 * (idx - j * (D / 4));
      cp_async16(smem_addr(xs + j * XS + c), xb + j * sxn + c);
    }
  } else if (x_type == kBF16) {
    stage_x<D>(xs, static_cast<const __nv_bfloat16*>(x) + xoff, N, sxn, sxd);
  } else if (x_type == kF16) {
    stage_x<D>(xs, static_cast<const __half*>(x) + xoff, N, sxn, sxd);
  } else {
    stage_x<D>(xs, static_cast<const float*>(x) + xoff, N, sxn, sxd);
  }
  for (int idx = tid; idx < (NP - N) * D; idx += nthreads) {
    const int j = N + idx / D;
    xs[j * XS + idx % D] = 0.f;
  }
  if (swd == 1 && swo % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0) {
    for (int idx = tid; idx < Do * (D / 4); idx += nthreads) {
      const int o = idx / (D / 4), c = 4 * (idx - o * (D / 4));
      cp_async16(smem_addr(ws + o * XS + c), w + o * swo + c);
    }
  } else if (swd == 1) {
    for (int idx = tid; idx < Do * D; idx += nthreads) {
      const int o = idx / D, d = idx - o * D;
      cp_async4(smem_addr(ws + o * XS + d), w + o * swo + d);
    }
  } else {                           // outputs innermost, e.g. a (D, Do) W
    for (int idx = tid; idx < Do * D; idx += nthreads) {
      const int d = idx / Do, o = idx - d * Do;
      cp_async4(smem_addr(ws + o * XS + d), w + d * swd + o * swo);
    }
  }
  for (int o = tid; o < Do; o += nthreads) {
    cp_async4(smem_addr(bs + o), bias + o);
    cp_async4(smem_addr(e11 + o), a11 + o);
    cp_async4(smem_addr(e22 + o), a22 + o);
    cp_async4(smem_addr(e12 + o), a12 + o);
  }
  cp_async_wait_all();
  __syncthreads();

  // ---- scores: a thread per (query, 4 keys, 8 outputs); every warp runs
  // the loop the same number of times, so the shuffles see full warps
  const int units = nq * KG * OT;
  for (int base = 0; base < units; base += nthreads) {
    const int u = min(base + tid, units - 1);
    const int ot = u % OT, r = u / OT;
    const int q = r / KG, j0 = (r - q * KG) * kKeys;
    const int i = i0 + q;
    const float* xi = xs + i * XS;
    const float* xj = xs + j0 * XS;
    const float* wr = ws + ot * XS;
    float acc[kKeys][kOuts];
#pragma unroll
    for (int k = 0; k < kKeys; ++k)
#pragma unroll
      for (int o = 0; o < kOuts; ++o) acc[k][o] = 0.f;
#pragma unroll(kMinBlocks == 1 ? 2 : 1)
    for (int d = 0; d < D; d += 4) {
      const float4 vi = *reinterpret_cast<const float4*>(xi + d);
      float4 a[kKeys];
#pragma unroll
      for (int k = 0; k < kKeys; ++k) {
        const float4 vj = *reinterpret_cast<const float4*>(xj + k * XS + d);
        a[k] = make_float4(vi.x * vj.x, vi.y * vj.y, vi.z * vj.z, vi.w * vj.w);
      }
#pragma unroll
      for (int o = 0; o < kOuts; ++o) {
        const float4 vw = *reinterpret_cast<const float4*>(wr + o * OT * XS + d);
#pragma unroll
        for (int k = 0; k < kKeys; ++k) {
          acc[k][o] = fmaf(a[k].x, vw.x, acc[k][o]);
          acc[k][o] = fmaf(a[k].y, vw.y, acc[k][o]);
          acc[k][o] = fmaf(a[k].z, vw.z, acc[k][o]);
          acc[k][o] = fmaf(a[k].w, vw.w, acc[k][o]);
        }
      }
    }
    const bool i1 = i < n1;
#pragma unroll
    for (int k = 0; k < kKeys; ++k) {
      const bool j1 = j0 + k < n1;
      const float* e = (i1 && j1) ? e11 : ((!i1 && !j1) ? e22 : e12);
      float s = 0.f;
#pragma unroll
      for (int o = 0; o < kOuts; ++o) {
        const int oo = ot + o * OT;
        s = fmaf(tanh_fast(acc[k][o] + bs[oo]), e[oo], s);
      }
      for (int off = OT / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (ot == 0 && base + tid < units && j0 + k < N)
        ss[q * NP + j0 + k] = s / temperature;
    }
  }
  __syncthreads();

  // ---- softmax over the N keys, one warp per query row
  const int warp = tid >> 5, lane = tid & 31;
  for (int q = warp; q < nq; q += nthreads / 32) {
    float* sr = ss + q * NP;
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
  }
  __syncthreads();

  // ---- out_i = sum_j att_ij x_j, a thread per (query, d)
  for (int idx = tid; idx < nq * D; idx += nthreads) {
    const int q = idx / D, d = idx - q * D;
    const float* sr = ss + q * NP;
    float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;   // four chains, not one
    int j = 0;
    for (; j + 4 <= N; j += 4) {
      p0 = fmaf(sr[j], xs[j * XS + d], p0);
      p1 = fmaf(sr[j + 1], xs[(j + 1) * XS + d], p1);
      p2 = fmaf(sr[j + 2], xs[(j + 2) * XS + d], p2);
      p3 = fmaf(sr[j + 3], xs[(j + 3) * XS + d], p3);
    }
    for (; j < N; ++j) p0 = fmaf(sr[j], xs[j * XS + d], p0);
    out[(static_cast<size_t>(b) * N + i0 + q) * D + d] = (p0 + p1) + (p2 + p3);
  }
}

int sm_count() {
  static int count[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0)
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev] > 0 ? count[dev] : 132;
}

// Query rows per block: the Q in {1, 2, 4, 8} whose busiest SM gets the
// fewest warps, counting blocks in waves over the SMs and each block's
// warps idle lanes included; ties go to the larger Q (fewer stagings).
int tiled_queries(int B, int N, int Do) {
  const int per_query = tiled_key_rows(N) / kKeys * (Do / kOuts);
  const long long sms = sm_count();
  int best = 1;
  long long best_cost = -1;
  for (int q = 1; q <= kMaxTiledQueries && q <= N; q *= 2) {
    const long long blocks = static_cast<long long>(B) * ((N + q - 1) / q);
    const long long cost = (blocks + sms - 1) / sms * ((q * per_query + 31) / 32);
    if (best_cost < 0 || cost <= best_cost) {
      best = q;
      best_cost = cost;
    }
  }
  return best;
}

template <int D, int kMinBlocks>
int launch_tiled_k(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   const void* x, int x_type, long long sxb, long long sxn,
                   long long sxd, const float* w, long long swd, long long swo,
                   const float* bias, const float* a11, const float* a22,
                   const float* a12, float* out, int N, int Do, int n1,
                   float temperature, int q) {
  static size_t allowed = 0;  // raised once per size, outside graph capture
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        gat_tiled_kernel<D, kMinBlocks>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  gat_tiled_kernel<D, kMinBlocks><<<grid, threads, smem, stream>>>(
      x, x_type, sxb, sxn, sxd, w, swd, swo, bias, a11, a22, a12, out, N, Do,
      n1, temperature, q);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tiled_d(const void* x, int x_type, long long sxb, long long sxn,
                   long long sxd, const float* w, long long swd, long long swo,
                   const float* bias, const float* a11, const float* a22,
                   const float* a12, float* out, int B, int N, int Do, int n1,
                   float temperature, cudaStream_t stream) {
  const int q = tiled_queries(B, N, Do);
  const int per_block = q * (tiled_key_rows(N) / kKeys) * (Do / kOuts);
  const int threads = per_block >= kMaxThreads ? kMaxThreads : (per_block + 31) / 32 * 32;
  const size_t smem = tiled_smem_bytes(N, D, Do, q);
  const dim3 grid((N + q - 1) / q, B);
  if (static_cast<long long>(grid.x) * grid.y >= 2LL * sm_count())
    return launch_tiled_k<D, 2>(grid, threads, smem, stream, x, x_type, sxb, sxn,
                                sxd, w, swd, swo, bias, a11, a22, a12, out, N,
                                Do, n1, temperature, q);
  return launch_tiled_k<D, 1>(grid, threads, smem, stream, x, x_type, sxb, sxn,
                              sxd, w, swd, swo, bias, a11, a22, a12, out, N, Do,
                              n1, temperature, q);
}

int launch_tiled(const void* x, int x_type, long long sxb, long long sxn,
                 long long sxd, const float* w, long long swd, long long swo,
                 const float* bias, const float* a11, const float* a22,
                 const float* a12, float* out, int B, int N, int D, int Do,
                 int n1, float temperature, cudaStream_t st) {
  if (!tiled_fits(N, D, Do) || x_type < kF32 || x_type > kF16)
    return static_cast<int>(cudaErrorInvalidValue);
#define GAT_TILED(DD)                                                          \
  case DD:                                                                     \
    return launch_tiled_d<DD>(x, x_type, sxb, sxn, sxd, w, swd, swo, bias, a11, \
                              a22, a12, out, B, N, Do, n1, temperature, st);
  switch (D) {
    GAT_TILED(16)
    GAT_TILED(32)
    GAT_TILED(64)
    GAT_TILED(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GAT_TILED
}

template <int D>
int launch_rows_d(const float* x, const float* w, const float* bias, const float* a11,
                  const float* a22, const float* a12, float* out, int B, int N, int Do,
                  int n1, float temperature, cudaStream_t stream) {
  const size_t smem = rows_smem_bytes(N, D, Do);
  static size_t allowed = 0;  // raised once per size, outside graph capture
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        gat_rows_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  dim3 grid((N + kQueries - 1) / kQueries, B);
  gat_rows_kernel<D><<<grid, kThreads, smem, stream>>>(x, w, bias, a11, a22, a12,
                                                       out, N, Do, n1, temperature);
  return static_cast<int>(cudaGetLastError());
}

int launch_rows(const float* x, const float* w, const float* bias,
                const float* a11, const float* a22, const float* a12, float* out,
                int B, int N, int D, int Do, int n1, float temperature,
                cudaStream_t st) {
  switch (D) {
    case 16: return launch_rows_d<16>(x, w, bias, a11, a22, a12, out, B, N, Do, n1, temperature, st);
    case 32: return launch_rows_d<32>(x, w, bias, a11, a22, a12, out, B, N, Do, n1, temperature, st);
    case 64: return launch_rows_d<64>(x, w, bias, a11, a22, a12, out, B, N, Do, n1, temperature, st);
    case 128: return launch_rows_d<128>(x, w, bias, a11, a22, a12, out, B, N, Do, n1, temperature, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Contiguous f32 x (B, N, D) and W (D, Do): the tiled body where it fits,
// else the rows body.
int launch(const float* x, const float* w, const float* bias, const float* a11,
           const float* a22, const float* a12, float* out, int B, int N, int D,
           int Do, int n1, float temperature, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tiled_fits(N, D, Do))
    return launch_tiled(x, kF32, static_cast<long long>(N) * D, D, 1, w, Do, 1,
                        bias, a11, a22, a12, out, B, N, D, Do, n1, temperature, st);
  return launch_rows(x, w, bias, a11, a22, a12, out, B, N, D, Do, n1,
                     temperature, st);
}

__global__ void tanh_check_kernel(const float* x, float* fast, float* ref, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    fast[i] = tanh_fast(x[i]);
    ref[i] = tanhf(x[i]);
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

// The tiled body on x of any strides in float32 (x_type 0), bfloat16 (1) or
// float16 (2), element (b, j, d) at x[b sxb + j sxn + d sxd], and a float32
// W of any strides, element (d, o) at w[d swd + o swo]; bias and the edge
// vectors contiguous float32 (Do); out (B, N, D) contiguous float32. The
// homogeneous layer passes a11 = a22 = a12 and n1 = N. Returns
// cudaErrorInvalidValue where tiled_fits refuses the shape.
int gat_tiled_aggregate(const void* x, int x_type, long long sxb, long long sxn,
                        long long sxd, const float* w, long long swd,
                        long long swo, const float* bias, const float* a11,
                        const float* a22, const float* a12, float* out, int B,
                        int N, int D, int Do, int n1, float temperature,
                        void* stream) {
  return launch_tiled(x, x_type, sxb, sxn, sxd, w, swd, swo, bias, a11, a22, a12,
                      out, B, N, D, Do, n1, temperature,
                      static_cast<cudaStream_t>(stream));
}

// The rows body alone, on the arguments of htrg_gat_aggregate_f32, whatever
// the shape rule says: the yardstick the tiled body is timed against.
int gat_rows_aggregate_f32(const float* x, const float* w, const float* bias,
                           const float* w11, const float* w22, const float* w12,
                           float* out, int B, int N, int D, int Do, int n1,
                           float temperature, void* stream) {
  if (rows_smem_bytes(N, D, Do) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_rows(x, w, bias, w11, w22, w12, out, B, N, D, Do, n1,
                     temperature, static_cast<cudaStream_t>(stream));
}

// The tiled body's tanh and tanhf on n floats, for measuring the former.
int gat_tanh_check(const float* x, float* fast, float* ref, int n, void* stream) {
  tanh_check_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, fast, ref, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
