// Small-T multi-head self-attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rtdsd_tpu/ops/pallas/attention.py
// (mha_small_t, body _mha_kernel). Per (batch, head): s = Q K^T with f32
// accumulation, times `scale` in f32, padded keys out of the softmax, row max
// and sum in f32, p = e / sum normalised in f32 and only then rounded to V's
// dtype, then p V with f32 accumulation, rounded once to the output dtype
// (the float32 tiled kernel, with no rounding of p, applies 1 / sum to the
// sums of e V instead).
// Inputs are read in their (B, T, H, D) layout through their strides (the
// head dimension contiguous); the output is a contiguous (B, T, H, D) tensor.
//
// What bounds it on the H100: at the XLSR shape (B 16, T 199, H 16, D 64,
// bf16) the work is 4 B H T^2 D = 2.6 GFLOP (0.0026 ms at 989 TFLOP/s)
// against 4 B T H D x 2 bytes = 26.1 MB of q, k, v and o (0.0078 ms at
// 3.35 TB/s): bound by bytes, by about 3x. Next come the exponentials, one
// per score: B H T^2 = 10.1 M on the SFUs (16 a clock per SM), about 0.003 ms.
// So the products and the softmax must hide behind the copies.
//
// bf16, D = 64 (mha_small_t_wgmma_kernel, the scoring path):
// - Both products on the tensor cores with warpgroup wgmma (bf16 in, f32
//   accumulate): a block is one warpgroup; each warp holds 16 query rows of
//   a 64-row tile as mma A fragments in registers; K (for Q K^T, 64 keys a
//   wgmma) and V (for P V, read transposed) are read by the tensor cores
//   from shared memory through matrix descriptors, once per warpgroup.
// - A block stages its head's K and V once, with 16-byte cp.async (K first;
//   V only once K has landed, so that K, which the first score pass waits
//   for, has the memory to itself), and then walks that head's query tiles,
//   so K and V cross from device memory once per block, not once per tile;
//   the grid gives about two blocks to each SM.
//   Rows are 128 bytes with wgmma's 128-byte swizzle (16-byte chunk index
//   XOR row % 8), zero-filled past T (source size 0), so 0 * garbage never
//   poisons O.
// - The score chunk (up to 256 keys) stays in registers: row max and sum in
//   f32, reduced across the quad of lanes sharing a row with two shuffles;
//   the scale is folded into the exponent, e = 2^(s scale log2(e) - max
//   scale log2(e)), one FFMA and one MUFU ex2 a score (a negative scale
//   negates q instead, exactly; see exp2_scale). p = e * (1 / sum) is
//   formed in f32 and only then rounded to bf16 (unlike flash attention's
//   online softmax, which rounds the unnormalised e). T > 256 takes 64-key
//   chunks in two passes (statistics, then the scores again for P V).
// - P never touches shared memory: the C fragments of two adjacent 8-key
//   score tiles are the A fragment of one 16-key step of P V.
// - ptxas keeps several wgmmas in flight only when none of them sits under a
//   branch, so every wgmma here is unconditional: the number of 64-key
//   score wgmmas is a template parameter (T <= 256: T rounded up to 64
//   keys, one instance for each of 64, 128, 192 and 256; T > 256: 64-key
//   chunks), padded keys contributing exact zeros.
// What it does not yet hide: a warpgroup runs its products, its softmax and
// its P V one after another, and with 231 registers a thread only two
// blocks share an SM, so the SM sub-partitions wait on their own
// instruction latencies (PERF.md, PR 3).
//
// bf16, D = 16, 32, 128 (mha_small_t_mma_kernel): the same arithmetic with
// mma.sync.m16n8k16, one warp per 16 query rows, K fragments by ldmatrix and
// V fragments by ldmatrix.trans from the swizzled shared copy (the swizzle
// puts the 8 rows one ldmatrix reads in 8 different bank groups).
// Shared memory is 4 T_pad D bytes (T_pad: T rounded up to 16, or to 64 at
// D = 64), so T reaches 3632 / 1808 / 896 / 448 at D = 16 /
// 32 / 64 / 128 (ops/attention.py::max_seq).
//
// float32 stays on the CUDA cores: TF32 tensor cores would not keep its
// accuracy. At the XLSR shape the same 2.6 GFLOP take 0.0387 ms at the
// H100's 67 TFLOP/s of FP32 FMAs, against 4 B T H D x 4 bytes = 52.2 MB of
// q, k, v and o (0.0156 ms at 3.35 TB/s): bound by operations, so the FMAs
// must be fed from registers, not one shared-memory load each.
// Shape rule (ops/attention.py::f32_tiled): T up to 512 / 384 / 256 / 128 at
// D = 16 / 32 / 64 / 128, where the tiled kernel's shared memory fits a
// block's 227 KB, runs mha_small_t_tiled_kernel; longer T, up to 1383 / 785
// / 421 / 218, runs mha_small_t_rows_kernel.
//
// mha_small_t_tiled_kernel (256 threads, one block an SM):
// - A block owns a head (or, when B H is below the SM count, a share of its
//   64-row query tiles). It stages K and V once with 16-byte cp.async (V
//   behind K) into rows of D + 4 floats, 16-byte aligned, so that LDS.128 of
//   consecutive rows spreads over the banks, zero-filled up to T_32 (T
//   rounded up to 32 keys). Then it walks its query tiles, loading the next
//   tile's Q during the softmax.
// - Scores: S = (Q K^T) scale for the 64 x T_32 tile, a warp per task of 32
//   rows x 32 keys, each thread a 4 x 8 micro-tile (rows lr + 8 i, keys lc +
//   4 j) walking d in float4 steps: 4 Q and 8 K LDS.128 feed 128 FFMAs (the
//   rows kernel: one shared load an FMA), the lanes of a quad sharing their
//   K loads (see lane_rows8).
// - Softmax in the 64 x (T_32 + 4) f32 score buffer in shared memory: a warp
//   takes 8 rows at once, max and sum reduced by shuffles, e = 2^(s log2(e)
//   - max log2(e)) (one FFMA and one ex2.approx a score) written back, and
//   1 / sum kept a row.
// - P V: a warp per task of 16 rows x 32 columns (32 x 16 at D = 16), each
//   thread 4 rows x 4 adjacent columns, 4 keys a step: 4 P and 4 V LDS.128
//   feed 64 FFMAs; the sums times 1 / sum are the output (p = e / sum applied
//   after the product, the same up to rounding in f32).
// Shared memory: 4 ((2 T_32 + 64) (D + 4) + 64 (T_32 + 5)) bytes; at T = 199,
// D = 64: K 60.9 KB, V 60.9, Q 17.4, scores 58.4, 197.9 KB in all. So one
// block holds an SM, and the 256 heads of a batch of 16 take two waves.
//
// mha_small_t_rows_kernel (long T): one block per (batch * head, tile of 64
// query rows); K and V in dynamic shared memory, rows padded by one word;
// each of the 8 warps owns a query row at a time, keeps q in registers,
// computes its scores lane-parallel over keys into a per-warp shared buffer,
// reduces max and sum with shuffles, and accumulates p V lane-parallel over
// the head dimension.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

// ------------------------------------------------ shared by all kernels

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; src_bytes 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// 4-byte asynchronous copy (through L1); src_bytes 0 writes a zero.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x in one MUFU instruction (relative error about 2^-22); 2^-inf = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------ float32, CUDA cores

constexpr int kWarps = 8;
constexpr int kRowsPerBlock = 64;

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// Shared-memory row stride in elements: D plus one 32-bit word.
template <typename T> __host__ __device__ constexpr int row_stride(int d) {
  return d + 4 / static_cast<int>(sizeof(T));
}

// Two consecutive elements of a shared-memory row as floats (d even).
__device__ __forceinline__ float2 load2(const float* row, int d) {
  return make_float2(row[d], row[d + 1]);
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
mha_small_t_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, int H, int seq,
                        int64_t sqb, int64_t sqt, int64_t sqh,
                        int64_t skb, int64_t skt, int64_t skh,
                        int64_t svb, int64_t svt, int64_t svh, float scale) {
  constexpr int KS = row_stride<T>(D);
  constexpr int PAIRS = D / 2;
  extern __shared__ __align__(16) unsigned char f32_smem[];
  T* ks = reinterpret_cast<T*>(f32_smem);
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

size_t rows_smem_bytes(int seq, int d) {
  return 2 * static_cast<size_t>(seq) * row_stride<float>(d) * sizeof(float) +
         static_cast<size_t>(kWarps) * seq * sizeof(float);
}

// The register-tiled kernel: kTileRows query rows of scores at a time, keys
// staged in strips of kKeyStrip (T_32), rows padded by 4 floats.
constexpr int kTiledThreads = 256;
constexpr int kTiledWarps = kTiledThreads / 32;
constexpr int kTileRows = 64;
constexpr int kKeyStrip = 32;
constexpr size_t kSmemLimit = 232448;  // bytes of shared memory a block may use

__host__ __device__ constexpr int keys32(int seq) {
  return (seq + kKeyStrip - 1) / kKeyStrip * kKeyStrip;
}

size_t tiled_smem_bytes(int seq, int d) {
  const size_t tk = keys32(seq);
  return sizeof(float) * ((2 * tk + kTileRows) * (d + 4) + kTileRows * (tk + 5));
}

// Copy `rows` rows of D floats (row stride st, from base) into shared memory
// at dst (row stride D + 4); rows >= seq become zeros. 16-byte copies when
// every row starts on a 16-byte boundary (vec), else 4-byte ones.
template <int D>
__device__ __forceinline__ void stage_f32(float* dst, const float* base, int64_t st, int rows,
                                          int seq, bool vec) {
  constexpr int S = D + 4;
  if (vec) {
    constexpr int R = D / 4;  // 16-byte chunks a row
    for (int i = threadIdx.x; i < rows * R; i += kTiledThreads) {
      const int r = i / R, c = 4 * (i % R);
      const bool ok = r < seq;
      cp_async16(smem_addr(dst + r * S + c), ok ? base + r * st + c : base, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += kTiledThreads) {
      const int r = i / D, c = i % D;
      const bool ok = r < seq;
      cp_async4(smem_addr(dst + r * S + c), ok ? base + r * st + c : base, ok ? 4 : 0);
    }
  }
}

// Lane layout. An LDS.128 serves a warp's 512 bytes in 2 clocks at best,
// and takes longer when the 4 lanes of a quad (4 consecutive lanes) read
// different 16-byte chunks. A score task loads 8 K rows a step against 4 Q
// rows, so the lanes of a quad share their key column (lane_cols4 is the
// same over a quad) and differ in their rows; a quarter-warp holds 4 rows x
// 2 key columns, and the 4 quarters are 2 x 2.
__device__ __forceinline__ int lane_rows8(int lane) { return (lane & 3) | (lane >> 1 & 4); }
__device__ __forceinline__ int lane_cols4(int lane) { return (lane >> 2 & 1) | (lane >> 3 & 2); }

// ss[r][j] = (q_r . k_j) scale for rows r < 32 ngroups of the tile and keys
// j < 32 nstrips: a warp per task of 32 rows x 32 keys, each thread the 4 x 8
// micro-tile of rows lr + 8 i and keys lc + 4 j, d in float4 steps: 4 Q and
// 8 K LDS.128 of consecutive rows, free of bank conflicts, feed 128 FFMAs.
template <int D>
__device__ __forceinline__ void tiled_scores(const float* qs, const float* ks, float* ss,
                                             int sst, int ngroups, int nstrips, float scale,
                                             int warp, int lane) {
  constexpr int S = D + 4;
  const int lr = lane_rows8(lane), lc = lane_cols4(lane);
  for (int task = warp; task < ngroups * nstrips; task += kTiledWarps) {
    const int g = task / nstrips, c = task - g * nstrips;
    const float* qp = qs + (32 * g + lr) * S;
    const float* kp = ks + (32 * c + lc) * S;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(qp + 8 * i * S + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = *reinterpret_cast<const float4*>(kp + 4 * j * S + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(qv[i].x, kv[j].x, acc[i][j]);
          acc[i][j] = fmaf(qv[i].y, kv[j].y, acc[i][j]);
          acc[i][j] = fmaf(qv[i].z, kv[j].z, acc[i][j]);
          acc[i][j] = fmaf(qv[i].w, kv[j].w, acc[i][j]);
        }
    }
    float* sp = ss + (32 * g + lr) * sst + 32 * c + lc;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sp[8 * i * sst + 4 * j] = acc[i][j] * scale;
  }
}

// Softmax of the tile's rows over the seq real keys, up to the division:
// warp w takes rows w, w + 8, ..., all 8 at once (independent loads and
// shuffles, to hide their latency). Row max in f32, e = 2^(s log2(e) - max
// log2(e)) written back (0 for keys seq ... nk - 1, which P V reads against
// V's zero rows), the row sum in f32 and inv[r] = 1 / sum; P V scales its
// sums by inv[r], which is p = e (1 / sum) applied after the product. Rows
// past T are finite (zero Q rows) or never read.
__device__ __forceinline__ void tiled_softmax(float* ss, float* inv, int sst, int seq, int nk,
                                              int warp, int lane) {
  constexpr int R = kTileRows / kTiledWarps;
  constexpr float kLog2e = 1.4426950408889634f;
  float* rw = ss + warp * sst;  // row warp + kTiledWarps r
  float m[R], l[R], x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) m[r] = -INFINITY, l[r] = 0.f;
  for (int j = lane; j < seq; j += 32)
#pragma unroll
    for (int r = 0; r < R; ++r) m[r] = fmaxf(m[r], rw[kTiledWarps * r * sst + j]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r) m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], o));
#pragma unroll
  for (int r = 0; r < R; ++r) m[r] *= kLog2e;
  for (int j = lane; j < nk; j += 32) {
    // all loads of the step before any store: the rows may alias as far as
    // the compiler knows
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = rw[kTiledWarps * r * sst + j];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      x[r] = j < seq ? exp2_approx(fmaf(x[r], kLog2e, -m[r])) : 0.f;
      l[r] += x[r];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) rw[kTiledWarps * r * sst + j] = x[r];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r) l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < R; ++r) inv[warp + kTiledWarps * r] = 1.f / l[r];
}

// O rows r < rows of the tile (row stride ost) = P V over keys j < nk (a
// multiple of 4): a warp per task of 4 LR rows x 4 LC columns, each thread 4
// rows (lr + LR i) x 4 adjacent columns, 4 keys a step: P as one float4 of 4
// keys a row (LR consecutive rows a load), V as one float4 a key; a quad
// reads 2 chunks of each, a quarter-warp holds 2 rows x 4 column groups (4 x
// 2 at D = 16), and the quarters are 2 x 2.
template <int D>
__device__ __forceinline__ void tiled_pv(const float* ss, const float* inv, int sst,
                                         const float* vs, float* o, int64_t ost, int rows, int nk,
                                         int warp, int lane) {
  constexpr int S = D + 4;
  constexpr int LC = D / 4 < 8 ? D / 4 : 8;  // lanes along the columns
  constexpr int LR = 32 / LC;                // and along the rows
  constexpr int NC = D / (4 * LC);           // column strips
  const int lr = LC == 8 ? (lane & 1) | (lane >> 2 & 2) : lane_rows8(lane);
  const int lc = LC == 8 ? (lane >> 1 & 3) | (lane >> 2 & 4) : lane_cols4(lane);
  const int ngroups = (rows + 4 * LR - 1) / (4 * LR);
  for (int task = warp; task < ngroups * NC; task += kTiledWarps) {
    const int g = task / NC, col = 4 * (LC * (task - g * NC) + lc);
    const int r0 = 4 * LR * g + lr;
    const float* pp = ss + r0 * sst;
    const float* vp = vs + col;
    float4 acc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
    for (int j = 0; j < nk; j += 4) {
      float4 p[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(pp + LR * i * sst + j);
#pragma unroll
      for (int t = 0; t < 4; ++t) vv[t] = *reinterpret_cast<const float4*>(vp + (j + t) * S);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pk[4] = {p[i].x, p[i].y, p[i].z, p[i].w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          acc[i].x = fmaf(pk[t], vv[t].x, acc[i].x);
          acc[i].y = fmaf(pk[t], vv[t].y, acc[i].y);
          acc[i].z = fmaf(pk[t], vv[t].z, acc[i].z);
          acc[i].w = fmaf(pk[t], vv[t].w, acc[i].w);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + LR * i;
      const float w = inv[r];
      if (r < rows)
        *reinterpret_cast<float4*>(o + r * ost + col) =
            make_float4(acc[i].x * w, acc[i].y * w, acc[i].z * w, acc[i].w * w);
    }
  }
}

// Blocks (blockIdx.x = batch * H + head, blockIdx.y = first query tile):
// K, the first Q tile, then V staged with cp.async; then tiles blockIdx.y,
// blockIdx.y + gridDim.y, ... each: scores (needs K and Q), softmax (the
// next tile's Q in flight), P V (needs V).
template <int D>
__global__ void __launch_bounds__(kTiledThreads, 1)
mha_small_t_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, int H, int seq,
                         int64_t sqb, int64_t sqt, int64_t sqh,
                         int64_t skb, int64_t skt, int64_t skh,
                         int64_t svb, int64_t svt, int64_t svh, float scale, int vec) {
  constexpr int S = D + 4;
  extern __shared__ __align__(16) float tiled_smem[];
  const int tk = keys32(seq);
  const int sst = tk + 4;  // score row stride
  const int nk = (seq + 3) & ~3;  // keys P V takes, 4 a step
  float* ks = tiled_smem;
  float* vs = ks + tk * S;
  float* qs = vs + tk * S;
  float* ss = qs + kTileRows * S;
  float* inv = ss + kTileRows * sst;  // 1 / row sum

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const float* qh = q + b * sqb + h * sqh;
  stage_f32<D>(ks, k + b * skb + h * skh, skt, tk, seq, vec);
  int r0 = blockIdx.y * kTileRows;
  stage_f32<D>(qs, qh + r0 * sqt, sqt, kTileRows, seq - r0, vec);
  cp_async_commit();
  stage_f32<D>(vs, v + b * svb + h * svh, svt, tk, seq, vec);
  cp_async_commit();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t ost = static_cast<int64_t>(H) * D;
  for (; r0 < seq; r0 += kTileRows * gridDim.y) {
    const int rows = min(kTileRows, seq - r0);
    if (r0 == static_cast<int>(blockIdx.y) * kTileRows) {
      cp_async_wait<1>();  // K and Q; V may still be in flight
    } else {
      cp_async_wait<0>();  // this tile's Q
    }
    __syncthreads();  // ... for every thread; and the last tile's P V is done
    tiled_scores<D>(qs, ks, ss, sst, (rows + 31) / 32, tk / kKeyStrip, scale, warp, lane);
    __syncthreads();  // scores complete; Q free
    const int rn = r0 + kTileRows * gridDim.y;
    if (rn < seq) stage_f32<D>(qs, qh + rn * sqt, sqt, kTileRows, seq - rn, vec);
    cp_async_commit();  // (an empty group on the last tile)
    tiled_softmax(ss, inv, sst, seq, nk, warp, lane);
    cp_async_wait<1>();  // V
    __syncthreads();
    tiled_pv<D>(ss, inv, sst, vs, o + ((static_cast<int64_t>(b) * seq + r0) * H + h) * D, ost,
                rows, nk, warp, lane);
  }
}

// ------------------------------------------------ bf16, tensor cores

using bf16 = __nv_bfloat16;

// Warps of the mma.sync kernel's block (16 query rows each) and 16-key
// tiles whose scores a warp holds in registers at once (halved at D = 128).
constexpr int kMmaWarps = 4;
template <int D> __host__ __device__ constexpr int key_tiles() { return D <= 64 ? 16 : 8; }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16 x 16, row major) * b (16 x 8, column major), bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Warpgroup mma (wgmma): four warps multiply a 64-row A held in their
// registers (each warp's 16 rows in the mma.sync A layout) by a B read once
// from shared memory through a matrix descriptor; each warp receives its 16
// rows of the product in the mma.sync C layout, one C fragment per 8 columns.
// ptxas keeps wgmmas in flight together only when none of them is issued
// under a branch, so every wgmma below is unconditional.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Make shared memory written by this thread (cp.async) visible to wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keep the compiler from touching wgmma accumulators before the wait.
template <int N> __device__ __forceinline__ void pin(float (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(r[i][j])::"memory");
}

// Descriptor of a 128-byte-swizzled operand at shared address `addr`: rows
// of 128 bytes (64 bf16), groups of 8 rows 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1) << 62;
}

// d[O ... O + 7] (64 x 64: this warp's 8 C fragments) (+)= a (64 x 16) b,
// where b is 64 keys by 16 d of K (K-major, kTrans 0) or 16 keys by 64 d of
// V (MN-major, kTrans 1: read transposed).
template <int kTrans, int O, int M>
__device__ __forceinline__ void wgmma_bf16(float (&d)[M][4], const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  static_assert(O + 8 <= M, "accumulators out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[O + 0][0]), "+f"(d[O + 0][1]), "+f"(d[O + 0][2]), "+f"(d[O + 0][3]),
        "+f"(d[O + 1][0]), "+f"(d[O + 1][1]), "+f"(d[O + 1][2]), "+f"(d[O + 1][3]),
        "+f"(d[O + 2][0]), "+f"(d[O + 2][1]), "+f"(d[O + 2][2]), "+f"(d[O + 2][3]),
        "+f"(d[O + 3][0]), "+f"(d[O + 3][1]), "+f"(d[O + 3][2]), "+f"(d[O + 3][3]),
        "+f"(d[O + 4][0]), "+f"(d[O + 4][1]), "+f"(d[O + 4][2]), "+f"(d[O + 4][3]),
        "+f"(d[O + 5][0]), "+f"(d[O + 5][1]), "+f"(d[O + 5][2]), "+f"(d[O + 5][3]),
        "+f"(d[O + 6][0]), "+f"(d[O + 6][1]), "+f"(d[O + 6][2]), "+f"(d[O + 6][3]),
        "+f"(d[O + 7][0]), "+f"(d[O + 7][1]), "+f"(d[O + 7][2]), "+f"(d[O + 7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate),
        "n"(kTrans));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Element offset of 16-byte chunk c of shared-memory row r (D bf16 a row).
// Chunks are XOR-swizzled so that the 8 rows one ldmatrix reads at one
// chunk column land in 8 different 16-byte bank groups. At D = 64 this is
// wgmma's 128-byte swizzle (chunk ^= row % 8 in 128-byte rows).
template <int D> __device__ __forceinline__ int swz(int r, int c) {
  constexpr int R = D / 8;  // chunks per row
  if constexpr (R >= 8) {
    return r * D + ((c ^ (r & 7)) << 3);
  } else {
    const int l = r * R + c;  // chunk index; a 128-byte line holds 8
    return ((l & ~7) | ((l ^ (l >> 3)) & 7)) << 3;
  }
}

// Copy `rows` rows of one head (row stride `st`) into swizzled shared
// memory at `dst` with 16-byte cp.async, thread `tid` of kThreads; rows >=
// seq are zero-filled.
template <int D, int kThreads>
__device__ __forceinline__ void stage(uint32_t dst, const bf16* base, int64_t st, int rows,
                                      int seq, int tid) {
  constexpr int R = D / 8;               // 16-byte chunks per row
  constexpr int kStep = kThreads / R;    // rows one pass of the threads copies
  const int c = tid % R;
  const int r0 = tid / R;
  const bf16* src = base + r0 * st + 8 * c;
  for (int r = r0; r < rows; r += kStep, src += kStep * st)
    cp_async16(dst + 2 * swz<D>(r, c), r < seq ? src : base, r < seq ? 16 : 0);
}

// This lane's Q fragments (rows r0 and r0 + 8; rows >= seq read as zero) in
// the mma A layout: qa[kk] covers d 16 kk ... 16 kk + 15.
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qa)[D / 16][4], const bf16* q0, int64_t sqt,
                                       int r0, int seq) {
  const bf16* q1 = q0 + 8 * sqt;
  const bool ok0 = r0 < seq, ok1 = r0 + 8 < seq;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int d = 16 * kk;
    qa[kk][0] = ok0 ? __ldg(reinterpret_cast<const uint32_t*>(q0 + d)) : 0u;
    qa[kk][1] = ok1 ? __ldg(reinterpret_cast<const uint32_t*>(q1 + d)) : 0u;
    qa[kk][2] = ok0 ? __ldg(reinterpret_cast<const uint32_t*>(q0 + d + 8)) : 0u;
    qa[kk][3] = ok1 ? __ldg(reinterpret_cast<const uint32_t*>(q1 + d + 8)) : 0u;
  }
}

// Issue the wgmmas of Q K^T for 64-key groups G0 ... KT / 4 - 1 of a chunk
// whose K starts at shared address kc, each over the four 16-d steps.
template <int KT, int G0>
__device__ __forceinline__ void issue_scores(float (&s)[2 * KT][4],
                                             const uint32_t (&qa)[4][4], uint32_t kc) {
  if constexpr (4 * G0 < KT) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_bf16<0, 8 * G0>(s, qa[kk], sw128_desc(kc + G0 * 64 * 128 + kk * 32), kk);
    issue_scores<KT, G0 + 1>(s, qa, kc);
  }
}

// Issue Q K^T of chunk c (keys 16 KT c ...) for the warpgroup's 64 rows,
// all wgmmas in flight together; the caller waits (wgmma_wait_all, then
// pin(s)).
template <int KT>
__device__ __forceinline__ void wgmma_scores(float (&s)[2 * KT][4], const uint32_t (&qa)[4][4],
                                             uint32_t ks, int c) {
  wgmma_fence();
  issue_scores<KT, 0>(s, qa, ks + c * KT * 16 * 128);  // 16 keys of 128 bytes a tile
  wgmma_commit();
}

// Q K^T of chunk c (keys 16 KT c ...) for the warp's 16 rows with mma.sync;
// tiles past the last real one stay 0.
template <int D, int KT>
__device__ __forceinline__ void mma_scores(float (&s)[2 * KT][4],
                                           const uint32_t (&qa)[D / 16][4], uint32_t ks,
                                           int c, int nkt, int lane) {
  const int kr = (lane & 7) + ((lane >> 4) << 3);  // this lane's ldmatrix row
  const int kc = (lane >> 3) & 1;                  // and chunk within 16 d
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    s[2 * t][0] = s[2 * t][1] = s[2 * t][2] = s[2 * t][3] = 0.f;
    s[2 * t + 1][0] = s[2 * t + 1][1] = s[2 * t + 1][2] = s[2 * t + 1][3] = 0.f;
    const int kt = c * KT + t;
    if (kt >= nkt) continue;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t bk[4];
      ldmatrix_x4(bk, ks + 2 * swz<D>(16 * kt + kr, 2 * kk + kc));
      mma_bf16(s[2 * t], qa[kk], bk[0], bk[1]);
      mma_bf16(s[2 * t + 1], qa[kk], bk[2], bk[3]);
    }
  }
}

// Scores of chunk `c` (keys 16 KT c ...): keys >= seq become -inf. s[j] is
// n8 tile j of the chunk in the mma C layout: s[j][0..1] row g, keys
// 2 (lane % 4) + {0, 1}; s[j][2..3] row g + 8.
template <int KT>
__device__ __forceinline__ void mask_tail(float (&s)[2 * KT][4], int c, int seq, int lane) {
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    const int kt = c * KT + t;
    if (16 * kt + 16 <= seq) continue;  // a tile of real keys only
    const int key = 16 * kt + 2 * (lane & 3);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = key + (e & 1);
      if (j >= seq) s[2 * t][e] = -INFINITY;
      if (j + 8 >= seq) s[2 * t + 1][e] = -INFINITY;
    }
  }
}

// Pass-1 step over a chunk's scores: raise the row max m of the unscaled
// scores (rows g and g + 8; the kernels keep the scale positive, so it is
// the max of the scaled ones) and rescale the lane's partial sum l to it.
template <int KT>
__device__ __forceinline__ void update_max(const float (&s)[2 * KT][4], float (&m)[2],
                                           float (&l)[2], float sl2) {
  float mc[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) {
    mc[0] = fmaxf(mc[0], fmaxf(s[j][0], s[j][1]));
    mc[1] = fmaxf(mc[1], fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 1));
    mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 2));
    const float mn = fmaxf(m[i], mc[i]);  // finite: every chunk has a real key
    l[i] *= exp2_approx((m[i] - mn) * sl2);
    m[i] = mn;
  }
}

// s <- e = exp(scale s - scale m) = 2^(s sl2 - m sl2), sl2 = scale log2(e)
// (> 0), one FFMA and one MUFU a score, and the lane's partial row sums
// added to l; tiles past the last real one (c KT + t >= nkt) become exactly
// 0.
template <int KT>
__device__ __forceinline__ void chunk_exp(float (&s)[2 * KT][4], const float (&m)[2],
                                          float sl2, int c, int nkt, float (&l)[2]) {
  const float ms[2] = {m[0] * sl2, m[1] * sl2};
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) {
    const bool real = c * KT + j / 2 < nkt;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = real ? exp2_approx(fmaf(s[j][e], sl2, -ms[e >> 1])) : 0.f;
      l[e >> 1] += s[j][e];
    }
  }
}

__device__ __forceinline__ void quad_sum(float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
}

// p = e * (1 / l) in f32, rounded to bf16: the two n8 tiles of keys
// 16 t ... 16 t + 15 as the A fragment pa[t].
template <int KT>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[KT][4], const float (&s)[2 * KT][4],
                                       const float (&rl)[2]) {
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    pa[t][0] = pack_bf16(s[2 * t][0] * rl[0], s[2 * t][1] * rl[0]);
    pa[t][1] = pack_bf16(s[2 * t][2] * rl[1], s[2 * t][3] * rl[1]);
    pa[t][2] = pack_bf16(s[2 * t + 1][0] * rl[0], s[2 * t + 1][1] * rl[0]);
    pa[t][3] = pack_bf16(s[2 * t + 1][2] * rl[1], s[2 * t + 1][3] * rl[1]);
  }
}

// Rows r0 and r0 + 8 of O (bf16 pairs), rows >= seq not written.
template <int D>
__device__ __forceinline__ void store_o(const float (&acc)[D / 8][4], bf16* o0, int64_t row,
                                        int r0, int seq) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (r0 < seq) *reinterpret_cast<uint32_t*>(o0 + 8 * n) = pack_bf16(acc[n][0], acc[n][1]);
    if (r0 + 8 < seq)
      *reinterpret_cast<uint32_t*>(o0 + 8 * row + 8 * n) = pack_bf16(acc[n][2], acc[n][3]);
  }
}

// Shared by both kernels: block (blockIdx.x = batch * H + head, blockIdx.y =
// tile of query rows); q, k, v, o advanced to the head; sl2 = scale log2(e).
struct Head {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int b, h;
};
__device__ __forceinline__ Head head_of(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                                        int H, int64_t sqb, int64_t sqh, int64_t skb,
                                        int64_t skh, int64_t svb, int64_t svh) {
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  return {q + b * sqb + h * sqh, k + b * skb + h * skh, v + b * svb + h * svh, o, b, h};
}

// Exponents are taken in units of log2: scores times sl2 = |scale| log2(e).
// A negative scale negates q instead (exact in bf16), so the row max of the
// unscaled scores stays the max of the scaled ones. A zero scale becomes
// 1e-30: every finite exponent then rounds to 2^0 = 1, as at scale 0, while
// -inf (masked keys, and the sum's first rescale) keeps giving 0, not NaN.
__device__ __forceinline__ float exp2_scale(float scale) {
  return fmaxf(fabsf(scale) * 1.4426950408889634f, 1e-30f);
}

// D = 64 (the XLSR shape): one warpgroup per block, both products with
// wgmma, up to 64 keys per score product. The block stages K and V of its head
// once and walks the head's 64-row query tiles blockIdx.y, blockIdx.y +
// gridDim.y, ..., loading the next tile's Q while it finishes the current.
// A warp whose 16 rows all lie past T (in the last tile) takes part in the
// wgmmas but skips the softmax, leaving its SM sub-partition to the other
// resident block.
// Not kChunked: T <= 256 and KT = 4 ceil(T / 64), one chunk of all keys,
// its scores held in registers across both passes.
// kChunked (KT = 4): chunks of 64 keys, any T, scores recomputed in pass 2.
// K and V rows are staged to the next multiple of 64, zeros past T.
template <int KT, bool kChunked>
__global__ void __launch_bounds__(128)
mha_small_t_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o, int H, int seq,
                         int64_t sqb, int64_t sqt, int64_t sqh,
                         int64_t skb, int64_t skt, int64_t skh,
                         int64_t svb, int64_t svt, int64_t svh, float scale) {
  constexpr int D = 64;
  static_assert(KT % 4 == 0, "scores are taken 64 keys a wgmma");
  extern __shared__ __align__(1024) unsigned char wgmma_smem[];  // the swizzle's period
  const Head hd = head_of(q, k, v, o, H, sqb, sqh, skb, skh, svb, svh);
  const int rows = 64 * ((seq + 63) >> 6);
  const int nkt = (seq + 15) >> 4;
  const int nch = kChunked ? rows / 64 : 1;
  const uint32_t ks = smem_addr(wgmma_smem);
  const uint32_t vs = ks + 2 * rows * D;
  stage<D, 128>(ks, hd.k, skt, rows, seq, threadIdx.x);  // V once K has landed
  cp_async_commit();

  const int lane = threadIdx.x & 31;
  const int ww = (threadIdx.x >> 5) * 16;  // the warp's first row in a tile
  const bf16* qlane = hd.q + 2 * (lane & 3);
  const float sl2 = exp2_scale(scale);
  const uint32_t qsign = scale < 0.f ? 0x80008000u : 0u;
  uint32_t qa[D / 16][4], qn[D / 16][4];
  int r0 = blockIdx.y * 64 + ww + (lane >> 2);
  load_q<D>(qn, qlane + static_cast<int64_t>(r0) * sqt, sqt, r0, seq);
  for (int tile = blockIdx.y; tile * 64 < seq; tile += gridDim.y, r0 += 64 * gridDim.y) {
    const bool live = tile * 64 + ww < seq;  // the warp has a real row
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[kk][i] = qn[kk][i] ^ qsign;
    float s[2 * KT][4];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // K is in shared memory
    if (tile == blockIdx.y) {  // V in flight during the first pass 1
      stage<D, 128>(vs, hd.v, svt, rows, seq, threadIdx.x);
      cp_async_commit();
    }
    for (int c = 0; c < nch; ++c) {
      wgmma_scores<KT>(s, qa, ks, c);
      wgmma_wait_all();
      pin(s);
      if (live) {
        mask_tail<KT>(s, c, seq, lane);
        update_max<KT>(s, m, l, sl2);
        chunk_exp<KT>(s, m, sl2, c, nkt, l);  // with one chunk, s keeps e for pass 2
      }
    }
    if (live) quad_sum(l);
    const int rn = r0 + 64 * gridDim.y;  // the next tile's Q, in flight during pass 2
    load_q<D>(qn, qlane + static_cast<int64_t>(rn) * sqt, sqt, rn, seq);
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // V is in shared memory

    const float rl[2] = {1.f / l[0], 1.f / l[1]};
    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int c = 0; c < nch; ++c) {
      if constexpr (kChunked) {
        float unused[2] = {0.f, 0.f};
        wgmma_scores<KT>(s, qa, ks, c);
        wgmma_wait_all();
        pin(s);
        if (live) {
          mask_tail<KT>(s, c, seq, lane);
          chunk_exp<KT>(s, m, sl2, c, nkt, unused);
        }
      }
      uint32_t pa[KT][4];
      if (live) {
        pack_p<KT>(pa, s, rl);
      } else {  // rows past T: zeros, never stored
#pragma unroll
        for (int t = 0; t < KT; ++t) pa[t][0] = pa[t][1] = pa[t][2] = pa[t][3] = 0u;
      }
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < KT; ++t)
        wgmma_bf16<1, 0>(acc, pa[t], sw128_desc(vs + (c * KT + t) * 16 * 2 * D), 1);
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
    }
    store_o<D>(acc, hd.o + ((static_cast<int64_t>(hd.b) * seq + r0) * H + hd.h) * D +
                        2 * (lane & 3), static_cast<int64_t>(H) * D, r0, seq);
  }
}

// D = 16, 32, 128: each warp owns 16 query rows and multiplies with
// mma.sync, K fragments by ldmatrix, V fragments by ldmatrix.trans. Scores
// of up to KT 16-key tiles are held in registers (one chunk when T <= 16 KT,
// else the scores are recomputed in pass 2). K and V rows are staged up to
// the next multiple of 16.
template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
mha_small_t_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o, int H, int seq,
                       int64_t sqb, int64_t sqt, int64_t sqh,
                       int64_t skb, int64_t skt, int64_t skh,
                       int64_t svb, int64_t svt, int64_t svh, float scale) {
  constexpr int KT = key_tiles<D>();
  extern __shared__ __align__(128) unsigned char mma_smem[];
  const Head hd = head_of(q, k, v, o, H, sqb, sqh, skb, skh, svb, svh);
  const int nkt = (seq + 15) >> 4;
  const int nch = (nkt + KT - 1) / KT;
  const uint32_t ks = smem_addr(mma_smem);
  const uint32_t vs = ks + 2 * 16 * nkt * D;
  stage<D, kMmaWarps * 32>(ks, hd.k, skt, 16 * nkt, seq, threadIdx.x);
  cp_async_commit();
  stage<D, kMmaWarps * 32>(vs, hd.v, svt, 16 * nkt, seq, threadIdx.x);
  cp_async_commit();

  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.y * kMmaWarps + (threadIdx.x >> 5)) * 16;
  const int r0 = row0 + (lane >> 2);
  const bool live = row0 < seq;  // a warp with no real row skips the work
  uint32_t qa[D / 16][4];
  load_q<D>(qa, hd.q + static_cast<int64_t>(r0) * sqt + 2 * (lane & 3), sqt, r0, seq);
  const float sl2 = exp2_scale(scale);  // q negated below for a negative scale
  if (scale < 0.f) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[kk][i] ^= 0x80008000u;
  }

  float s[2 * KT][4];

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  cp_async_wait<1>();
  __syncthreads();  // K is in shared memory
  if (live) {
    for (int c = 0; c < nch; ++c) {
      mma_scores<D, KT>(s, qa, ks, c, nkt, lane);
      mask_tail<KT>(s, c, seq, lane);
      update_max<KT>(s, m, l, sl2);
      chunk_exp<KT>(s, m, sl2, c, nkt, l);  // with one chunk, s keeps e for pass 2
    }
    quad_sum(l);
  }
  cp_async_wait<0>();
  __syncthreads();  // V is in shared memory
  if (!live) return;

  const float rl[2] = {1.f / l[0], 1.f / l[1]};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int vr = (lane & 7) + (((lane >> 3) & 1) << 3);  // ldmatrix.trans row
  const int vc = lane >> 4;                              // and chunk within 16 d
  for (int c = 0; c < nch; ++c) {
    if (nch > 1) {
      float unused[2] = {0.f, 0.f};
      mma_scores<D, KT>(s, qa, ks, c, nkt, lane);
      mask_tail<KT>(s, c, seq, lane);
      chunk_exp<KT>(s, m, sl2, c, nkt, unused);
    }
    uint32_t pa[KT][4];
    pack_p<KT>(pa, s, rl);
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      const int kt = c * KT + t;
      if (kt >= nkt) continue;
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + 2 * swz<D>(16 * kt + vr, 2 * dp + vc));
        mma_bf16(acc[2 * dp], pa[t], bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pa[t], bv[2], bv[3]);
      }
    }
  }
  store_o<D>(acc, hd.o + ((static_cast<int64_t>(hd.b) * seq + r0) * H + hd.h) * D +
                      2 * (lane & 3), static_cast<int64_t>(H) * D, r0, seq);
}

// K and V rows of one head: T rounded up to 16 rows (to 64 at D = 64, the
// wgmma kernel's 64-key groups).
size_t bf16_smem_bytes(int seq, int d) {
  const int unit = d == 64 ? 64 : 16;
  return 2 * static_cast<size_t>((seq + unit - 1) / unit * unit) * d * sizeof(bf16);
}

// ------------------------------------------------ launch

// Raise a kernel's dynamic shared memory limit when a launch needs more than
// before (once per size, not on every launch: launches may be captured into
// a CUDA graph).
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t smem, size_t& allowed) {
  if (smem <= allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess) allowed = smem;
  return err;
}

// Streaming multiprocessors of the current device, read once.
cudaError_t sm_count(int& sms) {
  static int count = 0;
  cudaError_t err = cudaSuccess;
  if (count == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  sms = count;
  return err;
}

// The shape rule of the float32 path: the tiled kernel where its shared
// memory fits, else the one-warp-per-row kernel.
template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int seq, int H,
               const int64_t* s, float scale, cudaStream_t stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  const size_t tiled = tiled_smem_bytes(seq, D);
  if (tiled <= kSmemLimit) {
    auto kern = mha_small_t_tiled_kernel<D>;
    static size_t allowed = 0;
    int sms = 0;
    cudaError_t err = sm_count(sms);
    if (err == cudaSuccess) err = allow_smem(kern, tiled, allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    // 16-byte copies when every row of q, k and v starts on a 16-byte boundary
    int64_t bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                   reinterpret_cast<uintptr_t>(v);
    for (int i = 0; i < 9; ++i) bits |= s[i] * static_cast<int64_t>(sizeof(float));
    // one block an SM: a block per head, or query tiles shared out while
    // B H leaves SMs idle
    const int ntiles = (seq + kTileRows - 1) / kTileRows;
    const int tiles = std::max(1, std::min(ntiles, sms / std::max(1, B * H)));
    kern<<<dim3(B * H, tiles), kTiledThreads, tiled, stream>>>(
        qf, kf, vf, of, H, seq, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], scale,
        (bits & 15) == 0);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = rows_smem_bytes(seq, D);
  auto kern = mha_small_t_rows_kernel<float, D>;
  static size_t allowed = 0;
  cudaError_t err = allow_smem(kern, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, (seq + kRowsPerBlock - 1) / kRowsPerBlock);
  kern<<<grid, kWarps * 32, smem, stream>>>(qf, kf, vf, of, H, seq, s[0], s[1], s[2], s[3],
                                            s[4], s[5], s[6], s[7], s[8], scale);
  return static_cast<int>(cudaGetLastError());
}

using Bf16Kernel = void (*)(const bf16*, const bf16*, const bf16*, bf16*, int, int, int64_t,
                            int64_t, int64_t, int64_t, int64_t, int64_t, int64_t, int64_t,
                            int64_t, float);

// One bf16 kernel instance with `threads` a block, on a grid of (B H,
// tiles) blocks.
template <Bf16Kernel kKern>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int seq, int H,
                int D, int tiles, int threads, const int64_t* s, float scale,
                cudaStream_t stream) {
  const size_t smem = bf16_smem_bytes(seq, D);
  static size_t allowed = 0;
  cudaError_t err = allow_smem(kKern, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, tiles);
  kKern<<<grid, threads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), H, seq, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
      scale);
  return static_cast<int>(cudaGetLastError());
}

// The wgmma kernel for kt 16-key tiles, kt a multiple of 4 (T <= 256).
template <int KT>
int launch_wgmma(int kt, const void* q, const void* k, const void* v, void* o, int B, int seq,
                 int H, int tiles, const int64_t* s, float scale, cudaStream_t stream) {
  if (kt == KT)
    return launch_bf16<mha_small_t_wgmma_kernel<KT, false>>(q, k, v, o, B, seq, H, 64, tiles,
                                                             128, s, scale, stream);
  if constexpr (KT < 16) return launch_wgmma<KT + 4>(kt, q, k, v, o, B, seq, H, tiles, s, scale,
                                                     stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// strides: 9 element strides, (b, t, h) for q, then k, then v. float32 rows
// may start anywhere; the tiled kernel copies 16 bytes at a time only where
// all of them start on 16-byte boundaries.
int mha_small_t_f32(const void* q, const void* k, const void* v, void* o, int B,
                    int seq, int H, int D, const int64_t* strides, float scale,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_f32<16>(q, k, v, o, B, seq, H, strides, scale, st);
    case 32: return launch_f32<32>(q, k, v, o, B, seq, H, strides, scale, st);
    case 64: return launch_f32<64>(q, k, v, o, B, seq, H, strides, scale, st);
    case 128: return launch_f32<128>(q, k, v, o, B, seq, H, strides, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, k, v rows must start on 16-byte boundaries (checked by the wrapper).
int mha_small_t_bf16(const void* q, const void* k, const void* v, void* o, int B,
                     int seq, int H, int D, const int64_t* strides, float scale,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int mt = 32 * kMmaWarps;
  const int mr = (seq + 16 * kMmaWarps - 1) / (16 * kMmaWarps);  // mma.sync row tiles
  if (D == 64) {  // wgmma: T <= 256 in one chunk of 64-key groups, longer T in chunks
    // blocks per head: enough for about two blocks on every SM, each
    // staging K and V once for all of its 64-row query tiles
    int sms = 0;
    const cudaError_t err = sm_count(sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int ntiles = (seq + 63) / 64;
    const int tiles = std::max(1, std::min(ntiles, 2 * sms / std::max(1, B * H)));
    if (seq > 256)
      return launch_bf16<mha_small_t_wgmma_kernel<4, true>>(q, k, v, o, B, seq, H, D, tiles,
                                                             128, strides, scale, st);
    return launch_wgmma<4>(4 * ((seq + 63) / 64), q, k, v, o, B, seq, H, tiles, strides, scale,
                           st);
  }
  switch (D) {
    case 16: return launch_bf16<mha_small_t_mma_kernel<16>>(q, k, v, o, B, seq, H, D, mr, mt,
                                                            strides, scale, st);
    case 32: return launch_bf16<mha_small_t_mma_kernel<32>>(q, k, v, o, B, seq, H, D, mr, mt,
                                                            strides, scale, st);
    case 128: return launch_bf16<mha_small_t_mma_kernel<128>>(q, k, v, o, B, seq, H, D, mr,
                                                              mt, strides, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
