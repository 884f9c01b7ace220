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
// MFLOP a frame) against 2 (s Cin + Cout) bytes moved.
//
// ln_gelu design: one warp per row; each lane holds C / 32 values (channels
// lane + 32 i, so every load and store of the warp is contiguous), the
// mean and the variance are warp-shuffle sums.
//
// conv_ln_gelu_grouped has two bodies; ops/convstack.py::conv_body picks
// one per shape.
//
// The bf16 tensor-core body (conv_mma_kernel) is an implicit GEMM per batch
// row: M = output frames, N = Cout, K = k Cin. The patch of frame f is the
// contiguous run of k Cin values at x + f s Cin, so the A operand is read
// in place (no im2col, no padding of odd lengths), and w (k, Cin, Cout) is
// the (K, N) matrix row-major, read in place too. A block of 8 warps owns
// kMT frames by NB channels (each warp 32 frames by 128 channels, 128
// float32 accumulators a thread). At Cout 128 and 256 one block spans Cout
// (256 x 128, 128 x 256 frames x channels); at Cout 512 a cluster of two
// 128 x 256 blocks splits Cout, which halves the weight bytes each frame
// pulls through L2 (6-9% faster on the H100 than one 64 x 512 block). The
// K loop streams 64-deep chunks of A and B through a 3-stage cp.async ring
// in shared memory (16-byte chunks XOR-swizzled so that ldmatrix reads are
// free of bank conflicts), and each warp multiplies
// with ldmatrix / ldmatrix.trans fragments and mma.sync m16n8k16 (bf16 in,
// float32 accumulate: bf16 products are exact in float32, as in the JAX
// kernel's dot with preferred_element_type=f32). The epilogue adds the bias
// and runs the LayerNorm on the accumulators: per-frame sums by quad
// shuffles, one shared-memory step across the warps and, in a cluster, one
// exchange through distributed shared memory, for the mean and then for the
// variance; then gamma, beta, GELU and one bf16 store per value.
//
// The FFMA body (conv_ln_gelu_kernel, float32 and the shapes the bf16 body
// does not take): one block of 256 threads per (batch row, tile of kTF
// output frames). For each tap j the block stages the kTF input rows f s +
// j (all Cin channels, as float) in shared memory. Thread (ty, tx)
// accumulates a kFT-frame by 4-channel tile in registers: per group of four
// input channels it reads four weight rows (4 consecutive output channels
// each; neighbouring threads read neighbouring channels, so the warp's loads
// are contiguous) and kFT float4 broadcasts of the staged input. After the
// last tap the accumulated tile plus bias goes to shared memory, and one
// warp per frame applies the LayerNorm and GELU above and writes the frame.
//
// Both bodies compute and write only valid frames: the output has exactly
// (t_valid - k) / s + 1 rows.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

// ------------------------------------------------ bf16 tensor-core body

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;         // K values a pipeline stage
constexpr int kStages = 3;      // cp.async ring depth
constexpr int kWM = 32;         // frames a warp
constexpr int kWN = 128;        // channels a warp

template <int NB>               // channels a block
struct MmaTile {
  static constexpr int kWarpsN = NB / kWN;
  static constexpr int kWarpsM = kThreads / 32 / kWarpsN;
  static constexpr int kMT = kWM * kWarpsM;          // frames a block
  static constexpr int kABytes = kMT * kBK * 2;      // rows of 2 kBK bytes
  static constexpr int kBBytes = kBK * NB * 2;       // rows of 2 NB bytes
  static constexpr int kSmem = kStages * (kABytes + kBBytes);
  static_assert(kWarpsN * kWarpsM * 32 == kThreads, "NB");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte asynchronous copy; src_bytes 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c += a (16 x 16, row major) * b (16 x 8, column major), bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk c of row r in a stage's A tile (rows of
// kBK / 8 chunks) and B tile (rows of NB / 8 chunks). The XOR puts the 8
// rows that one ldmatrix reads at one chunk column on 8 bank groups.
__device__ __forceinline__ uint32_t a_off(int r, int c) {
  constexpr int kChunks = kBK / 8;
  constexpr int kShift = kChunks == 4 ? 1 : 0;   // rows a bank-group cycle
  return r * (kBK * 2) + ((c ^ ((r >> kShift) & (kChunks - 1))) << 4);
}
template <int NB> __device__ __forceinline__ uint32_t b_off(int r, int c) {
  return r * (NB * 2) + ((c ^ (r & 7)) << 4);
}

// Sum over the cluster (CN blocks) of the per-frame partial sums v that
// the lanes of this block hold: v[mt][h] is frame wm 32 + mt 16 + h 8 +
// lane / 4, summed over the lane's channels. Returns the total for each of
// the lane's frames. red (kWarpsN x kMT) and tot (kMT) are shared memory;
// tot is read by the peers.
template <int NB, int CN>
__device__ __forceinline__ void frame_sums(float (&v)[2][2], float* red,
                                           float* tot, float* out_tot) {
  using Tile = MmaTile<NB>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / Tile::kWarpsN, wn = warp % Tile::kWarpsN;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float a = v[mt][h];
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      if ((lane & 3) == 0)
        red[wn * Tile::kMT + wm * kWM + mt * 16 + h * 8 + (lane >> 2)] = a;
    }
  __syncthreads();
  if (threadIdx.x < Tile::kMT) {
    float a = 0.f;
#pragma unroll
    for (int q = 0; q < Tile::kWarpsN; ++q) a += red[q * Tile::kMT + threadIdx.x];
    tot[threadIdx.x] = a;
  }
  if (CN > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  if (threadIdx.x < Tile::kMT) {
    float a = tot[threadIdx.x];
    if (CN > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      const unsigned me = cluster.block_rank();
#pragma unroll
      for (int q = 1; q < CN; ++q)
        a += cluster.map_shared_rank(tot, (me + q) % CN)[threadIdx.x];
    }
    out_tot[threadIdx.x] = a;
  }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      v[mt][h] = out_tot[wm * kWM + mt * 16 + h * 8 + (lane >> 2)];
}

template <int NB, int CN>
__global__ void __launch_bounds__(kThreads, 1)
conv_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const float* __restrict__ bias,
                const float* __restrict__ gamma,
                const float* __restrict__ beta, bf16* __restrict__ out,
                int t_in, int cin, int cout, int f_out, int s, int K,
                float eps) {
  using Tile = MmaTile<NB>;
  constexpr int kMT = Tile::kMT;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[Tile::kWarpsN * kMT];
  __shared__ float tot_sum[kMT], tot_sq[kMT], stat[2][kMT];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / Tile::kWarpsN, wn = warp % Tile::kWarpsN;
  const int b = blockIdx.y;
  const int f0 = (blockIdx.x / CN) * kMT;
  const int n0 = (blockIdx.x % CN) * NB;   // the block's rank in its cluster
  const bf16* xb = x + static_cast<size_t>(b) * t_in * cin;
  const size_t frame_stride = static_cast<size_t>(s) * cin;
  const uint32_t sbase = smem_addr(smem);
  auto a_stage = [&](int st) { return sbase + st * (Tile::kABytes + Tile::kBBytes); };
  auto b_stage = [&](int st) { return a_stage(st) + Tile::kABytes; };

  auto load = [&](int st, int kc) {
    const uint32_t sa = a_stage(st), sb = b_stage(st);
#pragma unroll
    for (int i = 0; i < kMT * (kBK / 8) / kThreads; ++i) {
      const int idx = tid + kThreads * i, r = idx / (kBK / 8), c = idx % (kBK / 8);
      const int f = f0 + r;
      const bf16* src = f < f_out ? xb + f * frame_stride + kc * kBK + c * 8 : xb;
      cp_async16(sa + a_off(r, c), src, f < f_out ? 16 : 0);
    }
    constexpr int kRowChunks = NB / 8;
#pragma unroll
    for (int i = 0; i < kBK * kRowChunks / kThreads; ++i) {
      const int idx = tid + kThreads * i;
      const int r = idx / kRowChunks, c = idx % kRowChunks;
      cp_async16(sb + b_off<NB>(r, c),
                 w + static_cast<size_t>(kc * kBK + r) * cout + n0 + c * 8, 16);
    }
  };

  float acc[2][16][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

  const int nk = K / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load(st, st);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                 // chunk kc landed; chunk kc - 1 is read
    const int pf = kc + kStages - 1;
    if (pf < nk) load(pf % kStages, pf);
    cp_async_commit();
    const uint32_t sa = a_stage(kc % kStages), sb = b_stage(kc % kStages);
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * kWM + mt * 16 + (lane & 15);
        ldmatrix_x4(a[mt], sa + a_off(r, ks * 2 + (lane >> 4)));
      }
      const int kr = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, sb + b_off<NB>(kr, wn * 16 + np * 2 + (lane >> 4)));
        mma_bf16(acc[0][2 * np], a[0], bf[0], bf[1]);
        mma_bf16(acc[1][2 * np], a[1], bf[0], bf[1]);
        mma_bf16(acc[0][2 * np + 1], a[0], bf[2], bf[3]);
        mma_bf16(acc[1][2 * np + 1], a[1], bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: bias, LayerNorm over all cout channels (two passes), GELU
  const int cbase = n0 + wn * kWN + 2 * (lane & 3);   // + nt 8 + j
  float v[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) v[mt][h] = 0.f;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const float2 bv = *reinterpret_cast<const float2*>(bias + cbase + nt * 8);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      acc[mt][nt][0] += bv.x; acc[mt][nt][1] += bv.y;
      acc[mt][nt][2] += bv.x; acc[mt][nt][3] += bv.y;
      v[mt][0] += acc[mt][nt][0] + acc[mt][nt][1];
      v[mt][1] += acc[mt][nt][2] + acc[mt][nt][3];
    }
  }
  const float inv_c = 1.f / static_cast<float>(cout);
  frame_sums<NB, CN>(v, red, tot_sum, stat[0]);
  float mean[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mean[mt][h] = v[mt][h] * inv_c;
      v[mt][h] = 0.f;
    }
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = acc[mt][nt][j] - mean[mt][j >> 1];
        v[mt][j >> 1] += d * d;
      }
  frame_sums<NB, CN>(v, red, tot_sq, stat[1]);
  if (CN > 1)       // the peers read tot_sq: arrive now, wait before exit
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) v[mt][h] = rsqrtf(v[mt][h] * inv_c + eps);
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int c = cbase + nt * 8;
    const float2 g = *reinterpret_cast<const float2*>(gamma + c);
    const float2 be = *reinterpret_cast<const float2*>(beta + c);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = f0 + wm * kWM + mt * 16 + h * 8 + (lane >> 2);
        if (f >= f_out) continue;
        const float y0 = gelu_rational(
            (acc[mt][nt][2 * h] - mean[mt][h]) * v[mt][h] * g.x + be.x);
        const float y1 = gelu_rational(
            (acc[mt][nt][2 * h + 1] - mean[mt][h]) * v[mt][h] * g.y + be.y);
        *reinterpret_cast<__nv_bfloat162*>(
            out + (static_cast<size_t>(b) * f_out + f) * cout + c) =
            __floats2bfloat162_rn(y0, y1);
      }
  }
  if (CN > 1) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int NB, int CN>
int launch_conv_mma(const void* x, const void* w, const float* bias,
                    const float* gamma, const float* beta, void* out, int B,
                    int t_in, int cin, int cout, int f_out, int k, int s,
                    float eps, cudaStream_t st) {
  using Tile = MmaTile<NB>;
  static bool configured = false;   // set once, outside graph capture
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_mma_kernel<NB, CN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tile::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((f_out + Tile::kMT - 1) / Tile::kMT * CN, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Tile::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CN;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, conv_mma_kernel<NB, CN>, static_cast<const bf16*>(x),
      static_cast<const bf16*>(w), bias, gamma, beta, static_cast<bf16*>(out),
      t_in, cin, cout, f_out, s, k * cin, eps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Shapes: bf16, Cin % 64 == 0, Cout in {128, 256, 512}, as
// ops/convstack.py::conv_body admits them. Cout 512 runs as a cluster of two
// blocks that split it, Cout 128 and 256 as one block.
int dispatch_conv_mma(const void* x, const void* w, const float* bias,
                      const float* gamma, const float* beta, void* out, int B,
                      int t_in, int cin, int cout, int f_out, int k, int s,
                      float eps, cudaStream_t st) {
  if (cin % 64) return static_cast<int>(cudaErrorInvalidValue);
  switch (cout) {
    case 128: return launch_conv_mma<128, 1>(x, w, bias, gamma, beta, out, B, t_in, cin, cout, f_out, k, s, eps, st);
    case 256: return launch_conv_mma<256, 1>(x, w, bias, gamma, beta, out, B, t_in, cin, cout, f_out, k, s, eps, st);
    case 512: return launch_conv_mma<256, 2>(x, w, bias, gamma, beta, out, B, t_in, cin, cout, f_out, k, s, eps, st);
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
// mma 0 runs the FFMA body (float32 or bf16), 1 the bf16 tensor-core body.
int conv_ln_gelu(const void* x, const void* w, const float* bias,
                 const float* gamma, const float* beta, void* out, int B,
                 int t_in, int cin, int cout, int f_out, int k, int s,
                 float eps, int bf16, int mma, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mma)
    return bf16 ? dispatch_conv_mma(x, w, bias, gamma, beta, out, B, t_in, cin, cout, f_out, k, s, eps, st)
                : static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? dispatch_conv<__nv_bfloat16>(x, w, bias, gamma, beta, out, B, t_in, cin, cout, f_out, k, s, eps, st)
              : dispatch_conv<float>(x, w, bias, gamma, beta, out, B, t_in, cin, cout, f_out, k, s, eps, st);
}

}  // extern "C"
