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
// x comes in one of two layouts, read in place: row-major (R, C) (the JAX
// package's (in, out) layout), or the transposed view of a row-major (C, R)
// matrix (strides (1, R): a model's ``weight.t()``), where column c is the
// contiguous row c of the weight.
//
// What bounds it on the H100: bytes, 4 R C read and R C + 4 C written. The
// work per element (a hash, a division, a rounding: about 25 instructions,
// no MUFU, see divide() and uniform()) is as large a share of the time: a
// tile's rounding takes longer than its loads.
//
// Design: one pass over x. The matrix is cut into strips of kCols columns,
// and each strip into tiles of kRows rows. A cluster of ceil(R / kRows)
// blocks (at most 8) takes a strip, one tile a block: the block copies its
// tile into shared memory with cp.async (16-byte copies, each column or row
// segment contiguous), takes each column's partial max, and the cluster's
// blocks read each other's partial maxima through distributed shared
// memory; so the strip never goes back to device memory between the max and
// the rounding. The block then rounds its tile, packs four columns of one
// row into a 32-bit word of a shared-memory int8 tile (words XOR-swizzled so
// that neither the writes nor the reads conflict on banks) and writes each
// row of it with 16-byte stores. The clusters are persistent (as many as
// fit at once, two blocks an SM) and walk the strips; the other block on
// the SM loads while one rounds, so the rounding overlaps the loads (a
// second, prefetching buffer a block measured slower: one block an SM).
// Past 8 kRows rows a block holds several tiles of a strip and reads all
// but its last one twice (the second time mostly from L2); no layer of the
// flagship needs that (R <= 4096).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 512;            // rows of a tile
constexpr int kCols = 32;             // columns of a strip
constexpr int kMaxCluster = 8;        // portable cluster size
constexpr int kColsPerWarp = kCols / kWarps;   // max pass, transposed
constexpr int kWords = kCols / 4;               // int8 tile words a row
constexpr int kChunks = kCols / 16;             // 16-byte stores a row

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

// Word of the shared tile that holds columns 4 word .. 4 word + 3 of row r.
__device__ __forceinline__ int tile_word(int r, int word) {
  return r * kWords + (word ^ ((r >> 2) & (kWords - 1)));
}

// a / s rounded to nearest, as IEEE division gives it, from y = RN(1 / s):
// two residual corrections, the second of which rounds correctly because
// its q is faithful and y correctly rounded (Markstein). The residuals are
// exact while a is not tiny and 1 / s is normal; quantize4 divides
// otherwise.
__device__ __forceinline__ float divide(float a, float s, float y) {
  float q = __fmul_rn(a, y);
  float r = __fmaf_rn(-s, q, a);
  q = __fmaf_rn(r, y, q);
  r = __fmaf_rn(-s, q, a);
  return __fmaf_rn(r, y, q);
}

// The int8 bits of clip(floor(w)) (kFloor) or clip(rint(w)): clip first (the
// bounds are integers), then one float-to-int conversion.
template <bool kFloor>
__device__ __forceinline__ uint32_t to_byte(float w) {
  const float c = fminf(fmaxf(w, -128.f), 127.f);
  return static_cast<uint32_t>(kFloor ? __float2int_rd(c) : __float2int_rn(c)) &
         0xffu;
}

// u = (bits >> 8) 2^-24 exactly, without an int-to-float conversion.
__device__ __forceinline__ float uniform(uint32_t bits) {
  return __fadd_rn(__uint_as_float(0x3f800000u | (bits >> 9)), -1.f) +
         ((bits & 0x100u) ? 0x1p-24f : 0.f);
}

template <bool kStochastic>
__device__ __forceinline__ uint32_t quantize4(const float (&v)[4],
                                              const float (&s)[4],
                                              const float (&y)[4],
                                              const bool (&fast)[4],
                                              uint32_t hrow, uint32_t col0) {
  // IEEE division where divide() may not be exact: a warp-uniform branch,
  // so that the common case carries no division code
  float scaled[4];
  bool slow = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    scaled[j] = divide(v[j], s[j], y[j]);
    slow |= !fast[j] || fabsf(v[j]) < 0x1p-96f;
  }
  if (__any_sync(0xffffffffu, slow)) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (!fast[j] || fabsf(v[j]) < 0x1p-96f) scaled[j] = v[j] / s[j];
  }
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t q;
    if (kStochastic) {
      const float u = uniform(mix32(hrow + col0 + j));
      q = to_byte<true>(__fadd_rn(scaled[j], u));
    } else {
      q = to_byte<false>(scaled[j]);
    }
    word |= q << (8 * j);
  }
  return word;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// Asynchronous copies of 16 or 4 bytes; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Issues the copies of tile rows [r0, r0 + kRows) x columns [c0, c0 +
// kCols) into buf (zeros outside the matrix): transposed, buf[col kRows +
// row]; row-major, buf[row kCols + col].
template <bool kTrans>
__device__ __forceinline__ void load_tile(const float* __restrict__ x, int R,
                                          int C, int r0, int c0, bool vec,
                                          float* buf) {
  const int t = threadIdx.x;
  const uint32_t base = smem_addr(buf);
  if (vec && r0 + kRows <= R && c0 + kCols <= C) {
#pragma unroll
    for (int k = 0; k < kRows * kCols / 4 / kThreads; ++k) {
      const int id = t + kThreads * k;
      if (kTrans) {
        const int cc = id / (kRows / 4), q = id % (kRows / 4);
        cp_async16(base + 4 * (cc * kRows + 4 * q),
                   x + static_cast<size_t>(c0 + cc) * R + r0 + 4 * q);
      } else {
        const int r = id / (kCols / 4), q = id % (kCols / 4);
        cp_async16(base + 4 * (r * kCols + 4 * q),
                   x + static_cast<size_t>(r0 + r) * C + c0 + 4 * q);
      }
    }
  } else {
    for (int k = 0; k < kRows * kCols / kThreads; ++k) {
      const int id = t + kThreads * k;
      const int cc = kTrans ? id / kRows : id % kCols;
      const int r = kTrans ? id % kRows : id / kCols;
      const bool in = r0 + r < R && c0 + cc < C;
      const float* src = kTrans ? x + static_cast<size_t>(c0 + cc) * R + r0 + r
                                : x + static_cast<size_t>(r0 + r) * C + c0 + cc;
      cp_async4(base + 4 * (kTrans ? cc * kRows + r : r * kCols + cc),
                in ? src : x, in ? 4 : 0);
    }
  }
}

// The thread's partial max over its columns of a tile in buf: transposed,
// warp w takes columns kColsPerWarp w + h whole (m[h]); row-major, thread t
// takes column t % kCols of every (kThreads / kCols)-th row (m[0]).
template <bool kTrans>
__device__ __forceinline__ void tile_max(const float* buf,
                                         float (&m)[kColsPerWarp]) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (kTrans) {
#pragma unroll
    for (int h = 0; h < kColsPerWarp; ++h) {
      const float4* col = reinterpret_cast<const float4*>(
          buf + (kColsPerWarp * warp + h) * kRows);
#pragma unroll
      for (int i = 0; i < kRows / 4 / 32; ++i) {
        const float4 v = col[lane + 32 * i];
        m[h] = fmaxf(m[h], fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                                 fmaxf(fabsf(v.z), fabsf(v.w))));
      }
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < kRows / (kThreads / kCols); ++i)
      m[0] = fmaxf(m[0], fabsf(buf[(t / kCols + (kThreads / kCols) * i) * kCols +
                                   t % kCols]));
  }
}

template <bool kTrans, bool kStochastic>
__global__ void __launch_bounds__(kThreads, 2)
quant_kernel(const float* __restrict__ x, int8_t* __restrict__ vals,
             float* __restrict__ scales, int R, int C, int tiles, int strips,
             bool vec, uint32_t seed) {
  extern __shared__ float4 smem4[];
  float* const b = reinterpret_cast<float*>(smem4);        // the f32 tile
  uint32_t* tile = reinterpret_cast<uint32_t*>(b + kRows * kCols);
  __shared__ float part[kWarps][kCols];
  __shared__ float block_max[kCols];       // read by the whole cluster
  __shared__ float col_scale[kCols], col_recip[kCols];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int clusters = gridDim.x / ranks, me = blockIdx.x / ranks;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int rbeg = rank * tiles * kRows;
  const uint32_t key = mix32(seed);
  const bool vec_out = (C & 15) == 0;
  // the rounding's mapping: word w (columns 4 w .. 4 w + 3) of rows
  // rq + 64 i; transposed, lanes on consecutive rows, row-major on
  // consecutive words (both read buf and write tile without conflicts)
  const int w = kTrans ? warp % kWords : t % kWords;
  const int rq = kTrans ? 32 * (warp / kWords) + lane : t / kWords;

  for (int strip = me; strip < strips; strip += clusters) {
    const int c0 = strip * kCols;
    float m[kColsPerWarp] = {};
    for (int tl = 0; tl < tiles; ++tl) {
      load_tile<kTrans>(x, R, C, rbeg + tl * kRows, c0, vec, b);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      tile_max<kTrans>(b, m);
      if (tl != tiles - 1) __syncthreads();
    }
    float* const bmax = block_max;
    if (kTrans) {
#pragma unroll
      for (int h = 0; h < kColsPerWarp; ++h) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], o));
        if (lane == 0) bmax[kColsPerWarp * warp + h] = m[h];
      }
    } else {
#pragma unroll
      for (int o = kCols; o < 32; o <<= 1)
        m[0] = fmaxf(m[0], __shfl_xor_sync(0xffffffffu, m[0], o));
      if (lane < kCols) part[warp][lane] = m[0];
      __syncthreads();
      if (t < kCols) {
        float mm = part[0][t];
#pragma unroll
        for (int q = 1; q < kWarps; ++q) mm = fmaxf(mm, part[q][t]);
        bmax[t] = mm;
      }
    }
    cluster.sync();                        // every block's partial max is in
    if (t < kCols) {
      float mm = 0.f;
      for (int q = 0; q < ranks; ++q)
        mm = fmaxf(mm, cluster.map_shared_rank(bmax, q)[t]);
      // times the float32 reciprocal, as XLA compiles the JAX package's
      // division by the constant 127
      const float sc = fmaxf(mm, 1e-12f) * (1.f / 127.f);
      col_scale[t] = sc;
      col_recip[t] = __frcp_rn(sc);
      if (rank == 0 && c0 + t < C) scales[c0 + t] = sc;
    }
    // this block's reads of its peers' maxima are done; they may write
    // theirs again once every block has arrived (the wait below)
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    __syncthreads();
    float sv[4], yv[4];
    bool fast[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sv[j] = col_scale[4 * w + j];
      yv[j] = col_recip[4 * w + j];
      fast[j] = sv[j] <= 0x1p90f;          // 1 / s normal; s >= 1e-12 / 127
    }
    for (int tl = tiles - 1; tl >= 0; --tl) {
      const int r0 = rbeg + tl * kRows;
      if (tl != tiles - 1) {
        load_tile<kTrans>(x, R, C, r0, c0, vec, b);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
      }
#pragma unroll 2
      for (int i = 0; i < kRows / (kThreads / kWords); ++i) {
        const int r = rq + (kThreads / kWords) * i;
        float e[4];
        if (kTrans) {
#pragma unroll
          for (int j = 0; j < 4; ++j) e[j] = b[(4 * w + j) * kRows + r];
        } else {
          const float4 v = *reinterpret_cast<const float4*>(b + r * kCols + 4 * w);
          e[0] = v.x; e[1] = v.y; e[2] = v.z; e[3] = v.w;
        }
        const uint32_t hrow = mix32(key + static_cast<uint32_t>(r0 + r));
        tile[tile_word(r, w)] = quantize4<kStochastic>(
            e, sv, yv, fast, hrow, static_cast<uint32_t>(c0 + 4 * w));
      }
      __syncthreads();
      // each thread writes 16 bytes (columns 16 h .. 16 h + 15) of rows
#pragma unroll
      for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
        const int r = t / kChunks + (kThreads / kChunks) * i, h = t % kChunks;
        const int row = r0 + r, col = c0 + 16 * h;
        if (row >= R || col >= C) continue;
        uint4 q;
        q.x = tile[tile_word(r, 4 * h)];
        q.y = tile[tile_word(r, 4 * h + 1)];
        q.z = tile[tile_word(r, 4 * h + 2)];
        q.w = tile[tile_word(r, 4 * h + 3)];
        int8_t* dst = vals + static_cast<size_t>(row) * C + col;
        if (vec_out) {
          *reinterpret_cast<uint4*>(dst) = q;
        } else {
          const uint32_t wd[4] = {q.x, q.y, q.z, q.w};
          for (int k = 0; k < 16 && col + k < C; ++k)
            dst[k] = static_cast<int8_t>(wd[k / 4] >> (8 * (k % 4)));
        }
      }
      __syncthreads();                     // tile and b are free again
    }
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
}

constexpr int kSmem = (kRows * kCols + kRows * kCols / 4) * 4;   // 80 KB

template <bool kTrans, bool kStochastic>
int launch(const float* x, int8_t* vals, float* scales, int R, int C,
           uint32_t seed, cudaStream_t st) {
  const int row_tiles = (R + kRows - 1) / kRows;
  const int cluster = row_tiles < kMaxCluster ? row_tiles : kMaxCluster;
  const int tiles = (row_tiles + cluster - 1) / cluster;
  const int strips = (C + kCols - 1) / kCols;
  const bool vec = (kTrans ? R % 4 : C % 4) == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto kernel = quant_kernel<kTrans, kStochastic>;
  // set once per instantiation, outside graph capture; the clusters that
  // fit at once, per cluster size
  static bool configured = false;
  static int fit[kMaxCluster + 1] = {};
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = st;
  if (fit[cluster] == 0) {
    cfg.gridDim = dim3(cluster * strips);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess || n < 1)
      n = 1;
    fit[cluster] = n;
  }
  const int clusters = strips < fit[cluster] ? strips : fit[cluster];
  cfg.gridDim = dim3(cluster * clusters);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x, vals, scales, R,
                                             C, tiles, strips, vec, seed);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (R, C) float32: row-major (transposed 0) or the transposed view of a
// row-major (C, R) matrix (transposed 1); vals (R, C) int8 and scales (C)
// float32, contiguous.
int quantize_int8_f32(const float* x, int8_t* vals, float* scales, int R, int C,
                      unsigned int seed, int stochastic, int transposed,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (transposed)
    return stochastic ? launch<true, true>(x, vals, scales, R, C, seed, st)
                      : launch<true, false>(x, vals, scales, R, C, seed, st);
  return stochastic ? launch<false, true>(x, vals, scales, R, C, seed, st)
                    : launch<false, false>(x, vals, scales, R, C, seed, st);
}

}  // extern "C"
