// Paged and ragged decode attention for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   - _paged_kernel  (ray_tpu/ops/paged_attention.py:55): one query token per
//     slot against a shared K/V block pool [NB, bs, Hkv, D], reached through
//     per-slot block tables [B, MAXB];
//   - _decode_kernel (ray_tpu/ops/decode_attention.py:49): one query token per
//     slot against a dense per-slot cache [B, S, Hkv, D].
// Both are bounded by `lengths` [B]. One template serves both: the ragged
// case is the paged case with an identity row map (row `pos` of slot `b` is
// row b*S + pos of the dense cache), and rows at or past a slot's length are
// never read.
//
// What bounds it: device-memory bytes. Per slot and KV head the kernel must
// read the K and V rows of the live context once (2 * len * D * sizeof(T))
// and does 4 * G * D flops per row (G = H / Hkv query heads per KV head):
// about G flops per byte in bf16, far below the ~295 flops per byte at which
// the H100's tensor cores, not its memory, become the limit, so f32 FMAs on
// the CUDA cores suffice. A block that walks a long context alone is bound
// by the latency of its loads, not by the card's bandwidth: the longest
// slot sets the time while the rest of the card idles. So the design
// (flash-decoding) spreads every context over many blocks and keeps loads
// in flight:
//   - split-KV: each (slot, KV head) context is cut into chunks of
//     split_rows rows (a multiple of kTile; the wrapper picks it and the
//     chunk count from the table width, on the host). One thread block per
//     (chunk, KV head, slot); a block whose chunk starts at or past its
//     slot's length exits at once;
//   - a ring of kStages tiles of kTile rows, filled with 16-byte cp.async
//     (zero-fill past the length) while the block computes on the oldest
//     tile: two __syncthreads a tile. TMA fits a paged gather badly (one
//     head's rows are strided by Hkv * D inside scattered blocks), and the
//     physical row is resolved once a row, not once a 16-byte chunk;
//   - each K/V row is read once and serves all G query heads of its group,
//     so GQA costs no extra bytes and K/V are never repeated in device
//     memory; softmax is online in f32, the accumulator in registers;
//   - each block writes its partial (m, l, acc[G][D]) in f32 to scratch the
//     wrapper allocates; merge_splits_kernel, launched by the same entry
//     point, combines the chunks below each slot's length with the
//     log-sum-exp rescale and writes the output.
// Numerics follow the Pallas kernels: inputs widened to f32, scores masked
// with -1e30 at idx >= length, l == 0 -> 1 (an empty slot gives 0), output
// cast to the input type; table entries outside the pool wrap and clamp as
// JAX's gather does.
//
// Built by ray_tpu_torch/_build.py with nvcc into a shared library with a
// plain C interface; ray_tpu_torch/ops/{paged,decode}_attention.py bind it
// with ctypes. Each entry point returns cudaGetLastError() after the
// launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;      // context rows per tile: one per lane
constexpr int kThreads = 128;  // four warps; four threads stage a tile row
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;     // tiles in the cp.async ring
constexpr int kMaxPairs = 8;   // accumulator pairs a thread: G * D <= 2048
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Two consecutive elements widened to f32 (4- or 8-byte aligned).
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// 16 bytes global -> shared, asynchronously; `live` false zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Element offset of K/V row (slot b, context position pos, KV head g).
struct PagedRows {
  const int* tables;  // [B, maxb] physical block ids in logical order
  int maxb, bs, nb, hkv, d;
  __device__ __forceinline__ int64_t row(int b, int pos, int g) const {
    int blk = tables[(int64_t)b * maxb + pos / bs];
    if (blk < 0) blk += nb;            // JAX's gather: negatives wrap,
    blk = min(max(blk, 0), nb - 1);    // then clamp into the pool
    return (((int64_t)blk * bs + pos % bs) * hkv + g) * d;
  }
  __host__ __device__ __forceinline__ int limit() const { return maxb * bs; }
};

struct DenseRows {
  int s, hkv, d;
  __device__ __forceinline__ int64_t row(int b, int pos, int g) const {
    return (((int64_t)b * s + pos) * hkv + g) * d;
  }
  __host__ __device__ __forceinline__ int limit() const { return s; }
};

template <typename T>
__host__ __device__ constexpr int padded_row(int d) {
  return d + 16 / (int)sizeof(T);  // +16 bytes: conflict-free row reads
}

template <typename T>
size_t smem_bytes(int g, int d) {
  return (size_t)kStages * 2 * kTile * padded_row<T>(d) * sizeof(T) +
         ((size_t)g * d + (size_t)g * kTile + 3 * (size_t)g) * sizeof(float);
}

// grid (n_split, Hkv, B), block kThreads, smem smem_bytes<T>(G, D).
// part_acc [B, n_split, H, D] and part_ml [B, n_split, H, 2] (f32) receive
// the chunk's unnormalised accumulator, running max and running sum.
template <typename T, typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    Rows rows, int H, int G, int D, int split_rows,
                    float scale) {
  const int split = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int len = min(max(lengths[b], 0), rows.limit());
  const int begin = split * split_rows;
  if (begin >= len) return;  // the merge never reads this chunk
  const int end = min(len, begin + split_rows);
  const int n_tiles = (end - begin + kTile - 1) / kTile;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ld = padded_row<T>(D);
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  const int chunks = D / kVec;
  const int tile = kTile * ld;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [kStages][K, V][kTile][ld]
  float* qs = reinterpret_cast<float*>(ring + kStages * 2 * tile);  // [G][D]
  float* ps = qs + G * D;                                  // [G][kTile]
  float* m_run = ps + G * kTile;                           // [G]
  float* l_run = m_run + G;                                // [G]
  float* alpha = l_run + G;                                // [G]

  // Tile i of the chunk into its ring stage: thread tid stages row tid / 4,
  // 16-byte chunks tid % 4, tid % 4 + 4, ...; rows past `end` read as 0, so
  // that p == 0 never meets a NaN in the value product.
  auto load = [&](int i) {
    T* ks = ring + (i % kStages) * 2 * tile;
    T* vs = ks + tile;
    const int t = tid >> 2;
    const int pos = begin + i * kTile + t;
    const bool live = pos < end;
    const int64_t r = live ? rows.row(b, pos, g) : 0;
    for (int c = tid & 3; c < chunks; c += 4) {
      cp_async16(ks + t * ld + c * kVec, k + r + c * kVec, live);
      cp_async16(vs + t * ld + c * kVec, v + r + c * kVec, live);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load(i);
    cp_async_commit();
  }

  const int64_t head0 = ((int64_t)b * H + (int64_t)g * G) * D;  // q base
  for (int i = tid; i < G * D; i += kThreads) qs[i] = to_f32(q[head0 + i]);
  for (int i = tid; i < G; i += kThreads) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
  }
  // thread tid owns accumulator pairs (2 p, 2 p + 1), p = tid + j kThreads
  const int n_pairs = G * D / 2;
  float acc[kMaxPairs][2];
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j) acc[j][0] = acc[j][1] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile i landed
    __syncthreads();  // everyone's, and tile i - 1's stage is free again
    if (i + kStages - 1 < n_tiles) load(i + kStages - 1);
    cp_async_commit();
    const T* ks = ring + (i % kStages) * 2 * tile;
    const T* vs = ks + tile;
    const int start = begin + i * kTile;

    // Scores and the online-softmax update: warp w takes query heads
    // w, w + kWarps, ...; lane t scores tile row t.
    for (int h = warp; h < G; h += kWarps) {
      const int pos = start + lane;
      float s = kNegInf;
      if (pos < end) {
        const float* qh = qs + h * D;
        const T* kr = ks + lane * ld;
        float dot[4] = {0.f, 0.f, 0.f, 0.f};  // four independent chains
#pragma unroll 4
        for (int c = 0; c < chunks; ++c) {
          const uint4 raw = *reinterpret_cast<const uint4*>(kr + c * kVec);
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int j = 0; j < kVec; j += 4) {
            const float4 qv =
                *reinterpret_cast<const float4*>(qh + c * kVec + j);
            dot[0] += qv.x * to_f32(e[j]);
            dot[1] += qv.y * to_f32(e[j + 1]);
            dot[2] += qv.z * to_f32(e[j + 2]);
            dot[3] += qv.w * to_f32(e[j + 3]);
          }
        }
        s = ((dot[0] + dot[1]) + (dot[2] + dot[3])) * scale;
      }
      float m_cur = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, off));
      const float m_prev = m_run[h];
      const float m_new = fmaxf(m_prev, m_cur);
      const float p = expf(s - m_new);  // masked rows: exp(-1e30 - m) == 0
      float p_sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        p_sum += __shfl_xor_sync(0xffffffffu, p_sum, off);
      ps[h * kTile + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha[h] = a;
        l_run[h] = a * l_run[h] + p_sum;
        m_run[h] = m_new;
      }
    }
    __syncthreads();

    // acc[h][d] = alpha[h] * acc[h][d] + sum_t p[h][t] * V[t][d]
    const int live = min(kTile, end - start);
#pragma unroll
    for (int j = 0; j < kMaxPairs; ++j) {
      const int e = 2 * (tid + j * kThreads);
      if (e < 2 * n_pairs) {
        const int h = e / D;
        const int d = e - h * D;
        const float* ph = ps + h * kTile;
        float a0 = acc[j][0] * alpha[h];
        float a1 = acc[j][1] * alpha[h];
        for (int t = 0; t < live; ++t) {
          const float p = ph[t];
          const float2 x = load_pair(vs + t * ld + d);
          a0 += p * x.x;
          a1 += p * x.y;
        }
        acc[j][0] = a0;
        acc[j][1] = a1;
      }
    }
  }

  const int64_t part = ((int64_t)b * gridDim.x + split) * H + (int64_t)g * G;
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j) {
    const int e = 2 * (tid + j * kThreads);
    if (e < 2 * n_pairs)
      *reinterpret_cast<float2*>(part_acc + part * D + e) =
          make_float2(acc[j][0], acc[j][1]);
  }
  for (int i = tid; i < G; i += kThreads) {
    part_ml[(part + i) * 2] = m_run[i];
    part_ml[(part + i) * 2 + 1] = l_run[i];
  }
}

// grid (H, B), block D threads: out[b, hh, d] from the chunks of slot b
// that start below its length, with the log-sum-exp rescale.
template <typename T>
__global__ void __launch_bounds__(256)
merge_splits_kernel(const float* __restrict__ part_acc,
                    const float* __restrict__ part_ml,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int limit, int H, int D, int n_split, int split_rows) {
  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int len = min(max(lengths[b], 0), limit);
  const int n_live = (len + split_rows - 1) / split_rows;
  const int64_t first = (int64_t)b * n_split * H + hh;  // chunk 0's head
  float m = kNegInf;
  for (int c = 0; c < n_live; ++c)
    m = fmaxf(m, part_ml[(first + (int64_t)c * H) * 2]);
  float l = 0.f, o = 0.f;
  for (int c = 0; c < n_live; ++c) {
    const int64_t at = first + (int64_t)c * H;
    const float w = expf(part_ml[at * 2] - m);
    l += w * part_ml[at * 2 + 1];
    o += w * part_acc[at * D + d];
  }
  l = (l == 0.f) ? 1.f : l;
  out[((int64_t)b * H + hh) * D + d] = from_f32<T>(o / l);
}

template <typename T, typename Rows>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, float* part_acc, float* part_ml, Rows rows, int B,
           int H, int Hkv, int D, int n_split, int split_rows, float scale,
           cudaStream_t stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hkv > 65535 || H % Hkv != 0 ||
      D % 8 != 0 || D > 256 || (H / Hkv) * D > 2 * kThreads * kMaxPairs ||
      split_rows <= 0 || split_rows % kTile != 0 || n_split <= 0 ||
      (int64_t)n_split * split_rows < rows.limit())
    return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  const size_t smem = smem_bytes<T>(G, D);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    // a driver call: made once per instantiation, device and size
    static int reserved[kMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= kMaxDevices || reserved[dev] < (int)smem) {
      e = cudaFuncSetAttribute(decode_split_kernel<T, Rows>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
      if (dev < kMaxDevices) reserved[dev] = (int)smem;
    }
  }
  decode_split_kernel<T, Rows>
      <<<dim3(n_split, Hkv, B), kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), lengths, part_acc, part_ml, rows, H, G, D,
          split_rows, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  merge_splits_kernel<T><<<dim3(H, B), D, 0, stream>>>(
      part_acc, part_ml, lengths, static_cast<T*>(out), rows.limit(), H, D,
      n_split, split_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. part_acc [B, n_split, H, D] and part_ml
// [B, n_split, H, 2] are f32 scratch; n_split * split_rows must cover the
// table width (max_blocks * block_size, or S), split_rows a multiple of 32.
// Returns a cudaError_t (0 = launched; cudaErrorInvalidValue for shapes the
// kernels do not take, including G * D > 2048 or more than 227 KB of shared
// memory).
int rt_paged_decode_attention(int dtype, const void* q, const void* k_pool,
                              const void* v_pool, const int* tables,
                              const int* lengths, void* out, float* part_acc,
                              float* part_ml, int B, int H, int Hkv, int D,
                              int num_blocks, int block_size, int max_blocks,
                              int n_split, int split_rows, float scale,
                              void* stream) {
  PagedRows rows{tables, max_blocks, block_size, num_blocks, Hkv, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, lengths, out, part_acc, part_ml,
                         rows, B, H, Hkv, D, n_split, split_rows, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, lengths, out, part_acc,
                                 part_ml, rows, B, H, Hkv, D, n_split,
                                 split_rows, scale, s);
  return (int)cudaErrorInvalidValue;
}

int rt_ragged_decode_attention(int dtype, const void* q, const void* k,
                               const void* v, const int* lengths, void* out,
                               float* part_acc, float* part_ml, int B, int H,
                               int Hkv, int D, int S, int n_split,
                               int split_rows, float scale, void* stream) {
  DenseRows rows{S, Hkv, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, lengths, out, part_acc, part_ml, rows, B,
                         H, Hkv, D, n_split, split_rows, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, lengths, out, part_acc, part_ml,
                                 rows, B, H, Hkv, D, n_split, split_rows,
                                 scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
