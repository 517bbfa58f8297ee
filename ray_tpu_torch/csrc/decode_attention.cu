// Paged and ragged decode attention for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   - _paged_kernel  (ray_tpu/ops/paged_attention.py:55): one query token per
//     slot against a shared K/V block pool [NB, bs, Hkv, D], reached through
//     per-slot block tables [B, MAXB];
//   - _decode_kernel (ray_tpu/ops/decode_attention.py:49): one query token per
//     slot against a dense per-slot cache [B, S, Hkv, D].
// Both are bounded by `lengths` [B]. One kernel serves both: the ragged case
// is the paged case with an identity block map (row `pos` of slot `b` is row
// b*S + pos of the dense cache), and rows at or past a slot's length are never
// read.
//
// What bounds it: HBM bytes. Per slot and KV head the kernel must read the K
// and V rows of the live context once (2 * len * D * sizeof(T)) and does
// 4 * G * D flops per row (G = H / Hkv query heads per KV head): about G
// flops per byte in bf16, far below the ~295 flops per byte at which the
// H100's tensor cores, not its memory, become the limit. So the design is
// about moving each byte once and nothing else:
//   - one thread block per (KV head g, slot b); it walks only the
//     ceil(len / kTile) tiles of its slot's live context (the Pallas grid
//     visited every logical block and skipped the dead ones);
//   - each K/V row is read once with 16-byte loads into shared memory and
//     serves all G query heads of its group, so GQA costs no extra bytes and
//     K/V are never repeated in HBM (the JAX ragged kernel repeated them);
//   - softmax is online in f32 (running max, running sum, f32 accumulator in
//     shared memory), so no score or probability tensor reaches HBM;
//   - rows are addressed one by one through the table, so any block size
//     works and a tile may span blocks.
// Numerics follow the Pallas kernels: inputs widened to f32, scores masked
// with -1e30 at idx >= length, l == 0 -> 1 in the epilogue, output cast to
// the input type. Later work: split-KV across blocks when B * Hkv is small
// against the 132 SMs, and cp.async/TMA double buffering of the tiles.
//
// Built by ray_tpu_torch/_build.py with nvcc into a shared library with a
// plain C interface; ray_tpu_torch/ops/{paged,decode}_attention.py bind it
// with ctypes. Each entry point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;      // context rows per tile: one per lane
constexpr int kThreads = 128;  // four warps
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 227 * 1024;

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
  __device__ __forceinline__ int limit() const { return maxb * bs; }
};

struct DenseRows {
  int s, hkv, d;
  __device__ __forceinline__ int64_t row(int b, int pos, int g) const {
    return (((int64_t)b * s + pos) * hkv + g) * d;
  }
  __device__ __forceinline__ int limit() const { return s; }
};

template <typename T>
__host__ __device__ constexpr int padded_row(int d) {
  return d + 16 / (int)sizeof(T);  // +16 bytes: conflict-free row reads
}

template <typename T>
size_t smem_bytes(int g, int d) {
  return 2 * (size_t)kTile * padded_row<T>(d) * sizeof(T) +
         (2 * (size_t)g * d + (size_t)g * kTile + 3 * (size_t)g) * sizeof(float);
}

// grid (Hkv, B), block kThreads, dynamic shared memory smem_bytes<T>(G, D).
template <typename T, typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        Rows rows, int H, int G, int D, float scale) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ld = padded_row<T>(D);
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  const int chunks = D / kVec;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                      // [kTile][ld]
  T* vs = ks + kTile * ld;                                 // [kTile][ld]
  float* qs = reinterpret_cast<float*>(vs + kTile * ld);   // [G][D]
  float* acc = qs + G * D;                                 // [G][D]
  float* ps = acc + G * D;                                 // [G][kTile]
  float* m_run = ps + G * kTile;                           // [G]
  float* l_run = m_run + G;                                // [G]
  float* alpha = l_run + G;                                // [G]

  const int len = min(max(lengths[b], 0), rows.limit());
  const int64_t head0 = ((int64_t)b * H + (int64_t)g * G) * D;  // q/out base

  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = to_f32(q[head0 + i]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < G; i += kThreads) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
  }
  __syncthreads();

  for (int start = 0; start < len; start += kTile) {
    // Stage the tile's K and V rows; rows at or past len are zero-filled so
    // that p == 0 never meets a NaN in the value product.
    for (int i = tid; i < kTile * chunks; i += kThreads) {
      const int t = i / chunks;
      const int c = i - t * chunks;
      const int pos = start + t;
      uint4 kx = make_uint4(0, 0, 0, 0);
      uint4 vx = make_uint4(0, 0, 0, 0);
      if (pos < len) {
        const int64_t r = rows.row(b, pos, g) + (int64_t)c * kVec;
        kx = *reinterpret_cast<const uint4*>(k + r);
        vx = *reinterpret_cast<const uint4*>(v + r);
      }
      *reinterpret_cast<uint4*>(ks + t * ld + c * kVec) = kx;
      *reinterpret_cast<uint4*>(vs + t * ld + c * kVec) = vx;
    }
    __syncthreads();

    // Scores and the online-softmax update: warp w takes query heads
    // w, w + kWarps, ...; lane t scores tile row t.
    for (int h = warp; h < G; h += kWarps) {
      const int pos = start + lane;
      float s = kNegInf;
      if (pos < len) {
        const float* qh = qs + h * D;
        const T* kr = ks + lane * ld;
        float dot = 0.f;
        for (int c = 0; c < chunks; ++c) {
          const uint4 raw = *reinterpret_cast<const uint4*>(kr + c * kVec);
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int j = 0; j < kVec; ++j) dot += qh[c * kVec + j] * to_f32(e[j]);
        }
        s = dot * scale;
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
    const int live = min(kTile, len - start);
    for (int i = tid; i < G * D; i += kThreads) {
      const int h = i / D;
      const int d = i - h * D;
      const float* ph = ps + h * kTile;
      float a = acc[i] * alpha[h];
      for (int t = 0; t < live; ++t) a += ph[t] * to_f32(vs[t * ld + d]);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += kThreads) {
    float l = l_run[i / D];
    l = (l == 0.f) ? 1.f : l;
    out[head0 + i] = from_f32<T>(acc[i] / l);
  }
}

template <typename T, typename Rows>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, Rows rows, int B, int H, int Hkv, int D, float scale,
           cudaStream_t stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || D % 8 != 0 || D > 256 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  const size_t smem = smem_bytes<T>(G, D);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<T, Rows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(Hkv, B);
  decode_attention_kernel<T, Rows><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), rows, H, G, D,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched;
// cudaErrorInvalidValue for shapes the kernel does not take, including more
// than 227 KB of shared memory for G = H / Hkv heads at this head_dim).
int rt_paged_decode_attention(int dtype, const void* q, const void* k_pool,
                              const void* v_pool, const int* tables,
                              const int* lengths, void* out, int B, int H,
                              int Hkv, int D, int num_blocks, int block_size,
                              int max_blocks, float scale, void* stream) {
  PagedRows rows{tables, max_blocks, block_size, num_blocks, Hkv, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, lengths, out, rows, B, H, Hkv, D,
                         scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, lengths, out, rows, B, H,
                                 Hkv, D, scale, s);
  return (int)cudaErrorInvalidValue;
}

int rt_ragged_decode_attention(int dtype, const void* q, const void* k,
                               const void* v, const int* lengths, void* out,
                               int B, int H, int Hkv, int D, int S,
                               float scale, void* stream) {
  DenseRows rows{S, Hkv, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, lengths, out, rows, B, H, Hkv, D, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, lengths, out, rows, B, H, Hkv, D,
                                 scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
