// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _flash_fwd_kernel
// (ray_tpu/ops/attention.py:128), launched by _flash_forward (:219) under
// the flash_attention custom VJP (:269): causal or full softmax attention of
// q [B, Sq, H, D] against k/v [B, Sk, Hkv, D], GQA by kv head h / (H / Hkv),
// f32 online softmax, out in q's dtype. The backward is not a kernel, in the
// JAX package or here: it recomputes through blockwise attention.
//
// What bounds it: operations. At the training slice (B 8, S 2048, H 8,
// Hkv 4, D 128, causal, bf16) the function needs 2*B*H*S^2*D = 68.7 GFLOP
// (half of the full product, by the causal mask) against 100.7 MB of q, k,
// v and out: ~680 flops per byte, above the ~295 at which the H100's tensor
// cores, not its memory, are the limit. What the design does about it:
//   - bf16 runs both products on the tensor cores (mma.sync m16n8k16, bf16
//     in, f32 accumulate; operands staged in shared memory and read with
//     ldmatrix). P is cast to bf16 before P*V, as the Pallas kernel casts p
//     to v's dtype (:179), and the C fragment of S*scale is reused as the A
//     fragment of P without a trip through shared memory;
//   - f32 stays on the scalar path: TF32 would miss the repo's f32 bar;
//   - one thread block per (tile of query rows, head, batch); its K/V loop
//     stops at the causal limit (the Pallas grid visits every block and
//     skips those above the diagonal with pl.when), and the heaviest causal
//     tiles are issued first;
//   - q/k/v are read in their [B, S, H, D] layout through strides (no
//     [B*H, S, D] transposes), and each block reads the rows of its own KV
//     head, so K/V are never repeated in device memory.
// Numerics follow the Pallas kernel: scores scaled after the product,
// columns >= Sk and (causal) row < col set to -1e30, l == 0 -> 1 in the
// epilogue. Rows past Sq or Sk, and head-dim columns past D, are zero-filled
// in shared memory, so a zero weight never meets garbage. Later work: wgmma
// with TMA loads, a pipelined K/V ring, and the exp2 rescaling trick.
//
// Built by ray_tpu_torch/_build.py with nvcc into a shared library with a
// plain C interface; ray_tpu_torch/ops/attention.py binds it with ctypes.
// The entry point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // four warps
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 227 * 1024;

struct Shape {
  int sq, sk, h, hkv, d, group;  // group = h / hkv
  int causal;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores. kD is the head dim rounded up to 16, 32, 64, 128 or 256.
// ---------------------------------------------------------------------------

constexpr int kBr = 64;  // query rows per block, 16 per warp
constexpr int kBc = 64;  // key rows per tile

__host__ __device__ constexpr int bf16_ld(int kd) {
  return kd + 8;  // +16 bytes a row: ldmatrix rows fall in distinct banks
}

template <int kD>
constexpr size_t bf16_smem() {
  return (size_t)(kBr + 2 * kBc) * bf16_ld(kD) * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c[16x8] += a[16x16] * b[16x8]; bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16x2 register: lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage rows [row0, row0 + rows) of one head into smem [rows][bf16_ld(kD)]
// with 16-byte loads; rows past n and columns past d are zero-filled.
template <int kD>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int row0,
                                           int rows, int n, int64_t stride,
                                           int d) {
  constexpr int kChunks = kD / 8;
  constexpr int ld = bf16_ld(kD);
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (row0 + r < n && c * 8 < d)
      x = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * stride +
                                          c * 8);
    *reinterpret_cast<uint4*>(dst + r * ld + c * 8) = x;
  }
}

// grid (ceil(Sq / kBr), H, B), block kThreads, smem bf16_smem<kD>().
// Warp w owns query rows w*16 .. w*16+15 of the block's tile. Fragment
// layouts are those of mma.m16n8k16: lane = 4 * g + t holds rows g and g + 8,
// columns 2t and 2t + 1 of each 8-column slice.
template <int kD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ out, Shape s) {
  constexpr int ld = bf16_ld(kD);
  constexpr int kNt = kBc / 8;  // 8-column slices of a score tile
  constexpr int kDt = kD / 8;   // 8-column slices of the output
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBr;  // heavy tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [kBr][ld]
  __nv_bfloat16* ks = qs + kBr * ld;                            // [kBc][ld]
  __nv_bfloat16* vs = ks + kBc * ld;                            // [kBc][ld]

  const int64_t q_stride = (int64_t)s.h * s.d;
  const int64_t kv_stride = (int64_t)s.hkv * s.d;
  const int64_t q_head = ((int64_t)b * s.sq * s.h + h) * s.d;
  const int64_t kv_head = ((int64_t)b * s.sk * s.hkv + h / s.group) * s.d;
  stage_bf16<kD>(qs, q + q_head, q0, kBr, s.sq, q_stride, s.d);

  float acc[kDt][4];
#pragma unroll
  for (int i = 0; i < kDt; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this lane's columns only; summed at the end
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const __nv_bfloat16* q_frag = qs + (warp * 16 + (lane & 15)) * ld +
                                (lane >> 4) * 8;
  const __nv_bfloat16* k_frag = ks + ((lane & 7) + ((lane >> 4) << 3)) * ld +
                                ((lane >> 3) & 1) * 8;
  const __nv_bfloat16* v_frag = vs + ((lane & 7) + (((lane >> 3) & 1) << 3)) *
                                ld + (lane >> 4) * 8;

  const int kv_end = s.causal ? min(s.sk, q0 + kBr) : s.sk;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBc) {
    __syncthreads();  // the last tile is consumed (and Q staged)
    stage_bf16<kD>(ks, k + kv_head, kv0, kBc, s.sk, kv_stride, s.d);
    stage_bf16<kD>(vs, v + kv_head, kv0, kBc, s.sk, kv_stride, s.d);
    __syncthreads();

    // S = Q K^T: the warp's 16 rows against the tile's 64 keys.
    float sc[kNt][4];
#pragma unroll
    for (int i = 0; i < kNt; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, q_frag + kk * 16);
#pragma unroll
      for (int nt = 0; nt < kNt; nt += 2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, k_frag + nt * 8 * ld + kk * 16);
        mma_bf16(sc[nt], a, bk[0], bk[1]);
        mma_bf16(sc[nt + 1], a, bk[2], bk[3]);
      }
    }

    // Scale, mask, and the online-softmax update of rows g and g + 8.
    float m_cur[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + nt * 8 + 2 * t + (e & 1);
        const int r = row[e >> 1];
        const bool ok = col < s.sk && (!s.causal || r >= col);
        const float x = ok ? sc[nt][e] * s.scale : kNegInf;
        sc[nt][e] = x;
        m_cur[e >> 1] = fmaxf(m_cur[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_cur[i] = fmaxf(m_cur[i], __shfl_xor_sync(0xffffffffu, m_cur[i], 1));
      m_cur[i] = fmaxf(m_cur[i], __shfl_xor_sync(0xffffffffu, m_cur[i], 2));
      const float m_new = fmaxf(m_run[i], m_cur[i]);
      alpha[i] = expf(m_run[i] - m_new);
      m_run[i] = m_new;
    }
    float p_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[nt][e] - m_run[e >> 1]);
        sc[nt][e] = p;
        p_sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = alpha[i] * l_run[i] + p_sum[i];
#pragma unroll
    for (int dt = 0; dt < kDt; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O += bf16(P) V: the C fragments of two score slices are the A
    // fragment of one 16-key step.
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < kDt; dt += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, v_frag + kk * 16 * ld + dt * 8);
        mma_bf16(acc[dt], a, bv[0], bv[1]);
        mma_bf16(acc[dt + 1], a, bv[2], bv[3]);
      }
    }
  }

  float l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = l_run[i];
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = (l[i] == 0.f) ? 1.f : l[i];
  }
#pragma unroll
  for (int dt = 0; dt < kDt; ++dt) {
    const int d = dt * 8 + 2 * t;  // d even and D % 8 == 0: d + 1 < D too
    if (d >= s.d) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= s.sq) continue;
      *reinterpret_cast<uint32_t*>(out + q_head + row[i] * q_stride + d) =
          pack_bf16(acc[dt][2 * i] / l[i], acc[dt][2 * i + 1] / l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs on tiles of 32 x 32; any D that is a multiple of 8 up to
// 256. Lane group r (four consecutive lanes) owns query row r of the tile:
// lane c of the group scores columns c, c + 4, ... and accumulates head-dim
// columns c, c + 4, ... in registers.
// ---------------------------------------------------------------------------

constexpr int kTr = 32;
constexpr int kTc = 32;
constexpr int kMaxD = 256;

size_t f32_smem(int d) {
  return ((size_t)(kTr + kTc) * (d + 1) + (size_t)kTc * d +
          (size_t)kTr * (kTc + 1)) * sizeof(float);
}

__device__ __forceinline__ void stage_f32(float* dst, int ld, const float* src,
                                          int row0, int rows, int n,
                                          int64_t stride, int d) {
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    dst[r * ld + c] =
        row0 + r < n ? src[(int64_t)(row0 + r) * stride + c] : 0.f;
  }
}

// grid (ceil(Sq / kTr), H, B), block kThreads, smem f32_smem(D).
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, Shape s) {
  const int D = s.d;
  const int ldk = D + 1;  // odd row stride: rows fall in distinct banks
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTr;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int r = threadIdx.x >> 2;
  const int c = threadIdx.x & 3;
  const int row = q0 + r;
  const int nd = D / 4;  // accumulator columns of this lane

  extern __shared__ float fsm[];
  float* qs = fsm;                  // [kTr][D + 1]
  float* ks = qs + kTr * ldk;       // [kTc][D + 1]
  float* vs = ks + kTc * ldk;       // [kTc][D]
  float* ps = vs + kTc * D;         // [kTr][kTc + 1]

  const int64_t q_stride = (int64_t)s.h * D;
  const int64_t kv_stride = (int64_t)s.hkv * D;
  const int64_t q_head = ((int64_t)b * s.sq * s.h + h) * D;
  const int64_t kv_head = ((int64_t)b * s.sk * s.hkv + h / s.group) * D;
  stage_f32(qs, ldk, q + q_head, q0, kTr, s.sq, q_stride, D);

  float acc[kMaxD / 4];
#pragma unroll
  for (int j = 0; j < kMaxD / 4; ++j) acc[j] = 0.f;
  float m_run = kNegInf;
  float l_run = 0.f;

  const int kv_end = s.causal ? min(s.sk, q0 + kTr) : s.sk;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kTc) {
    __syncthreads();
    stage_f32(ks, ldk, k + kv_head, kv0, kTc, s.sk, kv_stride, D);
    stage_f32(vs, D, v + kv_head, kv0, kTc, s.sk, kv_stride, D);
    __syncthreads();

    float sc[kTc / 4];
#pragma unroll
    for (int i = 0; i < kTc / 4; ++i) sc[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = qs[r * ldk + d];
#pragma unroll
      for (int i = 0; i < kTc / 4; ++i) sc[i] += qv * ks[(c + 4 * i) * ldk + d];
    }
    float m_cur = kNegInf;
#pragma unroll
    for (int i = 0; i < kTc / 4; ++i) {
      const int col = kv0 + c + 4 * i;
      const bool ok = col < s.sk && (!s.causal || row >= col);
      sc[i] = ok ? sc[i] * s.scale : kNegInf;
      m_cur = fmaxf(m_cur, sc[i]);
    }
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 2));
    const float m_new = fmaxf(m_run, m_cur);
    const float alpha = expf(m_run - m_new);
    m_run = m_new;
    float p_sum = 0.f;
#pragma unroll
    for (int i = 0; i < kTc / 4; ++i) {
      const float p = expf(sc[i] - m_new);
      ps[r * (kTc + 1) + c + 4 * i] = p;
      p_sum += p;
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 2);
    l_run = alpha * l_run + p_sum;
    __syncwarp();  // the row's p, written by its four lanes, is read by them

#pragma unroll
    for (int j = 0; j < kMaxD / 4; ++j) acc[j] *= alpha;
    for (int col = 0; col < kTc; ++col) {
      const float p = ps[r * (kTc + 1) + col];
      const float* vr = vs + col * D + c;
#pragma unroll
      for (int j = 0; j < kMaxD / 4; ++j)
        if (j < nd) acc[j] += p * vr[4 * j];
    }
  }

  if (row >= s.sq) return;
  const float l = (l_run == 0.f) ? 1.f : l_run;
  float* o = out + q_head + row * q_stride + c;
#pragma unroll
  for (int j = 0; j < kMaxD / 4; ++j)
    if (j < nd) o[4 * j] = acc[j] / l;
}

// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;

// Opts `kernel` into `smem` bytes of dynamic shared memory past the default
// 48 KB. The attribute is a driver call, so it is made once per kernel,
// device and size: `reserved` (one per kernel) holds the most each device
// already allows, and a launch that fits it makes no call.
template <typename Kernel>
int reserve_smem(Kernel kernel, size_t smem, int* reserved) {
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < kMaxDevices && reserved[dev] >= (int)smem) return 0;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (!err && dev < kMaxDevices) reserved[dev] = (int)smem;
  return err;
}

template <int kD>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, const Shape& s, cudaStream_t stream) {
  static int reserved[kMaxDevices] = {};
  const size_t smem = bf16_smem<kD>();
  const int err = reserve_smem(flash_fwd_bf16<kD>, smem, reserved);
  if (err) return err;
  dim3 grid((s.sq + kBr - 1) / kBr, s.h, B);
  flash_fwd_bf16<kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      s);
  return (int)cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               const Shape& s, cudaStream_t stream) {
  static int reserved[kMaxDevices] = {};
  const size_t smem = f32_smem(s.d);
  const int err = reserve_smem(flash_fwd_f32, smem, reserved);
  if (err) return err;
  dim3 grid((s.sq + kTr - 1) / kTr, s.h, B);
  flash_fwd_f32<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q/out [B, Sq, H, D], k/v [B, Sk, Hkv, D],
// contiguous, 16-byte aligned. Returns a cudaError_t (0 = launched;
// cudaErrorInvalidValue for shapes the kernel does not take).
int rt_flash_attention_forward(int dtype, const void* q, const void* k,
                               const void* v, void* out, int B, int Sq,
                               int Sk, int H, int Hkv, int D, int causal,
                               float scale, void* stream) {
  if (B < 1 || B > 65535 || Sq < 1 || Sk < 1 || H < 1 || H > 65535 ||
      Hkv < 1 || H % Hkv != 0 || D < 8 || D % 8 != 0 || D > kMaxD)
    return (int)cudaErrorInvalidValue;
  const Shape s{Sq, Sk, H, Hkv, D, H / Hkv, causal ? 1 : 0, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(q, k, v, out, B, s, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (D <= 16) return launch_bf16<16>(q, k, v, out, B, s, st);
  if (D <= 32) return launch_bf16<32>(q, k, v, out, B, s, st);
  if (D <= 64) return launch_bf16<64>(q, k, v, out, B, s, st);
  if (D <= 128) return launch_bf16<128>(q, k, v, out, B, s, st);
  return launch_bf16<256>(q, k, v, out, B, s, st);
}

}  // extern "C"
