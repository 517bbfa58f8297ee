// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _flash_fwd_kernel
// (ray_tpu/ops/attention.py:128), launched by _flash_forward (:219) under
// the flash_attention custom VJP (:269): causal or full softmax attention of
// q [B, Sq, H, D] against k/v [B, Sk, Hkv, D], GQA by kv head h / (H / Hkv),
// causal masking aligned top-left (row r sees keys 0..r, also when
// Sq != Sk), f32 online softmax, out in q's dtype. The backward is not a
// kernel, in the JAX package or here: it recomputes through blockwise
// attention.
//
// What bounds it: operations. At the training slice (B 8, S 2048, H 8,
// Hkv 4, D 128, causal, bf16) the function needs 4*B*H*D*S(S+1)/2 = 68.7
// GFLOP against 100.7 MB of q, k, v and out: ~680 flops per byte, above the
// ~295 at which the H100's tensor cores, not its memory, are the limit. Only
// wgmma reaches the tensor cores' full rate, and only while the next tiles
// arrive during the current products. Three kernels:
//   - flash_fwd_wgmma, bf16 at head_dim 128 (bench_400m, Llama-3-8B), warp
//     specialised. One producer thread issues TMA loads
//     (cp.async.bulk.tensor) of the block's Q once and of 128-key K/V tiles
//     into a two-stage ring guarded by full/empty mbarriers. Two consumer
//     warpgroups own 64 query rows each. S = Q K^T is wgmma m64n128k16 with
//     both operands in shared memory (K-major, the 128-byte swizzle TMA
//     writes); O += P V is wgmma with P from registers (the f32 accumulator
//     of S repacked as bf16 A fragments: P is rounded to bf16 as the Pallas
//     kernel casts p to v's dtype, :179) and V from shared memory, MN-major.
//     setmaxnreg moves registers from the producer to the consumers (S and
//     O are 64 f32 each a thread). Scores are prescaled by scale * log2(e)
//     for exp2f, and only tiles that cross the causal diagonal or the end of
//     the keys are masked; TMA zero-fills rows past Sq or Sk. Later work:
//     overlap of the softmax with the next product inside a warpgroup,
//     ping-pong of the two consumers, a persistent grid.
//   - flash_fwd_bf16, bf16 at any other head_dim (a multiple of 8 up to
//     256): mma.sync m16n8k16 on operands read with ldmatrix from padded
//     shared memory, 64 x 64 tiles loaded behind __syncthreads.
//   - flash_fwd_f32: scalar FMAs; TF32 would miss the repo's f32 bar.
// Each runs one thread block per (tile of query rows, head, batch); its K/V
// loop stops at the causal limit (the Pallas grid visits every block and
// skips those above the diagonal with pl.when), and the heaviest causal
// tiles are issued first. q/k/v are read in their [B, S, H, D] layout (no
// transposes) and each block reads the rows of its own KV head, so K/V are
// never repeated in device memory.
// Numerics follow the Pallas kernel: scores scaled after the product,
// columns >= Sk and (causal) col > row set to -1e30, l == 0 -> 1 in the
// epilogue. Rows past Sq or Sk, and head-dim columns past D, are zero in
// shared memory, so a zero weight never meets garbage.
//
// Built by ray_tpu_torch/_build.py with nvcc into a shared library with a
// plain C interface; ray_tpu_torch/ops/attention.py binds it with ctypes.
// The entry point returns cudaGetLastError() after the launch. The tensor
// maps are encoded on the host through cudaGetDriverEntryPoint, so the
// library needs no -lcuda.

#include <cuda.h>
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
// bf16 at head_dim 128: wgmma fed by TMA through an mbarrier ring.
// Warpgroups 0 and 1 consume (query rows 0-63 and 64-127 of the block's
// tile); warpgroup 2 produces (one thread issues every TMA load).
// Shared memory holds 128-row x 128-column bf16 tiles, each as two halves
// of [128 rows][64 columns] (128 bytes a row, the 128-byte swizzle atom),
// 1024-byte aligned: Q, then kWgStages K tiles, kWgStages V tiles, and the
// barriers.
// ---------------------------------------------------------------------------

constexpr int kWgRows = 128;                  // query rows per block
constexpr int kWgKeys = 128;                  // keys per K/V tile
constexpr int kWgStages = 2;                  // depth of the K/V ring
constexpr int kWgThreads = 384;               // 2 consumer + 1 producer warpgroups
constexpr int kHalfBytes = kWgKeys * 128;     // [128][64] bf16: 16 KB
constexpr int kTileBytes = 2 * kHalfBytes;    // [128][128] bf16: 32 KB
constexpr float kLog2e = 1.4426950408889634f;

constexpr size_t wg_smem() {
  return 1024 + (size_t)(1 + 2 * kWgStages) * kTileBytes +
         8 * (1 + 2 * kWgStages);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the phase of `bar` with this parity has completed. A wait
// that outlasts 4 s (a tile arrives in microseconds) traps, so a broken
// pipeline fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (t0 == 0)
      t0 = now;
    else if (now - t0 > 4000000000ull)
      __trap();
  }
}

// One box of `map` at coordinates (d, head, row, batch) into shared memory;
// completion is reported to `bar` in bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64x128] (+)= A[64x16] * B[16x128]: A and B from shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64x128] += A[64x16] * B[16x128]: A from registers (bf16 pairs), B from
// shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Scale (to log2 units), mask (kMask: the tile crosses the diagonal or the
// end of the keys) and the online-softmax update of this thread's rows
// row0 and row0 + 8. Accumulator layout of m64n128: element 4i + e holds
// row row0 + 8 * (e >> 1), column kv0 + 8i + 2 * (lane & 3) + (e & 1).
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&o)[64],
                                             float (&m_run)[2],
                                             float (&l_run)[2], int kv0,
                                             int row0, const Shape& s,
                                             float c) {
  const int t = threadIdx.x & 3;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * i + e] * c;
      if (kMask) {
        const int col = kv0 + 8 * i + 2 * t + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        if (col >= s.sk || (s.causal && col > row)) x = kNegInf;
      }
      sc[4 * i + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r]);
    alpha[r] = exp2f(m_run[r] - m_new);
    m_run[r] = m_new;
  }
  float p_sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float p = exp2f(sc[i] - m_run[(i >> 1) & 1]);
    sc[i] = p;
    p_sum[(i >> 1) & 1] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = alpha[r] * l_run[r] + p_sum[r];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// grid (ceil(Sq / 128), H, B), block kWgThreads, smem wg_smem(). The maps
// cover q / k / v as [B][S][heads][128] with boxes of 1 x 128 x 1 x 64.
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ out, Shape s) {
  extern __shared__ __align__(1024) unsigned char wg_smem_raw[];
  const uint32_t qs = (smem_u32(wg_smem_raw) + 1023u) & ~1023u;
  const uint32_t ks = qs + kTileBytes;
  const uint32_t vs = ks + kWgStages * kTileBytes;
  const uint32_t q_full = vs + kWgStages * kTileBytes;
  const uint32_t full = q_full + 8;                 // [kWgStages]
  const uint32_t empty = full + 8 * kWgStages;      // [kWgStages]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWgRows;  // heavy tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_end = s.causal ? min(s.sk, q0 + kWgRows) : s.sk;
  const int n_kv = (kv_end + kWgKeys - 1) / kWgKeys;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kWgStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: a thread issues every load and waits for freed stages
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 2 * 128) {
      const int hk = h / s.group;
      mbar_expect_tx(q_full, kTileBytes);
      tma_load(qs, &tq, q_full, 0, h, q0, b);
      tma_load(qs + kHalfBytes, &tq, q_full, 64, h, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % kWgStages;
        if (j >= kWgStages)
          mbar_wait(empty + 8 * st, ((j / kWgStages) - 1) & 1);
        const uint32_t bar = full + 8 * st;
        const uint32_t kd = ks + st * kTileBytes;
        const uint32_t vd = vs + st * kTileBytes;
        mbar_expect_tx(bar, 2 * kTileBytes);
        tma_load(kd, &tk, bar, 0, hk, j * kWgKeys, b);
        tma_load(kd + kHalfBytes, &tk, bar, 64, hk, j * kWgKeys, b);
        tma_load(vd, &tv, bar, 0, hk, j * kWgKeys, b);
        tma_load(vd + kHalfBytes, &tv, bar, 64, hk, j * kWgKeys, b);
      }
    }
  } else {
    // consumers: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    const int first = q0 + wg * 64;                    // the warpgroup's rows
    const int row0 = first + warp * 16 + (lane >> 2);  // and row0 + 8
    const float c = s.scale * kLog2e;
    const uint32_t qa = qs + wg * 64 * 128;            // its rows of Q

    float o[64], sc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = sc[i] = 0.f;
    float m_run[2] = {kNegInf, kNegInf};
    float l_run[2] = {0.f, 0.f};  // this lane's columns only; summed at the end

    mbar_wait(q_full, 0);
    __syncwarp();
    for (int j = 0; j < n_kv; ++j) {
      const int st = j % kWgStages;
      mbar_wait(full + 8 * st, (j / kWgStages) & 1);
      __syncwarp();
      const uint32_t kb = ks + st * kTileBytes;
      const uint32_t vb = vs + st * kTileBytes;

      // S = Q K^T: 8 steps of 16 along head_dim, 4 in each 64-column half
      // (K-major: +32 bytes a step inside the swizzle atom; LBO unused,
      // SBO = 8 rows of 128 bytes).
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t off = (kk >> 2) * kHalfBytes + (kk & 3) * 32;
        wgmma_ss(sc, sw128_desc(qa + off, 16, 1024),
                 sw128_desc(kb + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);

      const int kv0 = j * kWgKeys;
      if (kv0 + kWgKeys > s.sk || (s.causal && kv0 + kWgKeys - 1 > first))
        softmax_tile<true>(sc, o, m_run, l_run, kv0, row0, s, c);
      else
        softmax_tile<false>(sc, o, m_run, l_run, kv0, row0, s, c);

      // O += bf16(P) V: 8 steps of 16 keys. The C fragments of two 8-key
      // slices of S are the A fragment of one step. V is MN-major: a step
      // starts 16 rows (2048 bytes) further, LBO = the other 64-column half,
      // SBO = 8 rows of 128 bytes.
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs(o, pa[kk], sw128_desc(vb + kk * 2048, kHalfBytes, 1024));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
      mbar_arrive(empty + 8 * st);  // this thread is done with the stage
    }

    float l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l_run[r];
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = (l[r] == 0.f) ? 1.f : l[r];
    }
    const int64_t q_stride = (int64_t)s.h * 128;
    __nv_bfloat16* o_head = out + ((int64_t)b * s.sq * s.h + h) * 128;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= s.sq) continue;
      __nv_bfloat16* o_row = o_head + row * q_stride + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        *reinterpret_cast<uint32_t*>(o_row + 8 * i) =
            pack_bf16(o[4 * i + 2 * r] / l[r], o[4 * i + 2 * r + 1] / l[r]);
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

// cuTensorMapEncodeTiled from the driver, found at run time: the library
// then links only the runtime.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map over a bf16 [B][S][heads][128] tensor in boxes of 64 head-dim
// columns x 128 rows of one head, 128-byte swizzle; rows past S read as 0.
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {128, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {128 * 2, (cuuint64_t)heads * 128 * 2,
                                 (cuuint64_t)S * heads * 128 * 2};
  const cuuint32_t box[4] = {64, 1, kWgKeys, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int launch_bf16_wgmma(const void* q, const void* k, const void* v, void* out,
                      int B, const Shape& s, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, B, s.sq, s.h);
  if (!err) err = make_map(&tk, k, B, s.sk, s.hkv);
  if (!err) err = make_map(&tv, v, B, s.sk, s.hkv);
  if (err) return err;
  static int reserved[kMaxDevices] = {};
  const size_t smem = wg_smem();
  err = reserve_smem(flash_fwd_wgmma, smem, reserved);
  if (err) return err;
  dim3 grid((s.sq + kWgRows - 1) / kWgRows, s.h, B);
  flash_fwd_wgmma<<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), s);
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
// contiguous, 16-byte aligned; Sq and Sk may differ (causal: top-left).
// bf16 at D = 128 takes flash_fwd_wgmma, other bf16 widths flash_fwd_bf16. Returns a cudaError_t (0 = launched;
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
  if (D == 128) return launch_bf16_wgmma(q, k, v, out, B, s, st);
  if (D <= 128) return launch_bf16<128>(q, k, v, out, B, s, st);
  return launch_bf16<256>(q, k, v, out, B, s, st);
}

}  // extern "C"
