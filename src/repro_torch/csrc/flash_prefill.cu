// Causal flash attention for layer-segmented prefill, for Hopper.
//
// Replaces the Pallas TPU kernel `flash_prefill` in
// src/repro/kernels/flash_prefill.py (mirrored on the serving path by
// `flash_attention_jnp`, src/repro/models/attention.py):
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / G] * scale) @ v[b, j, h / G]
// over the keys j <= q_offset + i (causal) and j < Sk, with
// q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) bf16 and out (B, Sq, Hq, D) bf16.
// q_offset is the absolute position of query 0: a chunk continuation
// passes the earlier chunks' keys ahead of its window, Sk = q_offset + Sq.
//
// What bounds it: operations.  4 * Hq * D flops per visible (query, key)
// pair against 2 bytes per element read once: at a 4096-token prompt that
// is thousands of flops per byte, far above the ~295 at which the H100's
// tensor cores, not HBM, are the limit.
//
// Design (FlashAttention-2 on mma.sync): one CTA of 4 warps per (query
// tile of 64 rows, query head, batch row), heavy tiles (near the end of
// the prompt) first.  The Pallas grid's sequential key axis is a loop
// inside the CTA: K/V tiles of 64 keys are double-buffered in shared
// memory with cp.async (rows padded by 16 bytes so ldmatrix is free of
// bank conflicts; rows past Sk are zero-filled, so a masked probability
// never meets garbage), the loop stops at the causal diagonal of the
// tile's last real query, and each warp owns 16 query rows whose Q
// fragments stay in registers.  S = Q K^T and O += P V run on the tensor
// cores as m16n8k16 bf16 products accumulating in float32; the online
// softmax is float32 in the log2 domain; P is rounded to bf16 for the
// P V product (the usual FlashAttention choice).  Keys of other query
// heads of the GQA group are re-read from L2, not shared between CTAs.
// Head dims 64 and 128 are instantiated.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBr = 64;   // query rows per CTA, 16 per warp
constexpr int kBc = 64;   // keys per tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t row_stride, int row0,
                                          int rows_valid, int tid) {
  constexpr int kStride = D + 8;
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
#pragma unroll
  for (int i = tid; i < kBr * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool ok = row0 + r < rows_valid;
    const bf16* g = src + (size_t)(ok ? row0 + r : 0) * row_stride + c;
    cp_async16(dst + r * kStride + c, g, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     int Sq, int Sk, int Hq, int Hkv, int G, int q_offset,
                     float scale_log2) {
  constexpr int kStride = D + 8;   // padded shared-memory row, elements
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // kBr rows
  bf16* k_s = q_s + kBr * kStride;                 // 2 stages of kBc rows
  bf16* v_s = k_s + 2 * kBc * kStride;             // 2 stages of kBc rows

  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy tiles first
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = qt * kBr;

  const size_t q_row = (size_t)Hq * D;    // elements between tokens
  const size_t kv_row = (size_t)Hkv * D;
  const bf16* qb = q + (size_t)b * Sq * q_row + (size_t)hq * D;
  const bf16* kb = k + (size_t)b * Sk * kv_row + (size_t)hk * D;
  const bf16* vb = v + (size_t)b * Sk * kv_row + (size_t)hk * D;

  // keys up to the causal diagonal of the tile's last real query
  const int last_q = min(q0 + kBr, Sq) - 1;
  const int k_end = min(Sk, q_offset + last_q + 1);
  const int n_tiles = k_end > 0 ? (k_end + kBc - 1) / kBc : 0;

  load_tile<D>(q_s, qb, q_row, q0, Sq, tid);
  if (n_tiles > 0) {
    load_tile<D>(k_s, kb, kv_row, 0, Sk, tid);
    load_tile<D>(v_s, vb, kv_row, 0, Sk, tid);
  }
  cp_async_commit();

  const int g = lane >> 2;   // row within the 8-row half of the fragment
  const int t = lane & 3;    // column pair
  const int row0 = q0 + warp * 16 + g;   // this thread's rows: row0, +8
  const int qpos0 = q_offset + row0;
  const int qpos1 = qpos0 + 8;

  uint32_t qf[D / 16][4];
  float o[D / 8][4];
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {   // prefetch the next tile into the other stage
      load_tile<D>(k_s + (st ^ 1) * kBc * kStride, kb, kv_row,
                   (j + 1) * kBc, Sk, tid);
      load_tile<D>(v_s + (st ^ 1) * kBc * kStride, vb, kv_row,
                   (j + 1) * kBc, Sk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();   // every group but the newest: tile j has landed
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * kStride +
                                kk * 16 + (lane >> 4) * 8);
    }
    const bf16* ks = k_s + st * kBc * kStride;
    const bf16* vs = v_s + st * kBc * kStride;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[kBc / 8][4];
#pragma unroll
    for (int n = 0; n < kBc / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nn = 0; nn < kBc / 16; ++nn) {
        uint32_t bfrag[4];
        ldmatrix_x4(bfrag, ks + (nn * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                    kStride +
                               kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * nn], qf[kk], bfrag[0], bfrag[1]);
        mma_bf16(s[2 * nn + 1], qf[kk], bfrag[2], bfrag[3]);
      }
    }

    // mask, online softmax (log2 domain)
    const int kbase = j * kBc;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kBc / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kbase + n * 8 + 2 * t + (e & 1);
        const int qp = e < 2 ? qpos0 : qpos1;
        const bool ok = kpos <= qp && kpos < Sk;
        s[n][e] = ok ? s[n][e] * scale_log2 : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < kBc / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[n][e] > 0.5f * kNegInf
                            ? exp2f(s[n][e] - m[e >> 1]) : 0.f;
        s[n][e] = p;
        rsum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l[r] = l[r] * corr[r] + rsum[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V, P from the S accumulators as bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bfrag[4];
        ldmatrix_x4_trans(
            bfrag, vs + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                            kStride +
                       dn * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dn], a, bfrag[0], bfrag[1]);
        mma_bf16(o[2 * dn + 1], a, bfrag[2], bfrag[3]);
      }
    }
    __syncthreads();   // this stage's reads are done before it is refilled
  }
  cp_async_wait<0>();

  const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
  bf16* ob = out + (size_t)b * Sq * q_row + (size_t)hq * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * q_row + d) =
          __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    if (row0 + 8 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)(row0 + 8) * q_row +
                                         d) =
          __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int Hkv, int q_offset, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (size_t)(kBr + 4 * kBc) * (D + 8);
  auto kern = flash_prefill_kernel<D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Sq + kBr - 1) / kBr, Hq, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Sk, Hq, Hkv,
      Hq / Hkv, q_offset, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// bfloat16, causal, D == Dv in {64, 128}.  Limits checked by the wrapper:
// contiguous (B, S, H, D) tensors, 16-byte aligned, Hq % Hkv == 0,
// q_offset >= 0.
extern "C" int launch_flash_prefill(const void* q, const void* k,
                                    const void* v, void* out, int B, int Sq,
                                    int Sk, int Hq, int Hkv, int D,
                                    int q_offset, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0 || Hq == 0) return (int)cudaGetLastError();
  if (D == 64)
    return launch<64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, q_offset, scale, s);
  if (D == 128)
    return launch<128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}
