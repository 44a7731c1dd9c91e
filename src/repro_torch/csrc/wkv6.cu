// WKV recurrence (the RWKV6 time-mix's matrix-state scan) for Hopper.
//
// Replaces no Pallas kernel: the reference runs the recurrence as a
// jax.lax.scan over tokens, `_wkv_step` under `rwkv_time_mix` in
// src/repro/models/rwkv6.py:93 and :135-140.  A loop over tokens in PyTorch
// would launch some five kernels a token in every layer (about 1.97 M for a
// 16,384-token window over 24 layers), so the port computes the scan's
// function in one launch, prefill window and decode step alike:
//
//   r, k, v (B, S, H, 64) bf16; w (B, S, H, 64), u (H, 64) and
//   S0 (B, H, 64, 64) float32
//   per token, kv_ij = k_i v_j:
//     y_j = sum_i r_i (S_ij + u_i kv_ij),   S_ij = w_i S_ij + kv_ij
//   -> y (B, S, H, 64) float32, S after token S-1 (B, H, 64, 64) float32
//
// r, k and v widened to float32.  A padded position arrives with k = 0
// and w = 1, which leave S as it was, so no mask is needed, and with
// trailing padding the final state is the state after the row's last valid
// token.  S = 1 is the decode step.
//
// What bounds it: operations.  Per (token, head) it reads r, k and v (64
// bf16 values each) and w (64 float32) and writes y (64 float32), 896
// bytes.  The function needs 5 float32 operations per (i, j): the bonus
// term is a scalar per token, y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i,
// so y costs one multiply-add per (i, j), and the update w_i S_ij +
// k_i v_j a multiply and a multiply-add; 20,480 operations (plus 5 per
// channel) at 67 TFLOP/s take longer than 896 bytes at 3.35 TB/s.  This
// kernel spends 7 (it forms u_i k_i v_j per (i, j)).  The state is read
// and written once per launch (32 KB per (row, head)).
//
// Design (simple first): one CTA of 64 threads per (row, head); thread j
// keeps column j of S in 64 registers, so y_j needs no cross-thread
// reduction.  The tokens come in chunks of kChunk: r, k, v and w of the
// chunk are staged in shared memory as float32 (neighbouring threads load
// neighbouring channels), and each thread then walks the chunk's tokens,
// reading r, k, w and u as float4 broadcasts.  The sum over i is kept in
// four partial sums (a dependent chain of 16 in place of 64).  y is stored
// per token, 64 consecutive floats.  At a prefill window of one row the
// grid is only H = 32 CTAs: a chunked form with the state in tensor-core
// tiles, and more threads per head, are later work.
#include "common.cuh"

namespace {

constexpr int kHead = 64;     // head width: a thread per state column
constexpr int kChunk = 32;    // tokens staged per pass (32 KB of staging)

__global__ void __launch_bounds__(kHead)
wkv6_kernel(const __nv_bfloat16* __restrict__ r,
            const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_out, int S, int H) {
  __shared__ __align__(16) float rs[kChunk][kHead];
  __shared__ __align__(16) float ks[kChunk][kHead];
  __shared__ __align__(16) float vs[kChunk][kHead];
  __shared__ __align__(16) float ws[kChunk][kHead];
  __shared__ __align__(16) float us[kHead];

  const int j = threadIdx.x;
  const int h = blockIdx.x;
  const size_t b = blockIdx.y;
  const size_t head = b * H + h;
  float st[kHead];   // st[i] = S[i][j]
  const float* s0h = s0 + head * kHead * kHead;
#pragma unroll
  for (int i = 0; i < kHead; ++i) st[i] = s0h[i * kHead + j];
  us[j] = u[(size_t)h * kHead + j];

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n_tok = min(kChunk, S - t0);
    // every thread has finished reading the previous chunk (and us is
    // staged before the first)
    __syncthreads();
    for (int t = 0; t < n_tok; ++t) {
      const size_t off = ((b * S + t0 + t) * H + h) * kHead + j;
      rs[t][j] = to_f32(r[off]);
      ks[t][j] = to_f32(k[off]);
      vs[t][j] = to_f32(v[off]);
      ws[t][j] = w[off];
    }
    __syncthreads();
    for (int t = 0; t < n_tok; ++t) {
      const float vj = vs[t][j];
      const float4* r4 = reinterpret_cast<const float4*>(rs[t]);
      const float4* k4 = reinterpret_cast<const float4*>(ks[t]);
      const float4* w4 = reinterpret_cast<const float4*>(ws[t]);
      const float4* u4 = reinterpret_cast<const float4*>(us);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < kHead / 4; ++c) {
        const float4 rr = r4[c], kk = k4[c], ww = w4[c], uu = u4[c];
        const float ri[4] = {rr.x, rr.y, rr.z, rr.w};
        const float ki[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wi[4] = {ww.x, ww.y, ww.z, ww.w};
        const float ui[4] = {uu.x, uu.y, uu.z, uu.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * c + e;
          const float kv = ki[e] * vj;
          acc[e] += ri[e] * (st[i] + ui[e] * kv);
          st[i] = wi[e] * st[i] + kv;
        }
      }
      y[((b * S + t0 + t) * H + h) * kHead + j] =
          (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
  }
  float* sh = s_out + head * kHead * kHead;
#pragma unroll
  for (int i = 0; i < kHead; ++i) sh[i * kHead + j] = st[i];
}

}  // namespace

// r, k and v bfloat16; w, u, S0, y and S_out float32; all contiguous.
// The head width must be 64.
extern "C" int launch_wkv6(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           void* y, void* s_out, int B, int S, int H, int hd,
                           void* stream) {
  if (hd != kHead || B < 0 || S < 0 || H <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  wkv6_kernel<<<dim3(H, B), kHead, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(r),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_out), S, H);
  return (int)cudaGetLastError();
}
