// The backward of the selective scan (selective_scan.cu) for Hopper.
//
// Replaces no Pallas kernel: the reference trains the Mamba layer through
// jax.value_and_grad of a jax.lax.scan (`_ssm_scan`,
// src/repro/models/mamba.py:60-80), whose gradient is a reverse scan.  This
// file computes that gradient's function, kernels/ref.py's
// selective_scan_bwd, over a whole window; it does not repeat the
// reference's scan step by step.  Every operand float32:
//
//   x, dt, dy (Bt, S, di); B, C (Bt, S, 16); A (di, 16); D (di,); h_ckpt
//   (Bt, ceil(S / 64), di, 16), the state before each 64-token chunk, from
//   training's forward (launch_selective_scan_f32); dh (Bt, di, 16), the
//   final state's gradient.  Per (row, channel d, state n), a_t =
//   exp(dt_t A), h_t the state after token t, g_t its gradient (g_t =
//   C_t dy_t + a_{t+1} g_{t+1}, from dh):
//     dx_t = dt_t sum_n g_t B_t + D dy_t
//     ddt_t = sum_n g_t (A a_t h_{t-1} + x_t B_t)
//     dB_t[n] = sum_d g_t dt_t x_t        dC_t[n] = sum_d dy_t h_t
//     dA = sum_{b,t} g_t dt_t a_t h_{t-1}  dD = sum_{b,t} dy_t x_t
//     dh0 = a_0 g_0.
//
// What bounds it: bytes.  It reads x, dt and dy and writes dx and ddt, 20
// bytes a (token, channel): 0.200 ms at B 1 x 4,096, d_inner 8192 on the
// H100's 3.35 TB/s, against ~18 float32 operations a (token, channel,
// state), 0.14 ms at 67 TFLOP/s.  The partial sums over channels (below)
// add a round trip of 32 floats a (token, CTA) that the bound does not
// count (134 MB each way at that shape).
//
// Design.  The forward's layout: a thread per (row, channel, 4 states)
// keeps g and its A in registers; 4 threads hold a channel, a CTA of 128
// threads 32 channels of one row, and walks the row's 64-token chunks in
// reverse, so g never leaves the CTA.  A chunk's x, dt, dy, B and C land
// in shared memory by cp.async while the chunk after it (in the walk) is
// computed.  Within a chunk the CTA reruns the states forward from the
// chunk's checkpoint, keeping each thread's state at the start of every
// 8-token sub-chunk in shared memory; then, sub-chunk by sub-chunk in
// reverse, it reruns those 8 tokens into registers (h_{t-1} and a_t) and
// walks g back over them.  h_t is never recovered by dividing by a_t,
// which underflows for large dt |A|.  So every exponential is taken twice.
// dx and ddt sum over the channel's 4 lanes (two shuffles each); dB and
// dC, sums over channels, go through a transposing butterfly over the
// warp's 8 channels (7 shuffles for 8 values), then the 4 warps' sums in
// shared memory, in a fixed order, into a per-CTA partial (Bt, CTAs, S,
// 32); a second launch sums the CTAs' partials in CTA order, and dA and
// dD (per-row partials) over the rows in row order.  No atomics: two
// launches give the same bits.  Tokens past S in the last chunk and
// channels past d_inner are zeros in shared memory (dt = x = dy = 0), so
// they add nothing to any sum.
#include "common.cuh"

namespace {

constexpr int kStates = 16;              // d_state
constexpr int kP = 4;                    // states per thread
constexpr int kLanes = kStates / kP;     // threads per channel
constexpr int kChannels = 32;            // channels per CTA
constexpr int kThreads = kChannels * kLanes;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;               // selective_scan.cu's checkpoints
constexpr int kSub = 8;                  // tokens rerun into registers
constexpr int kSubs = kChunk / kSub;
constexpr int kPart = 2 * kStates;       // a token's dB and dC sums

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Stage {     // one chunk's inputs (32 KB)
  float x[kChunk][kChannels];
  float dt[kChunk][kChannels];
  float dy[kChunk][kChannels];
  float b[kChunk][kStates];
  float c[kChunk][kStates];
};

struct Smem {      // 88 KB
  Stage st[2];
  float4 bnd[kSubs][kThreads];         // a thread's state at sub-chunk starts
  float red[2][kSub][kWarps][kPart];   // the warps' dB and dC sums
};

// Copy tokens [t0, t0 + n) into stage st as 16-byte pieces, per token
// kItems items: a group of 4 channels (its x, dt and dy), or a quarter of
// B or of C.  A group past d_inner (di % 8 == 0) is not copied.
constexpr int kItems = kChannels / 4 + 8;

__device__ __forceinline__ void issue_chunk(
    Stage& st, const float* x, const float* dt, const float* dy,
    const float* B, const float* C, size_t row, int t0, int n, int c0,
    int di) {
  constexpr int kGroups = kChannels / 4;
  for (int i = threadIdx.x; i < n * kItems; i += kThreads) {
    const int t = i / kItems, it = i % kItems;
    const size_t tok = row + t0 + t;
    if (it < kGroups) {
      const int ch = it * 4;
      if (c0 + ch < di) {
        const size_t at = tok * di + c0 + ch;
        cp_async16(&st.x[t][ch], x + at);
        cp_async16(&st.dt[t][ch], dt + at);
        cp_async16(&st.dy[t][ch], dy + at);
      }
    } else {
      const int part = (it - kGroups) & 3;
      if (it - kGroups < 4)
        cp_async16(&st.b[t][part * 4], B + tok * kStates + part * 4);
      else
        cp_async16(&st.c[t][part * 4], C + tok * kStates + part * 4);
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ void ld4(const float* src, float (&dst)[kP]) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

__device__ __forceinline__ void st4(float* dst, const float (&v)[kP]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

// one token forward: h = exp(dt A) h + (dt x) B, as selective_scan.cu
__device__ __forceinline__ void step(const Stage& st, int t, int cl, int q,
                                     const float (&a)[kP], float (&h)[kP]) {
  const float dtv = st.dt[t][cl];
  const float dtx = dtv * st.x[t][cl];
  float bn[kP];
  ld4(&st.b[t][q * kP], bn);
#pragma unroll
  for (int e = 0; e < kP; ++e) h[e] = fmaf(expf(dtv * a[e]), h[e], dtx * bn[e]);
}

__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const float* __restrict__ A,
                          const float* __restrict__ Dskip,
                          const float* __restrict__ h_ckpt,
                          const float* __restrict__ dy,
                          const float* __restrict__ dh,
                          float* __restrict__ dx, float* __restrict__ ddt,
                          float* __restrict__ dh0,
                          float* __restrict__ part,
                          float* __restrict__ dA_part,
                          float* __restrict__ dD_part, int S, int di) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int cl = tid / kLanes;           // the thread's channel in the CTA
  const int q = tid % kLanes;            // its states: 4 q .. 4 q + 3
  const int c0 = blockIdx.x * kChannels;
  const int c = c0 + cl;
  const size_t b = blockIdx.y;
  const bool live = c < di;
  const size_t row = b * S;
  const int n_ck = (S + kChunk - 1) / kChunk;
  // the butterfly leaves lane its value idx of the 8 (4 dB, then 4 dC)
  const int idx = ((lane >> 2) & 1) * 4 + ((lane >> 3) & 1) * 2 +
                  ((lane >> 4) & 1);
  const int j_out = idx < 4 ? q * kP + idx : kStates + q * kP + idx - 4;

  // zeros where nothing is copied: channels past di, tokens past S
  {
    float4* z = reinterpret_cast<float4*>(&sm.st[0]);
    for (int i = tid; i < (int)(2 * sizeof(Stage) / 16); i += kThreads)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float a[kP] = {}, G[kP] = {}, dA_acc[kP] = {};
  float dD_acc = 0.f;
  if (live) {
    ld4(A + (size_t)c * kStates + q * kP, a);
    ld4(dh + (b * di + c) * kStates + q * kP, G);
  }
  const float dskip = live ? Dskip[c] : 0.f;
  __syncthreads();

  if (n_ck > 0) {
    const int t0 = (n_ck - 1) * kChunk;
    issue_chunk(sm.st[0], x, dt, dy, Bm, Cm, row, t0, S - t0, c0, di);
  }
  int buf = 0, it_sub = 0;
  for (int ck = n_ck - 1; ck >= 0; --ck, buf ^= 1) {
    const int t0 = ck * kChunk, n_tok = min(kChunk, S - t0);
    cp_async_wait_all();
    // this chunk's pieces have landed, and every thread is done with the
    // other stage (the chunk after this one)
    __syncthreads();
    if (ck > 0)
      issue_chunk(sm.st[buf ^ 1], x, dt, dy, Bm, Cm, row, t0 - kChunk,
                  kChunk, c0, di);
    const Stage& st = sm.st[buf];
    const int n_sub = (n_tok + kSub - 1) / kSub;
    // the states forward from the checkpoint, each sub-chunk's start kept
    float h[kP] = {};
    if (live) ld4(h_ckpt + ((b * n_ck + ck) * di + c) * kStates + q * kP, h);
    for (int k = 0; k < n_sub; ++k) {
      sm.bnd[k][tid] = make_float4(h[0], h[1], h[2], h[3]);
      if (k + 1 < n_sub) {
#pragma unroll
        for (int u = 0; u < kSub; ++u) step(st, k * kSub + u, cl, q, a, h);
      }
    }
    for (int k = n_sub - 1; k >= 0; --k, ++it_sub) {
      const int par = it_sub & 1;
      // h_{t-1} and a_t of the sub-chunk's tokens, rerun into registers
      float hp[kSub][kP], ea[kSub][kP];
      {
        const float4 v = sm.bnd[k][tid];
        float hc[kP] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < kSub; ++u) {
          const int t = k * kSub + u;
          const float dtv = st.dt[t][cl];
          const float dtx = dtv * st.x[t][cl];
          float bn[kP];
          ld4(&st.b[t][q * kP], bn);
#pragma unroll
          for (int e = 0; e < kP; ++e) {
            hp[u][e] = hc[e];
            ea[u][e] = expf(dtv * a[e]);
            hc[e] = fmaf(ea[u][e], hc[e], dtx * bn[e]);
          }
        }
      }
      // g walked back over them
#pragma unroll
      for (int u = kSub - 1; u >= 0; --u) {
        const int t = k * kSub + u;
        const float xv = st.x[t][cl], dtv = st.dt[t][cl];
        const float dyv = st.dy[t][cl];
        const float dtx = dtv * xv;
        float bn[kP], cn[kP], v[2 * kP];
        ld4(&st.b[t][q * kP], bn);
        ld4(&st.c[t][q * kP], cn);
        float sx = 0.f, sdt = 0.f;
#pragma unroll
        for (int e = 0; e < kP; ++e) {
          const float ht = fmaf(ea[u][e], hp[u][e], dtx * bn[e]);
          const float g = fmaf(cn[e], dyv, G[e]);
          const float w = ea[u][e] * hp[u][e];
          v[e] = g * dtx;
          v[kP + e] = dyv * ht;
          sx = fmaf(g, bn[e], sx);
          sdt = fmaf(g * a[e], w, sdt);
          dA_acc[e] = fmaf(g * dtv, w, dA_acc[e]);
          G[e] = ea[u][e] * g;
        }
        // dx and ddt: the sums over the channel's 4 lanes
#pragma unroll
        for (int o = 1; o < kLanes; o <<= 1) {
          sx += __shfl_xor_sync(0xffffffffu, sx, o);
          sdt += __shfl_xor_sync(0xffffffffu, sdt, o);
        }
        const size_t tok = row + t0 + t;
        if (q == 0 && live && t0 + t < S) {
          dx[tok * di + c] = fmaf(dskip, dyv, dtv * sx);
          ddt[tok * di + c] = fmaf(xv, sx, sdt);
        }
        dD_acc = fmaf(dyv, xv, dD_acc);
        // dB and dC over the warp's 8 channels: each round halves the
        // values a lane holds, keeping the half its channel bit selects
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const int off = kLanes << r, half = kP >> r;
          const bool up = lane & off;
#pragma unroll
          for (int i = 0; i < half; ++i) {
            const float send = up ? v[i] : v[i + half];
            const float keep = up ? v[i + half] : v[i];
            v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
          }
        }
        sm.red[par][u][warp][j_out] = v[0];
      }
      __syncthreads();
      // the CTA's dB and dC sums of the sub-chunk's tokens, warps in order
      for (int i = tid; i < kSub * kPart; i += kThreads) {
        const int u = i / kPart, j = i % kPart;
        const int t = t0 + k * kSub + u;
        if (t < S) {
          const float* r = sm.red[par][u][0];
          float s = r[j];
#pragma unroll
          for (int w = 1; w < kWarps; ++w) s += r[w * kPart + j];
          part[((b * gridDim.x + blockIdx.x) * S + t) * kPart + j] = s;
        }
      }
    }
  }
  if (live) {
    st4(dh0 + (b * di + c) * kStates + q * kP, G);
    st4(dA_part + (b * di + c) * kStates + q * kP, dA_acc);
    if (q == 0) dD_part[b * di + c] = dD_acc;
  }
}

// dB and dC: the CTAs' partials summed in CTA order; dA and dD: the rows'
// partials summed in row order
__global__ void __launch_bounds__(256)
selective_scan_bwd_sum_kernel(const float* __restrict__ part,
                              const float* __restrict__ dA_part,
                              const float* __restrict__ dD_part,
                              float* __restrict__ dB, float* __restrict__ dC,
                              float* __restrict__ dA, float* __restrict__ dD,
                              int Bt, int S, int di, int n_cta) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long n_bc = (long long)Bt * S * kPart;
  const long long n_a = (long long)di * kStates;
  if (i < n_bc) {
    const long long bt = i / kPart;          // b S + t
    const int j = (int)(i % kPart);
    const long long b = bt / S, t = bt % S;
    const float* p = part + (b * n_cta * S + t) * kPart + j;
    float s = 0.f;
    for (int k = 0; k < n_cta; ++k) s += p[(long long)k * S * kPart];
    if (j < kStates)
      dB[bt * kStates + j] = s;
    else
      dC[bt * kStates + j - kStates] = s;
  } else if (i < n_bc + n_a) {
    const long long e = i - n_bc;
    float s = 0.f;
    for (int b = 0; b < Bt; ++b) s += dA_part[b * n_a + e];
    dA[e] = s;
  } else if (i < n_bc + n_a + di) {
    const long long e = i - n_bc - n_a;
    float s = 0.f;
    for (int b = 0; b < Bt; ++b) s += dD_part[(long long)b * di + e];
    dD[e] = s;
  }
}

}  // namespace

// The scratch launch_selective_scan_bwd takes, in floats: the CTAs' dB
// and dC partials (Bt, ceil(di / 32), S, 32), then dA's and dD's per-row
// partials (Bt, di, 16) and (Bt, di).
extern "C" long long selective_scan_bwd_ws_floats(int Bt, int S, int di) {
  const long long n_cta = (di + kChannels - 1) / kChannels;
  return (long long)Bt * n_cta * S * kPart + (long long)Bt * di * kStates +
         (long long)Bt * di;
}

// The gradient of launch_selective_scan_f32 (its h_ckpt given): every
// operand float32, contiguous and 16-byte aligned; d_state 16, d_inner a
// multiple of 8; ws at least selective_scan_bwd_ws_floats floats.  Writes
// dx, ddt (Bt, S, di), dB, dC (Bt, S, 16), dA (di, 16), dD (di,) and dh0
// (Bt, di, 16) whole.  Two launches; returns a runtime error code.
extern "C" int launch_selective_scan_bwd(
    const void* x, const void* dt, const void* B, const void* C,
    const void* A, const void* D, const void* h_ckpt, const void* dy,
    const void* dh, void* dx, void* ddt, void* dB, void* dC, void* dA,
    void* dD, void* dh0, void* ws, long long ws_n, int Bt, int S, int di,
    int ds, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ds != kStates || Bt <= 0 || S <= 0 || di <= 0 || di % 8 != 0 ||
      Bt > 65535 || ws_n < selective_scan_bwd_ws_floats(Bt, S, di))
    return (int)cudaErrorInvalidValue;
  const int n_cta = (di + kChannels - 1) / kChannels;
  float* part = static_cast<float*>(ws);
  float* dA_part = part + (size_t)Bt * n_cta * S * kPart;
  float* dD_part = dA_part + (size_t)Bt * di * kStates;
  constexpr int smem = sizeof(Smem);
  cudaError_t e = cudaFuncSetAttribute(
      selective_scan_bwd_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  selective_scan_bwd_kernel<<<dim3(n_cta, Bt), kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<const float*>(h_ckpt), static_cast<const float*>(dy),
      static_cast<const float*>(dh), static_cast<float*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dh0), part, dA_part,
      dD_part, S, di);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)Bt * S * kPart + (long long)di * kStates +
                      di;
  selective_scan_bwd_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      part, dA_part, dD_part, static_cast<float*>(dB),
      static_cast<float*>(dC), static_cast<float*>(dA),
      static_cast<float*>(dD), Bt, S, di, n_cta);
  return (int)cudaGetLastError();
}
