// Selective scan (the Mamba layer's SSM recurrence) for Hopper.
//
// Replaces no Pallas kernel: the reference runs the recurrence as a
// jax.lax.scan over tokens, `_ssm_scan` in src/repro/models/mamba.py:60.
// A loop over tokens in PyTorch would launch some eight kernels a token in
// every Mamba layer (about 114,000 for a 14,211-token prompt), so the port
// computes the scan's function in one launch, prefill and decode alike:
//
//   x (Bt, S, di), B, C (Bt, S, 16) bf16; dt (Bt, S, di), A (di, 16) =
//   -exp(A_log), D (di,), h0 (Bt, di, 16) float32
//   per token:  dA = exp(dt A),  h = dA h + (dt x) B,  y = sum_n h C + D x
//   -> y (Bt, S, di) float32, h after token S-1 (Bt, di, 16) float32
//
// every input widened to float32.  A padded position arrives with dt = 0:
// exp(0) = 1 and (dt x) B = 0 leave h as it was, so no mask is needed,
// and with trailing padding the final state is the state after the row's
// last valid token.  S = 1 is the decode step.
//
// What bounds it.  Bytes: per (token, channel) it reads x (2 bytes) and dt
// (4) and writes y (4), 10 bytes at 3.35 TB/s against 16 states x 8
// float32 operations (dt A, its exp, dt B, times x, dA h, the add, h C and
// its sum) at 67 TFLOP/s: 0.40 ms against 0.26 at jamba's prefill window
// (B 1, S 16,384, d_inner 8192).  Two floors of this card sit above that
// bound, both from the window's 2.15 G exponentials (`ab_kernels.py
// --probes` on an H100 SXM at 700 W): the SFU does 15.8 MUFU.EX2 a clock
// an SM (0.51 ms at 1.98 GHz), and expf, one MUFU.EX2 among eight
// instructions, issues at 12.2 a clock an SM (0.67 ms).  Around it a
// (token, state) spends 4 more instructions ((dt x) B, the multiply-add
// into h, h C into y, and dt A) and its share of the loads and the y
// sums, and at B 1 the grid holds only 8 warps an SM to hide their
// latencies: this kernel takes 1.72 ms there (PERF.md).
//
// Design: a thread per (row, channel, 4 states) keeps its states and their
// A in registers; 4 threads hold a channel, a CTA of 128 threads holds 32
// channels of one row and walks the row's tokens in order (256 CTAs at
// B 1, d_inner 8192).  The tokens come in chunks of kChunk, copied raw
// (bf16 x, B, C; float32 dt) with cp.async into one of two buffers while
// the other chunk is computed, one barrier a chunk.  A thread takes the
// chunk kGroup tokens at a time: every shared load of the group, then its
// kGroup x 4 exponentials, then the recurrence; {dt, x} is read once a
// token and dt x formed once, B's and C's 4 values come as one 8-byte load
// each.  y's sum over the channel's 4 lanes is a transposing butterfly
// over the group (6 shuffles for 8 tokens, where a shuffle per round and
// token would take 16), after which each lane holds 2 of the group's
// tokens, adds D x and stores them (8 channels a warp: 32-byte sectors).
// 2 states a thread (8 warps more an SM, 3 shuffle rounds), a float32
// working copy of each chunk, one-warp CTAs and longer chunks were each
// slower in exploratory runs on the card, and so was a ring of three
// buffers of 48 or 64 tokens with two chunks' copies in flight
// (`ab_kernels.py` on each, PERF.md).  A chunked form over time (as
// wkv6.cu's) would give B 1 more warps but compute every exponential
// twice.  expf, not __expf: the build uses no fast-math flag.
//
// Training's instance (launch_selective_scan_f32, "selective_scan:train"):
// the same kernel on float32 x, B and C (the reference trains in float32,
// and the kernel widens them to float32 anyway), which also stores the
// state before each 64-token chunk, h_ckpt (Bt, ceil(S / 64), di, 16):
// 33.5 MB a Mamba layer at B 1 x 4,096 and d_inner 8192, from which the
// backward (selective_scan_bwd.cu) reruns each chunk.  Its bound: x and
// dt read and y written, 12 bytes a (token, channel), 0.120 ms at that
// shape on the H100's 3.35 TB/s.  The serve's bf16 instance is the same
// template with the checkpoints compiled out.
#include "common.cuh"

namespace {

constexpr int kStates = 16;              // d_state
constexpr int kP = 4;                    // states per thread
constexpr int kLanes = kStates / kP;     // threads per channel
constexpr int kChannels = 32;            // channels per CTA
constexpr int kThreads = kChannels * kLanes;
constexpr int kChunk = 64;               // tokens staged per pass
constexpr int kGroup = 8;                // tokens a thread takes at once
static_assert(kChunk % kGroup == 0 && kGroup % kLanes == 0, "");

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

// two chunks' raw pieces, as cp.async lands them: x, B and C in the
// input's type T (bf16 for the serve, float32 for training: 48 KB)
template <typename T>
struct Smem {
  __align__(16) T x[2][kChunk][kChannels];
  __align__(16) float dt[2][kChunk][kChannels];
  __align__(16) T b[2][kChunk][kStates];
  __align__(16) T c[2][kChunk][kStates];
};

// Copy tokens [t0, t0 + n) into buffer buf as 16-byte pieces, per token
// kItems items: a group of 8 channels (its x, and dt in two pieces), or a
// half of B or of C.  A group past d_inner (di % 8 == 0, so a group is
// wholly in or out) is not copied.
constexpr int kItems = kChannels / 8 + 4;

__device__ __forceinline__ void issue_chunk(
    Smem<__nv_bfloat16>& sm, int buf, const __nv_bfloat16* x,
    const float* dt, const __nv_bfloat16* B, const __nv_bfloat16* C,
    size_t row, int t0, int n, int c0, int di) {
  constexpr int kGroups = kChannels / 8;
  for (int i = threadIdx.x; i < n * kItems; i += kThreads) {
    const int t = i / kItems, it = i % kItems;
    const size_t tok = row + t0 + t;
    if (it < kGroups) {
      const int ch = it * 8;
      if (c0 + ch < di) {
        cp_async16(&sm.x[buf][t][ch], x + tok * di + c0 + ch);
        cp_async16(&sm.dt[buf][t][ch], dt + tok * di + c0 + ch);
        cp_async16(&sm.dt[buf][t][ch + 4], dt + tok * di + c0 + ch + 4);
      }
    } else {
      const int half = (it - kGroups) & 1;
      if (it - kGroups < 2)
        cp_async16(&sm.b[buf][t][half * 8], B + tok * kStates + half * 8);
      else
        cp_async16(&sm.c[buf][t][half * 8], C + tok * kStates + half * 8);
    }
  }
  cp_async_commit();
}

// The float32 instance's pieces, per token kItemsF items: a group of 4
// channels (its x and its dt), or a quarter of B or of C.
constexpr int kItemsF = kChannels / 4 + 8;

__device__ __forceinline__ void issue_chunk(
    Smem<float>& sm, int buf, const float* x, const float* dt,
    const float* B, const float* C, size_t row, int t0, int n, int c0,
    int di) {
  constexpr int kGroups = kChannels / 4;
  for (int i = threadIdx.x; i < n * kItemsF; i += kThreads) {
    const int t = i / kItemsF, it = i % kItemsF;
    const size_t tok = row + t0 + t;
    if (it < kGroups) {
      const int ch = it * 4;
      if (c0 + ch < di) {
        cp_async16(&sm.x[buf][t][ch], x + tok * di + c0 + ch);
        cp_async16(&sm.dt[buf][t][ch], dt + tok * di + c0 + ch);
      }
    } else {
      const int part = (it - kGroups) & 3;
      if (it - kGroups < 4)
        cp_async16(&sm.b[buf][t][part * 4], B + tok * kStates + part * 4);
      else
        cp_async16(&sm.c[buf][t][part * 4], C + tok * kStates + part * 4);
    }
  }
  cp_async_commit();
}

// 4 consecutive floats (16-byte aligned)
__device__ __forceinline__ void load4(const float* src, float (&dst)[kP]) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

// 4 bf16 values (8-byte aligned) widened to float
__device__ __forceinline__ void load4(const __nv_bfloat16* src,
                                      float (&dst)[kP]) {
  const uint2 v = *reinterpret_cast<const uint2*>(src);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  dst[0] = lo.x; dst[1] = lo.y; dst[2] = hi.x; dst[3] = hi.y;
}

// U tokens from t of buffer buf: every shared load first, then the
// exponentials, then the recurrence and each token's partial y over the
// thread's states; then y's sum over the channel's lanes, D x added and y
// stored (yrow: the channel's y at the chunk's first token).
template <int U, typename T>
__device__ __forceinline__ void scan_tokens(const Smem<T>& sm, int buf, int t,
                                            int cl, int q,
                                            const float (&a)[kP],
                                            float (&h)[kP], float dskip,
                                            float* __restrict__ yrow,
                                            int di, bool live) {
  float dt[U], xv[U], bn[U][kP], cn[U][kP];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    dt[u] = sm.dt[buf][t + u][cl];
    xv[u] = to_f32(sm.x[buf][t + u][cl]);
    load4(&sm.b[buf][t + u][q * kP], bn[u]);
    load4(&sm.c[buf][t + u][q * kP], cn[u]);
  }
  float dA[U][kP];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int e = 0; e < kP; ++e) dA[u][e] = expf(dt[u] * a[e]);
  float p[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float dtx = dt[u] * xv[u];
    p[u] = 0.f;
#pragma unroll
    for (int e = 0; e < kP; ++e) {
      h[e] = fmaf(dA[u][e], h[e], dtx * bn[u][e]);
      p[u] = fmaf(h[e], cn[u][e], p[u]);
    }
  }
  if constexpr (U == kGroup) {
    // each round halves the tokens a lane holds, keeping the half its bit
    // of q selects and adding its partner's sums of them
    int base = 0;
#pragma unroll
    for (int rnd = 0; rnd < 2; ++rnd) {
      const int off = kLanes >> (rnd + 1), half = U >> (rnd + 1);
      const bool up = q & off;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = up ? p[i] : p[i + half];
        const float keep = up ? p[i + half] : p[i];
        p[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        xv[i] = up ? xv[i + half] : xv[i];
      }
      base += up ? half : 0;
    }
#pragma unroll
    for (int i = 0; i < U / kLanes; ++i)
      if (live) yrow[(size_t)(t + base + i) * di] = fmaf(dskip, xv[i], p[i]);
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1)
        p[u] += __shfl_xor_sync(0xffffffffu, p[u], o);
      if (q == 0 && live)
        yrow[(size_t)(t + u) * di] = fmaf(dskip, xv[u], p[u]);
    }
  }
}

// T: the type of x, B and C.  kCkpt (training's instance): the state
// before each chunk of kChunk tokens is stored in h_ckpt (Bt, ceil(S /
// kChunk), di, 16), chunk 0's being h0, for the backward to rerun each
// chunk from (selective_scan_bwd.cu).
template <typename T, bool kCkpt>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ x,
                      const float* __restrict__ dt,
                      const T* __restrict__ Bm,
                      const T* __restrict__ Cm,
                      const float* __restrict__ A,
                      const float* __restrict__ Dskip,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_out,
                      float* __restrict__ h_ckpt, int S, int di) {
  __shared__ Smem<T> sm;
  const int tid = threadIdx.x;
  const int cl = tid / kLanes;           // the thread's channel in the CTA
  const int q = tid % kLanes;            // its states: 4 q .. 4 q + 3
  const int c0 = blockIdx.x * kChannels;
  const int c = c0 + cl;
  const size_t b = blockIdx.y;
  const bool live = c < di;
  const size_t row = b * S;
  float h[kP] = {}, a[kP] = {};
  if (live) {
    load4(A + (size_t)c * kStates + q * kP, a);
    load4(h0 + (b * di + c) * kStates + q * kP, h);
  }
  const float dskip = live ? Dskip[c] : 0.f;

  if (S > 0) issue_chunk(sm, 0, x, dt, Bm, Cm, row, 0, min(kChunk, S), c0, di);
  int buf = 0;
  for (int t0 = 0; t0 < S; t0 += kChunk, buf ^= 1) {
    const int n_tok = min(kChunk, S - t0);
    cp_async_wait_all();
    // every thread's pieces of this chunk have landed, and every thread is
    // done with the other buffer (the previous chunk)
    __syncthreads();
    if (t0 + kChunk < S)
      issue_chunk(sm, buf ^ 1, x, dt, Bm, Cm, row, t0 + kChunk,
                  min(kChunk, S - t0 - kChunk), c0, di);
    if constexpr (kCkpt) {
      if (live) {
        const int n_ck = (S + kChunk - 1) / kChunk;
        float* ck = h_ckpt + ((b * n_ck + t0 / kChunk) * di + c) * kStates +
                    q * kP;
        *reinterpret_cast<float4*>(ck) = make_float4(h[0], h[1], h[2], h[3]);
      }
    }
    // a channel past d_inner computes on stale pieces and stores nothing
    float* yrow = y + (row + t0) * di + c;
    int t = 0;
    for (; t + kGroup <= n_tok; t += kGroup)
      scan_tokens<kGroup>(sm, buf, t, cl, q, a, h, dskip, yrow, di, live);
    for (; t < n_tok; ++t)
      scan_tokens<1>(sm, buf, t, cl, q, a, h, dskip, yrow, di, live);
  }
  if (live) {
    float* out = h_out + (b * di + c) * kStates + q * kP;
    *reinterpret_cast<float4*>(out) = make_float4(h[0], h[1], h[2], h[3]);
  }
}

}  // namespace

// x, B and C bfloat16; dt, A, D, h0, y and h_out float32; all contiguous
// and 16-byte aligned.  d_state must be 16 and d_inner a multiple of 8.
extern "C" int launch_selective_scan(const void* x, const void* dt,
                                     const void* B, const void* C,
                                     const void* A, const void* D,
                                     const void* h0, void* y, void* h_out,
                                     int Bt, int S, int di, int ds,
                                     void* stream) {
  if (ds != kStates || Bt < 0 || S < 0 || di <= 0 || di % 8 != 0 ||
      Bt > 65535)
    return (int)cudaErrorInvalidValue;
  if (Bt == 0) return (int)cudaGetLastError();
  const dim3 grid((di + kChannels - 1) / kChannels, Bt);
  selective_scan_kernel<__nv_bfloat16, false>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const float*>(dt),
          static_cast<const __nv_bfloat16*>(B),
          static_cast<const __nv_bfloat16*>(C),
          static_cast<const float*>(A), static_cast<const float*>(D),
          static_cast<const float*>(h0), static_cast<float*>(y),
          static_cast<float*>(h_out), nullptr, S, di);
  return (int)cudaGetLastError();
}

// Training's forward: every operand float32 (x, B and C too), and the
// state before each chunk of 64 tokens written to h_ckpt (Bt, ceil(S /
// 64), di, 16); otherwise launch_selective_scan's function and limits.
extern "C" int launch_selective_scan_f32(const void* x, const void* dt,
                                         const void* B, const void* C,
                                         const void* A, const void* D,
                                         const void* h0, void* y,
                                         void* h_out, void* h_ckpt, int Bt,
                                         int S, int di, int ds,
                                         void* stream) {
  if (ds != kStates || Bt < 0 || S < 0 || di <= 0 || di % 8 != 0 ||
      Bt > 65535)
    return (int)cudaErrorInvalidValue;
  if (Bt == 0) return (int)cudaGetLastError();
  const dim3 grid((di + kChannels - 1) / kChannels, Bt);
  selective_scan_kernel<float, true>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x), static_cast<const float*>(dt),
          static_cast<const float*>(B), static_cast<const float*>(C),
          static_cast<const float*>(A), static_cast<const float*>(D),
          static_cast<const float*>(h0), static_cast<float*>(y),
          static_cast<float*>(h_out), static_cast<float*>(h_ckpt), S, di);
  return (int)cudaGetLastError();
}
