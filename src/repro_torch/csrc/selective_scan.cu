// Selective scan (the Mamba layer's SSM recurrence) for Hopper.
//
// Replaces no Pallas kernel: the reference runs the recurrence as a
// jax.lax.scan over tokens, `_ssm_scan` in src/repro/models/mamba.py:60.
// A loop over tokens in PyTorch would launch some eight kernels a token in
// every Mamba layer (about 114,000 for a 14,211-token prompt), so the port
// computes the scan's function in one launch, prefill and decode alike:
//
//   x, dt (Bt, S, di); B, C (Bt, S, 16); A (di, 16) = -exp(A_log);
//   D (di,); h0 (Bt, di, 16) float32
//   per token:  dA = exp(dt A),  h = dA h + (dt B) x,  y = sum_n h C + D x
//   -> y (Bt, S, di) float32, h after token S-1 (Bt, di, 16) float32
//
// in the reference's arithmetic order, every input widened to float32.  A
// padded position arrives with dt = 0: exp(0) = 1 and (dt B) x = 0 leave h
// as it was, so no mask is needed, and with trailing padding the final
// state is the state after the row's last valid token.  S = 1 is the
// decode step.
//
// What bounds it: bytes.  Per (token, channel) it reads x (2 bytes, bf16)
// and dt (4) and writes y (4), against 16 states x 8 float32 operations
// (dt A, its exp, dt B, times x, dA h, the add, h C and its sum): 10 bytes
// at 3.35 TB/s take longer than 128 operations at 67 TFLOP/s.  This simple
// design is held by its instruction throughput instead (expf is
// several of them, and the y sum takes 4 shuffles).
//
// Design (simple first): one thread per (row, channel, state) keeps h in a
// register; a CTA holds 32 channels x 16 states of one row and walks the
// row's tokens in order.  The tokens come in chunks of kChunk: x and dt of
// the CTA's 32 channels and the row's B and C (shared by every channel)
// are staged in shared memory as float32, the chunk's recurrence runs,
// y is reduced over the 16 states with width-16 warp shuffles into shared
// memory, and the chunk's y is stored with neighbouring threads on
// neighbouring channels.  expf, not __expf: the build uses no fast-math
// flag.  A chunked parallel scan and cp.async loads that overlap the next
// chunk are later work.
#include "common.cuh"

namespace {

constexpr int kStates = 16;              // d_state, one half-warp per channel
constexpr int kChannels = 32;            // channels per CTA
constexpr int kThreads = kChannels * kStates;
constexpr int kChunk = 64;               // tokens staged per pass

template <typename T>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const float* __restrict__ A,
                      const float* __restrict__ Dskip,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_out, int S, int di) {
  __shared__ float xs[kChunk][kChannels];
  __shared__ float dts[kChunk][kChannels];
  __shared__ float bsm[kChunk][kStates];
  __shared__ float csm[kChunk][kStates];
  __shared__ float ys[kChunk][kChannels];

  const int tid = threadIdx.x;
  const int cl = tid / kStates;          // the thread's channel in the CTA
  const int n = tid % kStates;           // its state
  const int c0 = blockIdx.x * kChannels;
  const int c = c0 + cl;
  const size_t b = blockIdx.y;
  const bool live = c < di;
  const float a = live ? A[(size_t)c * kStates + n] : 0.f;
  const float dskip = live ? Dskip[c] : 0.f;
  float h = live ? h0[(b * di + c) * kStates + n] : 0.f;
  const size_t row = b * S;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n_tok = min(kChunk, S - t0);
    for (int i = tid; i < n_tok * kChannels; i += kThreads) {
      const int t = i / kChannels, cc = i % kChannels;
      const size_t off = (row + t0 + t) * di + c0 + cc;
      const bool in = c0 + cc < di;
      xs[t][cc] = in ? to_f32(x[off]) : 0.f;
      dts[t][cc] = in ? dt[off] : 0.f;
    }
    for (int i = tid; i < n_tok * kStates; i += kThreads) {
      const int t = i / kStates, s = i % kStates;
      const size_t off = (row + t0 + t) * kStates + s;
      bsm[t][s] = to_f32(Bm[off]);
      csm[t][s] = to_f32(Cm[off]);
    }
    __syncthreads();
    for (int t = 0; t < n_tok; ++t) {
      const float d = dts[t][cl];
      const float xv = xs[t][cl];
      h = expf(d * a) * h + d * bsm[t][n] * xv;
      float p = h * csm[t][n];
#pragma unroll
      for (int o = kStates / 2; o > 0; o >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, o, kStates);
      if (n == 0) ys[t][cl] = p + dskip * xv;
    }
    __syncthreads();
    for (int i = tid; i < n_tok * kChannels; i += kThreads) {
      const int t = i / kChannels, cc = i % kChannels;
      if (c0 + cc < di) y[(row + t0 + t) * di + c0 + cc] = ys[t][cc];
    }
    // the next chunk's staging writes xs, dts, bsm and csm, which every
    // thread finished reading before the barrier above; ys is written
    // again only after the next chunk's first barrier, which every thread
    // reaches after its stores here
  }
  if (live) h_out[(b * di + c) * kStates + n] = h;
}

}  // namespace

// x, B, C in `dtype` (kFloat32 or kBFloat16); dt, A, D, h0, y and h_out
// float32; all contiguous.  d_state must be 16.
extern "C" int launch_selective_scan(const void* x, const void* dt,
                                     const void* B, const void* C,
                                     const void* A, const void* D,
                                     const void* h0, void* y, void* h_out,
                                     int Bt, int S, int di, int ds,
                                     int dtype, void* stream) {
  if (ds != kStates || Bt < 0 || S < 0 || di <= 0 || Bt > 65535)
    return (int)cudaErrorInvalidValue;
  if (Bt == 0) return (int)cudaGetLastError();
  const dim3 grid((di + kChannels - 1) / kChannels, Bt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  const float* h0f = static_cast<const float*>(h0);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h_out);
  if (dtype == kBFloat16)
    selective_scan_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), dtf,
        static_cast<const __nv_bfloat16*>(B),
        static_cast<const __nv_bfloat16*>(C), Af, Df, h0f, yf, hf, S, di);
  else if (dtype == kFloat32)
    selective_scan_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), dtf, static_cast<const float*>(B),
        static_cast<const float*>(C), Af, Df, h0f, yf, hf, S, di);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
