// Mamba-1 selective scan, sm_90a.
//
// Replaces: src/repro/kernels/selective_scan/kernel.py:51 selective_scan
// (Pallas body _kernel :23).  For dt, x (B, S, D), Bm, Cm (B, S, N),
// A (D, N) and Dskip (D,), float32 or bfloat16 in, float32 state:
//   h_s = exp(dt_s * A) * h_{s-1} + (dt_s * x_s) * Bm_s      (h_{-1} = 0)
//   y_s = h_s . Cm_s + Dskip * x_s
// y is written in the input type; the last state h_{S-1} (B, D, N) is
// written in float32 too (the Pallas kernel keeps it in scratch only; the
// port's mamba_forward needs it for the decode cache).
//
// What bounds it on the H100: the recurrence's latency.  The work is small
// (~7 N + 4 float32 operations and one exp per N for each (b, s, d)) and
// the bytes are ~4 (2 D + 2 N) per step, but step s needs step s - 1, so
// each channel is a chain of S dependent updates.  The roofline bound
// (bytes over 3.35 TB/s, operations over 67 TFLOP/s) is far below what a
// chain of S steps can reach; the design spreads the B * D independent
// chains over the card instead.
//
// Design: one thread per (b, d) channel holding its N state values in
// registers, 64 channels to a block.  The block walks S in 64-step chunks;
// for each chunk it stages the chunk's Bm and Cm rows, which all channels
// of b share, in shared memory as float32, then each thread runs the
// chunk's steps reading dt and x coalesced across d.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;            // channels per block
constexpr int kChunk = 64;              // steps per staged chunk

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Params {
  const void* dt;
  const void* bm;
  const void* cm;
  const void* x;
  const float* a;
  const float* d_skip;
  void* y;
  float* h_last;
  int b, s, d;
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) scan_kernel(const Params p) {
  __shared__ float bs[kChunk][N];
  __shared__ float cs[kChunk][N];
  const int tid = threadIdx.x;
  const int d = blockIdx.x * kThreads + tid, b = blockIdx.y;
  const bool live = d < p.d;
  const long long base = (long long)b * p.s;
  const T* dt = (const T*)p.dt;
  const T* x = (const T*)p.x;
  const T* bm = (const T*)p.bm + base * N;
  const T* cm = (const T*)p.cm + base * N;
  T* y = (T*)p.y;

  float a[N], h[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    a[i] = live ? p.a[(long long)d * N + i] : 0.0f;
    h[i] = 0.0f;
  }
  const float dsk = live ? p.d_skip[d] : 0.0f;

  for (int s0 = 0; s0 < p.s; s0 += kChunk) {
    const int steps = min(kChunk, p.s - s0);
    __syncthreads();                    // the previous chunk is consumed
    for (int i = tid; i < steps * N; i += kThreads) {
      bs[i / N][i % N] = ld(bm + (long long)s0 * N + i);
      cs[i / N][i % N] = ld(cm + (long long)s0 * N + i);
    }
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < steps; ++t) {
      const long long o = (base + s0 + t) * p.d + d;
      const float dtv = ld(dt + o), xv = ld(x + o);
      const float dx = dtv * xv;
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        h[i] = expf(dtv * a[i]) * h[i] + dx * bs[t][i];
        acc += h[i] * cs[t][i];
      }
      st(y + o, acc + dsk * xv);
    }
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < N; ++i) p.h_last[((long long)b * p.d + d) * N + i] = h[i];
}

template <typename T>
cudaError_t launch(const Params& p, int n, cudaStream_t stream) {
  const dim3 grid((p.d + kThreads - 1) / kThreads, p.b);
  switch (n) {
    case 4: scan_kernel<T, 4><<<grid, kThreads, 0, stream>>>(p); break;
    case 8: scan_kernel<T, 8><<<grid, kThreads, 0, stream>>>(p); break;
    case 16: scan_kernel<T, 16><<<grid, kThreads, 0, stream>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dt and x (B, S, D), bm and cm (B, S, N) in one type (dtype 0: float32,
// 1: bfloat16), y (B, S, D) in that type; a (D, N), d_skip (D,) and h_last
// (B, D, N) float32; all contiguous.  N in {4, 8, 16}.  Returns the
// launch's cudaError_t.
int selective_scan_launch(const void* dt, const void* bm, const void* cm,
                          const void* x, const float* a, const float* d_skip,
                          void* y, float* h_last, int b, int s, int d, int n,
                          int dtype, void* stream) {
  if (b <= 0 || s <= 0 || d <= 0) return 0;
  if (b > 65535) return (int)cudaErrorInvalidValue;
  const Params p{dt, bm, cm, x, a, d_skip, y, h_last, b, s, d};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch<float>(p, n, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, n, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
