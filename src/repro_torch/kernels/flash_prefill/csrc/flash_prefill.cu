// Causal GQA prefill attention with an optional sliding window, sm_90a.
//
// Replaces: src/repro/kernels/flash_prefill/kernel.py:79 flash_prefill
// (Pallas body _kernel :25).  For q (B, KH, G, S, hd) and k, v
// (B, KH, S, hd), float32 or bfloat16, each query row (b, kh, g, s)
// attends to keys t <= s (and t > s - window when a window is given):
//   o = softmax(q . k^T * hd^-0.5) v, online softmax in float32.
//
// What bounds it on the H100: operations.  ~4 hd float32 operations per
// visible (query, key) pair, 2 S^2 hd per (b, head), against ~8 S hd bytes
// per (b, head) read and written (q and o in float32; K and V are shared
// by the G heads): S/4 operations a byte, 128 at the serving path's
// S = 512, above the card's 20 (67 TFLOP/s over 3.35 TB/s).
// This first kernel uses the CUDA cores, not the tensor cores (wgmma is for
// a later PR), so its bound is the float32 non-tensor rate.
//
// Design: one block per (b, kh, tile of 64 query rows), where the rows of
// a kv head are ordered (s, g): the G query heads that share a K/V row sit
// next to each other, so one staged K/V tile serves all of them and a
// block's causal range is that of ~64/G positions.  Four threads share a
// row: each holds a quarter of q and of the float32 accumulator in
// registers (interleaved dims, so the four read adjacent shared-memory
// banks), and two shuffles finish each dot product.  The block walks the
// 32-key tiles that can hold a visible key (skipping tiles above the
// diagonal or wholly outside the window, as the Pallas kernel skips
// blocks), staging each K/V tile in shared memory as float32; per tile
// each row keeps (max, denominator, accumulator).  Inside a tile keys past
// S, above the diagonal or outside the window get weight 0.  Strides are
// arguments, so q, k, v and o may be permuted views of (B, S, H, hd).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTpr = 4;                 // threads per query row
constexpr int kRows = 64;               // query rows per block
constexpr int kThreads = kRows * kTpr;  // 256
constexpr int kBk = 32;                 // keys per tile
constexpr float kNegInf = -1e30f;       // the Pallas kernel's mask value

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int b, kh, g, s, window;              // window <= 0: none
  float scale;                          // hd^-0.5
  long long qsb, qsk, qsg, qss;         // element strides; hd stride is 1
  long long ksb, ksk, kss;
  long long vsb, vsk, vss;
  long long osb, osk, osg, oss;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) prefill_kernel(const Params p) {
  constexpr int PT = HD / kTpr;         // dims per thread
  __shared__ float ks[kBk][HD];
  __shared__ float vs[kBk][HD];
  const int tid = threadIdx.x, sub = tid % kTpr;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int n_rows = p.g * p.s;
  const int r0 = blockIdx.x * kRows;
  const int r = r0 + tid / kTpr;
  const bool active = r < n_rows;
  const int sq = active ? r / p.g : 0, gq = active ? r % p.g : 0;
  const T* q = (const T*)p.q;
  const T* k = (const T*)p.k + b * p.ksb + kh * p.ksk;
  const T* v = (const T*)p.v + b * p.vsb + kh * p.vsk;

  float qr[PT], acc[PT];
  const T* qrow = q + b * p.qsb + kh * p.qsk + gq * p.qsg + sq * p.qss;
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    qr[i] = active ? ld(qrow + i * kTpr + sub) : 0.0f;
    acc[i] = 0.0f;
  }
  float m = kNegInf, l = 0.0f;

  // the block's positions and the key tiles that can hold a visible key
  const int s_lo = r0 / p.g;
  const int s_hi = (min(r0 + kRows, n_rows) - 1) / p.g;
  const int t_first = p.window > 0 ? max(0, s_lo - p.window + 1) / kBk : 0;
  const int t_last = s_hi / kBk;

  for (int t = t_first; t <= t_last; ++t) {
    const int k0 = t * kBk;
    __syncthreads();                    // the previous tile is consumed
    for (int idx = tid; idx < kBk * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD;
      const bool in = k0 + j < p.s;
      ks[j][d] = in ? ld(k + (long long)(k0 + j) * p.kss + d) : 0.0f;
      vs[j][d] = in ? ld(v + (long long)(k0 + j) * p.vss + d) : 0.0f;
    }
    __syncthreads();

    float sc[kBk];
    uint32_t ok_mask = 0;               // bit j: key k0 + j is visible
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBk; ++j) {
      float part = 0.0f;
#pragma unroll
      for (int i = 0; i < PT; ++i) part += qr[i] * ks[j][i * kTpr + sub];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int key = k0 + j;
      const bool ok = active && key < p.s && key <= sq &&
                      (p.window <= 0 || key > sq - p.window);
      sc[j] = part * p.scale;
      if (ok) {
        ok_mask |= 1u << j;
        tile_max = fmaxf(tile_max, sc[j]);
      }
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < kBk; ++j) {
      sc[j] = (ok_mask >> j) & 1u ? expf(sc[j] - m_new) : 0.0f;
      psum += sc[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      float a = acc[i] * corr;
#pragma unroll
      for (int j = 0; j < kBk; ++j) a += sc[j] * vs[j][i * kTpr + sub];
      acc[i] = a;
    }
    m = m_new;
  }

  if (!active) return;
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  T* orow = (T*)p.o + b * p.osb + kh * p.osk + gq * p.osg + sq * p.oss;
#pragma unroll
  for (int i = 0; i < PT; ++i) st(orow + i * kTpr + sub, acc[i] * inv);
}

template <typename T>
cudaError_t launch(const Params& p, int hd, cudaStream_t stream) {
  const dim3 grid((p.g * p.s + kRows - 1) / kRows, p.kh, p.b);
  switch (hd) {
    case 32: prefill_kernel<T, 32><<<grid, kThreads, 0, stream>>>(p); break;
    case 64: prefill_kernel<T, 64><<<grid, kThreads, 0, stream>>>(p); break;
    case 128: prefill_kernel<T, 128><<<grid, kThreads, 0, stream>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, KH, G, S, hd), k and v (B, KH, S, hd), o like q; each given by its
// element strides, with the hd dim contiguous.  dtype 0: float32, 1:
// bfloat16 (all four tensors).  window <= 0: no window.  hd in {32, 64,
// 128}; scale is hd^-0.5.  Returns the launch's cudaError_t.
int flash_prefill_launch(const void* q, const void* k, const void* v,
                         void* o, int b, int kh, int g, int s, int hd,
                         int window, float scale, int dtype, long long qsb,
                         long long qsk, long long qsg, long long qss,
                         long long ksb, long long ksk, long long kss,
                         long long vsb, long long vsk, long long vss,
                         long long osb, long long osk, long long osg,
                         long long oss, void* stream) {
  if (b <= 0 || kh <= 0 || g <= 0 || s <= 0) return 0;
  if (kh > 65535 || b > 65535) return (int)cudaErrorInvalidValue;
  const Params p{q,   k,   v,   o,   b,   kh,  g,   s,   window, scale,
                 qsb, qsk, qsg, qss, ksb, ksk, kss, vsb, vsk,   vss,
                 osb, osk, osg, oss};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch<float>(p, hd, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, hd, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
