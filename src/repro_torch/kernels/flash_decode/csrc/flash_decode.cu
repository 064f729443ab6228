// Decode attention: one query token per sequence against a KV cache, sm_90a.
//
// Replaces: src/repro/kernels/flash_decode/kernel.py:59 flash_decode
// (Pallas body _kernel :23).  For q (B, KH, G, hd), caches (B, C, KH, hd)
// and valid (B, C) int32, float32 or bfloat16 in and out:
//   s_c = q . k_c * hd^-0.5 where valid[b, c], else -1e30
//   o   = sum_c softmax(s)_c v_c, online softmax in float32,
// so a row with no valid position averages the whole cache (the Pallas
// kernel's and the plain version's answer), finite, never 0/0.
//
// What bounds it on the H100: bytes.  Each valid cache position's K and
// V rows (8 hd bytes in float32) serve G query heads, ~4 G hd operations:
// G/2 operations a byte, 4 at G = 8, against the card's 20.  The least
// time is the valid positions' K and V rows (and q, valid, o) over
// 3.35 TB/s; masked positions add exactly 0 unless the whole row is
// masked.
//
// Design: one block of four warps per (b, kh, tile of up to 8 of the G
// query heads), so any G runs (G = 48 for granite's MQA is six tiles).
// The warps take turns over 32-position tiles of the cache.  A tile with
// no valid position is skipped when the row has one (its weights would be
// exactly 0); a row with none reads the whole cache.  In a tile each lane
// scores one cache position for the tile's heads (q staged once in shared
// memory), the warp updates each head's running (max, denominator) with
// shuffles, parks the tile's weights in shared memory, and then the lanes
// switch to owning head dims: each lane adds the weighted V rows into its
// hd/32 dims of every head's float32 accumulator, reading V coalesced.
// At the end the four warps' partial softmaxes are combined in shared
// memory, and the denominator is guarded with max(l, 1e-30) as the
// Pallas kernel does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;       // the Pallas kernel's mask value

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* valid;
  void* o;
  int b, kh, g, c;
  float scale;                          // hd^-0.5
};

// G here is the block's tile of query heads; heads g0 + g with g >= gn
// do not exist (their q is 0 and their output is not written).
template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads) decode_kernel(const Params p) {
  constexpr int PD = HD / 32;           // head dims per lane
  __shared__ float qs[G][HD];
  __shared__ float ps[kWarps][G][32];
  __shared__ float wm[kWarps][G], wl[kWarps][G];
  __shared__ float wacc[kWarps][G][HD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kh = blockIdx.x, b = blockIdx.y, g0 = blockIdx.z * G;
  const int gn = min(G, p.g - g0);
  const long long row = (long long)p.kh * HD;       // cache stride of c
  const T* k = (const T*)p.k + (long long)b * p.c * row + kh * HD;
  const T* v = (const T*)p.v + (long long)b * p.c * row + kh * HD;
  const int32_t* valid = p.valid + (long long)b * p.c;
  const long long head0 = ((long long)b * p.kh + kh) * p.g + g0;
  const T* q = (const T*)p.q + head0 * HD;
  for (int i = tid; i < G * HD; i += kThreads)
    qs[i / HD][i % HD] = i / HD < gn ? ld(q + i) : 0.0f;
  int seen = 0;
  for (int c = tid; c < p.c && !seen; c += kThreads) seen = valid[c] != 0;
  const bool row_valid = __syncthreads_or(seen);    // also orders qs

  float m[G], l[G], acc[G][PD];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < PD; ++i) acc[g][i] = 0.0f;
  }

  for (int c0 = warp * 32; c0 < p.c; c0 += kWarps * 32) {
    // scores: lane -> cache position c0 + lane, all G heads
    const int c = c0 + lane;
    const bool in = c < p.c;
    const bool ok = in && valid[in ? c : 0] != 0;
    // every position masked: each weight would be exactly 0 (or, before
    // the warp's first valid score, reset to 0 by its correction factor)
    if (row_valid && __ballot_sync(0xffffffffu, ok) == 0u) continue;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.0f;
    if (in) {
      const T* kr = k + c * row;
      for (int d = 0; d < HD; ++d) {
        const float kv = ld(kr + d);
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] += qs[g][d] * kv;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      // masked positions score -1e30; positions past C do not exist
      const float sg = ok ? s[g] * p.scale : kNegInf;
      const float m_new = fmaxf(m[g], warp_max(in ? sg : kNegInf));
      const float pg = in ? expf(sg - m_new) : 0.0f;
      const float corr = expf(m[g] - m_new);
      l[g] = l[g] * corr + warp_sum(pg);
      m[g] = m_new;
      ps[warp][g][lane] = pg;
#pragma unroll
      for (int i = 0; i < PD; ++i) acc[g][i] *= corr;
    }
    __syncwarp();
    // weighted V rows: lane -> head dims lane + 32 i
    const int n_in = min(32, p.c - c0);
    for (int j = 0; j < n_in; ++j) {
      const T* vr = v + (c0 + j) * row;
#pragma unroll
      for (int i = 0; i < PD; ++i) {
        const float vv = ld(vr + lane + 32 * i);
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g][i] += ps[warp][g][j] * vv;
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      wm[warp][g] = m[g];
      wl[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < PD; ++i) wacc[warp][g][lane + 32 * i] = acc[g][i];
  }
  __syncthreads();
  T* o = (T*)p.o + head0 * HD;
  for (int i = tid; i < gn * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w][g]);
    float den = 0.0f, num = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(wm[w][g] - mx);
      den += wl[w][g] * f;
      num += wacc[w][g][d] * f;
    }
    st(o + i, num / fmaxf(den, 1e-30f));
  }
}

// The tile of heads a block takes: G itself up to 8 (rounded up to a
// power of two), else 8 and ceil(G / 8) blocks along z.
template <typename T, int HD>
cudaError_t launch_hd(const Params& p, cudaStream_t stream) {
  const int gt = p.g <= 1 ? 1 : p.g <= 2 ? 2 : p.g <= 4 ? 4 : 8;
  const dim3 grid(p.kh, p.b, (p.g + gt - 1) / gt);
  switch (gt) {
    case 1: decode_kernel<T, HD, 1><<<grid, kThreads, 0, stream>>>(p); break;
    case 2: decode_kernel<T, HD, 2><<<grid, kThreads, 0, stream>>>(p); break;
    case 4: decode_kernel<T, HD, 4><<<grid, kThreads, 0, stream>>>(p); break;
    default: decode_kernel<T, HD, 8><<<grid, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_hd<T, 32>(p, stream);
    case 64: return launch_hd<T, 64>(p, stream);
    case 128: return launch_hd<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, KH, G, hd), k and v (B, C, KH, hd), valid (B, C) int32, o like q;
// all contiguous.  dtype 0: float32, 1: bfloat16 (q, k, v, o).  Any G,
// hd in {32, 64, 128}; scale is hd^-0.5.  Returns the launch's
// cudaError_t.
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const int32_t* valid, void* o, int b, int kh, int g,
                        int c, int hd, float scale, int dtype, void* stream) {
  if (b <= 0 || kh <= 0 || g <= 0 || c <= 0) return 0;
  if (b > 65535 || (g + 7) / 8 > 65535) return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, valid, o, b, kh, g, c, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch<float>(p, hd, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, hd, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
