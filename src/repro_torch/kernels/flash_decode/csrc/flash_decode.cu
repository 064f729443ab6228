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
// Design: the flash-decoding split.  The cache is cut along C into
// chunks of `chunk` positions (ops.decode_plan: enough blocks for about
// two an SM), and one block of four warps takes one (b, kh, tile of up
// to 8 query heads, chunk), so any G runs (G = 48 is six tiles).
//  * The block reads its chunk's mask once, as a bit mask a 32-position
//    tile, and lists the tiles with a valid position.  Only those are
//    copied: a tile with none is skipped before its copies are issued
//    (its weights would be exactly 0 whenever the row has a valid
//    position).
//  * K and V tiles go into shared memory in 16-byte pieces by cp.async,
//    in a ring of `stages` buffers, so the next tiles' copies overlap
//    this tile's arithmetic.  Rows are padded by 16 bytes, so the lanes
//    of a quarter warp, each reading its own position's row, hit
//    distinct banks.  q is staged once, in float32.
//  * Scores: warp w sums the dims [w hd/4, (w+1) hd/4) of every head's
//    dot product, a lane a position; the four partial sums meet in
//    shared memory.  Warp w then keeps the running (max, denominator) of
//    the heads w, w + 4 and parks the tile's weights in shared memory.
//  * Weighted V: thread t owns 16 bytes' worth of dims of one or two
//    heads and adds the tile's V rows, read from shared memory, into
//    float32 accumulators.
//  * Combine in one launch: each block writes its partial (m, l,
//    acc[heads][hd]) in float32 to a workspace; the last block of its
//    (b, kh, head tile) to finish, found by an atomic ticket after
//    __threadfence(), reads the first partials' acc while it computes
//    the factors exp(m_i - M), merges the partials in chunk order,
//    guards the denominator with max(l, 1e-30) as the Pallas kernel
//    does, writes o and resets the ticket.  So the result does not
//    depend on the order the blocks ran in.  When no chunk saw a valid
//    position the row has none, and the last block averages the row's
//    whole V cache.
//  * Head dims 32, 64, 128 and 256 (paligemma-3b's), one instance each.
//    Every per-thread extent follows from HD: at HD = 256 a float32 row
//    is 64 pieces, so the V pass has two head groups of 64 threads and
//    a thread carries 4 of a tile of 8 heads (bfloat16: 32 pieces, four
//    groups, 2 heads); the merge prefetches 4 chunks' acc either way.
//    A block's ring at 256 takes 147 KB of shared memory in float32
//    (one block an SM) and 82 KB in bfloat16 (two) at two stages.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;               // cache positions a tile
constexpr int kMinStages = 2, kMaxStages = 4;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes at p (shared or device memory) as float32 values.
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most `pending` of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    default: asm volatile("cp.async.wait_group 2;\n" ::); break;
  }
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
  float* ws;        // partial acc [pairs][chunks][gt][hd], then (m, l)
  int* tickets;     // [pairs], 0 between launches
  int b, kh, g, c;
  int chunk, n_chunks, n_gtiles, stages;
  float scale;                          // hd^-0.5
};

// Dynamic shared bytes of a block (ops.decode_plan's smem): the K/V
// ring, q, the warps' partial scores, the weights (rows of 33), the
// correction factors and denominators, the merge's factors, the tiles'
// bit masks and the list of tiles to copy, and three flags.
__host__ __device__ inline int smem_bytes(int elt, int hd, int gt, int chunk,
                                          int n_chunks, int stages) {
  const int vec = 16 / elt, tiles = chunk / kTile;
  return stages * 2 * kTile * (hd + vec) * elt +
         4 * (gt * hd + kWarps * gt * 32 + gt * 33 + 2 * gt + gt * n_chunks +
              2 * tiles + 3);
}

// GT is the block's tile of query heads; heads g0 + g with g >= gn do
// not exist (their q is 0 and their output is not written).
template <typename T, int HD, int GT>
__global__ void __launch_bounds__(kThreads) decode_kernel(const Params p) {
  constexpr int VEC = 16 / sizeof(T);   // values in a 16-byte piece
  constexpr int RS = HD + VEC;          // staged row stride (values)
  constexpr int DQ = HD / kWarps;       // dims a warp scores
  constexpr int NC = HD / VEC;          // 16-byte pieces of a row
  constexpr int NHG = kThreads / NC;    // head groups of the V pass
  constexpr int HPT = (GT + NHG - 1) / NHG;     // heads a thread in it
  constexpr int GW = (GT + kWarps - 1) / kWarps;  // heads a warp's softmax
  constexpr int STAGE = 2 * kTile * RS;  // K then V, values
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = p.chunk / kTile;
  T* ring = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(smem + p.stages * STAGE * sizeof(T));
  float* red = qs + GT * HD;            // [warp][g][lane]
  float* ps = red + kWarps * GT * 32;   // [g][33]
  float* corr = ps + GT * 33;           // [g]
  float* lsum = corr + GT;              // [g], merge
  float* fac = lsum + GT;               // [g][n_chunks], merge
  uint32_t* tmask = reinterpret_cast<uint32_t*>(fac + GT * p.n_chunks);
  int* act = reinterpret_cast<int*>(tmask + tiles);
  int* flags = act + tiles;             // tiles to copy, last block

  const int chunk = blockIdx.x % p.n_chunks;
  const int pair = blockIdx.x / p.n_chunks;     // (b, kh, head tile)
  const int bk = pair / p.n_gtiles;             // b * KH + kh
  const int kh = bk % p.kh, b = bk / p.kh;
  const int g0 = (pair % p.n_gtiles) * GT, gn = min(GT, p.g - g0);
  const long long row = (long long)p.kh * HD;   // cache stride of c
  const T* kb = (const T*)p.k + (long long)b * p.c * row + kh * HD;
  const T* vb = (const T*)p.v + (long long)b * p.c * row + kh * HD;
  const int32_t* valid = p.valid + (long long)b * p.c;
  const int c_lo = chunk * p.chunk, c_hi = min(c_lo + p.chunk, p.c);
  const int nt = (c_hi - c_lo + kTile - 1) / kTile;
  const long long head0 = (long long)bk * p.g + g0;

  const T* q = (const T*)p.q + head0 * HD;
  for (int i = tid; i < GT * HD; i += kThreads)
    qs[i] = i / HD < gn ? ld(q + i) : 0.0f;
  for (int t = warp; t < nt; t += kWarps) {
    const int c = c_lo + t * kTile + lane;
    const uint32_t bits = __ballot_sync(0xffffffffu, c < c_hi && valid[c]);
    if (lane == 0) tmask[t] = bits;
  }
  __syncthreads();
  if (warp == 0) {                      // list the tiles with a valid bit
    int n = 0;
    for (int t0 = 0; t0 < nt; t0 += 32) {
      const int t = t0 + lane;
      const bool live = t < nt && tmask[t] != 0u;
      const uint32_t bal = __ballot_sync(0xffffffffu, live);
      if (live) act[n + __popc(bal & ((1u << lane) - 1u))] = t;
      n += __popc(bal);
    }
    if (lane == 0) flags[0] = n;
  }
  __syncthreads();
  const int n_act = flags[0];

  // copy listed tile i (K and V rows in range) into ring buffer i % stages
  auto issue = [&](int i) {
    if (i < n_act) {
      const int c0 = c_lo + act[i] * kTile, n_in = min(kTile, c_hi - c0);
      T* ks = ring + (i % p.stages) * STAGE;
      for (int j = tid; j < n_in * NC; j += kThreads) {
        const int r = j / NC, x = (j % NC) * VEC;
        const long long off = (long long)(c0 + r) * row + x;
        cp_async16(ks + r * RS + x, kb + off);
        cp_async16(ks + kTile * RS + r * RS + x, vb + off);
      }
    }
    cp_async_commit();                  // a group a call, empty or not
  };

  const int col = tid % NC, hg = tid / NC;
  float m_run[GW], l_run[GW], acc[HPT][VEC];
#pragma unroll
  for (int j = 0; j < GW; ++j) {
    m_run[j] = -INFINITY;
    l_run[j] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < HPT; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[j][e] = 0.0f;

  for (int i = 0; i < p.stages - 1; ++i) issue(i);
  for (int i = 0; i < n_act; ++i) {
    cp_async_wait(p.stages - 2);        // this thread's copies of tile i
    __syncthreads();                    // everyone's; tile i - 1 done
    issue(i + p.stages - 1);            // into tile i - 1's buffer
    const int t = act[i];
    const int n_in = min(kTile, c_hi - (c_lo + t * kTile));
    const uint32_t bits = tmask[t];
    const T* ks = ring + (i % p.stages) * STAGE;
    const T* vs = ks + kTile * RS;

    // partial scores: dims [warp DQ, (warp + 1) DQ), lane -> position
    float s[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) s[g] = 0.0f;
#pragma unroll
    for (int j = 0; j < DQ / VEC; ++j) {
      const int d = warp * DQ + j * VEC;
      float kf[VEC];
      load16(ks + lane * RS + d, kf);
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qs + g * HD + d + e);
          s[g] += qv.x * kf[e] + qv.y * kf[e + 1] + qv.z * kf[e + 2] +
                  qv.w * kf[e + 3];
        }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) red[(warp * GT + g) * 32 + lane] = s[g];
    __syncthreads();

    // online softmax: warp -> heads warp, warp + 4; lane -> position.
    // A masked position (or one past C) weighs exactly 0: the tile has a
    // valid position, so the running max is a finite score.
#pragma unroll
    for (int j = 0; j < GW; ++j) {
      const int g = warp + kWarps * j;
      if (g < GT) {
        float sc = red[g * 32 + lane];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) sc += red[(w * GT + g) * 32 + lane];
        sc = (bits >> lane) & 1u ? sc * p.scale : -INFINITY;
        const float m_new = fmaxf(m_run[j], warp_max(sc));
        const float pe = expf(sc - m_new);
        const float cr = expf(m_run[j] - m_new);
        l_run[j] = l_run[j] * cr + warp_sum(pe);
        m_run[j] = m_new;
        ps[g * 33 + lane] = pe;
        if (lane == 0) corr[g] = cr;
      }
    }
    __syncthreads();

    // weighted V: thread -> dims [col VEC, (col + 1) VEC) of heads hg + NHG j
#pragma unroll
    for (int j = 0; j < HPT; ++j) {
      const int g = hg + NHG * j;
      if (g < GT) {
        const float cr = corr[g];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[j][e] *= cr;
      }
    }
    auto add_row = [&](int r) {
      float vf[VEC];
      load16(vs + r * RS + col * VEC, vf);
#pragma unroll
      for (int j = 0; j < HPT; ++j) {
        const int g = hg + NHG * j;
        if (g < GT) {
          const float w = ps[g * 33 + r];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[j][e] += w * vf[e];
        }
      }
    };
    if (n_in == kTile) {                // rows' reads in flight together
#pragma unroll 8
      for (int r = 0; r < kTile; ++r) add_row(r);
    } else {
      for (int r = 0; r < n_in; ++r) add_row(r);
    }
  }
  cp_async_wait(0);

  // this chunk's partial; a chunk without a valid position writes m = -inf,
  // l = 0 and acc = 0
  const long long n_pairs = (long long)p.b * p.kh * p.n_gtiles;
  float* ws_acc = p.ws;
  float* ws_ml = p.ws + n_pairs * p.n_chunks * GT * HD;
  const long long part = (long long)pair * p.n_chunks + chunk;
#pragma unroll
  for (int j = 0; j < HPT; ++j) {
    const int g = hg + NHG * j;
    if (g < gn) {
      float* dst = ws_acc + (part * GT + g) * HD + col * VEC;
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        *reinterpret_cast<float4*>(dst + e) =
            make_float4(acc[j][e], acc[j][e + 1], acc[j][e + 2], acc[j][e + 3]);
    }
  }
#pragma unroll
  for (int j = 0; j < GW; ++j) {
    const int g = warp + kWarps * j;
    if (g < gn && lane == 0) {
      float* ml = ws_ml + (part * GT + g) * 2;
      ml[0] = m_run[j];
      ml[1] = l_run[j];
    }
  }
  __syncthreads();                      // the block's partial written
  if (tid == 0) {
    __threadfence();                    // ... and visible to the card
    const bool last = atomicAdd(p.tickets + pair, 1) == p.n_chunks - 1;
    if (last) {
      p.tickets[pair] = 0;              // for the next launch
      __threadfence();                  // the others' partials, before reads
    }
    flags[1] = last;
  }
  __syncthreads();
  if (!flags[1]) return;

  // the last block: merge the pair's partials in chunk order.  Factors
  // exp(m_i - M) and the denominator first: warp -> heads warp + 4 j,
  // lane -> chunks lane, lane + 32, ...; M = -inf for head 0 says no chunk
  // saw a valid position (every head shares the row's mask).
  const long long base = (long long)pair * p.n_chunks;
  const int nc = p.n_chunks;
  auto ml_of = [&](int i, int g, int which) {
    return __ldcg(ws_ml + ((base + i) * GT + g) * 2 + which);
  };
  // the first PF chunks' acc, read now so the reads overlap the factors'
  constexpr int PF = 16 / (HPT * VEC / 4);
  float4 pre[HPT][PF][VEC / 4];
#pragma unroll
  for (int j = 0; j < HPT; ++j) {
    const float* src = ws_acc + (base * GT + hg + NHG * j) * HD + col * VEC;
#pragma unroll
    for (int i = 0; i < PF; ++i)
#pragma unroll
      for (int e = 0; e < VEC / 4; ++e)
        pre[j][i][e] = hg + NHG * j < gn && i < nc
                           ? __ldcg(reinterpret_cast<const float4*>(
                                 src + (long long)i * GT * HD) + e)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int j = 0; j < GW; ++j) {
    const int g = warp + kWarps * j;
    if (g < gn) {
      const float m0 = lane < nc ? ml_of(lane, g, 0) : -INFINITY;
      const float l0 = lane < nc ? ml_of(lane, g, 1) : 0.0f;
      float mx = m0;
      for (int i = lane + 32; i < nc; i += 32) mx = fmaxf(mx, ml_of(i, g, 0));
      mx = warp_max(mx);
      auto factor = [&](float mi) {
        return mi == -INFINITY ? 0.0f : expf(mi - mx);
      };
      float l = 0.0f;
      if (lane < nc) {
        const float f = factor(m0);
        fac[g * nc + lane] = f;
        l = l0 * f;
      }
      for (int i = lane + 32; i < nc; i += 32) {
        const float f = factor(ml_of(i, g, 0));
        fac[g * nc + i] = f;
        l += ml_of(i, g, 1) * f;
      }
      l = warp_sum(l);
      if (lane == 0) {
        lsum[g] = fmaxf(l, 1e-30f);
        if (g == 0) flags[2] = mx == -INFINITY;
      }
    }
  }
  __syncthreads();
  T* o = (T*)p.o + head0 * HD;
  if (flags[2]) {
    // no valid position in the row: every score is -1e30, the weights
    // uniform, and o the mean of the row's V rows, for every head
    float sum[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) sum[e] = 0.0f;
#pragma unroll 4
    for (int r = hg; r < p.c; r += NHG) {
      float vf[VEC];
      load16(vb + r * row + col * VEC, vf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) sum[e] += vf[e];
    }
    float* part_sum = reinterpret_cast<float*>(smem);   // [NHG][HD]
#pragma unroll
    for (int e = 0; e < VEC; ++e) part_sum[hg * HD + col * VEC + e] = sum[e];
    __syncthreads();
    for (int i = tid; i < gn * HD; i += kThreads) {
      const int d = i % HD;
      float tot = 0.0f;
      for (int h = 0; h < NHG; ++h) tot += part_sum[h * HD + d];
      st(o + i, tot / (float)p.c);
    }
    return;
  }
  // the weighted sum of the partials' acc, chunk by chunk
#pragma unroll
  for (int j = 0; j < HPT; ++j) {
    const int g = hg + NHG * j;
    if (g < gn) {
      float num[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) num[e] = 0.0f;
      const float* src = ws_acc + (base * GT + g) * HD + col * VEC;
      auto add = [&](float f, const float4& a, int e) {
        num[e] += a.x * f;
        num[e + 1] += a.y * f;
        num[e + 2] += a.z * f;
        num[e + 3] += a.w * f;
      };
#pragma unroll
      for (int i = 0; i < PF; ++i)
        if (i < nc)
#pragma unroll
          for (int e = 0; e < VEC; e += 4)
            add(fac[g * nc + i], pre[j][i][e / 4], e);
#pragma unroll 16
      for (int i = PF; i < nc; ++i)
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          add(fac[g * nc + i],
              __ldcg(reinterpret_cast<const float4*>(
                  src + (long long)i * GT * HD + e)), e);
      const float den = lsum[g];
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        st(o + g * HD + col * VEC + e, num[e] / den);
    }
  }
}

template <typename T, int HD, int GT>
cudaError_t launch_one(const Params& p, int smem, cudaStream_t stream) {
  auto fn = decode_kernel<T, HD, GT>;
  static int allowed = 48 * 1024;       // dynamic shared bytes admitted
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const long long blocks = (long long)p.b * p.kh * p.n_gtiles * p.n_chunks;
  fn<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_hd(const Params& p, int gt, int smem, cudaStream_t st) {
  switch (gt) {
    case 1: return launch_one<T, HD, 1>(p, smem, st);
    case 2: return launch_one<T, HD, 2>(p, smem, st);
    case 4: return launch_one<T, HD, 4>(p, smem, st);
    case 8: return launch_one<T, HD, 8>(p, smem, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const Params& p, int hd, int gt, int smem,
                   cudaStream_t st) {
  switch (hd) {
    case 32: return launch_hd<T, 32>(p, gt, smem, st);
    case 64: return launch_hd<T, 64>(p, gt, smem, st);
    case 128: return launch_hd<T, 128>(p, gt, smem, st);
    case 256: return launch_hd<T, 256>(p, gt, smem, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared bytes of a block of the plan (ops.DecodePlan.smem);
// dtype 0: float32, 1: bfloat16.
int flash_decode_smem_bytes(int dtype, int hd, int gt, int chunk,
                            int n_chunks, int stages) {
  return smem_bytes(dtype == 1 ? 2 : 4, hd, gt, chunk, n_chunks, stages);
}

// q (B, KH, G, hd), k and v (B, C, KH, hd), valid (B, C) int32, o like q;
// all contiguous, q, k and v 16-byte aligned.  dtype 0: float32, 1:
// bfloat16 (q, k, v, o).  Any G, hd in {32, 64, 128, 256}; scale is
// hd^-0.5.
// The plan (ops.decode_plan): gt heads a block, chunks of `chunk`
// positions (a multiple of 32), `stages` ring buffers, `smem` shared
// bytes.  ws: B KH ceil(G / gt) ceil(C / chunk) gt (hd + 2) float32;
// tickets: B KH ceil(G / gt) int32, zero (and left zero).  Returns the
// launch's cudaError_t.
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const int32_t* valid, void* o, float* ws,
                        int* tickets, int b, int kh, int g, int c, int hd,
                        float scale, int dtype, int gt, int chunk,
                        int stages, int smem, void* stream) {
  if (b <= 0 || kh <= 0 || g <= 0 || c <= 0) return 0;
  const int n_chunks = (c + chunk - 1) / chunk;
  if (chunk < kTile || chunk % kTile || stages < kMinStages ||
      stages > kMaxStages ||
      smem != flash_decode_smem_bytes(dtype, hd, gt, chunk, n_chunks, stages))
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, valid, o, ws, tickets, b, kh, g, c, chunk,
                 n_chunks, (g + gt - 1) / gt, stages, scale};
  if ((long long)b * kh * p.n_gtiles * n_chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch<float>(p, hd, gt, smem, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, hd, gt, smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
