// Causal GQA prefill attention with an optional sliding window, sm_90a.
//
// Replaces: src/repro/kernels/flash_prefill/kernel.py:79 flash_prefill
// (Pallas body _kernel :24).  For q (B, KH, G, S, hd) and k, v
// (B, KH, S, hd), float32 or bfloat16, each query row (b, kh, g, s)
// attends to keys t <= s (and t > s - window when a window is given):
//   o = softmax(q . k^T * hd^-0.5) v, online softmax in float32,
// masked scores at -1e30 as in the Pallas kernel.
//
// What bounds it on the H100: operations.  2 hd multiply-adds for each
// visible (query, key) pair in each of the two products, S/4 operations
// a byte of q, k, v and o at the serving path's S = 512.  On the tensor
// cores a float32 product is split in three TF32 products (below), so
// the least time is 3 x 4 hd operations a visible pair over 495 TFLOP/s
// (bfloat16: one product over 989 TFLOP/s), plus the softmax on the CUDA
// cores.
//
// Precision.  float32 operands: 3xTF32.  x = hi + lo, hi = x rounded to
// TF32 (cvt.rna), lo = x - hi rounded to TF32 as well; a product is
// a_lo b_hi + a_hi b_lo + a_hi b_hi, all three on the tensor cores into
// one float32 accumulator, about 2^-22 relative error a term (one TF32
// product keeps ~2^-11 and misses the float32 tolerance at the scores in
// the hundreds that full-width models give).  bfloat16 operands: one
// bf16 product with float32 accumulation (exact products, as the Pallas
// kernel's cast of q and k to float32); P is cast to bf16 before P V, as
// the Pallas kernel does.
//
// Design.  Two launches.
//  * kv_images_kernel lays K and V out once per call in a workspace, a
//    tile of `bk` keys of a (b, kh) after another, each tile an image of the
//    shared-memory layout wgmma reads: K as it is (rows of keys, hd
//    contiguous) and V transposed (rows of dims, keys contiguous; wgmma
//    takes TF32 operands only K-major), each 128-byte swizzled, float32
//    as a hi and a lo part.  In V^T the keys of each group of 8 are
//    ordered 0 2 4 6 1 3 5 7, so the P V product reads P straight from
//    the score accumulators (a thread holds keys 2t, 2t + 1 of a group;
//    the TF32 A fragment wants keys t, t + 4).
//  * prefill_kernel, launched as kv_images_kernel's programmatic dependent
//    (its blocks start while the split runs and wait on it before the
//    first copy): one block of `rows` / 64 warpgroups takes `rows` query
//    rows of one (b, kh), rows ordered (s, g), so the G heads that share
//    a K/V row share each staged tile and a block's causal range is that
//    of rows / G positions.  Blocks launch heaviest first (the last
//    positions of every (b, kh), then the next), so the longest walks
//    start at once.  A warpgroup holds its Q rows as wgmma A fragments in
//    registers (float32: hi and lo; at hd = 128 hi only, lo in shared
//    memory; bf16 Q in shared memory), then walks the key tiles that
//    hold a visible key for its rows; tile images come by bulk copy (the
//    TMA unit) into a ring of `stages` buffers, each completing an
//    mbarrier, the next tiles in flight while this one is computed.  Per
//    tile: S = Q K^T by wgmma (m64 n=bk, float32 accumulators in
//    registers), the mask only on tiles that cross the diagonal, the
//    window or S, the online softmax on the accumulators (exp2 of scores
//    scaled by hd^-0.5 log2 e), then O += P V by wgmma with P from
//    registers (m64 n=hd).  The ring slot is refilled (by thread 0) once
//    every warpgroup of the block has passed a barrier after its P V.
//  * Deterministic: no atomics; every sum in a fixed order.
// Strides are arguments, so q, k, v and o may be permuted views of
// (B, S, H, hd).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWgRows = 64;             // query rows a warpgroup (wgmma M)
constexpr int kMinStages = 2, kMaxStages = 4;
constexpr float kMaskInit = -1e30f;     // the Pallas kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;

// Sizes of one (type, hd, bk) instance.  A K-major operand of R rows and
// D columns is laid out in 128-byte swizzle atoms: columns [128 a / elt,
// 128 (a + 1) / elt) of all R rows form a block of R x 128 bytes, row r
// at 128 r, its 16-byte chunks XOR-ed with r % 8 (CU_TENSOR_MAP_SWIZZLE
// _128B's pattern).  Blocks are multiples of 1024 bytes, so the pattern
// holds on absolute shared addresses once the base is 1024-aligned.
template <typename T, int HD, int BK>
struct Shape {
  static constexpr int kElt = (int)sizeof(T);
  static constexpr bool kSplit = sizeof(T) == 4;      // 3xTF32
  static constexpr int kParts = kSplit ? 2 : 1;       // hi (and lo)
  static constexpr int kAtom = 128 / kElt;            // an atom row's elements
  // Q K^T depth: hd, padded with zeros to a whole atom (bf16 at hd = 32)
  static constexpr int kKd = HD < kAtom ? kAtom : HD;
  static constexpr int kKBytes = BK * kKd * kElt;     // one part of K
  static constexpr int kVBytes = HD * BK * kElt;      // one part of V^T
  static constexpr int kImage = kParts * (kKBytes + kVBytes);
  static constexpr int kQBytes = kWgRows * kKd * kElt;  // one part of Q
  // Q's parts held as wgmma A fragments in registers: float32 hi and lo,
  // at hd = 128 hi only (128 registers of Q would spill), lo in shared
  // memory; bf16 Q in shared memory (ptxas gave its fragments' registers
  // to P's when the two products had the same shape, hd = 64)
  static constexpr int kQRegParts = kSplit ? (HD <= 64 ? 2 : 1) : 0;
  static constexpr int kQSmemParts = kParts - kQRegParts;
  static constexpr int kQSteps = kKd * kElt / 32;     // k-steps of Q K^T
  static_assert(BK * kElt % 128 == 0, "a key tile fills whole atoms");
};

__host__ __device__ constexpr int image_bytes(int elt, int hd, int bk) {
  return (elt == 4 ? 2 : 1) *
         (bk * (hd < 128 / elt ? 128 / elt : hd) * elt + hd * bk * elt);
}

// Dynamic shared bytes of a block (ops.PrefillPlan.smem): 1024 of slack
// to align the base, the part of each warpgroup's Q not in registers (bf16
// Q; float32 lo at hd = 128), the ring, one mbarrier a stage.
__host__ __device__ constexpr int smem_bytes(int elt, int hd, int bk,
                                             int rows, int stages) {
  return 1024 +
         (elt == 2 || hd > 64 ? rows * (hd < 128 / elt ? 128 / elt : hd) * elt
                              : 0) +
         stages * image_bytes(elt, hd, bk) + 8 * stages;
}

// The row and row byte held at byte offset `off` of a swizzled K-major
// operand of `rows` rows (row r's byte kb sits at lin = (kb / 128) rows
// 128 + 128 r + kb % 128, with bits 4-6 of lin XOR-ed with bits 7-9).
__device__ __forceinline__ void unswz(int off, int rows, int& r, int& kb) {
  const int lin = off ^ (((off >> 7) & 7) << 4);
  const int block = lin / (rows * 128), in = lin % (rows * 128);
  r = in >> 7;
  kb = block * 128 + (in & 127);
}
// Byte offset of wgmma k-step j (32 bytes of depth) in such an operand.
__device__ __forceinline__ int kstep(int j, int rows) {
  return (j * 32 >> 7) * rows * 128 + (j * 32 & 127);
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// Two floats as a bf16 pair, `lo` in the low half (the lower column):
// the bits by cvt, not by reading one type through a pointer to another.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Store 16 bytes' worth of values at byte `off` of a part of `part`
// bytes: float32 as hi at `off` and lo at part + off, bf16 as it is.
__device__ __forceinline__ void put(uint8_t* base, int part, int off,
                                    const float (&x)[4]) {
  float h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    h[e] = tf32(x[e]);
    l[e] = tf32(x[e] - h[e]);
  }
  *reinterpret_cast<float4*>(base + off) = make_float4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<float4*>(base + part + off) =
      make_float4(l[0], l[1], l[2], l[3]);
}
__device__ __forceinline__ void put(uint8_t* base, int, int off,
                                    const float (&x)[8]) {
  *reinterpret_cast<uint4*>(base + off) =
      make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                 pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Wait for the phase of `parity` to complete; a wait that never ends (a
// copy that never lands) traps, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  int tries = 0;
  do {
    if (++tries == (1 << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk copy (the TMA unit, no tensor map) of `bytes` from device
// memory into shared memory, completing on `bar`; the caller has set the
// barrier's expected bytes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// wgmma descriptor of a K-major, 128-byte swizzled operand at `addr`:
// 8-row groups 1024 bytes apart (SBO), the leading offset unused.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps the compiler from moving reads or writes of accumulator
// registers across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, float32, in registers) = scale_d D + A B for one k-step
// (8 TF32 or 16 bf16 of depth).  _ss: A and B from shared memory by
// descriptor; _rs: A from registers (4 32-bit registers a thread).
template <typename T, int N>
__device__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                       int scale_d);
template <typename T, int N>
__device__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                       int scale_d);

template <>
__device__ __forceinline__ void mma_ss<float, 32>(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_ss<float, 64>(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<float, 32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<float, 64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<float, 128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_ss<__nv_bfloat16, 64>(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<__nv_bfloat16, 32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<__nv_bfloat16, 64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<__nv_bfloat16, 128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

struct ImageParams {
  const void* k;
  const void* v;
  uint8_t* ws;
  int kh, s, n_ktiles;
  long long ksb, ksk, kss;              // element strides; hd stride is 1
  long long vsb, vsk, vss;
};

// One block a (key tile, (b, kh)): the tile's image in the workspace.
// Writes go out in 16-byte pieces in image order; K is read in place
// (a piece is 16 contiguous bytes of a K row), V through shared memory
// (the transpose; rows padded by one float, so reading down a column
// misses no bank twice).
template <typename T, int HD, int BK>
__global__ void __launch_bounds__(256) kv_images_kernel(const ImageParams p) {
  using S = Shape<T, HD, BK>;
  constexpr int kVec = 16 / S::kElt;
  __shared__ float vs[BK][HD + 1];
  // prefill_kernel may start now: it waits for this grid before it reads
  // the images
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int tile = blockIdx.x, pair = blockIdx.y;
  const int b = pair / p.kh, kh = pair % p.kh, k0 = tile * BK;
  const T* k = (const T*)p.k + b * p.ksb + kh * p.ksk;
  const T* v = (const T*)p.v + b * p.vsb + kh * p.vsk;
  uint8_t* img =
      p.ws + ((long long)pair * p.n_ktiles + tile) * (long long)S::kImage;
  for (int i = threadIdx.x; i < BK * HD; i += blockDim.x) {
    const int j = i / HD, d = i % HD;
    vs[j][d] = k0 + j < p.s ? ld(v + (long long)(k0 + j) * p.vss + d) : 0.f;
  }
  for (int c = threadIdx.x; c < S::kKBytes / 16; c += blockDim.x) {
    int r, kb;
    unswz(c * 16, BK, r, kb);
    const int d0 = kb / S::kElt;
    const bool in = k0 + r < p.s;
    const T* row = k + (long long)(k0 + r) * p.kss;
    float x[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      x[e] = in && d0 + e < HD ? ld(row + d0 + e) : 0.f;
    put(img, S::kKBytes, c * 16, x);
  }
  __syncthreads();
  uint8_t* vimg = img + S::kParts * S::kKBytes;
  for (int c = threadIdx.x; c < S::kVBytes / 16; c += blockDim.x) {
    int d, kb;
    unswz(c * 16, HD, d, kb);
    const int c0 = kb / S::kElt;
    float x[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const int col = c0 + e, u = col & 7;
      // float32: slot u of a group of 8 holds key 2u (u < 4) or 2u - 7
      const int key = S::kSplit ? (col & ~7) + (u < 4 ? 2 * u : 2 * u - 7)
                                : col;
      x[e] = vs[key][d];
    }
    put(vimg, S::kVBytes, c * 16, x);
  }
}

struct Params {
  const void* q;
  void* o;
  const uint8_t* ws;                    // kv_images_kernel's images
  int b, kh, g, s, window;              // window <= 0: none
  int n_ktiles, n_qtiles, stages;
  float c;                              // hd^-0.5 log2 e
  long long qsb, qsk, qsg, qss;         // element strides; hd stride is 1
  long long osb, osk, osg, oss;
};

template <typename T, int HD, int BK, int WGS>
__global__ void __launch_bounds__(128 * WGS, 1)
    prefill_kernel(const Params p) {
  using S = Shape<T, HD, BK>;
  constexpr int kRows = kWgRows * WGS;
  constexpr int kVec = 16 / S::kElt;
  constexpr int kQSteps = S::kQSteps;
  constexpr int kVSteps = BK * S::kElt / 32;      // k-steps of P V
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = smem + WGS * S::kQSmemParts * S::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * S::kImage);

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int warp = (tid % 128) / 32, quad = lane & 3;
  const int pairs = p.b * p.kh, pair = blockIdx.x % pairs;
  const int qt = p.n_qtiles - 1 - blockIdx.x / pairs;   // heaviest first
  const int b = pair / p.kh, kh = pair % p.kh;
  const int n_rows = p.g * p.s;
  const int rb = qt * kRows, rw = rb + kWgRows * wg;
  // the key tiles with a visible key: for the block's rows, and for
  // this warpgroup's (none when its rows are all past G S)
  const int blo = rb / p.g, bhi = (min(rb + kRows, n_rows) - 1) / p.g;
  const int t_first = p.window > 0 ? max(0, blo - p.window + 1) / BK : 0;
  const int n_t = bhi / BK - t_first + 1;
  const bool has_rows = rw < n_rows;
  const int wlo = rw / p.g, whi = (min(rw + kWgRows, n_rows) - 1) / p.g;
  const int w_first = p.window > 0 ? max(0, wlo - p.window + 1) / BK : 0;
  const int w_last = has_rows ? whi / BK : -1;
  const uint8_t* images =
      p.ws + (long long)pair * p.n_ktiles * (long long)S::kImage;

  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto fetch = [&](int i) {             // tile t_first + i into its slot
    uint8_t* dst = ring + (i % p.stages) * S::kImage;
    const uint8_t* src = images + (long long)(t_first + i) * S::kImage;
    uint64_t* bar = &full[i % p.stages];
    mbar_expect(bar, S::kImage);
#pragma unroll
    for (int part = 0; part < 2 * S::kParts; ++part) {
      const int off = part < S::kParts ? part * S::kKBytes
                                       : S::kParts * S::kKBytes +
                                             (part - S::kParts) * S::kVBytes;
      bulk_copy(dst + off, src + off,
                part < S::kParts ? S::kKBytes : S::kVBytes, bar);
    }
  };
  // this warpgroup's Q rows, zero past G S and past hd: the A fragments
  // of Q K^T in registers (a thread holds rows 16 warp + lane / 4 and 8
  // below it), and at hd = 128 float32 the lo part in shared memory
  const T* q = (const T*)p.q + b * p.qsb + kh * p.qsk;
  int pos[2];
  const T* qrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rw + 16 * warp + lane / 4 + 8 * h;
    pos[h] = row < n_rows ? row / p.g : -1;
    qrow[h] = q + (row % p.g) * p.qsg + (long long)(row / p.g) * p.qss;
  }
  // float32: TF32 columns t, t + 4 of each k-step
  uint32_t qf[S::kQRegParts > 0 ? S::kQRegParts : 1][kQSteps][4];
#pragma unroll
  for (int j = 0; j < kQSteps; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (S::kQRegParts > 0) {
        const int h = e & 1, col = 8 * j + quad + 4 * (e >> 1);
        const float x = pos[h] >= 0 ? ld(qrow[h] + col) : 0.f;
        const float hi = tf32(x);
        qf[0][j][e] = __float_as_uint(hi);
        if constexpr (S::kQRegParts == 2)
          qf[1][j][e] = __float_as_uint(tf32(x - hi));
      }
    }
  uint8_t* qs = smem + wg * S::kQSmemParts * S::kQBytes;
  if constexpr (S::kQSmemParts > 0) {   // bf16 Q, or float32 lo
    for (int c = tid % 128; c < S::kQBytes / 16; c += 128) {
      int r, kb;
      unswz(c * 16, kWgRows, r, kb);
      const int row = rw + r, d0 = kb / S::kElt;
      const T* src = q + (row % p.g) * p.qsg + (long long)(row / p.g) * p.qss;
      float x[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        x[e] = row < n_rows && d0 + e < HD ? ld(src + d0 + e) : 0.f;
      if constexpr (S::kSplit) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) x[e] = tf32(x[e] - tf32(x[e]));
        *reinterpret_cast<float4*>(qs + c * 16) =
            make_float4(x[0], x[1], x[2], x[3]);
      } else {
        put(qs, 0, c * 16, x);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  // the images are kv_images_kernel's output: wait for that grid (launched
  // ahead of this one, programmatic dependent launch) before the copies
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (tid == 0)
    for (int i = 0; i < min(p.stages, n_t); ++i) fetch(i);
  __syncthreads();

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {kMaskInit, kMaskInit}, l[2] = {0.f, 0.f};
  const uint32_t q_lo = smem_addr(qs);   // bf16: all of Q

  for (int i = 0; i < n_t; ++i) {
    const int tile = t_first + i;
    if (tile >= w_first && tile <= w_last) {
      mbar_wait(&full[i % p.stages], (i / p.stages) & 1);
      const uint32_t img = smem_addr(ring + (i % p.stages) * S::kImage);
      const uint32_t k_hi = img, k_lo = img + S::kKBytes;
      const uint32_t v_hi = img + S::kParts * S::kKBytes,
                     v_lo = v_hi + S::kVBytes;
      float sc[BK / 2];
      wg_fence();
#pragma unroll
      for (int j = 0; j < kQSteps; ++j) {
        const uint64_t kd_hi = desc(k_hi + kstep(j, BK));
        if constexpr (S::kSplit) {
          if constexpr (S::kQSmemParts > 0)
            mma_ss<T, BK>(sc, desc(q_lo + kstep(j, kWgRows)), kd_hi, j > 0);
          else
            mma_rs<T, BK>(sc, qf[1][j], kd_hi, j > 0);
          mma_rs<T, BK>(sc, qf[0][j], desc(k_lo + kstep(j, BK)), 1);
          mma_rs<T, BK>(sc, qf[0][j], kd_hi, 1);
        } else {
          mma_ss<T, BK>(sc, desc(q_lo + kstep(j, kWgRows)), kd_hi, j > 0);
        }
      }
      wg_commit();
      wg_wait();
      hold(sc);

      // mask (only where the tile crosses the diagonal, S or the
      // window), then the online softmax in the exp2 domain
      const int k0 = tile * BK;
      const bool edge = k0 + BK - 1 > wlo || k0 + BK > p.s ||
                        (p.window > 0 && k0 <= whi - p.window);
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = sc[4 * j + 2 * h + e] * p.c;
            if (edge) {
              const int key = k0 + 8 * j + 2 * quad + e;
              if (!(key <= pos[h] && key < p.s &&
                    (p.window <= 0 || key > pos[h] - p.window)))
                x = -INFINITY;
            }
            sc[4 * j + 2 * h + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        corr[h] = ex2(m[h] - m_new);
        m[h] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pv = ex2(sc[4 * j + 2 * h + e] - m_new);
            sc[4 * j + 2 * h + e] = pv;
            sum += pv;
          }
        l[h] = l[h] * corr[h] + sum;
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * j + e] *= corr[e / 2];

      // O += P V, P from the score registers; every A fragment is built
      // before the first wgmma, so none is written while one reads it
      if constexpr (S::kSplit) {
        uint32_t hi[kVSteps][4], lo[kVSteps][4];
#pragma unroll
        for (int j = 0; j < kVSteps; ++j) {
          // keys 2t, 2t + 1 of group j are TF32 columns t, t + 4
          const float f[4] = {sc[4 * j], sc[4 * j + 2], sc[4 * j + 1],
                              sc[4 * j + 3]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float fh = tf32(f[e]);
            hi[j][e] = __float_as_uint(fh);
            lo[j][e] = __float_as_uint(tf32(f[e] - fh));
          }
        }
        hold(acc);
        wg_fence();
#pragma unroll
        for (int j = 0; j < kVSteps; ++j) {
          const uint64_t vh = desc(v_hi + kstep(j, HD));
          mma_rs<T, HD>(acc, lo[j], vh, 1);
          mma_rs<T, HD>(acc, hi[j], desc(v_lo + kstep(j, HD)), 1);
          mma_rs<T, HD>(acc, hi[j], vh, 1);
        }
      } else {
        uint32_t a[kVSteps][4];
#pragma unroll
        for (int j = 0; j < kVSteps; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a[j][e] = pack_bf16(sc[8 * j + 2 * e], sc[8 * j + 2 * e + 1]);
        hold(acc);
        wg_fence();
#pragma unroll
        for (int j = 0; j < kVSteps; ++j)
          mma_rs<T, HD>(acc, a[j], desc(v_hi + kstep(j, HD)), 1);
      }
      wg_commit();
      wg_wait();
      hold(acc);
    }
    // the slot is free once every warpgroup is done with it
    asm volatile("bar.sync 1, %0;" ::"r"(128 * WGS) : "memory");
    if (tid == 0 && i + p.stages < n_t) fetch(i + p.stages);
  }

  if (!has_rows) return;
  T* o = (T*)p.o + b * p.osb + kh * p.osk;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float den = l[h];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    den = fmaxf(den, 1e-30f);
    if (pos[h] < 0) continue;
    const int row = rw + 16 * warp + lane / 4 + 8 * h;
    T* dst = o + (row % p.g) * p.osg + (long long)(row / p.g) * p.oss;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        st(dst + 8 * j + 2 * quad + e, acc[4 * j + 2 * h + e] / den);
  }
}

template <typename T, int HD, int BK, int WGS>
cudaError_t launch_one(const ImageParams& sp, const Params& p, int smem,
                       cudaStream_t stream) {
  auto fn = prefill_kernel<T, HD, BK, WGS>;
  static int allowed = 48 * 1024;       // dynamic shared bytes admitted
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  kv_images_kernel<T, HD, BK>
      <<<dim3(p.n_ktiles, p.b * p.kh), 256, 0, stream>>>(sp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // launched as kv_images_kernel's programmatic dependent: its blocks start
  // (barriers, Q) while the split runs, and wait on it before the copies
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.n_qtiles * p.b * p.kh));
  cfg.blockDim = dim3(128 * WGS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int HD, int BK>
cudaError_t launch_bk(const ImageParams& sp, const Params& p, int rows,
                      int smem, cudaStream_t st) {
  switch (rows) {
    case 64: return launch_one<T, HD, BK, 1>(sp, p, smem, st);
    case 128: return launch_one<T, HD, BK, 2>(sp, p, smem, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int HD>
cudaError_t launch_hd(const ImageParams& sp, const Params& p, int bk,
                      int rows, int smem, cudaStream_t st) {
  if (bk == 64) return launch_bk<T, HD, 64>(sp, p, rows, smem, st);
  if constexpr (sizeof(T) == 4)         // bf16 tiles fill 128-byte rows
    if (bk == 32) return launch_bk<T, HD, 32>(sp, p, rows, smem, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const ImageParams& sp, const Params& p, int hd, int bk,
                   int rows, int smem, cudaStream_t st) {
  switch (hd) {
    case 32: return launch_hd<T, 32>(sp, p, bk, rows, smem, st);
    case 64: return launch_hd<T, 64>(sp, p, bk, rows, smem, st);
    case 128: return launch_hd<T, 128>(sp, p, bk, rows, smem, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared bytes of a block of the plan (ops.PrefillPlan.smem);
// dtype 0: float32, 1: bfloat16.
int flash_prefill_smem_bytes(int dtype, int hd, int bk, int rows,
                             int stages) {
  return smem_bytes(dtype == 1 ? 2 : 4, hd, bk, rows, stages);
}

// Workspace bytes of the K/V images (ops.PrefillPlan.workspace_bytes).
long long flash_prefill_workspace_bytes(int dtype, int b, int kh, int s,
                                        int hd, int bk) {
  return (long long)b * kh * ((s + bk - 1) / bk) *
         image_bytes(dtype == 1 ? 2 : 4, hd, bk);
}

// q (B, KH, G, S, hd), k and v (B, KH, S, hd), o like q; each given by
// its element strides, with the hd dim contiguous.  dtype 0: float32, 1:
// bfloat16 (all four tensors).  window <= 0: no window.  hd in {32, 64,
// 128}; scale is hd^-0.5.  The plan (ops.launch_plan): `rows` query rows
// a block (64 or 128), key tiles of `bk` (64, or 32 for float32),
// `stages` ring slots, `smem` shared bytes; ws holds
// flash_prefill_workspace_bytes, 16-byte aligned.  Returns the first
// failing launch's cudaError_t.
int flash_prefill_launch(const void* q, const void* k, const void* v,
                         void* o, void* ws, long long ws_bytes, int b,
                         int kh, int g, int s, int hd, int window,
                         float scale, int dtype, int rows, int bk,
                         int stages, int smem, long long qsb, long long qsk,
                         long long qsg, long long qss, long long ksb,
                         long long ksk, long long kss, long long vsb,
                         long long vsk, long long vss, long long osb,
                         long long osk, long long osg, long long oss,
                         void* stream) {
  if (b <= 0 || kh <= 0 || g <= 0 || s <= 0) return 0;
  if (stages < kMinStages || stages > kMaxStages ||
      smem != flash_prefill_smem_bytes(dtype, hd, bk, rows, stages) ||
      ws_bytes < flash_prefill_workspace_bytes(dtype, b, kh, s, hd, bk) ||
      (reinterpret_cast<uintptr_t>(ws) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int n_ktiles = (s + bk - 1) / bk;
  const long long n_qtiles = ((long long)g * s + rows - 1) / rows;
  if ((long long)b * kh > 65535 || (long long)g * s > 0x7fffffffLL - rows ||
      n_qtiles * b * kh > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const ImageParams sp{k, v, (uint8_t*)ws, kh, s, n_ktiles,
                       ksb, ksk, kss, vsb, vsk, vss};
  const Params p{q,   o,   (const uint8_t*)ws, b,   kh,  g,   s,   window,
                 n_ktiles, (int)n_qtiles, stages, scale * kLog2e,
                 qsb, qsk, qsg, qss, osb, osk, osg, oss};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch<float>(sp, p, hd, bk, rows, smem, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(sp, p, hd, bk, rows, smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
