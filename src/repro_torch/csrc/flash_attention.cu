// Hand-written Hopper (sm_90a) flash-attention forward (K8), float32, on
// the tensor cores with split TF32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention_local`, body `_kernel`) for float32 inputs and
// computes its function: GQA attention with an online softmax.
//
//   q (B, Sq, H, hd), k and v (B, Sk, KH, hd), H = KH * G, row-major,
//   contiguous and 16-byte aligned, float32; o like q.
//
// What it keeps from the TPU kernel:
//   * q is scaled by `scale` (hd**-0.5 rounded to f32) in f32 before the
//     dot products;
//   * P stays f32 (the sum l is of the f32 P); the running max m, the sum
//     and the accumulator are f32; m starts at -1e30, a key after the
//     query (causal, by absolute index) scores -1e30, keys at or past Sk
//     take no weight, and whole key tiles after a block's last query are
//     skipped;
//   * the output is acc / max(l, 1e-30).
// What differs: Q K^T and P V are each three TF32 products with f32 sums
// (below), and the running sums are rescaled once per tile of BN keys
// (the TPU kernel: once per block of bk <= 512). Both move f32 roundings
// only; the plain version (kernels/flash_attention.py) keeps the TPU
// kernel's bq/bk tile order, and the two are held to 2e-5.
//
// Why split TF32. One TF32 product keeps 11 bits of each operand and
// misses the f32 gate of 2e-5. Each f32 operand x is split into big =
// tf32(x) (cvt.rna: round to nearest, ties away) and small = tf32(x -
// big) (x - big is exact in f32), and a product is formed as small*big +
// big*small + big*big with f32 sums: about 22 bits of each operand, the
// small*small term (2^-22 of the product) left out. The CPU test
// tests/test_torch_flash.py::test_split_tf32_within_the_f32_bound holds
// this arithmetic to the gate.
//
// Bound on an H100 SXM: 4*hd operations per (query row, key) pair that
// the mask keeps (2*hd for q.k, 2*hd for p*v), done three times on the
// tensor cores at 495 TFLOP/s dense TF32; the same function on the CUDA
// cores (the kernel this one replaced) is bound by the f32 rate of 67
// TFLOP/s, 2.46x longer. q, k, v read once and o written once at 3.35
// TB/s is under a fifth of either at the serving shapes (S = 2048), so
// the operations bound it. What keeps it from that bound is the work
// around the products (the split, the softmax, the barriers) and the
// registers: Q's halves, O and S take up to 255 a thread.
//
// Design (what it does about that bound):
//   * One CTA of two warpgroups owns 128 rows of one (batch, kv head), a
//     row being a (query position, head of the group) pair: TQ = 128 / G
//     positions times the G heads that share the KV head, so each K and V
//     tile is staged once for the whole group. Rows past TQ * G are
//     unused and never stored. CTAs are issued from the last query tile
//     first, so the long causal rows start early.
//   * Tiles of 32 keys of K and V go through a ring of 3 f32 stages (1 at
//     hd 256, for shared memory) loaded with 16-byte cp.async (zero-filled
//     past Sk), so tiles it+1 and it+2 load while tile it is computed.
//   * Each landed tile is split once, by the whole CTA, into big and small
//     halves, stored in the 128-byte-swizzled K-major layout wgmma reads:
//     K by key in 32-column chunks, V transposed (a row a head-dim
//     column, its 32 keys one 128-byte row). Each warpgroup then forms
//     its 64 rows' S = Q K^T and O += P V with wgmma m64nNk8 tf32, A (Q,
//     P) from registers, B (the halves) from shared memory: three wgmma a
//     k step and no shared load or conversion in the warps. Splitting in
//     each warp instead, for mma.sync m16n8k8, took 10 instructions for
//     every 3 products and ran slower than SDPA at hd 112.
//   * The S accumulator of an 8-key block is, element for element, P's A
//     fragment if k column t is key 2t and column t + 4 is key 2t + 1, so
//     each 8 keys of V's transposed rows are stored in the order 0 2 4 6
//     1 3 5 7 and P stays in registers (split there).
//   * Q (scaled) is split once into registers for hd <= 128; at hd 256 it
//     is read from global memory (L1) and split each tile, as its 256
//     registers would not fit beside O's.
//   * Under the causal mask a warpgroup skips the tiles that lie wholly
//     after its own last query (their weights would be exactly 0), and
//     only tiles that cross the diagonal or Sk test keys.
//   * The softmax runs in base 2 (ex2.approx on scores times log2 e).
//
// C interface: repro_flash_attention(...) returns the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for a shape it does not
// take. Built by repro_torch/kernels/build.py with nvcc -gencode
// arch=compute_90a,code=sm_90a (wgmma needs the "a") and loaded with
// ctypes. bfloat16 inputs go to the kernel in flash_attention_sm90.cu.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 2 warpgroups of 64 rows
constexpr int kRows = 128;     // (query position, head) rows of a CTA
constexpr int kBN = 32;        // keys of a tile: one 128-byte row of tf32
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int STAGES = HD <= 128 ? 3 : 1;  // f32 tiles in flight
  static constexpr int FP = HD + 4;                 // f32 staging pitch
  static constexpr int NCH = (HD + 31) / 32;        // 32-column K chunks
  static constexpr int STAGE = 2 * kBN * FP;        // floats: K and V
  static constexpr int KHALF = NCH * kBN * 128;     // bytes: K big or small
  static constexpr int VHALF = HD * 128;            // bytes: V big or small
  static constexpr bool QREG = HD <= 128;           // Q split in registers
  static constexpr size_t SMEM =
      1024 + 2 * (size_t)KHALF + 2 * (size_t)VHALF +
      (size_t)STAGES * STAGE * sizeof(float);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `in` false fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small: big its TF32 rounding, small the TF32 rounding of the
// (exact) rest.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(__fsub_rn(x, __uint_as_float(big)));
}

// An A fragment split into its big and small halves.
struct SplitA {
  uint32_t big[4], small[4];
  __device__ __forceinline__ void set(const float (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(a[i], big[i], small[i]);
  }
};

// Four f32 values split: their big halves in `big`, small in `small`.
__device__ __forceinline__ void split4(float x0, float x1, float x2,
                                       float x3, uint4& big, uint4& small) {
  split(x0, big.x, small.x);
  split(x1, big.y, small.y);
  split(x2, big.z, small.z);
  split(x3, big.w, small.w);
}

// Byte offset of byte `b` of row `r` in a region of 128-byte rows stored
// with the 128-byte swizzle (16-byte unit u of row r at u ^ (r % 8)), the
// layout TMA writes and wgmma reads.
__device__ __forceinline__ uint32_t swz(int r, int b) {
  return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

// A shared-memory matrix descriptor for wgmma: K-major rows of 128 bytes,
// 128-byte swizzle, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D[64 x 16] (+)= A[64 x 8] B[8 x 16]: A (tf32) in registers, B K-major in
// shared memory; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_n16(float (&d)[8], const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64 x 32] (+)= A[64 x 8] B[8 x 32]: A (tf32) in registers, B K-major in
// shared memory; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 8] B[8 x 64]: A (tf32) in registers, B K-major in
// shared memory; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64 x 80] (+)= A[64 x 8] B[8 x 80]: A (tf32) in registers, B K-major in
// shared memory; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_n80(float (&d)[40], const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64 x 112] (+)= A[64 x 8] B[8 x 112]: A (tf32) in registers, B K-major in
// shared memory; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_n112(float (&d)[56], const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 8] B[8 x 128]: A (tf32) in registers, B K-major in
// shared memory; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64 x 256] (+)= A[64 x 8] B[8 x 256]: A (tf32) in registers, B K-major in
// shared memory; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_n256(float (&d)[128], const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


template <int N>
__device__ __forceinline__ void wgmma_n(float (&d)[N / 2],
                                        const uint32_t (&a)[4], uint64_t db,
                                        int scale_d) {
  if constexpr (N == 16) wgmma_n16(d, a, db, scale_d);
  else if constexpr (N == 32) wgmma_n32(d, a, db, scale_d);
  else if constexpr (N == 64) wgmma_n64(d, a, db, scale_d);
  else if constexpr (N == 80) wgmma_n80(d, a, db, scale_d);
  else if constexpr (N == 112) wgmma_n112(d, a, db, scale_d);
  else if constexpr (N == 128) wgmma_n128(d, a, db, scale_d);
  else wgmma_n256(d, a, db, scale_d);
}

// D += A B as small*big + big*small + big*big (the small terms first); B's
// halves by their descriptors. scale_d 0 on the first overwrites D.
template <int N>
__device__ __forceinline__ void wgmma3(float (&d)[N / 2], const SplitA& a,
                                       uint64_t b_big, uint64_t b_small,
                                       int scale_d) {
  wgmma_n<N>(d, a.small, b_big, scale_d);
  wgmma_n<N>(d, a.big, b_small, 1);
  wgmma_n<N>(d, a.big, b_big, 1);
}

// Fragment layouts (g = lane / 4, t = lane % 4, rows of the thread's warp
// within its warpgroup): an A fragment holds (row g, k t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); the accumulator, element 4n + q, (row g + 8
// * (q >> 1), column 8n + 2t + (q & 1)). For Q K^T the k index is the
// head dim in order (K tiles split by key, 32-column chunks). For P V the
// S accumulator of key block j is P's A fragment if k column t is key
// 8j + 2t and column t + 4 is key 8j + 2t + 1, so V is split transposed
// (a row a column of V) with each 8 keys stored in the order 0 2 4 6 1 3
// 5 7.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int Sq,
               int Sk, int H, int KH, int G, int TQ, int causal,
               float scale) {
  using C = Cfg<HD>;
  constexpr int BN = kBN, FP = C::FP, ST = C::STAGES, PF = ST - 1;
  constexpr int NK = HD / 8;  // k steps of Q K^T; n blocks of O
  constexpr int NB = BN / 8;  // n blocks of S; k steps of P V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* Kb = smem_raw + pad;          // K big, NCH chunks of [BN][128 B]
  uint8_t* Ks = Kb + C::KHALF;           // K small
  uint8_t* Vb = Ks + C::KHALF;           // V big, transposed: [HD][128 B]
  uint8_t* Vs = Vb + C::VHALF;           // V small
  float* stage0 = reinterpret_cast<float*>(Vs + C::VHALF);  // f32 tiles

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TQ;
  const int q_last = min(q0 + TQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (k_end + BN - 1) / BN;

  // This thread's rows: g and g + 8 of its warp's 16.
  int qpos[2];
  bool valid[2];
  size_t row_off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h, tq = r / G;
    qpos[h] = q0 + tq;
    valid[h] = tq < TQ && qpos[h] < Sq;
    row_off[h] = valid[h]
        ? (((size_t)b * Sq + qpos[h]) * H + kh * G + (r - tq * G)) * HD
        : 0;
  }
  // The keys this warpgroup's rows can see: up to its last valid position.
  const int g_first = wg * 64, used = TQ * G;
  int g_end = 0;
  if (g_first < used && q0 + g_first / G < Sq) {
    const int g_last = min(q0 + min(g_first + 63, used - 1) / G, Sq - 1);
    g_end = causal ? min(Sk, g_last + 1) : Sk;
  }
  const int g_pos0 = q0 + g_first / G;  // the warpgroup's first position

  // The A fragment of Q (scaled) for k step s, split.
  auto q_frag = [&](int s, SplitA& qa) {
    float a[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x0 = 0.f, x1 = 0.f;
      if (valid[h]) {
        x0 = __ldg(q + row_off[h] + s * 8 + t);
        x1 = __ldg(q + row_off[h] + s * 8 + t + 4);
      }
      a[h] = __fmul_rn(x0, scale);
      a[2 + h] = __fmul_rn(x1, scale);
    }
    qa.set(a);
  };
  SplitA qf[C::QREG ? NK : 1];
  if constexpr (C::QREG) {
#pragma unroll
    for (int s = 0; s < NK; ++s) q_frag(s, qf[s]);
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float sc[BN / 2];

  // Tile `it` of K and V, f32, into its stage.
  auto load_tile = [&](int it) {
    float* dk = stage0 + (it % ST) * C::STAGE;
    float* dv = dk + BN * FP;
    const int k0 = it * BN;
    for (int idx = tid; idx < BN * HD / 4; idx += kThreads) {
      const int c = idx / (HD / 4), d = (idx % (HD / 4)) * 4, kp = k0 + c;
      const bool in = kp < Sk;
      const size_t off = in ? (((size_t)b * Sk + kp) * KH + kh) * HD + d : 0;
      cp_async16(dk + c * FP + d, k + off, in);
      cp_async16(dv + c * FP + d, v + off, in);
    }
  };
  // A landed tile split once for both warpgroups, in the layouts wgmma
  // reads: K by key in 32-column chunks, V transposed.
  auto split_tile = [&](int it) {
    const float* fk = stage0 + (it % ST) * C::STAGE;
    const float* fv = fk + BN * FP;
    for (int idx = tid; idx < BN * HD / 4; idx += kThreads) {
      const int c = idx / (HD / 4), d4 = idx % (HD / 4);
      const float4 x = *reinterpret_cast<const float4*>(fk + c * FP + 4 * d4);
      uint4 big, small;
      split4(x.x, x.y, x.z, x.w, big, small);
      const uint32_t off = (d4 / 8) * BN * 128 + swz(c, (d4 % 8) * 16);
      *reinterpret_cast<uint4*>(Kb + off) = big;
      *reinterpret_cast<uint4*>(Ks + off) = small;
    }
    for (int idx = tid; idx < NB * HD; idx += kThreads) {
      const int d = idx % HD, j = idx / HD;
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = fv[(8 * j + e) * FP + d];
      uint4 big, small;
      split4(x[0], x[2], x[4], x[6], big, small);
      *reinterpret_cast<uint4*>(Vb + swz(d, 32 * j)) = big;
      *reinterpret_cast<uint4*>(Vs + swz(d, 32 * j)) = small;
      split4(x[1], x[3], x[5], x[7], big, small);
      *reinterpret_cast<uint4*>(Vb + swz(d, 32 * j + 16)) = big;
      *reinterpret_cast<uint4*>(Vs + swz(d, 32 * j + 16)) = small;
    }
    // The split halves are read by wgmma, through the async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  const uint32_t kb = smem_u32(Kb), ks = smem_u32(Ks);
  const uint32_t vb = smem_u32(Vb), vs = smem_u32(Vs);

#pragma unroll
  for (int s = 0; s < PF; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    if constexpr (PF == 0) {
      load_tile(it);
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      cp_async_wait<PF - 1>();  // this thread's copies of tile it
    }
    __syncthreads();  // everyone's; both warpgroups are done with the split
    if (PF > 0 && it + PF < n_tiles) load_tile(it + PF);
    if constexpr (PF > 0) cp_async_commit();
    split_tile(it);
    __syncthreads();
    const int k0 = it * BN;
    if (k0 >= g_end) continue;  // wholly after this warpgroup's rows

    // S = (q * scale) K^T on the tensor cores.
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < NK; ++s) {
      const uint32_t off = (s / 4) * BN * 128 + (s % 4) * 32;
      if constexpr (C::QREG) {
        wgmma3<BN>(sc, qf[s], desc(kb + off), desc(ks + off), s > 0);
      } else {
        SplitA qa;
        q_frag(s, qa);
        wgmma3<BN>(sc, qa, desc(kb + off), desc(ks + off), s > 0);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);

    // Mask, then the online softmax in base 2.
    const bool edge = k0 + BN > Sk || (causal && k0 + BN - 1 > g_pos0);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      float x = __fmul_rn(sc[i], kLog2e);
      if (edge) {
        const int key = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
        if (key >= Sk)
          x = -INFINITY;  // past the keys: no weight at all
        else if (causal && key > qpos[(i >> 1) & 1])
          x = kNegInf;
      }
      sc[i] = x;
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 2 * h; i < BN / 2; i += 4)
        mx = fmaxf(mx, fmaxf(sc[i], sc[i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      alpha[h] = ex2(m[h] - m_new);
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int i = 2 * h; i < BN / 2; i += 4) {
        sc[i] = ex2(sc[i] - m_new);
        sc[i + 1] = ex2(sc[i + 1] - m_new);
        sum += sc[i] + sc[i + 1];
      }
      l[h] = l[h] * alpha[h] + sum;  // this thread's share of the row
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V: the S accumulator of key block j is P's A fragment.
    SplitA pa[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float pf[4] = {sc[4 * j], sc[4 * j + 2], sc[4 * j + 1],
                           sc[4 * j + 3]};
      pa[j].set(pf);
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NB; ++j)
      wgmma3<HD>(acc, pa[j], desc(vb + 32 * j), desc(vs + 32 * j), 1);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
  }

  // acc / max(l, 1e-30), the row's sum gathered from its four threads.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    if (!valid[h]) continue;
    const float li = fmaxf(lh, 1e-30f);
    float* orow = o + row_off[h];
#pragma unroll
    for (int n = 0; n < NK; ++n)
      *reinterpret_cast<float2*>(orow + n * 8 + 2 * t) = make_float2(
          acc[4 * n + 2 * h] / li, acc[4 * n + 2 * h + 1] / li);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int KH, int causal,
                   float scale, cudaStream_t stream) {
  const int G = H / KH, TQ = kRows / G;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Cfg<HD>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + TQ - 1) / TQ, KH, B);
  flash_fwd_tf32<HD><<<grid, kThreads, Cfg<HD>::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, KH, G,
      TQ, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// The wrapper has checked shapes, contiguity, 16-byte aligned pointers,
// H % KH == 0, G = H / KH <= 64 and hd in {16, 32, 64, 80, 112, 128, 256}.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int Sq,
                                     int Sk, int H, int KH, int hd,
                                     int causal, float scale, void* stream) {
  if (KH <= 0 || H % KH != 0 || H / KH > 64 || B <= 0 || Sq <= 0 ||
      Sk <= 0 || (reinterpret_cast<uintptr_t>(q) |
                  reinterpret_cast<uintptr_t>(k) |
                  reinterpret_cast<uintptr_t>(v) |
                  reinterpret_cast<uintptr_t>(o)) % 16)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, B, Sq, Sk, H, KH, causal, scale, s);
    case 32: return launch<32>(q, k, v, o, B, Sq, Sk, H, KH, causal, scale, s);
    case 64: return launch<64>(q, k, v, o, B, Sq, Sk, H, KH, causal, scale, s);
    case 80: return launch<80>(q, k, v, o, B, Sq, Sk, H, KH, causal, scale, s);
    case 112: return launch<112>(q, k, v, o, B, Sq, Sk, H, KH, causal, scale, s);
    case 128: return launch<128>(q, k, v, o, B, Sq, Sk, H, KH, causal, scale, s);
    case 256: return launch<256>(q, k, v, o, B, Sq, Sk, H, KH, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
