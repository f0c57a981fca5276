// Hand-written Hopper (sm_90a) flash-attention forward for bf16 (K8, the
// tensor-core route).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention_local`, body `_kernel`) for bfloat16 inputs; float32
// inputs go to the split-TF32 kernel in flash_attention.cu. It computes
// the TPU kernel's function:
//
//   q (B, Sq, H, hd), k and v (B, Sk, KH, hd), H = KH * G, bf16, row-major
//   and contiguous; o like q. GQA attention with an online softmax; a
//   running max that starts at -1e30; a key after the query (causal, by
//   absolute index) scores -1e30 and key tiles past a block's last query
//   are skipped; the output is acc / max(l, 1e-30), rounded once to bf16.
//
// Where it rounds (the f32 kernel keeps P and every sum in f32):
//   * S = Q K^T: bf16 operands into wgmma with f32 sums (the products of
//     bf16 values are exact in f32; only the order of the sum changes).
//     The score is scaled by hd**-0.5 after the product, folded with
//     log2(e) into one f32 multiply ahead of exp2;
//   * P V: P is split in registers into its bf16 rounding P_hi and the
//     bf16 rounding of P - P_hi, P_lo, and O += P_hi V + P_lo V by two
//     wgmma with A from registers; V is the B operand from shared memory
//     (MN-major); f32 sums. P_hi + P_lo carries P to about 16 bits;
//   * the running max m, the sum l (of the f32 P) and O stay f32.
// Why two products: with P_hi alone (one product, 0.178 ms at the serving
// shape) the qwen2.5-3b prefill logits left the serving gate against the
// plain-attention route (largest excess over rtol*|ref| 8.17e-2 against
// atol 8e-2) after 36 layers of bf16 rounding; with both halves they are
// where the f32-P kernel had them (7.83e-2), at 0.215 ms (H100 80GB HBM3,
// 700 W). The gate against the f32 plain version is 3e-2.
//
// Bound on an H100 SXM: 4*hd operations per (query row, key) pair that the
// mask keeps (the function's; the P_lo product is not counted), on the
// tensor cores at 989 TFLOP/s dense bf16. At the serving shape (B=4,
// S=2048, H=16, KH=2, hd=128, causal) that is 6.875e10 operations, 0.0695
// ms; q, k, v read once and o written once is 0.0225 ms at 3.35 TB/s, so
// the operations bound it.
//
// Design (what it does about that bound):
//   * One CTA per (batch, kv head, tile of 128 rows), a row being a (query
//     position, head of the group) pair: TQ = 128 / G positions times the
//     G heads that share the KV head, so K and V are staged once for the
//     whole group. When G does not divide 128 the last 128 - TQ*G rows are
//     unused and never stored. The CTAs of each (batch, kv head) are
//     issued from the last query tile first, so the long causal rows
//     start early.
//   * Warp roles. Warpgroup 0 is the producer: one thread keeps TMA loads
//     of K and V tiles (BN keys x hd) in flight through a ring of 3 stages
//     (2 at hd 256) in dynamic shared memory, each stage with a K-full, a
//     V-full and an empty mbarrier. Warpgroups 1 and 2 are consumers, 64
//     rows each: per key tile, wgmma m64n{BN}k16 (Q, K from shared memory)
//     for S, the online softmax in registers, then wgmma m64n{hd}k16 with
//     P_hi and P_lo from registers for O. setmaxnreg gives the consumers
//     240 registers and the producer 24 (hd 256 holds a 64 x 256 f32
//     accumulator).
//   * Software pipeline in each consumer: S of tile j is issued, then P V
//     of tile j - 1 behind it; the softmax of tile j runs while that P V is
//     still on the tensor cores, and O is rescaled once it has landed. The
//     sums are the plain loop's, in the same order.
//   * Q is loaded once per CTA by TMA through a 4-D tensor map over (hd,
//     H, Sq, B) with boxes of (min(hd, 64), G, TQ, 1); K and V through
//     maps over (hd, KH, Sk, B). Out-of-range positions are filled with
//     zeros, and keys at or past Sk are masked to -inf. The maps are
//     encoded on the host at each launch (cuTensorMapEncodeTiled from
//     cudaGetDriverEntryPointByVersion, so the library needs no -lcuda)
//     and passed as __grid_constant__ parameters.
//   * Swizzle: a tile row is split into chunks of min(hd, 64) columns
//     (128, 64 or 32 bytes), each chunk region swizzled at its row width
//     (128B, 64B or 32B) by TMA and read by wgmma through descriptors of
//     the same layout.
//   * BN = 128 keys for hd <= 128 and 64 for hd 256 (shared memory at hd
//     128: 224 KiB, at hd 256: 192 KiB; one CTA an SM).
//   * O is written straight from the accumulator registers (bf16 pairs).
//   * Head dims 80 and 112 (hubert-xlarge, zamba2-7b) run hd 128's kernel
//     unchanged: shared-memory layout, swizzle, descriptors and wgmma
//     shapes. Their tensor maps declare the true hd as dim 0, so TMA fills
//     columns hd..127 of the second 64-column chunk with zeros: those add
//     nothing to S = Q K^T and give zero columns of O, which the epilogue
//     does not store (it writes hd columns at a row stride of hd). Rows of
//     160 and 224 bytes meet TMA's 16-byte stride rule. The cost is the
//     padded tensor work, 128/hd: 1.6x at hd 80, 1.14x at hd 112. No swizzle
//     spans the 16 or 48 columns left over, and exact chunks would need
//     their own swizzles and descriptors.
//
// C interface: repro_flash_attention_sm90(...) returns a cudaError_t (the
// launch's cudaGetLastError(), or cudaErrorInvalidValue for a shape or a
// tensor map the kernel does not take). Built by
// repro_torch/kernels/build.py with nvcc -gencode
// arch=compute_90a,code=sm_90a (wgmma and setmaxnreg need the "a") and
// loaded with ctypes.

#include <cuda.h>  // CUtensorMap and its enums only; no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kRows = 128;     // (query position, head) rows of a CTA
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int DC = HD < 64 ? HD : 64;  // columns of a chunk
  static constexpr int NCH = HD / DC;           // chunks of a row
  static constexpr int ROWB = DC * 2;           // bytes of a chunk row
  static constexpr int BN = HD == 256 ? 64 : 128;  // keys of a tile
  // wgmma descriptor layout type: 1 = 128B, 2 = 64B, 3 = 32B swizzle
  static constexpr uint64_t LAYOUT = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  static constexpr int Q_BYTES = kRows * HD * 2;
  static constexpr int KV_BYTES = BN * HD * 2;  // K (or V) of one stage
  // K/V ring stages: 3 where they fit in 227 KiB, 2 at hd 256.
  static constexpr int STAGES = HD == 256 ? 2 : 3;
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

// A shared-memory matrix descriptor for wgmma: start address, leading and
// stride byte offsets (16-byte units), swizzle layout in bits 62-63.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma wrappers. Inline PTX names every accumulator register, so each
// width the kernel uses is written out.

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]^T: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]^T: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 16] += A[64 x 16] B[16 x 16]: A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 32] += A[64 x 16] B[16 x 32]: A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] B[16 x 256]: A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73,"
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97,"
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117,"
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2], const uint32_t* a,
                                         uint64_t db) {
  if constexpr (HD == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (HD == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (HD == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (HD == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

template <int BN>
__device__ __forceinline__ void wgmma_qk(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (BN == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n128(d, da, db, accumulate);
}

// HD: the head dim of the layout (shared memory, wgmma); HDT <= HD: the
// tensors' head dim, the columns stored.
template <int HD, int HDT>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H, int G,
               int TQ, int causal, float scale_log2) {
  using C = Cfg<HD>;
  constexpr int BN = C::BN, ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // bars: [0] Q full; [1 + s] K full; [1 + ST + s] V full; [1 + 2 ST + s]
  // stage empty.
  __shared__ __align__(8) uint64_t bars[1 + 3 * ST];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;        // stage s at + s * KV_BYTES
  const uint32_t sV = sK + ST * C::KV_BYTES;  // stage s at + s * KV_BYTES
  const uint32_t bar0 = smem_u32(bars);
  auto k_full = [&](int s) { return bar0 + 8u * (1 + s); };
  auto v_full = [&](int s) { return bar0 + 8u * (1 + ST + s); };
  auto empty = [&](int s) { return bar0 + 8u * (1 + 2 * ST + s); };

  const int kh = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TQ;
  const int q_last = min(q0 + TQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (k_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(bar0, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each of the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar0, C::NCH * C::DC * G * TQ * 2);
      for (int c = 0; c < C::NCH; ++c)
        tma_load_4d(sQ + c * kRows * C::ROWB, &tm_q, bar0, c * C::DC,
                    kh * G, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST, n = it / ST;
        mbar_wait(empty(s), (n & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(k_full(s), C::KV_BYTES);
        for (int c = 0; c < C::NCH; ++c)
          tma_load_4d(sK + s * C::KV_BYTES + c * BN * C::ROWB, &tm_k,
                      k_full(s), c * C::DC, kh, it * BN, b);
        mbar_expect_tx(v_full(s), C::KV_BYTES);
        for (int c = 0; c < C::NCH; ++c)
          tma_load_4d(sV + s * C::KV_BYTES + c * BN * C::ROWB, &tm_v,
                      v_full(s), c * C::DC, kh, it * BN, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wgl = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    // This thread's two rows of the accumulators: r and r + 8.
    int qpos[2], head[2];
    bool valid[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wgl * 64 + warp * 16 + lane / 4 + 8 * h;
      const int tq = r / G;
      qpos[h] = q0 + tq;
      head[h] = kh * G + (r - tq * G);
      valid[h] = tq < TQ && qpos[h] < Sq;
    }
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float sc[BN / 2];
    uint32_t pa[BN / 4], pb[BN / 4];  // P's bf16 high and low halves
    const uint32_t q_rows = sQ + wgl * 64 * C::ROWB;

    // S of tile `it` into sc (asynchronous: committed, not waited for).
    auto issue_qk = [&](int it) {
      const uint32_t k_tile = sK + (it % ST) * C::KV_BYTES;
#pragma unroll
      for (int c = 0; c < C::NCH; ++c)
#pragma unroll
        for (int kk = 0; kk < C::DC / 16; ++kk)
          wgmma_qk<BN>(sc,
                       desc(q_rows + c * kRows * C::ROWB + kk * 32, 16,
                            8 * C::ROWB, C::LAYOUT),
                       desc(k_tile + c * BN * C::ROWB + kk * 32, 16,
                            8 * C::ROWB, C::LAYOUT),
                       c + kk > 0);
      wgmma_commit();
    };
    // O += P V of tile `it` as P_hi V + P_lo V, P from pa and pb
    // (asynchronous as above).
    auto issue_pv = [&](int it) {
      const uint32_t v_tile = sV + (it % ST) * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t dv = desc(v_tile + kk * 16 * C::ROWB, BN * C::ROWB,
                                 8 * C::ROWB, C::LAYOUT);
        wgmma_pv<HD>(acc, &pa[4 * kk], dv);
        wgmma_pv<HD>(acc, &pb[4 * kk], dv);
      }
      wgmma_commit();
    };
    // Scale and mask S of tile `it`, then the online softmax: sc becomes
    // P (f32), m and l are updated, and alpha rescales the earlier O.
    // Element i of sc is in row r + 8 * ((i >> 1) & 1) (r: this thread's
    // first row) and at key k0 + (i >> 2) * 8 + 2 * (lane % 4) + (i & 1).
    float alpha[2];
    auto softmax = [&](int it) {
      const int k0 = it * BN;
      const bool edge = k0 + BN > Sk || (causal && k0 + BN - 1 > q0);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        float x = sc[i] * scale_log2;
        if (edge) {
          const int key = k0 + (i >> 2) * 8 + 2 * (lane % 4) + (i & 1);
          if (key >= Sk)
            x = -INFINITY;  // past the keys: no weight at all
          else if (causal && key > qpos[(i >> 1) & 1])
            x = kNegInf;
        }
        sc[i] = x;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNegInf;
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
    };
    // Once P V of the earlier tile has landed: rescale O by alpha, and
    // split P into its bf16 rounding (pa) and the bf16 rounding of the
    // rest (pb) for P V.
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int j = 0; j < BN / 4; ++j) {
        const __nv_bfloat162 hi =
            __floats2bfloat162_rn(sc[2 * j], sc[2 * j + 1]);
        pa[j] = *reinterpret_cast<const uint32_t*>(&hi);
        pb[j] = pack_bf16(sc[2 * j] - __low2float(hi),
                          sc[2 * j + 1] - __high2float(hi));
      }
    };

    // Software pipeline: S of tile it is computed on the tensor cores
    // while P V of tile it - 1 is queued behind it, and the softmax of
    // tile it runs while that P V is still in flight.
    mbar_wait(bar0, 0);
    mbar_wait(k_full(0), 0);
    wgmma_fence();
    issue_qk(0);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0);
    rescale_and_pack();
    for (int it = 1; it < n_tiles; ++it) {
      const int prev = it - 1;
      mbar_wait(k_full(it % ST), (it / ST) & 1);
      fence_regs(sc);
      fence_regs(acc);
      fence_regs(pa);
      fence_regs(pb);
      wgmma_fence();
      issue_qk(it);
      mbar_wait(v_full(prev % ST), (prev / ST) & 1);
      issue_pv(prev);
      wgmma_wait<1>();  // S of tile it; P V of tile it - 1 may still run
      fence_regs(sc);
      softmax(it);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      fence_regs(pb);
      if (lane == 0) mbar_arrive(empty(prev % ST));
      rescale_and_pack();
    }
    const int last = n_tiles - 1;
    mbar_wait(v_full(last % ST), (last / ST) & 1);
    fence_regs(acc);
    fence_regs(pa);
    fence_regs(pb);
    wgmma_fence();
    issue_pv(last);
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty(last % ST));

    // acc / max(l, 1e-30), rounded once to bf16, straight from registers.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lh = l[h];
      lh += __shfl_xor_sync(0xffffffffu, lh, 1);
      lh += __shfl_xor_sync(0xffffffffu, lh, 2);
      if (!valid[h]) continue;
      const float inv = 1.f / fmaxf(lh, 1e-30f);
      __nv_bfloat16* row = o + (((size_t)b * Sq + qpos[h]) * H + head[h]) * HDT;
#pragma unroll
      for (int j = 0; j < HDT / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(row + j * 8 + 2 * (lane % 4)) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv,
                                  acc[4 * j + 2 * h + 1] * inv);
    }
  }
}

// ---- host side ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a (B, S, heads, hd) bf16 tensor, innermost first, whose
// box is (dc, box_heads, box_seq, 1). Elements of a box past the tensor
// (columns past hd, positions past seq) are filled with zeros, and count
// toward the barrier's bytes like the rest of the box.
bool make_map(CUtensorMap* map, const void* ptr, int hd, int heads, int seq,
              int batch, int dc, int box_heads, int box_seq) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)seq * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)dc, (cuuint32_t)box_heads,
                             (cuuint32_t)box_seq, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      dc == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
               : dc == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// HD: the layout's head dim; HDT: the tensors' (the tensor maps' dim 0).
template <int HD, int HDT = HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int KH, int causal,
                   float scale, cudaStream_t stream) {
  using C = Cfg<HD>;
  const int G = H / KH, TQ = kRows / G;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, HDT, H, Sq, B, C::DC, G, TQ) ||
      !make_map(&tk, k, HDT, KH, Sk, B, C::DC, 1, C::BN) ||
      !make_map(&tv, v, HDT, KH, Sk, B, C::DC, 1, C::BN))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90<HD, HDT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + TQ - 1) / TQ, KH, B);
  flash_fwd_sm90<HD, HDT><<<grid, kThreads, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Sk, H, G, TQ, causal,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// bf16 only. The wrapper has checked shapes, contiguity, 16-byte aligned
// pointers, H % KH == 0, G = H / KH <= 64 and hd in {16, 32, 64, 80, 112,
// 128, 256}.
extern "C" int repro_flash_attention_sm90(const void* q, const void* k,
                                          const void* v, void* o, int B,
                                          int Sq, int Sk, int H, int KH,
                                          int hd, int causal, float scale,
                                          void* stream) {
  if (KH <= 0 || H % KH != 0 || H / KH > 64 || B <= 0 || Sq <= 0 || Sk <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, B, Sq, Sk, H, KH, causal, scale, s);
    case 32: return launch<32>(q, k, v, o, B, Sq, Sk, H, KH, causal, scale, s);
    case 64: return launch<64>(q, k, v, o, B, Sq, Sk, H, KH, causal, scale, s);
    case 80:
      return launch<128, 80>(q, k, v, o, B, Sq, Sk, H, KH, causal, scale, s);
    case 112:
      return launch<128, 112>(q, k, v, o, B, Sq, Sk, H, KH, causal, scale, s);
    case 128:
      return launch<128>(q, k, v, o, B, Sq, Sk, H, KH, causal, scale, s);
    case 256:
      return launch<256>(q, k, v, o, B, Sq, Sk, H, KH, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
