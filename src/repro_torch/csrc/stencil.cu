// Hand-written Hopper (sm_90a) kernels for the four stencil engine policies.
//
// Each kernel replaces one Pallas kernel of the JAX package
// (src/repro/engine/policies.py) and computes exactly the f32 operations of
// its plain PyTorch version (src/repro_torch/engine/policies.py): every tap
// is one __fmul_rn and one __fadd_rn, in tap order, so nothing is contracted
// into a fused multiply-add whatever -fmad says, and the results are held
// against the plain versions bit for bit. This file alone is built with
// -ftz=true (src/repro_torch/kernels/build.py), so each multiply and add
// reads subnormal operands as zero and flushes a subnormal result to zero,
// as XLA's arithmetic does and the plain versions do explicitly. Values
// are stored in the grid dtype with round-to-nearest-even
// (__float2bfloat16_rn for bf16).
//
// Grids are ringed (H, W) planes, row-major and contiguous, with an optional
// batch of planes along gridDim.z. The kernels write interior cells only;
// the caller keeps the r-deep ring of the output buffer equal to the input.
//
// Bounds on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): one sweep of a grid must read it once and write its interior
// once, 8 bytes a cell in f32 and 4 in bf16, against 2*taps-1 f32
// operations a cell, so every one-sweep kernel here (K2, K3, K4) is bound
// by bytes: 0.011281 ms in bf16 and 0.022561 in f32 at 1026 x 9218. The
// temporal kernel divides the bytes by t and multiplies the operations by
// t. The peak counts a fused multiply-add as two operations; these kernels
// issue each multiply and add alone, at half that rate, so K1 at t = 8 is
// bound by operations in bf16 (5-point: 0.0158 ms against 0.0113 of
// bytes). A plain copy of that grid's bytes (Tensor.copy_) takes 0.0136
// ms warm and 0.0180 ms cold in bf16 on that card (launch/sweep_ab.py,
// PERF.md).
//
// The tap table (offsets and f32 weights) rides in registers: each general
// kernel is instantiated for a tap bound NT in {4, 8, 16, 32}, its tap
// loops are unrolled to NT, and taps past the spec's count are skipped.
// K1, K2 and K3 have a second form, compiled for each tap geometry the repo
// ships (offsets as constants), which the wrappers pick by the spec's
// offsets.
//
// C interface: one extern "C" launcher per policy, returning cudaError_t
// (the launch's cudaGetLastError()); K1's picks its kernel from the
// geometry, the mask and t, and repro_temporal_chain enqueues a schedule's
// K1 blocks in one call. Built by repro_torch/kernels/build.py with nvcc
// -gencode arch=compute_90a,code=sm_90a and loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#define MAX_TAPS 32
#define THREADS 256
#define TX 32  // threads along a row: a warp reads one contiguous span
#define TY (THREADS / TX)
#define NWARPS (THREADS / 32)
#define FULL_MASK 0xffffffffu

struct Taps {
  int n;
  int dy[MAX_TAPS];
  int dx[MAX_TAPS];
  float w[MAX_TAPS];
};

struct Sources {
  const void* p[MAX_TAPS];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The taps in registers: each tap's offset in elements of a tile whose rows
// are `pitch` apart, and its f32 weight (unused slots are zero).
template <int NT>
struct RegTaps {
  int n;
  int off[NT];
  float w[NT];
};

template <int NT>
__device__ __forceinline__ RegTaps<NT> reg_taps(const Taps& tp, int pitch) {
  RegTaps<NT> rt;
  rt.n = tp.n;
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    rt.off[k] = tp.dy[k] * pitch + tp.dx[k];
    rt.w[k] = tp.w[k];
  }
  return rt;
}

// f32 sum of the taps around tile element `idx`, in tap order, no FMA.
template <int NT, typename S>
__device__ __forceinline__ float tap_sum(const S* tile, int idx,
                                         const RegTaps<NT>& rt) {
  float acc = __fmul_rn(to_f32(tile[idx + rt.off[0]]), rt.w[0]);
#pragma unroll
  for (int k = 1; k < NT; ++k)
    if (k < rt.n)
      acc = __fadd_rn(acc, __fmul_rn(to_f32(tile[idx + rt.off[k]]), rt.w[k]));
  return acc;
}

// Tile geometry shared by the tile kernels: the output tile of block
// (x, y) starts at interior cell (R0, C0) in grid coordinates and is
// rows x cols (smaller than bm x bn on the ragged bottom and right edges).
struct Tile {
  int R0, C0, rows, cols;
};

__device__ __forceinline__ Tile tile_at(int ty, int tx, int H, int W, int r,
                                        int bm, int bn) {
  Tile t;
  t.R0 = r + ty * bm;
  t.C0 = r + tx * bn;
  t.rows = min(bm, H - r - t.R0);
  t.cols = min(bn, W - r - t.C0);
  return t;
}

// ---------------------------------------------------------------------------
// Tap geometries the repo ships. K1, K2 and K3 each have a form compiled for
// every one of them (offsets as constants, weights run-time arguments); the
// wrappers pick it by an exact, ordered match of the spec's offsets
// (repro_torch/engine/plan.py::TEMPORAL_GEOMETRIES), and every other spec
// runs the general form. Offsets in tap order, as the Python table lists
// them. PIPE marks those K1's register pipeline is compiled for
// (plan.py::TEMPORAL_PIPELINE).
// ---------------------------------------------------------------------------
struct Jacobi5 {
  static constexpr int N = 4;
  static constexpr bool PIPE = true;
  __host__ __device__ static constexpr int dy(int k) {
    constexpr int a[N] = {-1, 1, 0, 0};
    return a[k];
  }
  __host__ __device__ static constexpr int dx(int k) {
    constexpr int a[N] = {0, 0, -1, 1};
    return a[k];
  }
};
struct Laplace9 {
  static constexpr int N = 8;
  static constexpr bool PIPE = false;
  __host__ __device__ static constexpr int dy(int k) {
    constexpr int a[N] = {-1, -1, -1, 0, 0, 1, 1, 1};
    return a[k];
  }
  __host__ __device__ static constexpr int dx(int k) {
    constexpr int a[N] = {-1, 0, 1, -1, 1, -1, 0, 1};
    return a[k];
  }
};
struct Radius2 {
  static constexpr int N = 5;
  static constexpr bool PIPE = true;
  __host__ __device__ static constexpr int dy(int k) {
    constexpr int a[N] = {-2, -1, 0, 0, 0};
    return a[k];
  }
  __host__ __device__ static constexpr int dx(int k) {
    constexpr int a[N] = {0, 0, 0, -2, 1};
    return a[k];
  }
};

// What a geometry implies: the rows its taps reach (DYMIN..DYMAX, always
// including 0), its radius, and per tap row the columns it needs from the
// lane on the left and on the right.
template <typename G>
struct Geo {
  __host__ __device__ static constexpr int dymin() {
    int m = 0;
    for (int k = 0; k < G::N; ++k) m = G::dy(k) < m ? G::dy(k) : m;
    return m;
  }
  __host__ __device__ static constexpr int dymax() {
    int m = 0;
    for (int k = 0; k < G::N; ++k) m = G::dy(k) > m ? G::dy(k) : m;
    return m;
  }
  __host__ __device__ static constexpr int hrad() {
    int m = 0;
    for (int k = 0; k < G::N; ++k) {
      m = G::dx(k) > m ? G::dx(k) : m;
      m = -G::dx(k) > m ? -G::dx(k) : m;
    }
    return m;
  }
  __host__ __device__ static constexpr int left(int dy) {
    int m = 0;
    for (int k = 0; k < G::N; ++k)
      if (G::dy(k) == dy && -G::dx(k) > m) m = -G::dx(k);
    return m;
  }
  __host__ __device__ static constexpr int right(int dy) {
    int m = 0;
    for (int k = 0; k < G::N; ++k)
      if (G::dy(k) == dy && G::dx(k) > m) m = G::dx(k);
    return m;
  }
  __host__ __device__ static constexpr bool used(int dy) {
    for (int k = 0; k < G::N; ++k)
      if (G::dy(k) == dy) return true;
    return false;
  }
  static constexpr int DYMIN = dymin(), DYMAX = dymax();
  static constexpr int NW = DYMAX - DYMIN + 1;  // rows held in registers
  static constexpr int HR = hrad();
  static constexpr int R = (-DYMIN > DYMAX ? -DYMIN : DYMAX) > HR
                               ? (-DYMIN > DYMAX ? -DYMIN : DYMAX)
                               : HR;
};

// f(std::integral_constant<int, i>{}) for i = 0 .. N-1, unrolled.
template <typename F, int... Is>
__device__ __forceinline__ void static_for_(F&& f,
                                            std::integer_sequence<int, Is...>) {
  (f(std::integral_constant<int, Is>{}), ...);
}
template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_(f, std::make_integer_sequence<int, N>{});
}

// ---------------------------------------------------------------------------
// K2 rowchunk and K3 dbuf: one sweep out of a window in shared memory.
//
// K2 replaces repro/engine/policies.py::stencil_rowchunk (_rowchunk_kernel):
// each TPU grid step DMAs one (bm + 2r)-row chunk into VMEM and serves every
// tap from it. K3 replaces stencil_dbuf (_dbuf_kernel): the same function,
// the next chunk's DMA started while this one computes. Bound: a sweep
// reads the grid once and writes its interior once, 4 bytes a cell in bf16
// and 8 in f32, 0.011281 ms and 0.022561 ms at 1026 x 9218 at 3.35 TB/s; the
// 2*taps - 1 f32 operations a cell take a tenth of that.
//
// A 9218-wide row does not fit shared memory, so a block's window is a
// (bm + 2r) x (bn + 2r) tile of the grid, kept raw in the grid dtype. Each
// window row is copied as the 16-byte chunks that cover it, from the 16-byte
// boundary at or below its first column: the paper grid's row pitch (18,436
// bytes in bf16, 36,872 in f32) is no multiple of 16, so that column sits at
// another byte of its chunk in every row, and the copies (cp.async and
// cp.async.bulk move aligned 16-byte units) cannot realign it. At most two
// chunks of a whole tensor stick out of its extent (a view at any offset, a
// length that is no multiple of 16 bytes); their cells are copied one by
// one, so nothing outside the tensor is read.
//
// Compute: a thread takes one 16-byte chunk of an output row at a time (8
// bf16 or 4 f32 cells), chunks cut at the output row's own 16-byte
// boundaries, so a whole chunk is one 16-byte store. For each tap row it
// reads the chunk's cells and the taps' reach either side out of the window
// with two or three aligned 16-byte shared loads, shifts them into place in
// registers (a select by the 4-byte offset, a __funnelshift_r by the 2-byte
// one), widens to f32 and sums the taps in tap order. A chunk at a tile's
// left or right edge stores its own cells one by one, so neither the ring
// nor another tile's cells are written. Work is dealt out as (row, chunk)
// pairs over all threads, so every tile width keeps all threads busy. A
// compiled geometry reads each tap row once and unrolls its taps; the
// general form reads each tap's cells on their own, up to 32 taps.
//
// K2 (rowchunk): a block computes one tile. All its threads copy the window
// with 16-byte cp.async, wait for all of it and compute: no pipeline, as the
// TPU kernel waits for its one DMA. Blocks on one SM overlap one another.
// K3 (dbuf): a block walks a run of tiles down one column strip. A producer
// warp, a lane a window row, copies each window with one cp.async.bulk a
// row into a ring of DBUF_STAGES windows, each completing on its stage's
// full mbarrier; eight consumer warps compute a full stage and hand it back
// on its empty mbarrier, so window i + 1 is in flight while window i is
// computed. The launcher sizes the runs so the grid fills the card's
// resident blocks, two tiles a block at least. The TPU's asynchronous
// write-back needs no counterpart: stores do not block.
//
// What holds them on an H100 (PERF.md, 8-row x 1016 K2 and 16 x 504 K3
// tiles): in bf16 the sums' instruction issue as much as memory (about
// 210 SASS instructions a 16-byte chunk: the shifts into place, widening,
// the taps unfused, addresses; without its sums K3 runs near copy_'s
// time); in f32 the copy path (without its sums K3 keeps most of its).
// Tried and not kept: a row walk with the tap rows in registers and the
// output realigned by shuffles (96 registers, slower), two chunks a thread
// and 512 consumers (slower), the shifts as warp-uniform branches in place
// of selects (bf16 K3 5% faster, f32 K3 8% slower).
// ---------------------------------------------------------------------------
#define WIN_LEAD 16    // bytes of slack before a window row's data
#define WIN_TAIL 32    // and after it: the widest read runs 32 bytes past
#define DBUF_STAGES 2  // K3's ring of windows
#define DBUF_BARS 64   // bytes ahead of K3's stages: its full and empty
                       // mbarriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Row g of a tile's window: the bytes [p0, p1) of its columns X0 .. X1-1,
// the 16-byte chunks [c0, c1) that cover them, and [b0, b1), those of the
// chunks that lie whole inside the tensor's extent [lo, hi).
struct WinRow {
  uintptr_t p0, p1, c0, c1, b0, b1;
};

template <typename T>
__device__ __forceinline__ WinRow win_row(const T* plane, int W, int g,
                                          int X0, int X1, uintptr_t lo,
                                          uintptr_t hi) {
  WinRow w;
  const T* row = plane + (size_t)g * W;
  w.p0 = reinterpret_cast<uintptr_t>(row + X0);
  w.p1 = reinterpret_cast<uintptr_t>(row + X1);
  w.c0 = w.p0 & ~(uintptr_t)15;
  w.c1 = (w.p1 + 15) & ~(uintptr_t)15;
  w.b0 = w.c0 < lo ? w.c0 + 16 : w.c0;
  w.b1 = w.c1 > hi ? w.c1 - 16 : w.c1;
  return w;
}

// The window cells of the (at most two) chunks of row `w` that stick out of
// the tensor's extent, copied one by one into the row's data at `dst`.
template <typename T>
__device__ void copy_edge_cells(unsigned char* dst, const WinRow& w) {
  using Bits = typename std::conditional<sizeof(T) == 2, uint16_t,
                                         uint32_t>::type;
  auto cells = [&](uintptr_t a, uintptr_t b) {
    for (uintptr_t p = a; p < b; p += sizeof(T))
      *reinterpret_cast<Bits*>(dst + (p - w.c0)) =
          *reinterpret_cast<const Bits*>(p);
  };
  if (w.b0 != w.c0) cells(w.p0, w.c0 + 16 < w.p1 ? w.c0 + 16 : w.p1);
  if (w.b1 != w.c1) cells(w.c1 - 16 > w.p0 ? w.c1 - 16 : w.p0, w.p1);
}

// K2's fill: every thread copies chunks with 16-byte cp.async (a warp a
// window row), then the block waits for all of them.
template <typename T>
__device__ __forceinline__ void window_fill_all(unsigned char* win, int pitch,
                                                const T* plane, int W, int r,
                                                const Tile& tl, uintptr_t lo,
                                                uintptr_t hi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int X0 = tl.C0 - r, X1 = tl.C0 + tl.cols + r;
  for (int a = warp; a < tl.rows + 2 * r; a += NWARPS) {
    const WinRow w = win_row(plane, W, tl.R0 - r + a, X0, X1, lo, hi);
    unsigned char* dst = win + a * pitch + WIN_LEAD;
    for (uintptr_t p = w.b0 + 16 * lane; p < w.b1; p += 16 * 32)
      cp_async16(dst + (p - w.c0), reinterpret_cast<const void*>(p));
    if (lane == 0) copy_edge_cells<T>(dst, w);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// K3's fill, by the producer warp, a lane a window row: the cells that
// stick out first, then one arrival (lane 0's) that expects the bulk bytes,
// then one bulk copy a row.
template <typename T>
__device__ __forceinline__ void window_fill_bulk(unsigned char* win,
                                                 int pitch, const T* plane,
                                                 int W, int r, const Tile& tl,
                                                 uintptr_t lo, uintptr_t hi,
                                                 uint64_t* full, int lane) {
  const int X0 = tl.C0 - r, X1 = tl.C0 + tl.cols + r;
  const int rows = tl.rows + 2 * r;
  uint32_t bytes = 0;
  bool edges = false;
  for (int a = lane; a < rows; a += 32) {
    const WinRow w = win_row(plane, W, tl.R0 - r + a, X0, X1, lo, hi);
    if (w.b1 > w.b0) bytes += (uint32_t)(w.b1 - w.b0);
    if (w.b0 != w.c0 || w.b1 != w.c1) {
      copy_edge_cells<T>(win + a * pitch + WIN_LEAD, w);
      edges = true;
    }
  }
  bytes = __reduce_add_sync(FULL_MASK, bytes);
  // The ring's later bulk copies into these bytes come after these stores.
  if (__any_sync(FULL_MASK, edges))
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();  // the lanes' stores before lane 0's arrival
  if (lane == 0) mbar_arrive_expect_tx(full, bytes);
  __syncwarp();
  for (int a = lane; a < rows; a += 32) {
    const WinRow w = win_row(plane, W, tl.R0 - r + a, X0, X1, lo, hi);
    if (w.b1 > w.b0)
      bulk_load(win + a * pitch + WIN_LEAD + (w.b0 - w.c0),
                reinterpret_cast<const void*>(w.b0),
                (uint32_t)(w.b1 - w.b0), full);
  }
}

// The NWD 32-bit words that start at byte `off` of the window (an offset of
// an element, so 4-byte aligned in f32 and 2-byte in bf16: HALF), from the
// aligned 16-byte shared loads at and after the boundary below `off`.
template <int NWD, bool HALF>
__device__ __forceinline__ void window_words(const unsigned char* win,
                                             uint32_t off,
                                             uint32_t (&y)[NWD]) {
  constexpr int NZ = NWD + (HALF ? 1 : 0);  // words before the 2-byte shift
  constexpr int NCH = (NZ + 6) / 4;         // loads: the selects reach NZ + 2
  static_assert(NCH <= 1 + WIN_TAIL / 16, "a read would leave the row");
  uint32_t x[4 * NCH];
  const unsigned char* a = win + (off & ~15u);
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const uint4 v = *reinterpret_cast<const uint4*>(a + 16 * c);
    x[4 * c] = v.x;
    x[4 * c + 1] = v.y;
    x[4 * c + 2] = v.z;
    x[4 * c + 3] = v.w;
  }
  // Words q .. q+NWD-1 of x for q = (off >> 2) & 3 (two selects a word),
  // then the 2-byte shift.
  const bool q2 = off & 8, q1 = off & 4;
  uint32_t z1[NZ + 1], z[NZ];
#pragma unroll
  for (int i = 0; i <= NZ; ++i) z1[i] = q2 ? x[i + 2] : x[i];
#pragma unroll
  for (int i = 0; i < NZ; ++i) z[i] = q1 ? z1[i + 1] : z1[i];
  if constexpr (HALF) {
    const uint32_t f = (off & 2) * 8;
#pragma unroll
    for (int i = 0; i < NWD; ++i) y[i] = __funnelshift_r(z[i], z[i + 1], f);
  } else {
#pragma unroll
    for (int i = 0; i < NWD; ++i) y[i] = z[i];
  }
}

// Cell m of words `y` as f32 (widening bf16 is exact).
template <typename T, int NWD>
__device__ __forceinline__ float cell(const uint32_t (&y)[NWD], int m) {
  if constexpr (sizeof(T) == 4) return __uint_as_float(y[m]);
  return __uint_as_float(m & 1 ? y[m / 2] & 0xffff0000u : y[m / 2] << 16);
}

// acc (= or +=) cells * w, one rounded multiply and one rounded add a cell.
template <int V>
__device__ __forceinline__ void tap(float (&acc)[V], const float* c, float w,
                                    bool first) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float term = __fmul_rn(c[j], w);
    acc[j] = first ? term : __fadd_rn(acc[j], term);
  }
}

// The packed 16 bytes of `acc` in the grid dtype, cells in order.
template <typename T>
__device__ __forceinline__ void pack(const float* acc, uint32_t (&v)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      v[i] = __float_as_uint(acc[i]);
    } else {
      v[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(
                  __float2bfloat16_rn(acc[2 * i + 1]))
              << 16);
    }
  }
}

// The taps of compiled geometry G for one chunk whose first cell is window
// column e0: each tap row's cells read once, the taps unrolled in order.
template <typename T, typename G>
struct GeoTaps {
  static constexpr int E = sizeof(T), V = 16 / E;
  const Taps& tp;
  template <typename SX>
  __device__ __forceinline__ void operator()(const unsigned char* win, SX sx,
                                             int e0, float (&acc)[V]) const {
    using P = Geo<G>;
    constexpr int HR = P::HR;
    float x[P::NW][V + 2 * HR];  // tap row DYMIN + i; cell HR + j is j
    static_for<P::NW>([&](auto ic) {
      constexpr int i = decltype(ic)::value, dy = P::DYMIN + i;
      if constexpr (P::used(dy)) {
        constexpr int L = P::left(dy), NC = V + L + P::right(dy);
        constexpr int NWD = (NC * E + 3) / 4;
        uint32_t y[NWD];
        window_words<NWD, E == 2>(win, sx(dy) + (e0 - L) * E, y);
#pragma unroll
        for (int m = 0; m < NC; ++m) x[i][HR - L + m] = cell<T>(y, m);
      }
    });
    static_for<G::N>([&](auto kc) {
      constexpr int k = decltype(kc)::value;
      tap(acc, &x[G::dy(k) - P::DYMIN][HR + G::dx(k)], tp.w[k], k == 0);
    });
  }
};

// Any spec's taps (up to NT): each tap's V cells read on their own.
template <typename T, int NT>
struct RunTaps {
  static constexpr int E = sizeof(T), V = 16 / E;
  const Taps& tp;
  template <typename SX>
  __device__ __forceinline__ void operator()(const unsigned char* win, SX sx,
                                             int e0, float (&acc)[V]) const {
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      if (k < tp.n) {
        uint32_t y[4];
        window_words<4, E == 2>(win, sx(tp.dy[k]) + (e0 + tp.dx[k]) * E, y);
        float c[V];
#pragma unroll
        for (int j = 0; j < V; ++j) c[j] = cell<T>(y, j);
        tap(acc, c, tp.w[k], k == 0);
      }
    }
  }
};

// Cells jlo .. jhi-1 of the 16-byte aligned chunk at p: one 16-byte store
// when that is all of it, else one store a cell.
template <typename T>
__device__ __forceinline__ void store_chunk(T* p, const float* acc, int jlo,
                                            int jhi) {
  constexpr int V = 16 / sizeof(T);
  if (jlo == 0 && jhi == V) {
    uint32_t v[4];
    pack<T>(acc, v);
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (j >= jlo && j < jhi) p[j] = from_f32<T>(acc[j]);
}

// One sweep of tile `tl` out of its window `win`, whose row a (pitch bytes
// apart) holds grid row tl.R0 - r + a from byte WIN_LEAD on, starting at
// the 16-byte boundary at or below column X0 = tl.C0 - r. Thread `tid` of
// `nthr` takes the (row, chunk) pairs tid, tid + nthr, ... of the tile.
template <typename T, typename Sum>
__device__ __forceinline__ void sweep_window(const unsigned char* win,
                                             int pitch, const T* plane,
                                             T* oplane, int W, int r,
                                             const Tile& tl, int tid,
                                             int nthr, const Sum& sum) {
  constexpr int E = sizeof(T), V = 16 / E;
  const int nk = (tl.cols * E + 31 - E) / 16;  // chunks a row can touch
  // Byte of X0's chunk at which X0 sits in grid row g: ((x0 + g*rb) & 15).
  const uint32_t x0 =
      (uint32_t)reinterpret_cast<uintptr_t>(plane + (tl.C0 - r));
  const uint32_t rb = (uint32_t)W * E;
  int row = tid / nk, k = tid % nk;
  const int dr = nthr / nk, dk = nthr % nk;
  while (row < tl.rows) {
    const int g = tl.R0 + row;
    T* orow = oplane + (size_t)g * W + tl.C0;
    const int osh = (int)(reinterpret_cast<uintptr_t>(orow) & 15);
    const int d = (16 * k - osh) / E;  // the chunk's first cell, from C0
    if (d < tl.cols) {
      auto sx = [&](int dy) -> uint32_t {  // window offset of X0, row g+dy
        return (uint32_t)((row + r + dy) * pitch + WIN_LEAD) +
               ((x0 + (uint32_t)(g + dy) * rb) & 15u);
      };
      float acc[V];
      sum(win, sx, r + d, acc);
      store_chunk(orow + d, acc, d < 0 ? -d : 0,
                  tl.cols - d < V ? tl.cols - d : V);
    }
    row += dr;
    k += dk;
    if (k >= nk) {
      k -= nk;
      ++row;
    }
  }
}

template <typename T, typename Sum>
__global__ void __launch_bounds__(THREADS)
    rowchunk_kernel(const T* __restrict__ u, T* __restrict__ out, int H,
                    int W, int r, int bm, int bn, int pitch, Taps tp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t plane = (size_t)H * W;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(u);
  const uintptr_t hi = reinterpret_cast<uintptr_t>(u + gridDim.z * plane);
  u += blockIdx.z * plane;
  out += blockIdx.z * plane;
  const Tile tl = tile_at(blockIdx.y, blockIdx.x, H, W, r, bm, bn);
  window_fill_all(smem, pitch, u, W, r, tl, lo, hi);
  sweep_window(smem, pitch, u, out, W, r, tl, threadIdx.x, THREADS,
               Sum{tp});
}

template <typename T, typename Sum>
__global__ void __launch_bounds__(THREADS + 32)
    dbuf_kernel(const T* __restrict__ u, T* __restrict__ out, int H, int W,
                int r, int bm, int bn, int row_tiles, int tiles_per_block,
                int pitch, Taps tp) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // stage copied in
  uint64_t* empty = full + DBUF_STAGES;                // stage computed
  unsigned char* stages = smem + DBUF_BARS;
  const int stage_bytes = (bm + 2 * r) * pitch;
  const size_t plane = (size_t)H * W;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(u);
  const uintptr_t hi = reinterpret_cast<uintptr_t>(u + gridDim.z * plane);
  u += blockIdx.z * plane;
  out += blockIdx.z * plane;
  const int first = blockIdx.y * tiles_per_block;
  const int last = min(first + tiles_per_block, row_tiles);
  if (first >= last) return;
  if (threadIdx.x == 0) {
    for (int s = 0; s < DBUF_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= THREADS) {  // the producer warp
    const int lane = threadIdx.x - THREADS;
    for (int i = first; i < last; ++i) {
      const int n = i - first, s = n % DBUF_STAGES;
      if (n >= DBUF_STAGES) mbar_wait(&empty[s], (n / DBUF_STAGES - 1) & 1);
      window_fill_bulk(stages + s * stage_bytes, pitch, u, W, r,
                       tile_at(i, blockIdx.x, H, W, r, bm, bn), lo, hi,
                       &full[s], lane);
    }
    return;
  }
  const Sum sum{tp};
  for (int i = first; i < last; ++i) {
    const int n = i - first, s = n % DBUF_STAGES;
    mbar_wait(&full[s], (n / DBUF_STAGES) & 1);
    sweep_window(stages + s * stage_bytes, pitch, u, out, W, r,
                 tile_at(i, blockIdx.x, H, W, r, bm, bn), threadIdx.x,
                 THREADS, sum);
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[s]);
  }
}

// ---------------------------------------------------------------------------
// K1 temporal — replaces repro/engine/policies.py::stencil_temporal
// (_temporal_kernel). t sweeps fused. Bound: the same bytes as one sweep
// (22.6 us f32, 11.3 us bf16 at 1026 x 9218) against t times the
// operations ((2*taps-1)*t per cell: 7.9 us of f32 arithmetic at t=8,
// 4 taps). Design: each block loads its bm x bn output tile with a t*r
// halo on all four sides into shared memory as f32 (cells outside the grid
// are zero and pinned: they only ever neighbour ring cells, which are
// pinned too), then runs t sweeps between two f32 tiles, the computed
// region shrinking by r on every side each sweep, so after t sweeps the
// central tile is exact. Pinned cells (the r-deep ring, cells outside the
// grid, and with a mask every nonzero mask cell) hold their input value in
// both tiles and are never written. The tile is rounded once to the dtype
// on the way out. The kernel runs out of place: neighbouring tiles read
// the input. Redundant halo work grows as (1 + 2tr/bm)(1 + 2tr/bn), and
// the sweeps run from shared memory, which is what bounds it in practice.
// ---------------------------------------------------------------------------
template <typename T, int NT, bool MASKED>
__global__ void __launch_bounds__(THREADS)
    temporal_kernel(const T* __restrict__ u,
                    const uint8_t* __restrict__ mask, T* __restrict__ out,
                    int H, int W, int r, int t, int bm, int bn, Taps tp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t plane = (size_t)H * W;
  u += blockIdx.z * plane;
  out += blockIdx.z * plane;
  if (MASKED) mask += blockIdx.z * plane;
  const Tile tl = tile_at(blockIdx.y, blockIdx.x, H, W, r, bm, bn);
  const int halo = t * r;
  const int TH = tl.rows + 2 * halo, TW = tl.cols + 2 * halo;
  const int N = TH * TW;
  const RegTaps<NT> rt = reg_taps<NT>(tp, TW);
  float* A = reinterpret_cast<float*>(smem);
  float* B = A + N;
  uint8_t* pin = reinterpret_cast<uint8_t*>(B + N);
  const int g0 = tl.R0 - halo, c0 = tl.C0 - halo;  // grid cell of tile (0,0)
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;

  for (int a = ty; a < TH; a += TY) {
    const int g = g0 + a;
    for (int b = tx; b < TW; b += TX) {
      const int c = c0 + b;
      const bool inside = g >= 0 && g < H && c >= 0 && c < W;
      const float v = inside ? to_f32(u[(size_t)g * W + c]) : 0.0f;
      A[a * TW + b] = v;
      B[a * TW + b] = v;
      if (MASKED) {
        const bool ring = g < r || g >= H - r || c < r || c >= W - r;
        pin[a * TW + b] = ring || mask[(size_t)g * W + c] != 0;
      }
    }
  }
  __syncthreads();

  float* src = A;
  float* dst = B;
  for (int s = 1; s <= t; ++s) {
    const int lo = s * r;
    for (int a = lo + ty; a < TH - lo; a += TY) {
      const int g = g0 + a;
      const bool ring_row = g < r || g >= H - r;
      for (int b = lo + tx; b < TW - lo; b += TX) {
        const int idx = a * TW + b;
        bool pinned;
        if (MASKED) {
          pinned = pin[idx];
        } else {
          const int c = c0 + b;
          pinned = ring_row || c < r || c >= W - r;
        }
        if (!pinned) dst[idx] = tap_sum(src, idx, rt);
      }
    }
    __syncthreads();
    float* tmp = src;
    src = dst;
    dst = tmp;
  }

  for (int a = ty; a < tl.rows; a += TY) {
    T* orow = out + (size_t)(tl.R0 + a) * W + tl.C0;
    const float* trow = src + (a + halo) * TW + halo;
    for (int b = tx; b < tl.cols; b += TX) orow[b] = from_f32<T>(trow[b]);
  }
}

// ---------------------------------------------------------------------------
// K1 temporal, compiled geometries — the same function as temporal_kernel
// for the tap geometries the repo ships, with the offsets fixed at compile
// time (weights stay run-time arguments). The wrapper picks a geometry by
// an exact, ordered match of the spec's offsets
// (repro_torch/engine/plan.py::TEMPORAL_GEOMETRIES); every other spec runs
// temporal_kernel above. An unmasked plan of LEVELS sweeps on a geometry
// marked PIPE runs temporal_pipe_kernel, every other one
// temporal_geo_kernel. All three compute the same f32 operations in the
// same order.
//
// Registers cannot be indexed by run-time offsets, so each geometry is a
// type whose offsets are constants: taps, register slots and shuffles
// unroll away. A thread owns one 4-column quad of a 128-cell row (a warp
// spans it); the columns left and right of its quad come from the
// neighbouring lanes by warp shuffles. Grid quads are read and written one
// 16-byte (f32) or 8-byte (bf16) access where the quad's address is
// aligned, else element by element: the odd pitch 9218 aligns no quad.
// ---------------------------------------------------------------------------
#define QUADS 32           // 4-column quads a warp's row holds
#define TROW (4 * QUADS)   // cells a row of a warp's strip (or tile) holds

__device__ __forceinline__ void lds_quad(const float* s, float (&q)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  q[0] = v.x;
  q[1] = v.y;
  q[2] = v.z;
  q[3] = v.w;
}

// The f32 values of grid cells (g, c .. c+3); zero outside the grid. One
// 16-byte (f32) or 8-byte (bf16) load where the quad's address is aligned.
template <typename T>
__device__ __forceinline__ void ldg_quad(const T* __restrict__ u, int g, int c,
                                         int H, int W, float (&q)[4]) {
  if (g < 0 || g >= H) {
    q[0] = q[1] = q[2] = q[3] = 0.0f;
    return;
  }
  const T* p = u + (size_t)g * W + c;
  if (c >= 0 && c + 4 <= W &&
      (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(T) - 1)) == 0) {
    if constexpr (std::is_same<T, float>::value) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p));
      q[0] = v.x;
      q[1] = v.y;
      q[2] = v.z;
      q[3] = v.w;
    } else {  // four bf16 in 8 bytes; widening is exact
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      q[0] = __uint_as_float(v.x << 16);
      q[1] = __uint_as_float(v.x & 0xffff0000u);
      q[2] = __uint_as_float(v.y << 16);
      q[3] = __uint_as_float(v.y & 0xffff0000u);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    q[j] = c + j >= 0 && c + j < W ? to_f32(p[j]) : 0.0f;
}

// Grid cells (g, c .. c+n-1), n <= 4, rounded to T: one 16-byte (f32) or
// 8-byte (bf16) store where the quad is whole and its address aligned.
template <typename T>
__device__ __forceinline__ void stg_quad(T* __restrict__ out, int g, int c,
                                         int W, int n, const float (&q)[4]) {
  T* p = out + (size_t)g * W + c;
  if (n == 4 && (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(T) - 1)) == 0) {
    if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float4*>(p) = make_float4(q[0], q[1], q[2], q[3]);
    } else {
      uint2 v;
      v.x = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(q[0])) |
            ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(q[1])) << 16);
      v.y = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(q[2])) |
            ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(q[3])) << 16);
      *reinterpret_cast<uint2*>(p) = v;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < n) p[j] = from_f32<T>(q[j]);
}

// ---------------------------------------------------------------------------
// K1 unmasked on a compiled geometry at t = LEVELS: a register pipeline
// across sweeps.
//
// What bounds it on an H100 is issue slots. A 5-point sweep is 4 FMUL and 3
// FADD a cell (no FMA, for exactness) and an SM issues one warp
// instruction a clock on each of its four schedulers, so the 75.5 M
// cell-sweeps of a launch at 1026 x 9218, t = 8, need 15.8 us at the
// 1.98 GHz it runs at with nothing else issued; the bytes (the grid read
// once, its interior written once) need 11.3 us in bf16 and 22.6 in f32
// from HBM, and the paper's bf16 grid pair sits in the 50 MB L2. The
// shared-memory design (temporal_geo_kernel) loads a window 1.6x its
// output, computes 1.34x the useful cells, stops at a block barrier every
// sweep, and fits three blocks an SM.
//
// Design: each warp owns one column strip of TROW cells, bn of them its
// output with LEVELS*r columns of halo either side, and one segment of bm
// rows. It marches down the rows. At every step a grid row enters level 0,
// and each level k = 1..LEVELS computes one row from the last NW rows of
// level k-1 (NW = the rows the taps span, 3 for every shipped geometry),
// kept in registers; level LEVELS's row is rounded once and stored. A grid
// row so
// passes through every sweep as a diagonal wavefront, and one row is
// written a row advanced. No shared memory and no barrier. The window's
// overhead is the strip's halo columns (128 / 112 at t = 8) plus the
// segment's LEVELS*r warm-up rows above and below, whose warm-up steps
// skip the
// levels that hold no valid row yet. Registers: LEVELS x NW quads (96
// floats); __launch_bounds__(32, 14) has ptxas fit the kernel in 128
// registers without spilling, 16 warps an SM.
//
// What it took on the card (PERF.md, PR 36): the compiler wraps every
// shuffle in a reconvergence sequence (WARPSYNC) unless it can prove the
// warp converged, so a block is one warp, every branch is on values from
// blockIdx and the arguments, and per-lane conditions are predicates. A
// load's result must not be touched until it is used NW steps later (a
// select or a widening right behind it stalls every step on the L2), so
// grid cells are loaded raw by inline PTX and widened at use.
//
// Pins: a warp whose computed cells meet no ring cell takes a path with no
// test. Edge warps keep, where a cell is pinned, the middle tap of the
// level below, which for a pinned cell is its input: ring rows and ring
// columns. Rows and columns outside the grid read zero and are pinned:
// they only ever neighbour ring cells.
//
// Where it runs (PERF.md, PR 36): only at t = LEVELS, and for the
// geometries marked PIPE. At t = 1 and 3 it took longer than
// temporal_geo_kernel (its per-cell loads and stores are paid for once a
// row whatever t), and cutting its levels at t made ptxas spill the whole
// kernel; the 9-point stencil at t = 8 ran no faster than there. It still
// takes any t up to LEVELS (its pin path carries the levels past t
// through): with t folded into a constant the bf16 5-point kernel ran 5%
// slower.
// ---------------------------------------------------------------------------
#define LEVELS 8  // sweeps a warp carries in registers: its t

// One level's new row for the thread's quad: the taps summed in tap order
// (no FMA) over rows x[i] = level k-1's row a + DYMIN + i, which sit in
// ring slots (PH + i) % NW of `src`.
template <typename G, int PH>
__device__ __forceinline__ void pipe_level(
    const float (&src)[Geo<G>::NW][4], float (&acc)[4], const Taps& tp) {
  using P = Geo<G>;
  constexpr int NW = P::NW, HR = P::HR;
  float x[NW][4 + 2 * HR];
  static_for<NW>([&](auto ic) {
    constexpr int i = decltype(ic)::value;
    constexpr int slot = (PH + i) % NW;
    constexpr int dy = P::DYMIN + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][HR + j] = src[slot][j];
    static_for<P::left(dy)>([&](auto mc) {
      constexpr int m = decltype(mc)::value;  // column -1 - m
      x[i][HR - 1 - m] = __shfl_up_sync(FULL_MASK, src[slot][3 - m], 1);
    });
    static_for<P::right(dy)>([&](auto mc) {
      constexpr int m = decltype(mc)::value;  // column 4 + m
      x[i][HR + 4 + m] = __shfl_down_sync(FULL_MASK, src[slot][m], 1);
    });
  });
  static_for<G::N>([&](auto kc) {
    constexpr int k = decltype(kc)::value;
    constexpr int i = G::dy(k) - P::DYMIN, c = HR + G::dx(k);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float term = __fmul_rn(x[i][c + j], tp.w[k]);
      if constexpr (k == 0)
        acc[j] = term;
      else
        acc[j] = __fadd_rn(acc[j], term);
    }
  });
}

// A grid cell as loaded: the f32 value, or a bf16's bits in the low half
// of the word (widen() makes them f32). The loaded register is touched by
// nothing until its consumer NW steps later, so the load's latency stalls
// no step; `ok` false loads nothing and gives zero.
__device__ __forceinline__ float ldg_raw(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float ldg_raw(const __nv_bfloat16* p) {
  unsigned b;
  asm volatile("ld.global.nc.u16 %0, [%1];" : "=r"(b) : "l"(p));
  return __uint_as_float(b);
}
__device__ __forceinline__ float ldg_raw(const float* p, bool ok) {
  float v;
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n mov.b32 %0, 0;\n"
      " @q ld.global.nc.f32 %0, [%1];\n}"
      : "=f"(v) : "l"(p), "r"((unsigned)ok));
  return v;
}
__device__ __forceinline__ float ldg_raw(const __nv_bfloat16* p, bool ok) {
  unsigned b;
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n mov.b32 %0, 0;\n"
      " @q ld.global.nc.u16 %0, [%1];\n}"
      : "=r"(b) : "l"(p), "r"((unsigned)ok));
  return __uint_as_float(b);
}
template <typename T>
__device__ __forceinline__ float widen(float raw) {
  if constexpr (std::is_same<T, float>::value)
    return raw;
  else
    return __uint_as_float(__float_as_uint(raw) << 16);  // exact
}

// A warp's segment: rows [R0, R0 + rows) of its strip, the thread's quad
// at column c. Step s reads grid row gs + s into level 0 and level k
// computes row gs + s - k*D1; level LEVELS's rows from step s0 on are the
// output. Ring slot s % NW of each level holds the row of step s. Every
// branch here is on values the whole warp shares (a block is one warp,
// and every value comes from blockIdx and the arguments), and per-lane
// conditions are predicates, so the warp stays converged and the shuffles
// need no reconvergence.
//   EDGE: the pin path (see above), its loads and stores tested cell by
//     cell. Without it (the pin-free path) every cell loaded is inside the
//     grid (a row past the last is clamped to it: no level needs it) and a
//     lane stores its whole quad or none of it.
//   WARM: skip the levels with no valid row yet (the pin-free path's first
//     steps: level k has one from step k*(D0 + D1) on, level LEVELS from
//     s0 on, so its stores need no test).
//   GUARD: stop at nsteps.
template <typename G>
struct Pipe {
  using P = Geo<G>;
  static constexpr int NW = P::NW, D0 = -P::DYMIN, D1 = P::DYMAX;
  float win[LEVELS][NW][4];  // win[k]: the last NW rows of level k
  float pf[NW][4];           // grid rows in flight: slot s % NW, step s + NW
  int gs, s0, nsteps;

  template <typename T, bool EDGE>
  __device__ __forceinline__ void load(const T* __restrict__ u, int g, int c,
                                       int H, int W, float (&q)[4]) {
    if constexpr (EDGE) {
      const bool row = g >= 0 && g < H;
      const T* p = u + (size_t)(row ? g : 0) * W + c;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        q[j] = ldg_raw(p + j, row && c + j >= 0 && c + j < W);
    } else {
      const T* p = u + (size_t)min(g, H - 1) * W + c;
#pragma unroll
      for (int j = 0; j < 4; ++j) q[j] = ldg_raw(p + j);
    }
  }

  template <typename T, bool EDGE, bool WARM, bool GUARD>
  __device__ __forceinline__ void steps(
      const T* __restrict__ u, T* __restrict__ out, int s, int H, int W,
      int r, int t, int c, unsigned store, unsigned col_pins,
      const Taps& tp) {
    static_for<NW>([&](auto pc) {
      constexpr int p = decltype(pc)::value;  // s % NW == 0
      const int sp = s + p;
      if (GUARD && sp >= nsteps) return;
#pragma unroll
      for (int j = 0; j < 4; ++j) win[0][p][j] = widen<T>(pf[p][j]);
      load<T, EDGE>(u, gs + sp + NW, c, H, W, pf[p]);
      static_for<LEVELS>([&](auto kc) {
        constexpr int k = decltype(kc)::value + 1;
        if (WARM && sp < k * (D0 + D1)) return;
        float acc[4];
        pipe_level<G, (p + 1) % NW>(win[k - 1], acc, tp);
        if constexpr (EDGE) {
          constexpr int mid = (p + 1 + D0) % NW;  // tap row dy = 0
          const int a = gs + sp - k * D1;
          const bool keep = k > t || a < r || a >= H - r;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[j] = keep || (col_pins >> j & 1u) ? win[k - 1][mid][j]
                                                   : acc[j];
        }
        if constexpr (k < LEVELS) {
#pragma unroll
          for (int j = 0; j < 4; ++j) win[k][p][j] = acc[j];
        } else if (!EDGE || sp >= s0) {
          T* o = out + (size_t)(gs + sp - LEVELS * D1) * W + c;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (store >> (EDGE ? j : 0) & 1u) o[j] = from_f32<T>(acc[j]);
        }
      });
    });
  }
};

// One warp a block: blockIdx.x is the strip, blockIdx.y the segment.
template <typename T, typename G>
__global__ void __launch_bounds__(32, 14)
    temporal_pipe_kernel(const T* __restrict__ u, T* __restrict__ out,
                         int H, int W, int r, int t, int bm, int bn,
                         Taps tp) {
  const int lane = threadIdx.x;
  const size_t plane = (size_t)H * W;
  u += blockIdx.z * plane;
  out += blockIdx.z * plane;
  const Tile tl = tile_at(blockIdx.y, blockIdx.x, H, W, r, bm, bn);
  using Q = Pipe<G>;
  constexpr int NW = Q::NW, D0 = Q::D0, D1 = Q::D1;
  Q q;
  q.gs = tl.R0 - t * D0;
  q.s0 = t * D0 + LEVELS * D1;
  q.nsteps = q.s0 + tl.rows;
  const int c0 = tl.C0 - t * r;  // the strip's first column
  const int c = c0 + 4 * lane;
  unsigned store = 0, col_pins = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    store |= (unsigned)(c + j >= tl.C0 && c + j < tl.C0 + tl.cols) << j;
    col_pins |= (unsigned)(c + j < r || c + j >= W - r) << j;
  }
#pragma unroll
  for (int k = 0; k < LEVELS; ++k)
#pragma unroll
    for (int i = 0; i < NW; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) q.win[k][i][j] = 0.0f;

  // Every computed row and column clear of the ring, no level past t, and
  // the tile's columns whole quads of the strip: no pin test, and a lane
  // stores all of its quad or none. Level 1 computes rows gs + D0 ..
  // R0 + rows - 1 + (t-1)*D1.
  const bool pin_free = t == LEVELS && q.gs + D0 >= r &&
                        tl.R0 + tl.rows + (t - 1) * D1 <= H - r && c0 >= r &&
                        c0 + TROW <= W - r && (t * r) % 4 == 0 &&
                        tl.cols % 4 == 0;
  if (pin_free) {
    // The first and the last steps share one body (warm-up skips, and a
    // guard): a level past its warm-up is never skipped there.
    constexpr int warm = (LEVELS * (D0 + D1) + NW - 1) / NW * NW;
    const unsigned whole = store == 15u;
#pragma unroll
    for (int i = 0; i < NW; ++i)
      q.template load<T, false>(u, q.gs + i, c, H, W, q.pf[i]);
    int s = 0;
    for (; s < warm; s += NW)
      q.template steps<T, false, true, true>(u, out, s, H, W, r, t, c, whole,
                                             0u, tp);
    for (; s + NW <= q.nsteps; s += NW)
      q.template steps<T, false, false, false>(u, out, s, H, W, r, t, c,
                                               whole, 0u, tp);
    if (s < q.nsteps)
      q.template steps<T, false, true, true>(u, out, s, H, W, r, t, c, whole,
                                             0u, tp);
  } else {
#pragma unroll
    for (int i = 0; i < NW; ++i)
      q.template load<T, true>(u, q.gs + i, c, H, W, q.pf[i]);
    for (int s = 0; s < q.nsteps; s += NW)
      q.template steps<T, true, false, true>(u, out, s, H, W, r, t, c, store,
                                             col_pins, tp);
  }
}

// ---------------------------------------------------------------------------
// K1 on a compiled geometry from shared memory: masked plans
// (run_distributed's shards), and unmasked ones deeper than the register
// pipeline's LEVELS sweeps. The tile is two f32 ping-pong copies in shared
// memory; a block barrier ends each sweep.
//   * A tile row in shared memory is 128 f32 cells: one warp of 4-column
//     quads spans it (the tile is bn + 2*t*r <= 128 columns wide). Each
//     thread owns one quad and walks down a run of rows, reading each row
//     once as one 16-byte load and keeping the rows the taps reach in
//     registers; the columns left and right of its quad come from the
//     neighbouring lanes by warp shuffles. One shared load and one shared
//     store a quad a sweep, where the general kernel makes 5 a cell.
//   * A block whose window lies inside the ring-free interior runs a loop
//     with no pin test (PIN_NONE). Edge blocks test a row once and a
//     thread's four columns once (PIN_RING); a masked run reads the pin
//     byte of its quad as one 4-byte word (PIN_MASK). Pinned cells are
//     never written, so they keep their input in both tiles.
// Shared memory: two f32 tiles of (bm + 2tr) x 128 cells, plus one byte a
// cell when masked: 57,344 bytes at the default 40 x 112 tile and t*r = 8
// (64,512 masked; radius 2: 73,728). 256 threads; __launch_bounds__(256, 4)
// keeps four blocks an SM. nvcc -Xptxas -v (CUDA 12.9, sm_90a), registers
// unmasked / masked, the same in f32 and bf16, no stack, no spills:
// Jacobi5 53 / 52, Laplace9 61 / 56, Radius2 56 / 56.
// On an H100 (PERF.md) the 5-point masked kernel takes 0.114784 ms at
// 1026 x 9218, bf16, t = 8.
// ---------------------------------------------------------------------------
enum { PIN_NONE = 0, PIN_RING = 1, PIN_MASK = 2 };

// One row of one sweep for the thread's quad: start the read of row
// `row + 1 + DYMAX` (the next row's new tap row) into the spare register
// slot, sum the taps for `row` in tap order (no FMA) from the slots that
// hold rows row + DYMIN .. row + DYMAX, and store the quad unless pinned.
// ST is the row's place in the slot rotation; rows a run has not reached
// (`row + 1 >= end`) are not read.
template <typename G, int PIN, int ST>
__device__ __forceinline__ void temporal_row(
    float (&w)[Geo<G>::NW + 1][4], const float* __restrict__ src,
    float* __restrict__ dst, const uint8_t* __restrict__ pin, int row,
    int end, int lane, const Taps& tp, bool row_pinned, unsigned col_pins) {
  using P = Geo<G>;
  constexpr int NW = P::NW, NS = NW + 1, HR = P::HR;
  if (row + 1 < end)
    lds_quad(src + (row + 1 + P::DYMAX) * TROW + 4 * lane,
             w[(ST + NW) % NS]);
  // x[i]: tap row DYMIN + i with HR columns of the neighbours either side.
  float x[NW][4 + 2 * HR];
  static_for<NW>([&](auto ic) {
    constexpr int i = decltype(ic)::value;
    constexpr int slot = (ST + i) % NS;
    constexpr int dy = P::DYMIN + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][HR + j] = w[slot][j];
    static_for<P::left(dy)>([&](auto mc) {
      constexpr int m = decltype(mc)::value;  // column -1 - m
      x[i][HR - 1 - m] = __shfl_up_sync(FULL_MASK, w[slot][3 - m], 1);
    });
    static_for<P::right(dy)>([&](auto mc) {
      constexpr int m = decltype(mc)::value;  // column 4 + m
      x[i][HR + 4 + m] = __shfl_down_sync(FULL_MASK, w[slot][m], 1);
    });
  });
  float acc[4];
  static_for<G::N>([&](auto kc) {
    constexpr int k = decltype(kc)::value;
    constexpr int i = G::dy(k) - P::DYMIN, c = HR + G::dx(k);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float term = __fmul_rn(x[i][c + j], tp.w[k]);
      if constexpr (k == 0)
        acc[j] = term;
      else
        acc[j] = __fadd_rn(acc[j], term);
    }
  });
  float* d = dst + row * TROW + 4 * lane;
  unsigned pins = 0;
  if constexpr (PIN == PIN_RING) {
    if (row_pinned) return;
    pins = col_pins;
  } else if constexpr (PIN == PIN_MASK) {
    const uint32_t b =
        *reinterpret_cast<const uint32_t*>(pin + row * TROW + 4 * lane);
    pins = (b & 0xff ? 1u : 0u) | (b & 0xff00 ? 2u : 0u) |
           (b & 0xff0000 ? 4u : 0u) | (b & 0xff000000u ? 8u : 0u);
  }
  if (pins == 0) {
    *reinterpret_cast<float4*>(d) = make_float4(acc[0], acc[1], acc[2],
                                                acc[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (!(pins & (1u << j))) d[j] = acc[j];
  }
}

// One sweep over tile rows [lo, hi): each warp walks one contiguous run of
// rows, its lanes side by side across the 128 columns, one row read ahead.
// Columns outside the valid window hold garbage that never reaches a valid
// cell: the valid region shrinks by r a sweep, as the taps' reach does.
template <typename G, int PIN>
__device__ __forceinline__ void temporal_sweep(
    const float* __restrict__ src, float* __restrict__ dst,
    const uint8_t* __restrict__ pin, int lo, int hi, int warp, int lane,
    const Taps& tp, int g0, int H, int r, unsigned col_pins) {
  using P = Geo<G>;
  constexpr int NW = P::NW, NS = NW + 1;
  const int per = (hi - lo + NWARPS - 1) / NWARPS;
  const int a0 = lo + warp * per, a1 = min(a0 + per, hi);
  if (a0 >= a1) return;
  float w[NS][4];
  static_for<NW>([&](auto ic) {
    constexpr int i = decltype(ic)::value;
    lds_quad(src + (a0 + P::DYMIN + i) * TROW + 4 * lane, w[i]);
  });
  for (int a = a0; a < a1; a += NS) {
    static_for<NS>([&](auto sc) {
      constexpr int st = decltype(sc)::value;
      const int row = a + st;
      if (row < a1) {  // uniform across the warp: shuffles stay converged
        const int g = g0 + row;
        temporal_row<G, PIN, st>(w, src, dst, pin, row, a1, lane, tp,
                                 g < r || g >= H - r, col_pins);
      }
    });
  }
}

template <typename T, typename G, bool MASKED>
__global__ void __launch_bounds__(THREADS, 4)
    temporal_geo_kernel(const T* __restrict__ u,
                        const uint8_t* __restrict__ mask,
                        T* __restrict__ out, int H, int W, int r, int t,
                        int bm, int bn, Taps tp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t plane = (size_t)H * W;
  u += blockIdx.z * plane;
  out += blockIdx.z * plane;
  if (MASKED) mask += blockIdx.z * plane;
  const Tile tl = tile_at(blockIdx.y, blockIdx.x, H, W, r, bm, bn);
  const int halo = t * r;
  const int TH = tl.rows + 2 * halo, TW = tl.cols + 2 * halo;
  float* A = reinterpret_cast<float*>(smem);
  float* B = A + TH * TROW;
  uint8_t* pin = reinterpret_cast<uint8_t*>(B + TH * TROW);
  const int g0 = tl.R0 - halo, c0 = tl.C0 - halo;  // grid cell of tile (0,0)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = c0 + 4 * lane;  // the thread's quad starts at this column
  // No cell of the window is pinned: no test, and B needs no copy of the
  // input (sweep 1 writes every row that sweep 2 reads).
  const bool interior = !MASKED && g0 >= r && g0 + TH <= H - r && c0 >= r &&
                        c0 + TW <= W - r;

  if (4 * lane < TW) {
    for (int a = warp; a < TH; a += NWARPS) {
      const int g = g0 + a;
      float q[4];
      ldg_quad(u, g, c, H, W, q);
      const float4 v = make_float4(q[0], q[1], q[2], q[3]);
      *reinterpret_cast<float4*>(A + a * TROW + 4 * lane) = v;
      if (!interior) *reinterpret_cast<float4*>(B + a * TROW + 4 * lane) = v;
      if (MASKED) {
        uint32_t bits = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cj = c + j;
          const bool inside = g >= 0 && g < H && cj >= 0 && cj < W;
          const bool p = !inside || g < r || g >= H - r || cj < r ||
                         cj >= W - r || mask[(size_t)g * W + cj] != 0;
          bits |= (uint32_t)p << (8 * j);
        }
        *reinterpret_cast<uint32_t*>(pin + a * TROW + 4 * lane) = bits;
      }
    }
  }
  __syncthreads();

  unsigned col_pins = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    col_pins |= (unsigned)(c + j < r || c + j >= W - r) << j;
  float* src = A;
  float* dst = B;
  for (int s = 1; s <= t; ++s) {
    const int lo = s * r, hi = TH - s * r;
    if (MASKED)
      temporal_sweep<G, PIN_MASK>(src, dst, pin, lo, hi, warp, lane, tp, g0,
                                  H, r, col_pins);
    else if (interior)
      temporal_sweep<G, PIN_NONE>(src, dst, pin, lo, hi, warp, lane, tp, g0,
                                  H, r, col_pins);
    else
      temporal_sweep<G, PIN_RING>(src, dst, pin, lo, hi, warp, lane, tp, g0,
                                  H, r, col_pins);
    __syncthreads();
    float* tmp = src;
    src = dst;
    dst = tmp;
  }

  const int n = min(4, tl.cols - 4 * lane);
  if (n <= 0) return;
  for (int a = warp; a < tl.rows; a += NWARPS) {
    const float* s = src + (a + halo) * TROW + halo + 4 * lane;
    float q[4];
    if ((halo & 3) == 0) {
      lds_quad(s, q);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) q[j] = j < n ? s[j] : 0.0f;
    }
    stg_quad(out, tl.R0 + a, tl.C0 + 4 * lane, W, n, q);
  }
}

// ---------------------------------------------------------------------------
// K4 shifted — replaces repro/engine/policies.py::stencil_shifted
// (_shifted_kernel), the paper's section IV baseline. It reads `taps`
// separately materialized shifted interior copies (made by the wrapper, as
// XLA made them) and sums them. Bound: the function moves the grid once
// and its interior once, as K2; the policy itself reads taps + 1 interior
// copies and writes taps + 1, and that replicated traffic is the point of
// the policy and is kept. Design: a grid-stride elementwise pass over the
// interior, batch along gridDim.z.
// ---------------------------------------------------------------------------
template <typename T, int NT>
__global__ void __launch_bounds__(THREADS)
    shifted_kernel(Sources srcs, T* __restrict__ out, int hi, int wi, int W,
                   int r, Taps tp) {
  const size_t iplane = (size_t)hi * wi;
  const size_t plane = (size_t)(hi + 2 * r) * W;
  const size_t z = blockIdx.z;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < iplane;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = __fmul_rn(
        to_f32(static_cast<const T*>(srcs.p[0])[z * iplane + i]), tp.w[0]);
#pragma unroll
    for (int k = 1; k < NT; ++k)
      if (k < tp.n)
        acc = __fadd_rn(
            acc,
            __fmul_rn(to_f32(static_cast<const T*>(srcs.p[k])[z * iplane + i]),
                      tp.w[k]));
    const size_t a = i / wi, b = i - a * wi;
    out[z * plane + (a + r) * W + b + r] = from_f32<T>(acc);
  }
}

// ---------------------------------------------------------------------------
// Launchers. dtype: 0 = float32, 1 = bfloat16. `smem` is the dynamic shared
// memory the plan budgeted (repro_torch/engine/plan.py::smem_2d).
// ---------------------------------------------------------------------------
static Taps make_taps(int n, const int* dy, const int* dx, const float* w) {
  Taps tp;
  tp.n = n;
  for (int k = 0; k < MAX_TAPS; ++k) {
    tp.dy[k] = k < n && dy != nullptr ? dy[k] : 0;
    tp.dx[k] = k < n && dx != nullptr ? dx[k] : 0;
    tp.w[k] = k < n ? w[k] : 0.0f;
  }
  return tp;
}

template <typename T>
struct Type {
  using type = T;
};

// Calls f(Type<T>{}, std::integral_constant<int, NT>{}) for the grid dtype
// and the smallest tap bound that holds the spec's taps.
template <typename F>
static cudaError_t dispatch(int dtype, int taps, F f) {
  if ((dtype != 0 && dtype != 1) || taps < 1 || taps > MAX_TAPS)
    return cudaErrorInvalidValue;
  auto by_taps = [&](auto type) {
    if (taps <= 4) return f(type, std::integral_constant<int, 4>{});
    if (taps <= 8) return f(type, std::integral_constant<int, 8>{});
    if (taps <= 16) return f(type, std::integral_constant<int, 16>{});
    return f(type, std::integral_constant<int, MAX_TAPS>{});
  };
  return dtype == 0 ? by_taps(Type<float>{}) : by_taps(Type<__nv_bfloat16>{});
}

template <typename K>
static cudaError_t allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// The least window pitch for tiles bn cells wide: the row's 16-byte chunks
// wherever its first column falls in a chunk, and the slack either side
// (repro_torch/engine/plan.py::window_pitch).
static int window_pitch(int bn, int r, int esz) {
  const int span = (bn + 2 * r) * esz;
  return WIN_LEAD + (span + 16 - esz + 15) / 16 * 16 + WIN_TAIL;
}

template <typename G>
static bool same_offsets(const Taps& tp) {
  if (tp.n != G::N) return false;
  for (int k = 0; k < G::N; ++k)
    if (tp.dy[k] != G::dy(k) || tp.dx[k] != G::dx(k)) return false;
  return true;
}

// Calls f(Type<T>{}, Type<Sum>{}) for the grid dtype and the spec's taps:
// the compiled geometry `geometry` (0 = Jacobi5, 1 = Laplace9, 2 = Radius2,
// the order of TEMPORAL_GEOMETRIES), whose offsets the spec's must equal,
// or for -1 the general form at the smallest tap bound that holds them.
template <typename F>
static cudaError_t dispatch_sweep(int dtype, int geometry, const Taps& tp,
                                  F f) {
  if (tp.n < 1 || tp.n > MAX_TAPS) return cudaErrorInvalidValue;
  auto by_taps = [&](auto type) -> cudaError_t {
    using T = typename decltype(type)::type;
    auto geo = [&](auto g) -> cudaError_t {
      using G = typename decltype(g)::type;
      if (!same_offsets<G>(tp)) return cudaErrorInvalidValue;
      return f(type, Type<GeoTaps<T, G>>{});
    };
    switch (geometry) {
      case -1: break;
      case 0: return geo(Type<Jacobi5>{});
      case 1: return geo(Type<Laplace9>{});
      case 2: return geo(Type<Radius2>{});
      default: return cudaErrorInvalidValue;
    }
    if (tp.n <= 4) return f(type, Type<RunTaps<T, 4>>{});
    if (tp.n <= 8) return f(type, Type<RunTaps<T, 8>>{});
    if (tp.n <= 16) return f(type, Type<RunTaps<T, 16>>{});
    return f(type, Type<RunTaps<T, MAX_TAPS>>{});
  };
  if (dtype == 0) return by_taps(Type<float>{});
  if (dtype == 1) return by_taps(Type<__nv_bfloat16>{});
  return cudaErrorInvalidValue;
}

// K2. Refuses a pitch below window_pitch and shared memory short of the
// window's (bm + 2r) rows.
extern "C" cudaError_t repro_rowchunk(const void* u, void* out, int geometry,
                                      int dtype, int batch, int H, int W,
                                      int r, int bm, int bn, int row_tiles,
                                      int col_tiles, int pitch, int taps,
                                      const int* dy, const int* dx,
                                      const float* w, int smem,
                                      void* stream) {
  const int esz = dtype == 0 ? 4 : 2;
  if (bm < 1 || bn < 1 || pitch % 16 || pitch < window_pitch(bn, r, esz) ||
      smem < (bm + 2 * r) * pitch)
    return cudaErrorInvalidValue;
  const Taps tp = make_taps(taps, dy, dx, w);
  return dispatch_sweep(dtype, geometry, tp, [&](auto type, auto sum) {
    using T = typename decltype(type)::type;
    auto kernel = rowchunk_kernel<T, typename decltype(sum)::type>;
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(col_tiles, row_tiles, batch), THREADS, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(u), static_cast<T*>(out), H, W, r, bm, bn,
        pitch, tp);
    return cudaGetLastError();
  });
}

// K3: blocks of THREADS consumers and one producer warp, each walking up to
// tiles_per_block row tiles of one column strip; 0 takes as many tiles a
// block as leave the card's resident blocks (by occupancy) all in use, and
// at least two.
// Refuses what K2 refuses, against DBUF_STAGES windows behind DBUF_BARS.
extern "C" cudaError_t repro_dbuf(const void* u, void* out, int geometry,
                                  int dtype, int batch, int H, int W, int r,
                                  int bm, int bn, int row_tiles,
                                  int col_tiles, int tiles_per_block,
                                  int pitch, int taps, const int* dy,
                                  const int* dx, const float* w, int smem,
                                  void* stream) {
  const int esz = dtype == 0 ? 4 : 2;
  if (tiles_per_block < 0 || bm < 1 || bn < 1 || pitch % 16 ||
      pitch < window_pitch(bn, r, esz) ||
      smem < DBUF_BARS + DBUF_STAGES * (bm + 2 * r) * pitch)
    return cudaErrorInvalidValue;
  const Taps tp = make_taps(taps, dy, dx, w);
  return dispatch_sweep(dtype, geometry, tp, [&](auto type, auto sum) {
    using T = typename decltype(type)::type;
    auto kernel = dbuf_kernel<T, typename decltype(sum)::type>;
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    if (tiles_per_block == 0) {  // as many runs as fill the card
      int per_sm = 0, sms = 0, dev = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS + 32, smem);
      if (e == cudaSuccess) e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return e;
      const int strips = col_tiles * batch;
      int want = (per_sm * sms + strips - 1) / strips;
      want = want < 1 ? 1 : want > row_tiles ? row_tiles : want;
      tiles_per_block = row_tiles / want;
      // At least two tiles a block where a strip has them: the ring's
      // second stage is what overlaps a copy with the sums.
      if (tiles_per_block < 2 && row_tiles >= 2) tiles_per_block = 2;
    }
    const int runs = (row_tiles + tiles_per_block - 1) / tiles_per_block;
    kernel<<<dim3(col_tiles, runs, batch), THREADS + 32, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(u), static_cast<T*>(out), H, W, r, bm, bn,
        row_tiles, tiles_per_block, pitch, tp);
    return cudaGetLastError();
  });
}

// K1's kernel for a plan, resolved once: the general kernel (geometry -1)
// or a compiled geometry (0 = Jacobi5, 1 = Laplace9, 2 = Radius2, the
// order of repro_torch/engine/plan.py::TEMPORAL_GEOMETRIES): through the
// register pipeline when unmasked at t = LEVELS on a PIPE geometry, else
// from shared memory. Sets the kernel's shared memory once (none for the
// pipeline) and calls body(launch), where launch(in, out) enqueues one K1
// on `stream` and returns its cudaGetLastError().
// Refuses a geometry whose offsets, tap count or radius are not the
// spec's, and a tile wider than a row of its kernel.
template <typename Body>
static cudaError_t with_temporal(const void* mask, int geometry, int dtype,
                                 int batch, int H, int W, int r, int t,
                                 int bm, int bn, int row_tiles,
                                 int col_tiles, const Taps& tp, int smem,
                                 void* stream, Body body) {
  if (t < 1 || bm < 1 || bn < 1 || tp.n < 1 || tp.n > MAX_TAPS ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  const dim3 tiles(col_tiles, row_tiles, batch);
  auto by_type = [&](auto type) -> cudaError_t {
    using T = typename decltype(type)::type;
    auto geo = [&](auto g) -> cudaError_t {
      using G = typename decltype(g)::type;
      if (!same_offsets<G>(tp) || r != Geo<G>::R || bn + 2 * t * r > TROW)
        return cudaErrorInvalidValue;
      if constexpr (G::PIPE) {
        if (mask == nullptr && t == LEVELS)
          return body([&](const void* in, void* out) {
            temporal_pipe_kernel<T, G><<<tiles, 32, 0, st>>>(
                static_cast<const T*>(in), static_cast<T*>(out), H, W, r, t,
                bm, bn, tp);
            return cudaGetLastError();
          });
      }
      auto kernel = mask != nullptr ? temporal_geo_kernel<T, G, true>
                                    : temporal_geo_kernel<T, G, false>;
      cudaError_t e = allow_smem(kernel, smem);
      if (e != cudaSuccess) return e;
      return body([&](const void* in, void* out) {
        kernel<<<tiles, THREADS, smem, st>>>(static_cast<const T*>(in), mk,
                                             static_cast<T*>(out), H, W, r, t,
                                             bm, bn, tp);
        return cudaGetLastError();
      });
    };
    switch (geometry) {
      case -1: break;
      case 0: return geo(Type<Jacobi5>{});
      case 1: return geo(Type<Laplace9>{});
      case 2: return geo(Type<Radius2>{});
      default: return cudaErrorInvalidValue;
    }
    auto general = [&](auto nt) -> cudaError_t {
      constexpr int NT = decltype(nt)::value;
      auto kernel = mask != nullptr ? temporal_kernel<T, NT, true>
                                    : temporal_kernel<T, NT, false>;
      cudaError_t e = allow_smem(kernel, smem);
      if (e != cudaSuccess) return e;
      return body([&](const void* in, void* out) {
        kernel<<<tiles, THREADS, smem, st>>>(static_cast<const T*>(in), mk,
                                             static_cast<T*>(out), H, W, r, t,
                                             bm, bn, tp);
        return cudaGetLastError();
      });
    };
    if (tp.n <= 4) return general(std::integral_constant<int, 4>{});
    if (tp.n <= 8) return general(std::integral_constant<int, 8>{});
    if (tp.n <= 16) return general(std::integral_constant<int, 16>{});
    return general(std::integral_constant<int, MAX_TAPS>{});
  };
  return dtype == 0 ? by_type(Type<float>{}) : by_type(Type<__nv_bfloat16>{});
}

// One K1 launch, u -> out; `mask` (one byte a cell, nonzero = pinned) or
// null.
extern "C" cudaError_t repro_temporal(const void* u, const void* mask,
                                      void* out, int geometry, int dtype,
                                      int batch, int H, int W, int r, int t,
                                      int bm, int bn, int row_tiles,
                                      int col_tiles, int taps, const int* dy,
                                      const int* dx, const float* w, int smem,
                                      void* stream) {
  if (taps < 1 || taps > MAX_TAPS) return cudaErrorInvalidValue;
  const Taps tp = make_taps(taps, dy, dx, w);
  return with_temporal(mask, geometry, dtype, batch, H, W, r, t, bm, bn,
                       row_tiles, col_tiles, tp, smem, stream,
                       [&](auto launch) { return launch(u, out); });
}

// A schedule's `launches` unmasked K1 blocks in one call, enqueued back to
// back on `stream`: the first reads u and writes buf_a, each next one reads
// the last one's output and writes the other of buf_a and buf_b (buf_b may
// be u itself, or null for one launch), as engine/dispatch.py's loop
// ping-pongs. Returns the first launch error.
extern "C" cudaError_t repro_temporal_chain(
    const void* u, void* buf_a, void* buf_b, int launches, int geometry,
    int dtype, int batch, int H, int W, int r, int t, int bm, int bn,
    int row_tiles, int col_tiles, int taps, const int* dy, const int* dx,
    const float* w, int smem, void* stream) {
  if (launches < 1 || taps < 1 || taps > MAX_TAPS || buf_a == nullptr ||
      buf_a == u || buf_a == buf_b || (launches > 1 && buf_b == nullptr))
    return cudaErrorInvalidValue;
  const Taps tp = make_taps(taps, dy, dx, w);
  return with_temporal(nullptr, geometry, dtype, batch, H, W, r, t, bm, bn,
                       row_tiles, col_tiles, tp, smem, stream,
                       [&](auto launch) {
    const void* src = u;
    void* dst = buf_a;
    for (int i = 0; i < launches; ++i) {
      const cudaError_t e = launch(src, dst);
      if (e != cudaSuccess) return e;
      src = dst;
      dst = dst == buf_a ? buf_b : buf_a;
    }
    return cudaSuccess;
  });
}

extern "C" cudaError_t repro_shifted(const void* const* srcs, void* out,
                                     int dtype, int batch, int hi, int wi,
                                     int W, int r, int blocks, int taps,
                                     const float* w, void* stream) {
  if (blocks < 1 || taps < 1 || taps > MAX_TAPS) return cudaErrorInvalidValue;
  Sources sp;
  for (int k = 0; k < MAX_TAPS; ++k) sp.p[k] = k < taps ? srcs[k] : nullptr;
  const Taps tp = make_taps(taps, nullptr, nullptr, w);  // weights only
  return dispatch(dtype, taps, [&](auto type, auto nt) {
    using T = typename decltype(type)::type;
    shifted_kernel<T, decltype(nt)::value>
        <<<dim3(blocks, 1, batch), THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(sp, static_cast<T*>(out), hi,
                                                wi, W, r, tp);
    return cudaGetLastError();
  });
}
