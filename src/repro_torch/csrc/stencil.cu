// Hand-written Hopper (sm_90a) kernels for the four stencil engine policies.
//
// Each kernel replaces one Pallas kernel of the JAX package
// (src/repro/engine/policies.py) and computes exactly the f32 operations of
// its plain PyTorch version (src/repro_torch/engine/policies.py): every tap
// is one __fmul_rn and one __fadd_rn, in tap order, so nothing is contracted
// into a fused multiply-add whatever -fmad says, and the results are held
// against the plain versions bit for bit. Values are stored in the grid
// dtype with round-to-nearest-even (__float2bfloat16_rn for bf16).
//
// Grids are ringed (H, W) planes, row-major and contiguous, with an optional
// batch of planes along gridDim.z. The kernels write interior cells only;
// the caller keeps the r-deep ring of the output buffer equal to the input.
//
// Bounds on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): one sweep of a grid must read it once and write its interior
// once, 8 bytes a cell in f32 and 4 in bf16, against 2*taps-1 f32
// operations a cell, so every kernel here is bound by bytes; the temporal
// kernel divides the bytes by t and multiplies the operations by t. The
// peak counts a fused multiply-add as two operations; these kernels issue
// each multiply and add alone, at half that rate, so K1 at t = 8 is bound
// by operations in bf16 (5-point: 0.0158 ms against 0.0113 of bytes).
//
// The tap table (offsets and f32 weights) rides in registers: each kernel
// is instantiated for a tap bound NT in {4, 8, 16, 32}, its tap loops are
// unrolled to NT, and taps past the spec's count are skipped. K1 has a
// second form, compiled for each tap geometry the repo ships (offsets as
// constants), which the wrapper picks by the spec's offsets.
//
// C interface: one extern "C" launcher per kernel, returning cudaError_t
// (the launch's cudaGetLastError()). Built by repro_torch/kernels/build.py
// with nvcc -gencode arch=compute_90a,code=sm_90a and loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#define MAX_TAPS 32
#define THREADS 256
#define TX 32  // threads along a row: a warp reads one contiguous span
#define TY (THREADS / TX)

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
// K2 rowchunk — replaces repro/engine/policies.py::stencil_rowchunk
// (_rowchunk_kernel). One sweep. Bound: 8 B/cell f32, 4 B/cell bf16, i.e.
// 22.6 us f32 and 11.3 us bf16 for the 1026 x 9218 grid at 3.35 TB/s.
// Design: the TPU loads a full-width row chunk into VMEM; a 9218-wide row
// does not fit 227 KiB, so each block loads a (bm+2r) x (bn+2r) tile as f32
// into shared memory once (coalesced rows), and serves every tap from it,
// so each input byte crosses device memory about once whatever the taps.
// ---------------------------------------------------------------------------
template <typename T, int NT>
__global__ void __launch_bounds__(THREADS)
    rowchunk_kernel(const T* __restrict__ u, T* __restrict__ out, int H,
                    int W, int r, int bm, int bn, Taps tp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t plane = (size_t)H * W;
  u += blockIdx.z * plane;
  out += blockIdx.z * plane;
  const Tile tl = tile_at(blockIdx.y, blockIdx.x, H, W, r, bm, bn);
  const int TH = tl.rows + 2 * r, TW = tl.cols + 2 * r;
  const RegTaps<NT> rt = reg_taps<NT>(tp, TW);
  float* tile = reinterpret_cast<float*>(smem);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  for (int a = ty; a < TH; a += TY) {
    const T* row = u + (size_t)(tl.R0 - r + a) * W + (tl.C0 - r);
    for (int b = tx; b < TW; b += TX) tile[a * TW + b] = to_f32(row[b]);
  }
  __syncthreads();
  for (int a = ty; a < tl.rows; a += TY) {
    T* orow = out + (size_t)(tl.R0 + a) * W + tl.C0;
    for (int b = tx; b < tl.cols; b += TX)
      orow[b] = from_f32<T>(tap_sum(tile, (a + r) * TW + b + r, rt));
  }
}

// ---------------------------------------------------------------------------
// K3 dbuf — replaces repro/engine/policies.py::stencil_dbuf (_dbuf_kernel).
// The same function as K2, with the same bound. What makes it dbuf: each
// block walks a run of row tiles down one column strip, and a two-stage
// cp.async pipeline loads tile i+1 into the other stage while tile i is
// computed. The wrapper splits each strip into runs so the grid still
// holds at least two blocks per SM. The TPU's two-slot asynchronous
// write-back needs no counterpart: stores to device memory do not block.
// Stages hold the grid dtype; 4-byte cp.async copies start at the window's
// first column rounded down to a whole word (`shift` elements earlier).
// Rows whose start is not 4-byte aligned (bf16 with odd W) are loaded by
// plain loads into the same layout.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
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

template <typename T>
__device__ __forceinline__ void dbuf_load(T* stage, const T* __restrict__ u,
                                          const Tile& tl, int W, int r,
                                          int pitch_words, bool aligned) {
  constexpr int PER_WORD = 4 / sizeof(T);
  const int c_lo = tl.C0 - r;
  const int cs = c_lo & ~(PER_WORD - 1);
  const int shift = c_lo - cs;
  const int TH = tl.rows + 2 * r, TW = tl.cols + 2 * r;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  if (aligned) {
    const int nw = (shift + TW + PER_WORD - 1) / PER_WORD;
    uint32_t* words = reinterpret_cast<uint32_t*>(stage);
    for (int a = ty; a < TH; a += TY) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          u + (size_t)(tl.R0 - r + a) * W + cs);
      for (int k = tx; k < nw; k += TX)
        cp_async4(words + a * pitch_words + k, src + k);
    }
  } else {
    const int pitch = pitch_words * PER_WORD;
    for (int a = ty; a < TH; a += TY) {
      const T* src = u + (size_t)(tl.R0 - r + a) * W + c_lo;
      for (int b = tx; b < TW; b += TX) stage[a * pitch + shift + b] = src[b];
    }
  }
  cp_async_commit();
}

template <typename T, int NT>
__global__ void __launch_bounds__(THREADS)
    dbuf_kernel(const T* __restrict__ u, T* __restrict__ out, int H, int W,
                int r, int bm, int bn, int row_tiles, int tiles_per_block,
                int pitch_words, bool aligned, Taps tp) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int PER_WORD = 4 / sizeof(T);
  const size_t plane = (size_t)H * W;
  u += blockIdx.z * plane;
  out += blockIdx.z * plane;
  const int first = blockIdx.y * tiles_per_block;
  const int last = min(first + tiles_per_block, row_tiles);
  if (first >= last) return;
  const int pitch = pitch_words * PER_WORD;
  const RegTaps<NT> rt = reg_taps<NT>(tp, pitch);
  T* const stage0 = reinterpret_cast<T*>(smem);
  T* const stage1 = stage0 + (bm + 2 * r) * pitch;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;

  dbuf_load(stage0, u, tile_at(first, blockIdx.x, H, W, r, bm, bn), W, r,
            pitch_words, aligned);
  for (int i = first; i < last; ++i) {
    const bool odd = (i - first) & 1;
    if (i + 1 < last) {
      dbuf_load(odd ? stage0 : stage1, u,
                tile_at(i + 1, blockIdx.x, H, W, r, bm, bn), W, r,
                pitch_words, aligned);
      cp_async_wait<1>();  // this tile's group is done; the next in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Tile tl = tile_at(i, blockIdx.x, H, W, r, bm, bn);
    const int shift = (tl.C0 - r) - ((tl.C0 - r) & ~(PER_WORD - 1));
    const T* stage = odd ? stage1 : stage0;
    for (int a = ty; a < tl.rows; a += TY) {
      T* orow = out + (size_t)(tl.R0 + a) * W + tl.C0;
      for (int b = tx; b < tl.cols; b += TX)
        orow[b] = from_f32<T>(
            tap_sum(stage, (a + r) * pitch + shift + b + r, rt));
    }
    __syncthreads();  // the next iteration's prefetch overwrites this stage
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
// temporal_kernel above. Both compute the same f32 operations in the same
// order.
//
// What held the general kernel at 16x its byte bound on an H100 was issued
// instructions, not bytes: per cell-update four scalar shared loads at
// run-time offsets plus a store, a pin test rebuilt from coordinates, and
// two-level index arithmetic. Here:
//   * A tile row in shared memory is 128 f32 cells: one warp of 4-column
//     quads spans it (the tile is bn + 2*t*r <= 128 columns wide). Each
//     thread owns one quad and walks down a run of rows, reading each row
//     once as one 16-byte load and keeping the rows the taps reach in
//     registers; the columns left and right of its quad come from the
//     neighbouring lanes by warp shuffles. One shared load and one shared
//     store a quad a sweep, where the general kernel makes 5 a cell.
//   * Registers cannot be indexed by run-time offsets, so each geometry is
//     a type whose offsets are constants: taps, register slots and shuffles
//     unroll away.
//   * A block whose window lies inside the ring-free interior runs a loop
//     with no pin test (PIN_NONE). Edge blocks test a row once and a
//     thread's four columns once (PIN_RING); a masked run reads the pin
//     byte of its quad as one 4-byte word (PIN_MASK). Pinned cells are
//     never written, so they keep their input in both tiles.
//   * The tile is loaded and stored a quad a lane: one 16-byte (f32) or
//     8-byte (bf16) access where the quad's address is aligned, else
//     element by element. The odd pitch 9218 aligns no quad of a tile;
//     cutting each quad from the two aligned vectors around it measured
//     12% slower at t = 8 (PERF.md), so it was not kept.
// Shared memory: two f32 tiles of (bm + 2tr) x 128 cells, plus one byte a
// cell when masked: 57,344 bytes at the default 40 x 112 tile and t*r = 8
// (64,512 masked; radius 2: 73,728). 256 threads; __launch_bounds__(256, 4)
// keeps four blocks an SM. nvcc -Xptxas -v (CUDA 12.9, sm_90a), registers
// unmasked / masked, the same in f32 and bf16, no stack, no spills:
// Jacobi5 53 / 52, Laplace9 61 / 56, Radius2 56 / 56.
// On an H100 (PERF.md) the 5-point kernel takes 0.072 ms at 1026 x 9218,
// bf16, t = 8, against 0.185 for temporal_kernel: about 26 us of tile load
// and store plus 5.7 us a sweep. A sweep is bound by issue: 44
// instructions a warp-row of 128 cells, 28 of them the unfused f32 taps,
// over 1.38x the grid's cells (the halo the tile recomputes).
// ---------------------------------------------------------------------------
#define QUADS 32           // 4-column quads a tile row holds: one warp
#define TROW (4 * QUADS)   // f32 cells a row of the shared-memory tile
#define NWARPS (THREADS / 32)
#define FULL_MASK 0xffffffffu

enum { PIN_NONE = 0, PIN_RING = 1, PIN_MASK = 2 };

// Tap geometries: offsets in tap order, as the Python table lists them.
struct Jacobi5 {
  static constexpr int N = 4;
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

extern "C" cudaError_t repro_rowchunk(const void* u, void* out, int dtype,
                                      int batch, int H, int W, int r, int bm,
                                      int bn, int row_tiles, int col_tiles,
                                      int taps, const int* dy, const int* dx,
                                      const float* w, int smem,
                                      void* stream) {
  const Taps tp = make_taps(taps, dy, dx, w);
  return dispatch(dtype, taps, [&](auto type, auto nt) {
    using T = typename decltype(type)::type;
    auto kernel = rowchunk_kernel<T, decltype(nt)::value>;
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(col_tiles, row_tiles, batch), THREADS, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(u), static_cast<T*>(out), H, W, r, bm, bn, tp);
    return cudaGetLastError();
  });
}

extern "C" cudaError_t repro_dbuf(const void* u, void* out, int dtype,
                                  int batch, int H, int W, int r, int bm,
                                  int bn, int row_tiles, int col_tiles,
                                  int tiles_per_block, int pitch_words,
                                  int taps, const int* dy, const int* dx,
                                  const float* w, int smem, void* stream) {
  if (tiles_per_block < 1) return cudaErrorInvalidValue;
  const Taps tp = make_taps(taps, dy, dx, w);
  return dispatch(dtype, taps, [&](auto type, auto nt) {
    using T = typename decltype(type)::type;
    auto kernel = dbuf_kernel<T, decltype(nt)::value>;
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    const bool aligned = ((size_t)W * sizeof(T)) % 4 == 0 &&
                         reinterpret_cast<uintptr_t>(u) % 4 == 0;
    const int runs = (row_tiles + tiles_per_block - 1) / tiles_per_block;
    kernel<<<dim3(col_tiles, runs, batch), THREADS, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(u), static_cast<T*>(out), H, W, r, bm, bn,
        row_tiles, tiles_per_block, pitch_words, aligned, tp);
    return cudaGetLastError();
  });
}

extern "C" cudaError_t repro_temporal(const void* u, const void* mask,
                                      void* out, int dtype, int batch, int H,
                                      int W, int r, int t, int bm, int bn,
                                      int row_tiles, int col_tiles, int taps,
                                      const int* dy, const int* dx,
                                      const float* w, int smem,
                                      void* stream) {
  if (t < 1) return cudaErrorInvalidValue;
  const Taps tp = make_taps(taps, dy, dx, w);
  return dispatch(dtype, taps, [&](auto type, auto nt) {
    using T = typename decltype(type)::type;
    constexpr int NT = decltype(nt)::value;
    auto kernel = mask != nullptr ? temporal_kernel<T, NT, true>
                                  : temporal_kernel<T, NT, false>;
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(col_tiles, row_tiles, batch), THREADS, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(u), static_cast<const uint8_t*>(mask),
        static_cast<T*>(out), H, W, r, t, bm, bn, tp);
    return cudaGetLastError();
  });
}

// K1 on a compiled geometry: 0 = Jacobi5, 1 = Laplace9, 2 = Radius2 (the
// order of repro_torch/engine/plan.py::TEMPORAL_GEOMETRIES). Refuses a tap
// count or radius that is not the geometry's, and a tile wider than a row.
extern "C" cudaError_t repro_temporal_geo(const void* u, const void* mask,
                                          void* out, int geometry, int dtype,
                                          int batch, int H, int W, int r,
                                          int t, int bm, int bn,
                                          int row_tiles, int col_tiles,
                                          int taps, const float* w, int smem,
                                          void* stream) {
  if (t < 1 || bm < 1 || bn < 1 || bn + 2 * t * r > TROW ||
      (dtype != 0 && dtype != 1) || taps < 1 || taps > MAX_TAPS)
    return cudaErrorInvalidValue;
  const Taps tp = make_taps(taps, nullptr, nullptr, w);  // weights only
  auto run = [&](auto type, auto geo) -> cudaError_t {
    using T = typename decltype(type)::type;
    using G = typename decltype(geo)::type;
    if (taps != G::N || r != Geo<G>::R) return cudaErrorInvalidValue;
    auto kernel = mask != nullptr ? temporal_geo_kernel<T, G, true>
                                  : temporal_geo_kernel<T, G, false>;
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(col_tiles, row_tiles, batch), THREADS, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(u), static_cast<const uint8_t*>(mask),
        static_cast<T*>(out), H, W, r, t, bm, bn, tp);
    return cudaGetLastError();
  };
  auto by_geo = [&](auto type) -> cudaError_t {
    switch (geometry) {
      case 0: return run(type, Type<Jacobi5>{});
      case 1: return run(type, Type<Laplace9>{});
      case 2: return run(type, Type<Radius2>{});
      default: return cudaErrorInvalidValue;
    }
  };
  return dtype == 0 ? by_geo(Type<float>{}) : by_geo(Type<__nv_bfloat16>{});
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
