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
// kernel divides the bytes by t and multiplies the operations by t.
//
// The tap table (offsets and f32 weights) rides in registers: each kernel
// is instantiated for a tap bound NT in {4, 8, 16, 32}, its tap loops are
// unrolled to NT, and taps past the spec's count are skipped.
//
// C interface: one extern "C" launcher per kernel, returning cudaError_t
// (the launch's cudaGetLastError()). Built by repro_torch/kernels/build.py
// with nvcc -gencode arch=compute_90a,code=sm_90a and loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
