// Hand-written Hopper (sm_90a) kernels for the paper's memory-access study
// (§V, Tables III-VI) and its Table II component ablation.
//
// Each kernel replaces one Pallas kernel of the JAX package and computes
// what its plain PyTorch version (src/repro_torch/kernels/stream.py,
// src/repro_torch/kernels/components.py) computes, bit for bit:
//
//   K5a stream_copy        src/repro/kernels/stream.py (_copy_kernel)
//   K5b stream_copy_rowdma src/repro/kernels/stream.py (_rowdma_kernel)
//   K5c stream_replicated  src/repro/kernels/stream.py (_replicated_kernel)
//   K6a dma_only           benchmarks/table2_components.py (_dma_only_kernel)
//   K6b compute_only       benchmarks/table2_components.py
//                          (_compute_only_kernel)
//
// Arrays are (h, w), row-major and contiguous. The copies (K5a, K5b, K6a)
// move raw elements of 2 or 4 bytes (bf16, f32, int32); K5c and K6b widen to
// f32, add with __fadd_rn (and K6b multiplies with __fmul_rn), so nothing is
// contracted or reassociated whatever -fmad says, and round once to the
// dtype: round-to-nearest-even for bf16, truncation toward zero for int32.
//
// Bounds on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): every kernel reads its input once and writes its output once, at
// most a handful of f32 operations an element, so each is bound by bytes.
// K5c re-reads its input `factor` times by design; on this card the second
// and later reads of a tile are served by the 50 MB L2, where the TPU
// re-DMAs from HBM.
//
// C interface: one extern "C" launcher per kernel, returning cudaError_t
// (the launch's cudaGetLastError()). Built by repro_torch/kernels/build.py
// with nvcc -gencode arch=compute_90a,code=sm_90a and loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define MAX_SMEM (227 * 1024)  // dynamic shared memory a block may opt into

// Element types as raw bits, and their f32 value where a kernel does math.
struct F32 {
  using bits = uint32_t;
  static __device__ __forceinline__ float widen(uint32_t b) {
    return __uint_as_float(b);
  }
  static __device__ __forceinline__ uint32_t narrow(float v) {
    return __float_as_uint(v);
  }
};
struct BF16 {
  using bits = uint16_t;
  static __device__ __forceinline__ float widen(uint16_t b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
  static __device__ __forceinline__ uint16_t narrow(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
struct I32 {
  using bits = uint32_t;
  static __device__ __forceinline__ float widen(uint32_t b) {
    return __int2float_rn(static_cast<int>(b));
  }
  static __device__ __forceinline__ uint32_t narrow(float v) {
    return static_cast<uint32_t>(__float2int_rz(v));
  }
};

// V elements of B as one 16-byte access (V * sizeof(B) == 16).
template <typename B, int V>
union Pack {
  uint4 raw;
  B e[V];
};

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------------------
// K5a: blocked identity copy. One block per (bm, bn) tile; each row's bn
// elements are read and written as one contiguous span, so bn keeps its
// meaning as the transaction width (bn = 8 int32 is one 32-byte sector). A
// group of g lanes (g a power of two <= 32, about the span's 16-byte units)
// copies one row, so a warp covers consecutive elements of a row when bn is
// wide and 32/g rows when it is narrow; the block loops over its rows. A
// row takes 16-byte vectors where its start and bn * sizeof allow, else
// elements (Table VI's widths 1026 and 514 put every other row start 8
// bytes off 16). Each lane keeps four loads in flight before it stores.
// When the tiles alone would leave SMs idle (4096^2 int32 at bm 256 and
// bn 4096 is 16 tiles on 132 SMs), the wrapper splits each tile's rows
// over `split` blocks (kernels/stream.py::copy_split); each block copies a
// contiguous run of the tile's rows, each row still one bn-element span,
// and has only the threads its rows need. A split of 1 is one block a
// tile, as the TPU's grid has it. At bn 4096 the split copy runs at about
// 1.07x Tensor.copy_ on an H100: a lane still walks its row's 16 KB span
// in eight rounds, where a one-shot flat copy reaches copy_ (PERF.md).

template <typename U>
__device__ __forceinline__ void copy_units(const U* __restrict__ s,
                                           U* __restrict__ d, int n, int lane,
                                           int g) {
  int k = lane;
  for (; k + 3 * g < n; k += 4 * g) {
    const U a = s[k], b = s[k + g], c = s[k + 2 * g], e = s[k + 3 * g];
    d[k] = a;
    d[k + g] = b;
    d[k + 2 * g] = c;
    d[k + 3 * g] = e;
  }
  for (; k < n; k += g) d[k] = s[k];
}

#define COPY_THREADS 512

template <typename E>
__global__ void __launch_bounds__(COPY_THREADS)
    stream_copy_kernel(const E* __restrict__ x, E* __restrict__ out, int w,
                       int bm, int bn, int tiles_w, int g, int split) {
  int tile = blockIdx.x, r_begin = 0, r_end = bm;
  if (split > 1) {  // this block's run of the tile's rows
    const int part = blockIdx.x % split;
    tile = blockIdx.x / split;
    r_begin = part * bm / split;
    r_end = (part + 1) * bm / split;
  }
  const int ti = tile / tiles_w, tj = tile % tiles_w;
  const int grp = threadIdx.x / g, lane = threadIdx.x % g;
  const int groups = blockDim.x / g;
  const bool vec_bn = (bn * sizeof(E)) % 16 == 0;
  for (int r = r_begin + grp; r < r_end; r += groups) {
    const size_t off = static_cast<size_t>(ti * bm + r) * w +
                       static_cast<size_t>(tj) * bn;
    const E* s = x + off;
    E* d = out + off;
    if (vec_bn && aligned16(s) && aligned16(d)) {
      copy_units(reinterpret_cast<const uint4*>(s),
                 reinterpret_cast<uint4*>(d),
                 static_cast<int>(bn * sizeof(E) / 16), lane, g);
    } else {
      copy_units(s, d, bn, lane, g);
    }
  }
}

// ---------------------------------------------------------------------------
// K5b: the copy issued as one asynchronous copy per row, each way. A
// block's rows go global -> shared, each as one cp.async.bulk completed on
// an mbarrier (the closest Hopper form of the TPU's per-row DMA), and out
// again shared -> global, each as one bulk copy committed as a bulk group:
// no thread touches the data and no barrier is crossed per row. One thread
// issues the loads into a ring of `ring` row slots; another issues each
// row's store once it has landed and hands its slot back (an empty
// mbarrier) once the store has read it (cp.async.bulk.wait_group.read).
//
// What bounds it: the bytes, each row read once and written once at 3.35
// TB/s. Without sync the wrapper (kernels/stream.py::rowdma_plan) gives
// every row its own block (split = bm): all bm rows of a TPU block are in
// flight at once, as the TPU keeps them, and blocks of one 16 KiB slot
// start and end at different times, so the card reads and writes at once
// throughout, as copy_ does; rings of several rows a block, two blocks
// an SM, stayed slower than copy_, all blocks loading first and storing
// last together. Both copies take an L2 evict-first policy. On an H100
// this runs at 0.99x copy_ (PERF.md). With sync (Tables III/IV's
// per-access wait) a bm-row block is one block with one row in flight,
// its next row issued only after the last has landed, as the TPU waits
// after each row; only the write is asynchronous, out of a second slot.
// cp.async.bulk needs 16-byte aligned rows of a multiple of 16 bytes; the
// wrapper refuses anything else.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// An L2 policy that evicts the lines it touches first: a row is read once
// and written once, so neither side should hold the L2 against the other.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// Expect `bytes` on `bar`, then start the bulk copy global -> shared that
// delivers them.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(evict_first())
      : "memory");
}

// A bulk copy shared -> global, committed as its own bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], "
      "[%1], %2, %3;\n" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes), "l"(evict_first())
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

#define RING_BARS 128  // bytes ahead of the slots: a full and an empty
                       // barrier for each of up to 8 slots

__global__ void __launch_bounds__(64)
    stream_rowdma_kernel(const unsigned char* __restrict__ x,
                         unsigned char* __restrict__ out, uint32_t row_bytes,
                         int bm, int split, int ring, int sync) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // row landed
  uint64_t* empty = full + RING_BARS / 16;             // slot read out
  unsigned char* slots = smem + RING_BARS;
  // This block's run of its bm-row block's rows.
  const int part = blockIdx.x % split;
  const int r0 = part * bm / split, n = (part + 1) * bm / split - r0;
  const size_t first = static_cast<size_t>(blockIdx.x / split) * bm + r0;
  const unsigned char* src = x + first * row_bytes;
  unsigned char* dst = out + first * row_bytes;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ring; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // Loads: row r into slot r % ring once the store of row r - ring has
    // read it; with sync, each row waited for before the next is issued.
    for (int r = 0; r < n; ++r) {
      const int s = r % ring, round = r / ring;
      if (r >= ring) mbar_wait(&empty[s], (round - 1) & 1);
      bulk_load(slots + static_cast<size_t>(s) * row_bytes,
                src + static_cast<size_t>(r) * row_bytes, row_bytes,
                &full[s]);
      if (sync) mbar_wait(&full[s], round & 1);
    }
  } else if (threadIdx.x == 32) {
    // Stores: each landed row out as it lands, its slot handed back once
    // the store has read it.
    for (int r = 0; r < n; ++r) {
      const int s = r % ring;
      mbar_wait(&full[s], (r / ring) & 1);
      bulk_store(dst + static_cast<size_t>(r) * row_bytes,
                 slots + static_cast<size_t>(s) * row_bytes, row_bytes);
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      mbar_arrive(&empty[s]);
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// K5c: replicated reads. out = dtype(0 + x + x + ... + x), `factor` reads of
// x summed in f32 in order with __fadd_rn and rounded once. A block owns a
// tile of 32 rows x 32 units (a unit is one 16-byte vector, or one element
// where w * sizeof or a pointer is not 16-byte aligned); each thread
// accumulates 4 units of one column of units in registers, and the block
// reads its whole tile `factor` times, each read a volatile load that the
// compiler may neither merge nor drop. bm, the TPU's DMA block, does not
// change the result and is only checked by the wrapper.

#define REP_TX 32  // units along a row: one warp
#define REP_TY 8   // thread rows
#define REP_K 4    // rows each thread accumulates: a tile is 32 rows

__device__ __forceinline__ uint4 ld_volatile(const uint4* p) {
  uint4 v;
  asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ uint32_t ld_volatile(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.volatile.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ uint16_t ld_volatile(const uint16_t* p) {
  unsigned short v;
  asm volatile("ld.volatile.global.u16 %0, [%1];\n"
               : "=h"(v)
               : "l"(p)
               : "memory");
  return v;
}

// V elements of T at p, widened to f32 (one 16-byte volatile load when
// V > 1).
template <typename T, int V>
__device__ __forceinline__ void load_volatile(const typename T::bits* p,
                                              float (&f)[V]) {
  if constexpr (V > 1) {
    Pack<typename T::bits, V> u;
    u.raw = ld_volatile(reinterpret_cast<const uint4*>(p));
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = T::widen(u.e[i]);
  } else {
    f[0] = T::widen(ld_volatile(p));
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(typename T::bits* p,
                                      const float (&f)[V]) {
  if constexpr (V > 1) {
    Pack<typename T::bits, V> u;
#pragma unroll
    for (int i = 0; i < V; ++i) u.e[i] = T::narrow(f[i]);
    *reinterpret_cast<uint4*>(p) = u.raw;
  } else {
    p[0] = T::narrow(f[0]);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(REP_TX* REP_TY)
    stream_replicated_kernel(const typename T::bits* __restrict__ x,
                             typename T::bits* __restrict__ out, int h, int w,
                             int factor) {
  const int c = (blockIdx.x * REP_TX + threadIdx.x) * V;
  if (c >= w) return;
  const int r0 = blockIdx.y * (REP_TY * REP_K) + threadIdx.y;
  float acc[REP_K][V];
#pragma unroll
  for (int k = 0; k < REP_K; ++k) {
#pragma unroll
    for (int i = 0; i < V; ++i) acc[k][i] = 0.0f;
  }
  for (int f = 0; f < factor; ++f) {
#pragma unroll
    for (int k = 0; k < REP_K; ++k) {
      const int r = r0 + k * REP_TY;
      if (r < h) {
        float v[V];
        load_volatile<T, V>(x + static_cast<size_t>(r) * w + c, v);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[k][i] = __fadd_rn(acc[k][i], v[i]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < REP_K; ++k) {
    const int r = r0 + k * REP_TY;
    if (r < h) store<T, V>(out + static_cast<size_t>(r) * w + c, acc[k]);
  }
}

// ---------------------------------------------------------------------------
// The L2 read-rate probe: a measurement, not a port of any TPU kernel. It
// prices K5c's re-reads, which this card serves from its L2. As K5c does,
// each block re-reads its own tile `passes` times with the same
// ld.volatile.global.v4 loads: a tile is U x 256 vectors (16 KB at U = 4,
// 32 KB at U = 8), each thread issues its U loads of a pass (a warp's 32
// lanes on neighbouring vectors) before it adds any, and the words are
// summed into a u32 that is stored (one atomicAdd a warp), so no load can
// be dropped. A buffer of a few tiles an SM that fits the L2 is then served
// by the L2 on every pass after the first. The sum, passes x (the
// buffer's words summed mod 2^32), does not depend on the order, so the
// wrapper checks it exactly. The rate depends on the layout (U, tiles an
// SM, passes) by a few percent either way on an H100, and K5c itself has
// read faster than some of them, so the caller measures several layouts
// and takes the highest rate it sees.

template <int U>
__global__ void __launch_bounds__(THREADS)
    l2_probe_kernel(const uint4* __restrict__ x, int n, int passes,
                    unsigned int* out) {
  const int base = blockIdx.x * (THREADS * U) + threadIdx.x;
  unsigned int acc = 0;
  for (int p = 0; p < passes; ++p) {
    uint4 v[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int i = base + k * THREADS;
      v[k] = i < n ? ld_volatile(x + i) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      acc += v[k].x + v[k].y + v[k].z + v[k].w;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  }
  if ((threadIdx.x & 31) == 0) atomicAdd(out, acc);
}

// ---------------------------------------------------------------------------
// K6a: move a (bm + 2)-row window and write its interior, no math. out is
// (h - 2, w - 2) = u[1:-1, 1:-1]. One block per (bm-row block, column chunk
// of CHUNK_BYTES): it stages the window's rows and the chunk's columns plus
// one on either side through shared memory, then writes the interior out of
// it. Unlike the TPU kernel, the last row block may be ragged, so every
// output row is written.

#define CHUNK_BYTES 512

template <typename E>
__global__ void __launch_bounds__(THREADS)
    dma_only_kernel(const E* __restrict__ u, E* __restrict__ out, int h,
                    int w, int bm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* win = reinterpret_cast<E*>(smem_raw);
  constexpr int CW = CHUNK_BYTES / sizeof(E);
  constexpr int PITCH = CW + 2;
  const int hi = h - 2, wi = w - 2;
  const int r0 = blockIdx.y * bm, c0 = blockIdx.x * CW;
  const int rows = min(bm, hi - r0), cols = min(CW, wi - c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  for (int rr = warp; rr < rows + 2; rr += warps) {
    const E* src = u + static_cast<size_t>(r0 + rr) * w + c0;
    for (int cc = lane; cc < cols + 2; cc += 32) win[rr * PITCH + cc] = src[cc];
  }
  __syncthreads();
  for (int rr = warp; rr < rows; rr += warps) {
    E* dst = out + static_cast<size_t>(r0 + rr) * wi + c0;
    for (int cc = lane; cc < cols; cc += 32) {
      dst[cc] = win[(rr + 1) * PITCH + cc + 1];
    }
  }
}

// ---------------------------------------------------------------------------
// K6b: the Jacobi sweep's arithmetic on resident data, ((c + c + c + c) *
// 0.25) in f32, rounded once. Block rows [b * bm, min((b + 1) * bm, h)) of
// the array are one contiguous range of elements (the last block ragged);
// gridDim.x blocks cut each range into chunks of THREADS * 4 16-byte units.
// A chunk takes 16-byte vectors where its block's range starts 16-byte
// aligned, elements otherwise, and its tail elements one by one.

__device__ __forceinline__ float quad_quarter(float c) {
  return __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(c, c), c), c), 0.25f);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    compute_only_kernel(const typename T::bits* __restrict__ u,
                        typename T::bits* __restrict__ out, int h, int w,
                        int bm) {
  using B = typename T::bits;
  constexpr int V = 16 / sizeof(B);
  constexpr int CHUNK = THREADS * 4 * V;  // elements
  const size_t start = static_cast<size_t>(blockIdx.y) * bm * w;
  const size_t end =
      static_cast<size_t>(min(static_cast<int>(blockIdx.y + 1) * bm, h)) * w;
  const size_t c0 = start + static_cast<size_t>(blockIdx.x) * CHUNK;
  if (c0 >= end) return;
  const int n = end - c0 < CHUNK ? static_cast<int>(end - c0) : CHUNK;
  const B* s = u + c0;
  B* d = out + c0;
  int done = 0;
  if (aligned16(u + start) && aligned16(out + start)) {
    const int nv = n / V;
    for (int k = threadIdx.x; k < nv; k += THREADS) {
      Pack<B, V> p;
      p.raw = reinterpret_cast<const uint4*>(s)[k];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        p.e[i] = T::narrow(quad_quarter(T::widen(p.e[i])));
      }
      reinterpret_cast<uint4*>(d)[k] = p.raw;
    }
    done = nv * V;
  }
  for (int k = done + threadIdx.x; k < n; k += THREADS) {
    d[k] = T::narrow(quad_quarter(T::widen(s[k])));
  }
}

// ---------------------------------------------------------------------------
// Launchers. esize: bytes an element (2 or 4). dtype: 0 = f32, 1 = bf16,
// 2 = int32. The wrappers check shapes, divisibility, alignment and dtype
// before they call; the launchers refuse what would index out of bounds.

template <typename K>
static cudaError_t opt_in_smem(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

extern "C" cudaError_t repro_stream_copy(const void* x, void* out, int esize,
                                         int h, int w, int bm, int bn,
                                         int g, int split, void* stream) {
  if (h < 1 || w < 1 || bm < 1 || bn < 1 || h % bm || w % bn || g < 1 ||
      g > 32 || (g & (g - 1)) || split < 1 || split > bm) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_w = w / bn;
  const long long blocks = static_cast<long long>(h / bm) * tiles_w * split;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // A block of `split` > 1 holds only its run's rows: one group a row.
  const int rows = (bm + split - 1) / split;
  const int threads = min(COPY_THREADS, (rows * g + 31) / 32 * 32);
  if (esize == 4) {
    stream_copy_kernel<uint32_t>
        <<<static_cast<unsigned>(blocks), threads, 0, s>>>(
            static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), w,
            bm, bn, tiles_w, g, split);
  } else if (esize == 2) {
    stream_copy_kernel<uint16_t>
        <<<static_cast<unsigned>(blocks), threads, 0, s>>>(
            static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), w,
            bm, bn, tiles_w, g, split);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// split: blocks a bm-row block's rows go to; ring: row slots a block;
// sync: one row in flight, waited for before the next is issued.
// kernels/stream.py::rowdma_plan picks them.
extern "C" cudaError_t repro_stream_rowdma(const void* x, void* out,
                                           int esize, int h, int w, int bm,
                                           int split, int ring, int sync,
                                           void* stream) {
  const size_t row_bytes = static_cast<size_t>(w) * esize;
  const size_t smem = RING_BARS + static_cast<size_t>(ring) * row_bytes;
  const long long blocks = static_cast<long long>(h / bm) * split;
  if (h < 1 || w < 1 || bm < 1 || h % bm || (esize != 2 && esize != 4) ||
      row_bytes % 16 || split < 1 || split > bm || ring < 1 ||
      ring > RING_BARS / 16 || smem > MAX_SMEM || blocks > 0x7fffffffLL ||
      !aligned16(x) || !aligned16(out)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = opt_in_smem(stream_rowdma_kernel, smem);
  if (err != cudaSuccess) return err;
  stream_rowdma_kernel<<<static_cast<unsigned>(blocks), 64, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out),
      static_cast<uint32_t>(row_bytes), bm, split, ring, sync);
  return cudaGetLastError();
}

template <typename T, int V>
static cudaError_t launch_replicated(const void* x, void* out, int h, int w,
                                     int factor, cudaStream_t s) {
  const int units = w / V;
  const dim3 grid((units + REP_TX - 1) / REP_TX,
                  (h + REP_TY * REP_K - 1) / (REP_TY * REP_K));
  stream_replicated_kernel<T, V><<<grid, dim3(REP_TX, REP_TY), 0, s>>>(
      static_cast<const typename T::bits*>(x),
      static_cast<typename T::bits*>(out), h, w, factor);
  return cudaGetLastError();
}

// vec: 16-byte vectors along rows (the caller checks that w * sizeof and
// both pointers are 16-byte aligned).
extern "C" cudaError_t repro_stream_replicated(const void* x, void* out,
                                               int dtype, int h, int w,
                                               int factor, int vec,
                                               void* stream) {
  if (h < 1 || w < 1 || factor < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return vec ? launch_replicated<F32, 4>(x, out, h, w, factor, s)
                 : launch_replicated<F32, 1>(x, out, h, w, factor, s);
    case 1:
      return vec ? launch_replicated<BF16, 8>(x, out, h, w, factor, s)
                 : launch_replicated<BF16, 1>(x, out, h, w, factor, s);
    case 2:
      return vec ? launch_replicated<I32, 4>(x, out, h, w, factor, s)
                 : launch_replicated<I32, 1>(x, out, h, w, factor, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename E>
static cudaError_t launch_dma_only(const void* u, void* out, int h, int w,
                                   int bm, cudaStream_t s) {
  constexpr int CW = CHUNK_BYTES / sizeof(E);
  const size_t smem = static_cast<size_t>(bm + 2) * (CW + 2) * sizeof(E);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = opt_in_smem(dma_only_kernel<E>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((w - 2 + CW - 1) / CW, (h - 2 + bm - 1) / bm);
  dma_only_kernel<E><<<grid, THREADS, smem, s>>>(
      static_cast<const E*>(u), static_cast<E*>(out), h, w, bm);
  return cudaGetLastError();
}

extern "C" cudaError_t repro_dma_only(const void* u, void* out, int esize,
                                      int h, int w, int bm, void* stream) {
  if (h < 3 || w < 3 || bm < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (esize == 4) return launch_dma_only<uint32_t>(u, out, h, w, bm, s);
  if (esize == 2) return launch_dma_only<uint16_t>(u, out, h, w, bm, s);
  return cudaErrorInvalidValue;
}

template <typename T>
static cudaError_t launch_compute_only(const void* u, void* out, int h,
                                       int w, int bm, cudaStream_t s) {
  constexpr int CHUNK = THREADS * 4 * (16 / sizeof(typename T::bits));
  const size_t per_block = static_cast<size_t>(bm) * w;
  const dim3 grid(static_cast<unsigned>((per_block + CHUNK - 1) / CHUNK),
                  (h + bm - 1) / bm);
  if (grid.x > 2147483647u || grid.y > 65535u) return cudaErrorInvalidValue;
  compute_only_kernel<T><<<grid, THREADS, 0, s>>>(
      static_cast<const typename T::bits*>(u),
      static_cast<typename T::bits*>(out), h, w, bm);
  return cudaGetLastError();
}

extern "C" cudaError_t repro_compute_only(const void* u, void* out, int dtype,
                                          int h, int w, int bm,
                                          void* stream) {
  if (h < 1 || w < 1 || bm < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_compute_only<F32>(u, out, h, w, bm, s);
  if (dtype == 1) return launch_compute_only<BF16>(u, out, h, w, bm, s);
  return cudaErrorInvalidValue;
}

// x: n 16-byte vectors, 16-byte aligned; out: one u32, zeroed by the caller.
// One block a tile of THREADS x unroll vectors; unroll is 4 or 8.
extern "C" cudaError_t repro_l2_probe(const void* x, void* out, int n,
                                      int passes, int unroll, void* stream) {
  if (n < 1 || passes < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* v = static_cast<const uint4*>(x);
  unsigned int* o = static_cast<unsigned int*>(out);
  if (unroll == 4) {
    l2_probe_kernel<4><<<(n + THREADS * 4 - 1) / (THREADS * 4), THREADS, 0,
                         s>>>(v, n, passes, o);
  } else if (unroll == 8) {
    l2_probe_kernel<8><<<(n + THREADS * 8 - 1) / (THREADS * 8), THREADS, 0,
                         s>>>(v, n, passes, o);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
