// Hand-written Hopper (sm_90a) kernel for Mamba2's depthwise causal conv (K7).
//
// Replaces the Pallas kernel src/repro/kernels/conv1d.py
// (conv1d_depthwise_causal): out[b, l, d] = sum_k w[k, d] * x[b, l-(K-1)+k, d]
// with x = 0 before step 0, plus bias[d]. It computes exactly the f32
// operations of its plain PyTorch version
// (src/repro_torch/kernels/conv1d.py): acc = 0, then one __fmul_rn and one
// __fadd_rn a tap in tap order, then __fadd_rn of the bias, so nothing is
// contracted into a fused multiply-add whatever -fmad says, and the result
// is held against the plain version bit for bit. Values are stored in the
// input dtype with round-to-nearest-even (__float2bfloat16_rn for bf16).
//
// Layout: x and out (B, L, D) with D contiguous, w (K, D), bias (D,) or
// NULL, all of one dtype (f32 or bf16), widened to f32 in registers.
//
// Design. The TPU kernel DMAs a chunk of bl steps plus a (K-1)-step halo
// from a copy of x padded on the host. Here each thread owns V neighbouring
// channels (one 16-byte vector: 4 f32 or 8 bf16, or V = 1 where D or a
// pointer is not 16-byte aligned) and walks a segment of time steps,
// keeping the last K inputs in registers, so each input is read from device
// memory once (plus a K-1 step halo a segment) and steps before 0 are read
// as zeros in place: there is no pad copy. A warp's 32 lanes cover 32
// neighbouring vectors (512 contiguous bytes), so every load and store is
// coalesced. A block is 32 lanes x 8 segments over one chunk of bl time
// steps; the grid is (D tiles, L / bl chunks, B). The tail tile along D is
// bound-checked.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): x read once and out written once, 4 bytes an element in bf16 and
// 8 in f32, against 2K f32 operations an element: bound by bytes.
//
// C interface: one extern "C" launcher returning cudaError_t (the launch's
// cudaGetLastError()). Built by repro_torch/kernels/build.py with
// nvcc -gencode arch=compute_90a,code=sm_90a and loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define LANES 32  // vectors along D a block covers: one warp
#define SEGS 8    // time segments a block's chunk is cut into

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

// The bits of one T, a trivial type a union can hold.
template <typename T>
struct Bits;
template <>
struct Bits<float> {
  using type = float;
  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ float narrow(float v) { return v; }
};
template <>
struct Bits<__nv_bfloat16> {
  using type = unsigned short;
  static __device__ __forceinline__ float widen(unsigned short v) {
    return __bfloat162float(__ushort_as_bfloat16(v));
  }
  static __device__ __forceinline__ unsigned short narrow(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// V values of T as one 16-byte access (V * sizeof(T) == 16).
template <typename T, int V>
union Pack {
  uint4 raw;
  typename Bits<T>::type e[V];
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&f)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    Pack<T, V> u;
    u.raw = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = Bits<T>::widen(u.e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_f32(p[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&f)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    Pack<T, V> u;
#pragma unroll
    for (int i = 0; i < V; ++i) u.e[i] = Bits<T>::narrow(f[i]);
    *reinterpret_cast<uint4*>(p) = u.raw;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = from_f32<T>(f[i]);
  }
}

template <typename T, int K, int V>
__global__ void __launch_bounds__(LANES* SEGS)
    conv1d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ bias, T* __restrict__ out, int L,
                  int D, int bl, int seg) {
  const int d0 = (blockIdx.x * LANES + threadIdx.x) * V;
  if (d0 >= D) return;  // the tail tile along D
  const int c0 = blockIdx.y * bl;
  const int t0 = c0 + threadIdx.y * seg;
  const int t1 = min(t0 + seg, c0 + bl);
  if (t0 >= t1) return;
  const size_t row = static_cast<size_t>(blockIdx.z) * L;
  const T* xb = x + row * D + d0;
  T* ob = out + row * D + d0;

  float wr[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    load<T, V>(w + static_cast<size_t>(k) * D + d0, wr[k]);
  }
  float br[V];
  if (bias != nullptr) load<T, V>(bias + d0, br);

  // win[j] holds step t-(K-1)+j; the K-1 steps before t0 are the halo.
  float win[K][V];
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const int t = t0 - (K - 1) + j;
    if (t >= 0) {
      load<T, V>(xb + static_cast<size_t>(t) * D, win[j]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) win[j][i] = 0.0f;
    }
  }
#pragma unroll 4
  for (int t = t0; t < t1; ++t) {
    load<T, V>(xb + static_cast<size_t>(t) * D, win[K - 1]);
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float a = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        a = __fadd_rn(a, __fmul_rn(win[k][i], wr[k][i]));
      }
      if (bias != nullptr) a = __fadd_rn(a, br[i]);
      acc[i] = a;
    }
    store<T, V>(ob + static_cast<size_t>(t) * D, acc);
#pragma unroll
    for (int j = 0; j < K - 1; ++j) {
#pragma unroll
      for (int i = 0; i < V; ++i) win[j][i] = win[j + 1][i];
    }
  }
}

template <typename T, int K, int V>
static cudaError_t launch(const void* x, const void* w, const void* b,
                          void* out, int batch, int L, int D, int bl,
                          cudaStream_t stream) {
  const int lanes = (D + V - 1) / V;
  const dim3 grid((lanes + LANES - 1) / LANES, L / bl, batch);
  const int seg = (bl + SEGS - 1) / SEGS;
  conv1d_kernel<T, K, V><<<grid, dim3(LANES, SEGS), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(out), L, D, bl, seg);
  return cudaGetLastError();
}

template <typename T, int V>
static cudaError_t by_width(int K, const void* x, const void* w,
                            const void* b, void* out, int batch, int L, int D,
                            int bl, cudaStream_t s) {
  switch (K) {
    case 1: return launch<T, 1, V>(x, w, b, out, batch, L, D, bl, s);
    case 2: return launch<T, 2, V>(x, w, b, out, batch, L, D, bl, s);
    case 3: return launch<T, 3, V>(x, w, b, out, batch, L, D, bl, s);
    case 4: return launch<T, 4, V>(x, w, b, out, batch, L, D, bl, s);
    case 5: return launch<T, 5, V>(x, w, b, out, batch, L, D, bl, s);
    case 6: return launch<T, 6, V>(x, w, b, out, batch, L, D, bl, s);
    case 7: return launch<T, 7, V>(x, w, b, out, batch, L, D, bl, s);
    case 8: return launch<T, 8, V>(x, w, b, out, batch, L, D, bl, s);
    default: return cudaErrorInvalidValue;
  }
}

// dtype: 0 = f32, 1 = bf16. vec: 16-byte vectors along D (the caller checks
// that D * sizeof(T) and every pointer are 16-byte aligned). bl must divide
// L. b may be NULL (no bias).
extern "C" cudaError_t repro_conv1d(const void* x, const void* w,
                                    const void* b, void* out, int dtype,
                                    int batch, int L, int D, int K, int bl,
                                    int vec, void* stream) {
  if (batch < 1 || L < 1 || D < 1 || bl < 1 || L % bl) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vec ? by_width<float, 4>(K, x, w, b, out, batch, L, D, bl, s)
               : by_width<float, 1>(K, x, w, b, out, batch, L, D, bl, s);
  }
  if (dtype == 1) {
    return vec ? by_width<__nv_bfloat16, 8>(K, x, w, b, out, batch, L, D, bl,
                                            s)
               : by_width<__nv_bfloat16, 1>(K, x, w, b, out, batch, L, D, bl,
                                            s);
  }
  return cudaErrorInvalidValue;
}
