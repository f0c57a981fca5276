// Hand-written Hopper (sm_90a) flash-attention forward (K8), float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention_local`, body `_kernel`) and computes its function:
// GQA attention with an online softmax, all in f32.
//
//   q (B, Sq, H, hd), k and v (B, Sk, KH, hd), H = KH * G, row-major and
//   contiguous, float32; o like q.
//
// What it keeps from the TPU kernel:
//   * q is scaled by `scale` (hd**-0.5 rounded to f32) in f32 before the
//     dot products;
//   * Q K^T and P V are f32 products with f32 sums; P stays f32;
//   * the running max m, sum l and accumulator are f32; m starts at -1e30,
//     a key after the query (causal, by absolute index) scores -1e30, and
//     whole key tiles after a block's last query are skipped;
//   * the output is acc / max(l, 1e-30).
// What differs: the TPU kernel rescales its running sums once per key
// block of bk (<= 512) keys; this kernel does so once per tile of 64 keys.
// That moves f32 roundings only (the softmax is the same function); the
// plain version (kernels/flash_attention.py) keeps the TPU kernel's bq/bk
// tile order, and the two are held to 2e-5.
//
// Design. One block owns FA_ROWS = 64 rows of one (batch, kv_head): TQ =
// 64 / G query positions times the G heads that share the KV head, so K
// and V tiles are staged once in shared memory for the whole GQA group.
// 256 threads form a 16 x 16 grid; thread (ty, tx) holds rows ty*4..+3
// and, of S = Q K^T, keys tx*4..+3 of the tile (a 4 x 4 register tile
// fed by two float4 loads a step from d-major Q and K), and of O the same
// rows times HD/16 columns. The row max and row sum of the online softmax
// are reduced over the 16 lanes that share a row with shuffles. P is
// written to shared memory (over the K tile, which is dead by then) for
// the P V product. Work per block grows with its query position under the
// causal mask, so blocks are issued from the last query tile first.
// Shared memory at hd 128 is 100 KiB, so two blocks share an SM.
//
// Bound on an H100 SXM: 4*hd f32 operations per (query row, key) pair
// that the mask keeps (2*hd for q.k, 2*hd for p*v) on the CUDA cores at
// 67 TFLOP/s, against each of q, k, v read once and o written once at
// 3.35 TB/s: at serving shapes (S = 2048, hd = 128) the operations bound
// it (about 1 ms against 0.02 ms of bytes). The port sends only float32
// here: full f32 has no tensor-core product, and TF32 would miss the f32
// gate of 2e-5. bfloat16 inputs go to the tensor-core kernel in
// flash_attention_sm90.cu (wgmma, bf16 P).
//
// C interface: repro_flash_attention(...) returns the launch's
// cudaGetLastError(). Built by repro_torch/kernels/build.py with nvcc
// -gencode arch=compute_90a,code=sm_90a and loaded with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define FA_THREADS 256
#define FA_ROWS 64             // (query position, head) rows of a block
#define FA_KEYS 64             // keys of a shared-memory tile
#define FA_LD (FA_ROWS + 4)    // pitch of the d-major tiles (float4 rows)
#define FA_NEG_INF (-1e30f)

// The output columns a thread owns: NV groups of VEC adjacent columns,
// group i of thread tx starting at i*16*VEC + tx*VEC. VEC is the widest
// of 4, 2, 1 that divides CPT (hd 80 and 112 give an odd CPT, 5 and 7:
// scalar columns i*16 + tx).
template <int HD>
struct Cols {
  static constexpr int CPT = HD / 16;
  static constexpr int VEC = CPT % 4 == 0 ? 4 : CPT % 2 == 0 ? 2 : 1;
  static constexpr int NV = CPT / VEC;
  static __device__ __forceinline__ int col(int tx, int i) {
    return i * 16 * VEC + tx * VEC;
  }
};

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (VEC == 4) {
    float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (VEC == 2) {
    float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
    out[0] = *p;
  }
}

template <int HD>
constexpr size_t smem_floats() {
  // Qt [HD][FA_LD], Kt [HD][FA_LD] (also Pt [FA_KEYS][FA_LD]), Vs [FA_KEYS][HD]
  return (size_t)HD * FA_LD + (size_t)(HD > FA_KEYS ? HD : FA_KEYS) * FA_LD +
         (size_t)FA_KEYS * HD;
}

template <int HD>
__global__ void __launch_bounds__(FA_THREADS, HD <= 128 ? 2 : 1)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
          int H, int KH, int G, int TQ, int causal, float scale) {
  using C = Cols<HD>;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                  // q * scale, d-major
  float* Kt = Qt + HD * FA_LD;       // k tile, d-major
  float* Pt = Kt;                    // p tile, key-major (after Kt is read)
  float* Vs = Kt + (HD > FA_KEYS ? HD : FA_KEYS) * FA_LD;  // v tile

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TQ;
  const int rows = TQ * G;

  for (int idx = tid; idx < FA_ROWS * HD; idx += FA_THREADS) {
    const int r = idx / HD, d = idx % HD, qp = q0 + r / G;
    float val = 0.f;
    if (r < rows && qp < Sq)
      val = q[(((size_t)b * Sq + qp) * H + kh * G + r % G) * HD + d] * scale;
    Qt[d * FA_LD + r] = val;
  }

  int qpos[4];
  float m[4], l[4], acc[4][C::CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = q0 + (ty * 4 + i) / G;
    m[i] = FA_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::CPT; ++c) acc[i][c] = 0.f;
  }
  const int q_last = min(q0 + TQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;

  for (int k0 = 0; k0 < k_end; k0 += FA_KEYS) {
    __syncthreads();  // Q is stored; the last tile's P V reads are done
    for (int idx = tid; idx < FA_KEYS * HD; idx += FA_THREADS) {
      const int c = idx / HD, d = idx % HD, kp = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (kp < Sk) {
        const size_t off = (((size_t)b * Sk + kp) * KH + kh) * HD + d;
        kv = k[off];
        vv = v[off];
      }
      Kt[d * FA_LD + c] = kv;
      Vs[c * HD + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * FA_LD + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Kt[d * FA_LD + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        if (kp >= Sk)
          s[i][j] = -INFINITY;  // past the keys: no weight at all
        else if (causal && kp > qpos[i])
          s[i][j] = FA_NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
#pragma unroll
      for (int c = 0; c < C::CPT; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }

    __syncthreads();  // every thread is done reading Kt
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * FA_LD + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < FA_KEYS; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(&Pt[c * FA_LD + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < C::NV; ++g) {
        float vv[C::VEC];
        load_vec<C::VEC>(&Vs[c * HD + C::col(tx, g)], vv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < C::VEC; ++j)
            acc[i][g * C::VEC + j] = fmaf(pv[i], vv[j], acc[i][g * C::VEC + j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows || qpos[i] >= Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    float* orow = o + (((size_t)b * Sq + qpos[i]) * H + kh * G + r % G) * HD;
#pragma unroll
    for (int g = 0; g < C::NV; ++g)
#pragma unroll
      for (int j = 0; j < C::VEC; ++j)
        orow[C::col(tx, g) + j] = acc[i][g * C::VEC + j] / li;
  }
}

template <int HD>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          void* o, int B, int Sq, int Sk, int H, int KH,
                          int causal, float scale, cudaStream_t stream) {
  const int G = H / KH, TQ = FA_ROWS / G;
  const size_t bytes = smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + TQ - 1) / TQ, KH, B);
  flash_fwd<HD><<<grid, FA_THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, KH, G,
      TQ, causal, scale);
  return cudaGetLastError();
}

// The wrapper has checked shapes, H % KH == 0, G = H / KH <= 64 and hd in
// {16, 32, 64, 80, 112, 128, 256}.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int Sq,
                                     int Sk, int H, int KH, int hd,
                                     int causal, float scale, void* stream) {
  if (KH <= 0 || H % KH != 0 || H / KH > FA_ROWS) return cudaErrorInvalidValue;
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
