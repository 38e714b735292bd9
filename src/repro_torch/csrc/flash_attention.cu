// Prefill attention for Hopper (sm_90a): causal / sliding-window GQA
// attention with an online softmax in fp32.
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention.py), whose grid walked the KV blocks
// of one (batch, head, q-block) in order and carried (m, l, acc) in VMEM
// scratch between grid steps.  Blocks of a CUDA grid run in no order, so
// here one block owns one (batch, head, q-tile) and walks its KV tiles in
// a loop; (m, l, acc) live in registers for the whole walk.
//
// What bounds it: at the server's shapes (S = 128..200, hd = 64/128,
// 12 heads) the work is tiny — about 0.2 GFLOP per layer — and the K/V
// bytes fit in L2, so a launch is bound by latency and by the shared-
// memory traffic of the fp32 dot products, not by HBM or tensor cores.
// The design keeps it simple and right: fp32 CUDA-core FMAs, a K tile
// padded by one float per row so that 32 lanes reading 32 keys hit 32
// banks, and the causal / window bound setting the loop's limits so
// fully masked KV tiles are never loaded.  The ragged edge (Sq or Sk not
// a multiple of the tile) is masked element by element: rows past Sq are
// not stored, keys past Sk are zero-filled and masked.  wgmma and TMA
// are later work.
//
// Layout: q (B, H, Sq, hd), k/v (B, KV, Sk, hd), o (B, H, Sq, hd), each
// addressed through (batch, head, seq) strides with hd contiguous, so
// the model passes permuted views of its (B, S, H, hd) activations and
// nothing is copied.  Query head h reads KV head h / (H / KV).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 32;                     // keys per tile: one per lane

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Strides {
  long long b, h, s;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KV,
                 int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                 Strides os, int causal, int window, float scale) {
  constexpr int DPL = (HD + 31) / 32;  // accumulator columns per lane
  constexpr int KPAD = HD + 1;         // padded K row: conflict-free reads
  extern __shared__ float smem[];
  float* sq = smem;                 // [kBQ][HD]
  float* sk = sq + kBQ * HD;        // [kBK][KPAD]
  float* sv = sk + kBK * KPAD;      // [kBK][HD]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nthreads = kWarps * 32;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int i = threadIdx.x; i < kBQ * HD; i += nthreads) {
    const int r = i / HD, d = i % HD;
    const int qi = q0 + r;
    sq[i] = qi < Sq ? to_f32(qb[qi * qs.s + d]) : 0.f;
  }

  // The KV range any row of this tile can see: causal stops at the
  // tile's last row, the window starts at the first row's window.
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  k_lo = (k_lo / kBK) * kBK;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kBK * HD; i += nthreads) {
      const int r = i / HD, d = i % HD;
      const int kj = k0 + r;
      const bool in = kj < Sk;
      sk[r * KPAD + d] = in ? to_f32(kb[kj * ks.s + d]) : 0.f;
      sv[r * HD + d] = in ? to_f32(vb[kj * vs.s + d]) : 0.f;
    }
    __syncthreads();

    // Scores: lane j holds key k0 + j against the warp's rows.
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* krow = sk + lane * KPAD;
    const float* qrow = sq + warp * kRowsPerWarp * HD;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] += qrow[r * HD + d] * kd;
    }

    const int kj = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qi = q0 + warp * kRowsPerWarp + r;
      bool ok = kj < Sk;
      if (causal) ok = ok && kj <= qi;
      if (window > 0) ok = ok && kj > qi - window;
      const float sc = ok ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float p = expf(sc - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      m[r] = m_new;
      s[r] = p;
    }

    // acc += P · V: key j's probability is broadcast from lane j; lane
    // owns output columns lane, lane + 32, ...
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vj[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        vj[i] = d < HD ? sv[j * HD + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] += pj * vj[i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp * kRowsPerWarp + r;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) ob[qi * os.s + d] = from_f32<T>(acc[r][i] * inv);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KV, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
           Strides os, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kBQ * HD + kBK * (HD + 1) + kBK * HD);
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KV, Sq, Sk, qs, ks, vs,
      os, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                int B, int H, int KV, int Sq, int Sk, Strides qs, Strides ks,
                Strides vs, Strides os, int causal, int window, float scale,
                cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, KV, Sq, Sk, qs, ks, vs, os, causal, window, scale, st);
    case 32: return launch<T, 32>(q, k, v, o, B, H, KV, Sq, Sk, qs, ks, vs, os, causal, window, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KV, Sq, Sk, qs, ks, vs, os, causal, window, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KV, Sq, Sk, qs, ks, vs, os, causal, window, scale, st);
    case 256: return launch<T, 256>(q, k, v, o, B, H, KV, Sq, Sk, qs, ks, vs, os, causal, window, scale, st);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  Returns
// cudaGetLastError() after the launch, or -1 for an unsupported
// dtype / head size.
extern "C" int flash_attention_fwd(
    int dtype, int hd, const void* q, const void* k, const void* v, void* o,
    int B, int H, int KV, int Sq, int Sk, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long osb, long long osh, long long oss,
    int causal, int window, float scale, void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, B, H, KV, Sq, Sk, qs, ks, vs, os,
                              causal, window, scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, KV, Sq, Sk, qs, ks,
                                      vs, os, causal, window, scale, st);
  return -1;
}
