// Decode attention for Hopper (sm_90a): one new token per sequence over
// its KV cache, with the GQA group's query rows handled together.
//
// Replaces the Pallas TPU kernel `_decode_kernel`
// (src/repro/kernels/decode_attention.py).  That kernel packed the
// query-head group into the sublane axis to give the MXU a matrix-shaped
// product, walked KV blocks in order with (m, l, acc) in VMEM scratch,
// and skipped blocks past `pos`.  Here one block owns one (batch, KV
// head) and its G query rows; its warps split the cache positions
// 0..pos between them (warp w takes positions w, w + 4, ...), each warp
// keeps its own online-softmax state for up to kMaxG rows in registers,
// and the warps' states are merged through shared memory at the end.  A
// larger group (recurrentgemma's 10 query heads over one KV head) is
// walked kMaxG rows at a time, each pass reading the cache again (from
// L2): the per-row state of 10 rows at hd 256 would not fit in
// registers without spilling.  The loop stops at
// `pos` itself, so no tile rounding is needed and any cache length S
// (144 at the server's default) is taken as it is.
//
// What bounds it: reading the cache.  Per step a (batch, KV head) reads
// (pos + 1) · hd · 2 values once; the arithmetic is 4 · G · hd flops per
// position.  Each lane owns hd / 32 contiguous columns, so a warp reads
// one cache row as one coalesced transaction; the dot products are
// reduced with warp shuffles, and the G query rows reuse every K/V value
// loaded.  With few (batch, KV head) pairs the card is mostly idle —
// splitting the cache across blocks (flash-decoding) is later work.
//
// Layout: q (B, KV, G, hd) and k/v (B, KV, S, hd) are addressed through
// their (batch, head, row) strides with hd contiguous, so the model
// passes a view of its fused projection output and a permuted view of
// its (B, S, KV, hd) cache, and nothing is copied; pos (B,) int32;
// o (B, KV, G, hd) contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kMaxG = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ pos,
              T* __restrict__ o, int KV, int G, int S, long long qsb,
              long long qsh, long long qsg, long long ksb, long long ksh,
              long long kss, long long vsb, long long vsh, long long vss,
              int window, float scale) {
  constexpr int DPL = (HD + 31) / 32;  // contiguous columns per lane
  __shared__ float sm[kWarps][kMaxG];
  __shared__ float sl[kWarps][kMaxG];
  __shared__ float sacc[kWarps][kMaxG][HD];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d0 = lane * DPL;
  const bool active = d0 < HD;

  const int p = pos[b];
  const int hi = min(p, S - 1);
  const int lo = window > 0 ? max(0, p - window + 1) : 0;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;
  const long long ooff = ((long long)b * KV + kvh) * G * HD;

  for (int g0 = 0; g0 < G; g0 += kMaxG) {
    const int gn = min(kMaxG, G - g0);  // query rows of this pass
    const T* qb = q + b * qsb + kvh * qsh + g0 * qsg;
    float qr[kMaxG][DPL];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        qr[g][i] = (g < gn && active) ? to_f32(qb[g * qsg + d0 + i]) : 0.f;

    float m[kMaxG], l[kMaxG], acc[kMaxG][DPL];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
    }

    for (int j = lo + warp; j <= hi; j += kWarps) {
      float kr[DPL], vr[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        kr[i] = active ? to_f32(kb[j * kss + d0 + i]) : 0.f;
        vr[i] = active ? to_f32(vb[j * vss + d0 + i]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= gn) break;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) part += qr[g][i] * kr[i];
        const float s = warp_sum(part) * scale;
        const float m_new = fmaxf(m[g], s);
        const float pj = expf(s - m_new);
        const float alpha = expf(m[g] - m_new);
        l[g] = l[g] * alpha + pj;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] = acc[g][i] * alpha + pj * vr[i];
        m[g] = m_new;
      }
    }

    // Merge the warps' partial softmax states.
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        sm[warp][g] = m[g];
        sl[warp][g] = l[g];
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= gn) break;
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        if (active) sacc[warp][g][d0 + i] = acc[g][i];
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < gn * HD; idx += kWarps * 32) {
      const int g = idx / HD, d = idx % HD;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm[w][g]);
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(sm[w][g] - mx);
        den += sl[w][g] * f;
        num += sacc[w][g][d] * f;
      }
      o[ooff + g0 * HD + idx] = from_f32<T>(num / fmaxf(den, 1e-30f));
    }
    __syncthreads();  // the next pass reuses sm, sl and sacc
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* o, int B, int KV, int G, int S, const long long* st,
           int window, float scale, cudaStream_t stream) {
  dim3 grid(KV, B);
  decode_kernel<T, HD><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, static_cast<T*>(o), KV, G, S, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const int* pos, void* o, int B, int KV, int G, int S,
                const long long* st, int window, float scale,
                cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, pos, o, B, KV, G, S, st, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, pos, o, B, KV, G, S, st, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, pos, o, B, KV, G, S, st, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, pos, o, B, KV, G, S, st, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, pos, o, B, KV, G, S, st, window, scale, s);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements: the
// (batch, head, row) strides of q, then of k, then of v.  Returns
// cudaGetLastError() after the launch, or -1 for an unsupported
// dtype / head size, or a group size below 1.
extern "C" int decode_attention_fwd(int dtype, int hd, const void* q,
                                    const void* k, const void* v,
                                    const void* pos, void* o, int B, int KV,
                                    int G, int S, long long qsb, long long qsh,
                                    long long qsg, long long ksb,
                                    long long ksh, long long kss,
                                    long long vsb, long long vsh,
                                    long long vss, int window, float scale,
                                    void* stream) {
  if (G < 1) return -1;
  const long long st[9] = {qsb, qsh, qsg, ksb, ksh, kss, vsb, vsh, vss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, p, o, B, KV, G, S, st, window,
                              scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, p, o, B, KV, G, S, st,
                                      window, scale, s);
  return -1;
}
