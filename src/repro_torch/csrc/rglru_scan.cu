// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t h_{t-1} + b_t
// per channel, over (B, S, W), with an fp32 carry.
//
// Replaces the Pallas TPU kernel `_rglru_kernel`
// (src/repro/kernels/rglru_scan.py).  That kernel laid the channels on
// the 128 lanes, cut S into power-of-two blocks walked by a sequential
// grid axis with the carry in VMEM, and ran a log-depth doubling scan
// inside each block, because a TPU core does vector work on whole
// (8, 128) tiles.
//
// What bounds it on this card: bytes.  a and b are read once and h
// written once, two flops per element: 15.7 MB at recurrentgemma-2b's
// serve shape (B 4, S 128, W 2560, f32), 4.7 us at 3.35 TB/s.  Reaching
// that needs many loads in flight, and one thread per (batch, channel)
// walking all of S gives only B W = 10,240 threads, about 2.4 warps an
// SM.  So S is cut into segments inside one launch:
// - A block owns 32 neighbouring channels (one warp's coalesced loads)
//   times n_seg segments of S; the wrapper's `segment_plan` picks n_seg
//   from (B, S, W) so that the grid holds about 16 warps an SM.
// - Pass 1: each thread loads its segment's a and b (up to kR steps,
//   held in registers, all loads issued before any is used) and
//   composes the segment's affine map: (prod a, h from a zero carry).
// - The block combines the maps in shared memory: segment k's carry-in
//   is the maps of segments 0 .. k-1 applied to zero, in order.
// - Pass 2: each thread re-walks its segment from the true carry,
//   h = fma(a, h, b) in the reference's order, and stores h.
// a and b are read from device memory once.  Segments longer than kR
// (S above 32 kR) are walked from memory in both passes.  Any S is
// taken; the last segment may be short.
//
// Layout: a, b and h (B, S, W), addressed through their (batch, seq)
// strides with W contiguous; h is written in the dtype of a.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCh = 32;      // channels a block
constexpr int kMaxSeg = 32;  // segments a block (kCh x kMaxSeg threads)
constexpr int kR = 16;       // steps a thread holds in registers

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// blockDim = (kCh, n_seg); grid = (ceil(W / kCh), B).  kCached: every
// segment is at most kR steps long.
template <typename T, bool kCached>
__global__ void __launch_bounds__(kCh * kMaxSeg)
rglru_kernel(const T* __restrict__ a, const T* __restrict__ b,
             T* __restrict__ h, int S, int W, int seg, long long asb,
             long long ass, long long bsb, long long bss, long long hsb,
             long long hss) {
  __shared__ float sProd[kMaxSeg][kCh], sLoc[kMaxSeg][kCh];
  const int ch = threadIdx.x, sg = threadIdx.y;
  const int w = blockIdx.x * kCh + ch;
  const bool on = w < W;
  const long long bi = blockIdx.y;
  const int s_lo = sg * seg, s_hi = min(S, s_lo + seg);
  const T* ap = a + bi * asb + w;
  const T* bp = b + bi * bsb + w;
  T* hp = h + bi * hsb + w;

  // pass 1: the segment's map h -> prod h + loc
  float av[kCached ? kR : 1], bv[kCached ? kR : 1];
  float prod = 1.f, loc = 0.f;
  if (kCached) {
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int s = s_lo + i;
      const bool in = on && s < s_hi;
      av[i] = in ? to_f32(ap[s * ass]) : 1.f;
      bv[i] = in ? to_f32(bp[s * bss]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      loc = fmaf(av[i], loc, bv[i]);
      prod *= av[i];
    }
  } else if (on) {
    for (int s = s_lo; s < s_hi; ++s) {
      const float x = to_f32(ap[s * ass]);
      loc = fmaf(x, loc, to_f32(bp[s * bss]));
      prod *= x;
    }
  }
  sProd[sg][ch] = prod;
  sLoc[sg][ch] = loc;
  __syncthreads();

  // the carry into this segment
  float carry = 0.f;
  for (int k = 0; k < sg; ++k) carry = fmaf(sProd[k][ch], carry, sLoc[k][ch]);
  if (!on) return;

  // pass 2: the segment from its carry
  if (kCached) {
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int s = s_lo + i;
      if (s < s_hi) {
        carry = fmaf(av[i], carry, bv[i]);
        hp[s * hss] = from_f32<T>(carry);
      }
    }
  } else {
    for (int s = s_lo; s < s_hi; ++s) {
      carry = fmaf(to_f32(ap[s * ass]), carry, to_f32(bp[s * bss]));
      hp[s * hss] = from_f32<T>(carry);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* h, int B, int S, int W,
           int seg, const long long* st, cudaStream_t stream) {
  const int n_seg = (S + seg - 1) / seg;
  if (seg < 1 || n_seg > kMaxSeg) return -1;
  const dim3 grid((W + kCh - 1) / kCh, B), block(kCh, n_seg);
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  T* hp = static_cast<T*>(h);
  if (seg <= kR)
    rglru_kernel<T, true><<<grid, block, 0, stream>>>(
        ap, bp, hp, S, W, seg, st[0], st[1], st[2], st[3], st[4], st[5]);
  else
    rglru_kernel<T, false><<<grid, block, 0, stream>>>(
        ap, bp, hp, S, W, seg, st[0], st[1], st[2], st[3], st[4], st[5]);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a, b and h share it).  seg: the
// segment length (`segment_plan` in kernels/rglru_scan.py), with
// ceil(S / seg) <= 32 segments.  Strides are in elements: the (batch,
// seq) strides of a, then b, then h.  Returns cudaGetLastError() after
// the launch, or -1 for an unsupported dtype or segment length.
extern "C" int rglru_scan_fwd(int dtype, const void* a, const void* b,
                              void* h, int B, int S, int W, int seg,
                              long long asb, long long ass, long long bsb,
                              long long bss, long long hsb, long long hss,
                              void* stream) {
  const long long st[6] = {asb, ass, bsb, bss, hsb, hss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, h, B, S, W, seg, st, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, h, B, S, W, seg, st, s);
  return -1;
}
