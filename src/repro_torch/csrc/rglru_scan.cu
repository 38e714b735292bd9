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

// ---------------------------------------------------------------------
// Backward.  With g_t = ∂L/∂h_t through the recurrence,
//   g_t = dh_t + a_{t+1} g_{t+1},  da_t = g_t h_{t-1} (h_{-1} = 0),
//   db_t = g_t,
// the forward's affine recurrence read from the end: the carry
// x = a_{t+1} g_{t+1} flows right to left, x' = a_t (dh_t + x).  The same
// segment plan and two passes apply with the segments walked backwards:
// pass 1 composes each segment's map x_in -> x_out from its right end,
// the block combines the maps of the segments to the right of each one
// into its carry-in, and pass 2 re-walks the segment from it, writing
// da and db.  a, h and dh are read once (h_{t-1} shifted by a step);
// bytes bound it, as the forward.
template <typename T, bool kCached>
__global__ void __launch_bounds__(kCh * kMaxSeg)
rglru_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
                 const T* __restrict__ dh, T* __restrict__ da,
                 T* __restrict__ db, int S, int W, int seg, long long asb,
                 long long ass, long long hsb, long long hss, long long gsb,
                 long long gss, long long dasb, long long dass, long long dbsb,
                 long long dbss) {
  __shared__ float sProd[kMaxSeg][kCh], sLoc[kMaxSeg][kCh];
  const int ch = threadIdx.x, sg = threadIdx.y, n_seg = blockDim.y;
  const int w = blockIdx.x * kCh + ch;
  const bool on = w < W;
  const long long bi = blockIdx.y;
  const int s_lo = sg * seg, s_hi = min(S, s_lo + seg);
  const T* ap = a + bi * asb + w;
  const T* hp = h + bi * hsb + w;
  const T* gp = dh + bi * gsb + w;
  T* dap = da + bi * dasb + w;
  T* dbp = db + bi * dbsb + w;

  // pass 1: the segment's map x -> prod x + loc, from its right end
  float av[kCached ? kR : 1], gv[kCached ? kR : 1], hv[kCached ? kR : 1];
  float prod = 1.f, loc = 0.f;
  if (kCached) {
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int s = s_lo + i;
      const bool in = on && s < s_hi;
      av[i] = in ? to_f32(ap[s * ass]) : 1.f;
      gv[i] = in ? to_f32(gp[s * gss]) : 0.f;
      hv[i] = in && s > 0 ? to_f32(hp[(s - 1) * hss]) : 0.f;
    }
#pragma unroll
    for (int i = kR - 1; i >= 0; --i) {
      loc = av[i] * (gv[i] + loc);
      prod *= av[i];
    }
  } else if (on) {
    for (int s = s_hi - 1; s >= s_lo; --s) {
      const float x = to_f32(ap[s * ass]);
      loc = x * (to_f32(gp[s * gss]) + loc);
      prod *= x;
    }
  }
  sProd[sg][ch] = prod;
  sLoc[sg][ch] = loc;
  __syncthreads();

  // the carry into this segment from the segments to its right
  float carry = 0.f;
  for (int k = n_seg - 1; k > sg; --k)
    carry = fmaf(sProd[k][ch], carry, sLoc[k][ch]);
  if (!on) return;

  // pass 2: the segment from its carry, right to left
  if (kCached) {
#pragma unroll
    for (int i = kR - 1; i >= 0; --i) {
      const int s = s_lo + i;
      if (s < s_hi) {
        const float g = gv[i] + carry;
        dap[s * dass] = from_f32<T>(g * hv[i]);
        dbp[s * dbss] = from_f32<T>(g);
        carry = av[i] * g;
      }
    }
  } else {
    for (int s = s_hi - 1; s >= s_lo; --s) {
      const float g = to_f32(gp[s * gss]) + carry;
      const float hprev = s > 0 ? to_f32(hp[(s - 1) * hss]) : 0.f;
      dap[s * dass] = from_f32<T>(g * hprev);
      dbp[s * dbss] = from_f32<T>(g);
      carry = to_f32(ap[s * ass]) * g;
    }
  }
}

template <typename T>
int launch_bwd(const void* a, const void* h, const void* dh, void* da,
               void* db, int B, int S, int W, int seg, const long long* st,
               cudaStream_t stream) {
  const int n_seg = (S + seg - 1) / seg;
  if (seg < 1 || n_seg > kMaxSeg) return -1;
  const dim3 grid((W + kCh - 1) / kCh, B), block(kCh, n_seg);
  const T* ap = static_cast<const T*>(a);
  const T* hp = static_cast<const T*>(h);
  const T* gp = static_cast<const T*>(dh);
  T* dap = static_cast<T*>(da);
  T* dbp = static_cast<T*>(db);
  if (seg <= kR)
    rglru_bwd_kernel<T, true><<<grid, block, 0, stream>>>(
        ap, hp, gp, dap, dbp, S, W, seg, st[0], st[1], st[2], st[3],
        st[4], st[5], st[6], st[7], st[8], st[9]);
  else
    rglru_bwd_kernel<T, false><<<grid, block, 0, stream>>>(
        ap, hp, gp, dap, dbp, S, W, seg, st[0], st[1], st[2], st[3],
        st[4], st[5], st[6], st[7], st[8], st[9]);
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

// The backward of rglru_scan_fwd: from a, the forward's output h and
// dh = dL/dh (all (B, S, W), one dtype), da and db.  seg as for the
// forward.  Strides are in elements: the (batch, seq) strides of a, h,
// dh, da, db in that order.  Returns cudaGetLastError() after the
// launch, or -1 for an unsupported dtype or segment length.
extern "C" int rglru_scan_bwd(int dtype, const void* a, const void* h,
                              const void* dh, void* da, void* db, int B,
                              int S, int W, int seg, long long asb,
                              long long ass, long long hsb, long long hss,
                              long long gsb, long long gss, long long dasb,
                              long long dass, long long dbsb, long long dbss,
                              void* stream) {
  const long long st[10] = {asb, ass, hsb, hss, gsb, gss, dasb, dass, dbsb, dbss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(a, h, dh, da, db, B, S, W, seg, st, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(a, h, dh, da, db, B, S, W, seg, st, s);
  return -1;
}
