// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t h_{t-1} + b_t
// per channel, over (B, S, W), with an fp32 carry.
//
// Replaces the Pallas TPU kernel `_rglru_kernel`
// (src/repro/kernels/rglru_scan.py).  That kernel laid the channels on
// the 128 lanes, cut S into power-of-two blocks of 256 walked by a
// sequential grid axis with the carry in VMEM, and ran a log-depth
// doubling scan inside each block, because a TPU core does vector work
// on whole (8, 128) tiles.  A GPU has a thread per channel instead: here
// each thread owns one (batch, channel) and walks S in order with the
// carry in a register, so the work is S multiply-adds per channel with
// no doubling rounds, and any S is taken.  Neighbouring threads own
// neighbouring channels, so every step's loads and stores are coalesced
// across the warp.
//
// What bounds it: bytes.  a and b are read once and h written once, and
// there are two flops per element.  The loop over S is unrolled so that
// several steps' loads are in flight at once; the carry chain itself is
// one FMA per step.  With B W threads in all (10,240 at the server's
// shape) the card is latency bound rather than bandwidth bound; cutting
// S across blocks with a second pass is later work.
//
// Layout: a, b and h (B, S, W), addressed through their (batch, seq)
// strides with W contiguous; h is written in the dtype of a.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const T* __restrict__ a, const T* __restrict__ b,
             T* __restrict__ h, int S, int W, long long asb, long long ass,
             long long bsb, long long bss, long long hsb, long long hss) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const long long bi = blockIdx.y;
  const T* ap = a + bi * asb + w;
  const T* bp = b + bi * bsb + w;
  T* hp = h + bi * hsb + w;
  float carry = 0.f;
#pragma unroll 8
  for (int s = 0; s < S; ++s) {
    carry = fmaf(to_f32(ap[s * ass]), carry, to_f32(bp[s * bss]));
    hp[s * hss] = from_f32<T>(carry);
  }
}

template <typename T>
int launch(const void* a, const void* b, void* h, int B, int S, int W,
           const long long* st, cudaStream_t stream) {
  dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      S, W, st[0], st[1], st[2], st[3], st[4], st[5]);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a, b and h share it).  Strides are in
// elements: the (batch, seq) strides of a, then b, then h.  Returns
// cudaGetLastError() after the launch, or -1 for an unsupported dtype.
extern "C" int rglru_scan_fwd(int dtype, const void* a, const void* b,
                              void* h, int B, int S, int W,
                              long long asb, long long ass, long long bsb,
                              long long bss, long long hsb, long long hss,
                              void* stream) {
  const long long st[6] = {asb, ass, bsb, bss, hsb, hss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, h, B, S, W, st, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, h, B, S, W, st, s);
  return -1;
}
