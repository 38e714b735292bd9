// AdamW for Hopper (sm_90a): one multi-tensor pass over every leaf's p,
// g, m and v, after a multi-tensor global norm of the gradients.
//
// Replaces no TPU kernel: the reference steps AdamW with jnp under jit
// (src/repro/training/optimizer.py `adamw_update`), where XLA fuses each
// leaf's arithmetic into one loop.  The port's plain step
// (kernels/ref.py `adamw_ref`) runs it leaf by leaf as about 20 eager
// launches a leaf, each a pass over the leaf, and a square and a sum a
// leaf for the global norm: some 54 passes over the parameters where 8
// would do, and thousands of launches a step that the host paces.
//
// What bounds it: bytes.  Every parameter's p, m and v are read and
// written once and its g read twice (once for the norm, once for the
// update): 4 esize + 16 bytes a parameter, 32 in fp32, 49.4 GB for
// Qwen2-1.5B's leaves, 14.75 ms at 3.35 TB/s.  The arithmetic, ~20 fp32
// operations a parameter, is far below the CUDA cores' rate.  So:
// - The leaves are cut into chunks of at most CHUNK elements that never
//   cross a leaf (the wrapper's table, built once a parameter set).  A
//   block takes one chunk; a launch covers every chunk of up to
//   kMaxLeaves leaves.  Each leaf's p, m and v pointers, its dtypes and
//   its decay flag live in a device table; the gradients, new tensors
//   each step, come as pointers in the kernel's parameter space
//   (`__grid_constant__`, indexed in place).
// - adamw_norm_kernel: each block sums g² over its chunk in fp32 in a
//   fixed order and writes one partial; adamw_finish_kernel (one block)
//   sums the partials in a fixed order and writes ‖g‖ and the clip scale
//   to device memory.  No float atomics and no host sync: two runs on
//   the same gradients give the same bits.
// - adamw_step_kernel: each thread takes four neighbouring elements at a
//   time (16-byte loads of fp32, 8 of bf16) where p, g, m and v are all
//   aligned, element by element where not and for the tail.  It reads
//   the clip scale, the bias corrections and the learning rate from
//   device memory, so nothing waits on the host.
// The update is the plain step's arithmetic op for op, each operation
// rounded on its own (__f*_rn: no FMA contraction), with the constants
// rounded to fp32 as PyTorch rounds a Python scalar: at equal clip scale
// p, m and v come out bit for bit those of the plain step on the card.
// Only the norm sums in another order.
//
// Templates: p and g each fp32 or bf16 (a bf16 p rounds back to nearest
// even, as the plain step's `copy_` does); m and v fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;         // threads of a norm or step block
constexpr int kFinishThreads = 1024;  // threads of the finishing block
constexpr int kMaxLeaves = 448;       // gradients a launch takes (MAX_LEAVES)

enum : int { kDecay = 1, kPBf16 = 2, kGBf16 = 4 };  // Leaf::flags

struct Leaf {  // 32 bytes: adamw.py's LEAF records
  void* p;
  float* m;
  float* v;
  int flags;
  int pad;
};
struct Chunk {  // 16 bytes: adamw.py's CHUNK records
  long long off;
  int leaf;
  int len;
};
struct Grads {  // a launch's gradients, leaf0 .. leaf0 + n - 1
  const void* g[kMaxLeaves];
};
struct Hyper {  // the constants, rounded to fp32 by the wrapper
  float b1, c1, b2, c2, eps, wd;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Four neighbouring elements as one load or store.
template <typename T> struct Vec4;
template <> struct Vec4<float> {
  static __device__ __forceinline__ void load(const float* p, float (&x)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&x)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};
__device__ __forceinline__ float bf_lo(unsigned w) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(w & 0xffffu)));
}
__device__ __forceinline__ float bf_hi(unsigned w) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(w >> 16)));
}
__device__ __forceinline__ unsigned bf_pair(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
template <> struct Vec4<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&x)[4]) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    x[0] = bf_lo(t.x); x[1] = bf_hi(t.x); x[2] = bf_lo(t.y); x[3] = bf_hi(t.y);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&x)[4]) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(bf_pair(x[0], x[1]), bf_pair(x[2], x[3]));
  }
};

__device__ __forceinline__ bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// The sum of x over the block, in one fixed order; valid in thread 0.
__device__ __forceinline__ float block_sum(float x, float* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < (int)(blockDim.x >> 5) ? sh[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, o));
  }
  return x;
}

// ---------------------------------------------------------------------
// The global norm: a partial a chunk, then one block over the partials.
// ---------------------------------------------------------------------
__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

template <typename G>
__device__ float chunk_sumsq(const G* __restrict__ g, int len) {
  float acc = 0.f;
  int start = 0;
  if (aligned(g, 4 * sizeof(G))) {
    const int n4 = len >> 2;
#pragma unroll 4
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      float x[4];
      Vec4<G>::load(g + 4LL * i, x);
      acc = __fadd_rn(acc, sq(x[0]));
      acc = __fadd_rn(acc, sq(x[1]));
      acc = __fadd_rn(acc, sq(x[2]));
      acc = __fadd_rn(acc, sq(x[3]));
    }
    start = 4 * n4;
  }
  for (int i = start + threadIdx.x; i < len; i += kThreads)
    acc = __fadd_rn(acc, sq(to_f32(g[i])));
  return acc;
}

// grid: one block a chunk of chunks[chunk0 ..]; writes partials[chunk].
__global__ void __launch_bounds__(kThreads)
adamw_norm_kernel(const Leaf* __restrict__ leaves,
                  const Chunk* __restrict__ chunks, int chunk0, int leaf0,
                  const __grid_constant__ Grads grads,
                  float* __restrict__ partials) {
  __shared__ float sh[32];
  const int ci = chunk0 + blockIdx.x;
  const Chunk c = chunks[ci];
  const void* g = grads.g[c.leaf - leaf0];
  float acc;
  if (leaves[c.leaf].flags & kGBf16)
    acc = chunk_sumsq(static_cast<const __nv_bfloat16*>(g) + c.off, c.len);
  else
    acc = chunk_sumsq(static_cast<const float*>(g) + c.off, c.len);
  acc = block_sum(acc, sh);
  if (threadIdx.x == 0) partials[ci] = acc;
}

// One block: ‖g‖ = √(Σ partials) and the clip scale
// min(1, clip / (‖g‖ + tiny)) (1 without clipping) into out[0], out[1].
__global__ void __launch_bounds__(kFinishThreads)
adamw_finish_kernel(const float* __restrict__ partials, int n, float clip,
                    float tiny, float* __restrict__ out) {
  __shared__ float sh[32];
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += kFinishThreads)
    acc = __fadd_rn(acc, partials[i]);
  acc = block_sum(acc, sh);
  if (threadIdx.x == 0) {
    const float gnorm = __fsqrt_rn(acc);
    float scale = 1.f;
    if (clip > 0.f) {
      scale = __fdiv_rn(clip, __fadd_rn(gnorm, tiny));
      if (scale > 1.f) scale = 1.f;  // a NaN stays NaN, as clamp_max
    }
    out[0] = gnorm;
    out[1] = scale;
  }
}

// ---------------------------------------------------------------------
// The update
// ---------------------------------------------------------------------
struct Scalars {
  float scale, bc1, bc2, lr;
};

// kernels/ref.py `adam_ref`, one element: g·scale; m·b1 + (1−b1)·g;
// v·b2 + ((1−b2)·g)·g; (m / bc1) / (√(v / bc2) + eps) [+ wd·p]; p − lr·δ.
__device__ __forceinline__ void adam(float& p, float g, float& m, float& v,
                                     bool decay, const Scalars& s,
                                     const Hyper& h) {
  g = __fmul_rn(g, s.scale);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(h.c1, g));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(h.c2, g), g));
  float d = __fdiv_rn(__fdiv_rn(m, s.bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), h.eps));
  if (decay) d = __fadd_rn(d, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, d));
}

template <typename P, typename G>
__device__ void chunk_step(P* __restrict__ p, const G* __restrict__ g,
                           float* __restrict__ m, float* __restrict__ v,
                           int len, bool decay, const Scalars& s,
                           const Hyper& h) {
  int start = 0;
  if (aligned(p, 4 * sizeof(P)) && aligned(g, 4 * sizeof(G)) &&
      aligned(m, 16) && aligned(v, 16)) {
    const int n4 = len >> 2;
#pragma unroll 2
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      const long long e = 4LL * i;
      float pp[4], gg[4], mm[4], vv[4];
      Vec4<P>::load(p + e, pp);
      Vec4<G>::load(g + e, gg);
      Vec4<float>::load(m + e, mm);
      Vec4<float>::load(v + e, vv);
#pragma unroll
      for (int k = 0; k < 4; ++k) adam(pp[k], gg[k], mm[k], vv[k], decay, s, h);
      Vec4<P>::store(p + e, pp);
      Vec4<float>::store(m + e, mm);
      Vec4<float>::store(v + e, vv);
    }
    start = 4 * n4;
  }
  for (int i = start + threadIdx.x; i < len; i += kThreads) {
    float pf = to_f32(p[i]), mf = m[i], vf = v[i];
    adam(pf, to_f32(g[i]), mf, vf, decay, s, h);
    p[i] = from_f32<P>(pf);
    m[i] = mf;
    v[i] = vf;
  }
}

template <typename P>
__device__ __forceinline__ void chunk_step_g(const Leaf& L, const void* g,
                                             const Chunk& c, const Scalars& s,
                                             const Hyper& h) {
  P* p = static_cast<P*>(L.p) + c.off;
  float* m = L.m + c.off;
  float* v = L.v + c.off;
  const bool decay = L.flags & kDecay;
  if (L.flags & kGBf16)
    chunk_step(p, static_cast<const __nv_bfloat16*>(g) + c.off, m, v, c.len,
               decay, s, h);
  else
    chunk_step(p, static_cast<const float*>(g) + c.off, m, v, c.len, decay,
               s, h);
}

// grid: one block a chunk of chunks[chunk0 ..]; scal: the finishing
// block's out (clip scale at [1]); bc1, bc2, lr: 0-dim fp32 tensors.
__global__ void __launch_bounds__(kThreads)
adamw_step_kernel(const Leaf* __restrict__ leaves,
                  const Chunk* __restrict__ chunks, int chunk0, int leaf0,
                  const __grid_constant__ Grads grads,
                  const float* __restrict__ scal,
                  const float* __restrict__ bc1,
                  const float* __restrict__ bc2,
                  const float* __restrict__ lr, Hyper h) {
  const Chunk c = chunks[chunk0 + blockIdx.x];
  const Leaf L = leaves[c.leaf];
  const void* g = grads.g[c.leaf - leaf0];
  const Scalars s{scal[1], *bc1, *bc2, *lr};
  if (L.flags & kPBf16)
    chunk_step_g<__nv_bfloat16>(L, g, c, s, h);
  else
    chunk_step_g<float>(L, g, c, s, h);
}

bool fill(Grads& gr, const long long* gptrs, int n_g) {
  if (n_g < 1 || n_g > kMaxLeaves) return false;
  memset(&gr, 0, sizeof(gr));
  for (int i = 0; i < n_g; ++i)
    gr.g[i] = reinterpret_cast<const void*>(gptrs[i]);
  return true;
}

}  // namespace

// The C entry points.  leaves / chunks: the wrapper's device tables;
// the launch covers chunks chunk0 .. chunk0 + n_chunks − 1, whose leaves
// lie in leaf0 .. leaf0 + n_g − 1, with gptrs those leaves' gradients.
// Each returns cudaGetLastError() after its launch, or -1 when it
// refuses its arguments (nothing launched).
extern "C" int adamw_norm(const void* leaves, const void* chunks, int chunk0,
                          int n_chunks, int leaf0, const long long* gptrs,
                          int n_g, float* partials, cudaStream_t stream) {
  Grads gr;
  if (n_chunks < 1 || !fill(gr, gptrs, n_g)) return -1;
  adamw_norm_kernel<<<n_chunks, kThreads, 0, stream>>>(
      static_cast<const Leaf*>(leaves), static_cast<const Chunk*>(chunks),
      chunk0, leaf0, gr, partials);
  return (int)cudaGetLastError();
}

extern "C" int adamw_finish(const float* partials, int n, float clip,
                            float tiny, float* out, cudaStream_t stream) {
  if (n < 0) return -1;
  adamw_finish_kernel<<<1, kFinishThreads, 0, stream>>>(partials, n, clip,
                                                         tiny, out);
  return (int)cudaGetLastError();
}

extern "C" int adamw_step(const void* leaves, const void* chunks, int chunk0,
                          int n_chunks, int leaf0, const long long* gptrs,
                          int n_g, const float* scal, const float* bc1,
                          const float* bc2, const float* lr, float b1,
                          float c1, float b2, float c2, float eps, float wd,
                          cudaStream_t stream) {
  Grads gr;
  if (n_chunks < 1 || !fill(gr, gptrs, n_g)) return -1;
  adamw_step_kernel<<<n_chunks, kThreads, 0, stream>>>(
      static_cast<const Leaf*>(leaves), static_cast<const Chunk*>(chunks),
      chunk0, leaf0, gr, scal, bc1, bc2, lr, Hyper{b1, c1, b2, c2, eps, wd});
  return (int)cudaGetLastError();
}

// The constants the wrapper mirrors, for a check on the card.
extern "C" int adamw_limits(int* out) {
  out[0] = kMaxLeaves;
  out[1] = kThreads;
  out[2] = (int)sizeof(Leaf);
  out[3] = (int)sizeof(Chunk);
  return 0;
}
