// The SSD scan's fp32 training path: what its forward (ssd_scan.cu) and
// its backward (ssd_scan_bwd.cu) share.  The two are built as two
// libraries, one nvcc each, in parallel; each includes this header and
// gets its own copy of these helpers (all in an anonymous namespace):
// the fp32 tiles, the 3xTF32 warp products, the staging loads, the
// training path's arguments and shared memory, the scores of a tile
// pair, and the host helpers that launch a pass and check its grid.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float clip_exp(float v) {
  return expf(fminf(fmaxf(v, -60.f), 0.f));
}

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------
// The fp32 training path: K4's fp32 body and the backward (K4-bwd), on
// the tensor cores by 3xTF32, chunk-parallel.
//
// Every product runs on `mma.sync.m16n8k8.tf32` with fp32 operands split
// as they are read from shared memory into their TF32 rounding and the
// remainder (`split_tf32`): a product is small.big + big.small +
// big.big, about fp32's accuracy at three TF32 products (the scheme of
// csrc/flash_attention.cu's fp32 backward; copied here, since each
// library is built from its own source).  The tensor core truncates as
// it adds, so each 32-deep slice of a product is summed there and added
// to the running sum in fp32.  bf16 inputs of the backward are widened
// to fp32 as they are staged and go through the same products.  Every
// tile is staged in shared memory in fp32, zero-filled past the chunk
// and past N and hd (padded to 32), and every warp computes 32 x 32
// output tiles (`warp_mma`).
//
// Per chunk of one head (cum, total, L_ij = exp(cum_i - cum_j) and
// w_j = exp(total - cum_j) dt_j as in the bf16 body's note):
//   forward   y_i    = exp(cum_i) C_i . S_in + sum_{j<=i} sc_ij L_ij dt_j x_j
//             S_out  = exp(total) S_in + S_loc,  S_loc = sum_j w_j x_j (x) B_j
//   backward  G = dS_out; dS_in = exp(total) G + sum_i exp(cum_i) dy_i (x) C_i
//             dx_j   = w_j G B_j + sum_{i>=j} sc_ij L_ij dt_j dy_i
//             dsc_ij = (dy_i . x_j) L_ij dt_j, summed over the group's heads
//             dC_i   = sum_h exp(cum_i) dy_i S_in + sum_j dsc_ij B_j
//             dB_j   = sum_h w_j x_j G + sum_i dsc_ij C_i
// The scores sc = C B^T do not depend on the head: they are computed
// once per (batch, group, chunk, 64 x 64 tile pair) into scratch, where
// every head's blocks read them.  So are dC and dB, by linearity: the
// heads' dscores are summed first (`ssd_bwd_ds_kernel`), and the
// heads' inter-chunk terms are one product over (head, hd).  No pass
// writes per-head partials of dB or dC.
//
// Passes.  Forward: scores; each chunk's S_loc over (chunk, head,
// batch); the chain, elementwise over (head, batch, element): S_in of
// chunk c + 1 = exp(total_c) S_in + S_loc, into the chunk-entry states
// (scratch without them) and the final state; the outputs over (64-row
// tile, chunk, head, batch).  Backward: scores; each chunk's cum, its
// chain term sum_i exp(cum_i) dy_i (x) C_i and the inter term's d(cum)
// over (chunk, head, batch); dscores summed over the heads (a split of
// them) with each head's d(cum) row and column sums over (tile pair,
// chunk, batch, group); the chain of dS_out, elementwise; dx over
// (64-row tile, chunk, head, batch); dB and dC over (64-row tile, 64
// columns of N, chunk, batch, group); ddt over (chunk, head, batch);
// dA over the heads.  Every sum runs in a fixed order, each output
// element written by one thread: two calls give the same bits (no
// atomics).  d(cum) is paired for dA as the first version paired it
// (a term +q at row i and -q at row j adds q (cum_i - cum_j) / A).
//
// What bounds it: at mamba2-1.3b's training shape the products, three
// TF32 products each at 495 TFLOP/s; the kernels run well below that
// bound (PERF.md gives the times, on an H100 80GB HBM3 at 700 W), held
// back by the latency of staging tiles between barriers.  The walks
// (tiles j in the out pass, tiles i in dx, heads in dB / dC) copy the
// next step's fp32 tiles by cp.async into a second buffer while the
// tensor cores work on this one; other tiles are staged with every
// load of a thread in flight before any store (`batched`), four
// elements a load where the rows allow.

constexpr int kKC = 4;  // 8-deep k-steps summed on the tensor core

// c (16x8) += a (16x8, tf32) . b (8x8, tf32)
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// x = big + small: big is x rounded to TF32 (its 13 low bits cleared,
// half away from zero), small the exact remainder.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}
// c += a . b by 3xTF32, the small products first
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ab, const uint32_t* as,
                                           uint32_t b0, uint32_t b1, uint32_t s0,
                                           uint32_t s1) {
  mma_tf32(c, as, b0, b1);
  mma_tf32(c, ab, s0, s1);
  mma_tf32(c, ab, b0, b1);
}

__host__ __device__ constexpr int pad32(int v) { return (v + 31) / 32 * 32; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
template <int P>
__host__ __device__ constexpr int pad_hd() { return P < 32 ? 32 : P; }

// A chunk of cs rows as 64-row tiles: nt tiles, cs64 = 64 nt rows, and
// the npairs tile pairs (it, jt), jt <= it, numbered it (it + 1) / 2 + jt.
struct Tiles {
  int nt, cs64, npairs;
};
__host__ __device__ inline Tiles tiles_of(int cs) {
  const int nt = (cs + 63) / 64;
  return Tiles{nt, 64 * nt, nt * (nt + 1) / 2};
}
__host__ __device__ inline int pair_index(int it, int jt) { return it * (it + 1) / 2 + jt; }
__device__ __forceinline__ void pair_tiles(int p, int& it, int& jt) {
  it = 0;
  while (pair_index(it + 1, 0) <= p) ++it;
  jt = p - pair_index(it, 0);
}

// Row and column, in its 32 x 32 warp tile, of element e of fragment
// acc[mi][ni] (c0, c1 at row g, columns 2t, 2t + 1; c2, c3 at row g + 8).
__device__ __forceinline__ int frag_row(int mi, int e) {
  return 16 * mi + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int ni, int e) {
  return 8 * ni + 2 * (threadIdx.x & 3) + (e & 1);
}
__device__ __forceinline__ void zero_tile(float (&acc)[2][4][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

// A warp's 32 x 32 tile: acc += sum_{k < K} a(r, k) b(k, c) by 3xTF32,
// K a multiple of 32; a and b read the fp32 operands from shared memory
// in warp-tile coordinates.
template <class FA, class FB>
__device__ __forceinline__ void warp_mma(float (&acc)[2][4][4], int K, const FA& a,
                                         const FB& b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 8 * kKC) {
    float p[2][4][4];
    zero_tile(p);
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      const int k = k0 + 8 * kk + t;
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        split_tf32(a(16 * mi + g, k), ab[mi][0], as[mi][0]);
        split_tf32(a(16 * mi + g + 8, k), ab[mi][1], as[mi][1]);
        split_tf32(a(16 * mi + g, k + 4), ab[mi][2], as[mi][2]);
        split_tf32(a(16 * mi + g + 8, k + 4), ab[mi][3], as[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        uint32_t b0, b1, s0, s1;
        split_tf32(b(k, 8 * ni + g), b0, s0);
        split_tf32(b(k + 4, 8 * ni + g), b1, s1);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_3xtf32(p[mi][ni], ab[mi], as[mi], b0, b1, s0, s1);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += p[mi][ni][e];
  }
}

// Sum over the 4 lanes of a fragment row (t), and over the 8 lanes of a
// fragment column (g): every lane gets the same bits.
__device__ __forceinline__ float row_sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float col_sum8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct One {
  __device__ float operator()(int) const { return 1.f; }
};

// put(e, get(e)) for e in [0, n) over the block's NT threads, each
// thread issuing the loads of U elements before any of their stores, so
// that they are in flight together (a load followed by a store it may
// alias would otherwise wait for the load's full latency).
template <int NT, int U = 16, class Get, class Put>
__device__ __forceinline__ void batched(int n, const Get& get, const Put& put) {
  for (int e0 = threadIdx.x; e0 < n; e0 += NT * U) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * NT;
      v[u] = e < n ? get(e) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * NT;
      if (e < n) put(e, v[u]);
    }
  }
}

// The same, four floats an element.
template <int NT, int U = 8, class Get, class Put>
__device__ __forceinline__ void batched4(int n, const Get& get, const Put& put) {
  for (int e0 = threadIdx.x; e0 < n; e0 += NT * U) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * NT;
      v[u] = e < n ? get(e) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * NT;
      if (e < n) put(e, v[u]);
    }
  }
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// Four bf16 (8 bytes) as fp32.
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void st4(float* d, float4 v, float f) {
  d[0] = v.x * f;
  d[1] = v.y * f;
  d[2] = v.z * f;
  d[3] = v.w * f;
}

// rows x w elements into dst (pitch ld), as fp32: (r, k) =
// src[r st + k] scale(r) for r < nr and k < nk, else 0.  Rows whose
// four-element groups are aligned (16 bytes of fp32, 8 of bf16) are read
// four elements a load.
template <int NT, typename T, class F>
__device__ __forceinline__ void stage(float* dst, int ld, int rows, int w, const T* src,
                                      long long st, int nr, int nk, const F& scale) {
  if (((w | nk | (int)(st & 3)) & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(src) & (4 * sizeof(T) - 1)) == 0) {
    const int w4 = w >> 2;
    batched4<NT>(
        rows * w4,
        [&](int e) {
          const int r = e / w4, k = 4 * (e - r * w4);
          return r < nr && k < nk ? ld4(src + r * st + k) : make_float4(0.f, 0.f, 0.f, 0.f);
        },
        [&](int e, float4 v) {
          const int r = e / w4, k = 4 * (e - r * w4);
          st4(dst + r * ld + k, v, r < nr ? scale(r) : 0.f);
        });
    return;
  }
  batched<NT>(
      rows * w,
      [&](int e) {
        const int r = e / w, k = e - r * w;
        return r < nr && k < nk ? to_f32(src[r * st + k]) : 0.f;
      },
      [&](int e, float v) {
        const int r = e / w, k = e - r * w;
        dst[r * ld + k] = r < nr ? v * scale(r) : 0.f;
      });
}

// sDt = dt over the chunk [s0, s0 + len) and sCum its inclusive running
// sum of dt A.  Ends synchronised.
template <int NT>
__device__ void chunk_cum(const float* db, long long st, int s0, int len, float A,
                          float* sDt, float* sCum) {
  const int t = threadIdx.x;
  for (int i = t; i < len; i += NT) sDt[i] = db[(long long)(s0 + i) * st];
  __syncthreads();
  if (t < 32) {  // each lane a run, then the warp
    const int per = (len + 31) / 32;
    const int lo = t * per, hi = min(lo + per, len);
    float run = 0.f;
    for (int i = lo; i < hi; ++i) {
      run += sDt[i] * A;
      sCum[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, o);
      if (t >= o) incl += v;
    }
    for (int i = lo; i < hi; ++i) sCum[i] += incl - run;
  }
  __syncthreads();
}

struct TrainArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const void* dy;
  void* y;
  float* state;         // forward: the final state (B, H, hd, N)
  float* states;        // (B, H, nc, hd, N) chunk-entry states
  const float* dstate;  // backward: the final state's gradient, or null
  void* dx;
  float* ddt;  // (B, H, S)
  void* dB;
  void* dC;
  float* dA;
  // scratch (fp32)
  float* sc;   // (B G, nc, cs64, cs64) scores
  float* dS;   // (nsplit, B G, nc, cs64, cs64) dscores, each split's heads
  float* dSo;  // (B, H, nc, hd, N) the chain's local terms, then dS_out
  float* cum;  // (B, H, S)
  float* q;    // (B, H, S) d(cum) of the inter-chunk term
  float* dw;   // (B, H, S) <x_j, G B_j>
  float* tot;  // (B, H, nc)
  float* gs;   // (B, H, nc) <G, S_in>
  float* rr;   // (B, H, nc, npairs, 64) sum_j dt_j R_ij of each tile pair
  float* cr;   // (B, H, nc, npairs, 64) sum_i R_ij
  float* dar;  // (B, H, nc, npairs) sum_ij dt_j R_ij (cum_i - cum_j)
  float* dAp;  // (B, H, nc)
  int B, H, G, S, P, N, cs, nc, nsplit;
  Strides xs, ds, bs, cs_, ys, dys, dxs, dbs, dcs;
};

// Shared memory of the training path's blocks, in floats
// (`kernels/ssd_scan.py` `fwd_plan` and `bwd_plan` mirror them).
struct TrainSmem {
  int scores, fwd_state, fwd_out, local, dx, ds, dbdc, dt;
};
__host__ __device__ inline TrainSmem train_smem(int P, int N, int cs) {
  const int PP = P < 32 ? 32 : P, Np = pad32(N), cs64 = tiles_of(cs).cs64;
  const int ln = Np + 4, lx = PP + 8;
  const int out_u = imax(64 * ln + PP * ln, 2 * 64 * 68 + 2 * 64 * lx);
  const int dx_u = imax(64 * ln + PP * ln + 64 * lx, 2 * 64 * 72 + 2 * 64 * lx);
  TrainSmem s;
  s.scores = 2 * 64 * ln;
  s.fwd_state = PP * ln + 64 * lx + 64 * (Np + 8) + 3 * cs64;
  s.fwd_out = 2 * cs64 + 64 + out_u;
  s.local = 2 * PP * ln + 64 * ln + 64 * lx + (PP / 32) * 64 + 2 * cs64;
  s.dx = 2 * cs64 + (PP / 32) * 64 + 4 + dx_u;
  s.ds = 64 * 68 + 2 * 64 * (PP + 4) + 3 * 64 + 4 * 64 + 4;
  s.dbdc = 128 + imax(2 * 64 * (PP + 4) + 2 * PP * 72, 2 * 64 * 72);
  s.dt = 2 * cs64 + 16;
  return s;
}

// The scores C_i . B_j over N of one tile pair of one (batch, group,
// chunk), for all the group's heads.  Four warps, a 32 x 32 tile each.
template <typename T>
__device__ __forceinline__ void scores_tile(const TrainArgs& a) {
  const int Np = pad32(a.N), ln = Np + 4;
  const Tiles tl = tiles_of(a.cs);
  extern __shared__ float smem[];
  float* sC = smem;          // [64][ln]
  float* sB = sC + 64 * ln;  // [64][ln]
  int it, jt;
  pair_tiles(blockIdx.x, it, jt);
  const int c = blockIdx.y, bg = blockIdx.z, b = bg / a.G, g = bg % a.G;
  const int s0 = c * a.cs, len = min(a.cs, a.S - s0);
  if (64 * it >= len) return;
  const T* Cb = static_cast<const T*>(a.Cm) + b * a.cs_.b + g * a.cs_.h +
                (long long)(s0 + 64 * it) * a.cs_.s;
  const T* Bb = static_cast<const T*>(a.Bm) + b * a.bs.b + g * a.bs.h +
                (long long)(s0 + 64 * jt) * a.bs.s;
  stage<128>(sC, ln, 64, Np, Cb, a.cs_.s, len - 64 * it, a.N, One());
  stage<128>(sB, ln, 64, Np, Bb, a.bs.s, len - 64 * jt, a.N, One());
  __syncthreads();
  const int warp = threadIdx.x >> 5, r0 = 32 * (warp >> 1), c0 = 32 * (warp & 1);
  float acc[2][4][4];
  zero_tile(acc);
  warp_mma(acc, Np, [&](int r, int k) { return sC[(r0 + r) * ln + k]; },
           [&](int k, int cc) { return sB[(c0 + cc) * ln + k]; });
  float* out = a.sc + (((long long)bg * a.nc + c) * tl.cs64 + 64 * it + r0) * tl.cs64 +
               64 * jt + c0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[(long long)frag_row(mi, e) * tl.cs64 + frag_col(ni, e)] = acc[mi][ni][e];
}

// rows x w elements into dst (pitch ld, on 16 bytes) as fp32, zero past
// nr rows and nk columns: fp32 rows on 16 bytes by cp.async (the caller
// commits, waits and synchronises), others staged at once.
template <int NT, typename T>
__device__ __forceinline__ void copy_tile(float* dst, int ld, int rows, int w, const T* src,
                                          long long st, int nr, int nk) {
  if (sizeof(T) != 4 || ((w | nk | (int)(st & 3)) & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(src) & 15) != 0) {
    stage<NT>(dst, ld, rows, w, src, st, nr, nk, One());
    return;
  }
  const int w4 = w >> 2;
  for (int e = threadIdx.x; e < rows * w4; e += NT) {
    const int r = e / w4, k = 4 * (e - r * w4);
    const bool ok = r < nr && k < nk;
    cp_async16(dst + r * ld + k, ok ? src + r * st + k : src, ok);
  }
}

// Raise a kernel's dynamic shared-memory limit to the most a block may
// take (232,448 bytes on the H100; the limit bounds a launch and
// reserves nothing), once per kernel.
constexpr int kSmemOptIn = 232448;
int raise_smem(const void* kern) {
  static const void* done[64];
  static int n = 0;
  for (int i = 0; i < n; ++i)
    if (done[i] == kern) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptIn);
  if (err != cudaSuccess) return (int)err;
  if (n < 64) done[n++] = kern;
  return 0;
}

// One launch of a training-path kernel on grid g[0..2].
template <typename K>
int run(K kern, const int* g, int threads, size_t smem, TrainArgs& a, cudaStream_t s) {
  const int err = raise_smem((const void*)kern);
  if (err != 0) return err;
  void* params[] = {&a};
  const cudaError_t e =
      cudaLaunchKernel((const void*)kern, dim3(g[0], g[1], g[2]), dim3(threads), params, smem, s);
  return e != cudaSuccess ? (int)e : 0;
}

bool grids_cover(const int* grid, const int* want, int n) {
  for (int i = 0; i < n; ++i)
    if (grid[i] != want[i]) return false;
  return true;
}

bool hd_ok(int hd) { return hd == 16 || hd == 32 || hd == 64 || hd == 128; }

// The scratch of the training path, carved in order (`fwd_plan` and
// `bwd_plan` give its size).
struct Carve {
  float* p;
  float* take(long long n) {
    float* r = p;
    p += n;
    return r;
  }
};

Strides strides_at(const long long* st, int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; }

}  // namespace
