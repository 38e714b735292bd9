// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssd_kernel`
// (src/repro/kernels/ssd_scan.py).  That kernel's grid walked the chunks
// of one (batch, head) in order and carried the (hd x N) fp32 state in
// VMEM scratch between grid steps, with a whole chunk's working set in
// VMEM at once.  Blocks of a CUDA grid run in no order, so here one block
// owns one (batch, head) and walks its chunks in a loop, with the state
// in shared memory for the whole walk.  Per chunk of length len (the
// last one may be short):
//
//   cum_i  = sum_{k <= i} dt_k A                      (running log-decay)
//   y_i    = exp(cum_i) C_i . state                   (inter-chunk)
//          + sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j   (intra)
//   state  = exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j
//
// with every exponent clipped to [-60, 0] as the reference clips it.
// Rows past S are never stored: the ragged tail is masked, not padded,
// so any S is taken.  The final state is a second output (the decode
// cache starts from it).
//
// What bounds it on this card: at mamba2-1.3b's serve shape (B 4, H 64,
// G 1, S 128, hd 64, N 128) a call moves about 17 MB and does about
// 2.3 GFLOP: bytes bound (5 us at 3.35 TB/s) if the products run on the
// bf16 tensor cores (2.3 us at 989 TFLOP/s), operations bound seven
// times over (34 us) if they run as fp32 FMAs on CUDA cores, as the
// first port did.  The bf16 body:
// - All four products run on `mma.sync.m16n8k16` (bf16 in, fp32 out):
//   the scores C.B^T; M.X, where M = scores * L * dt is formed on the
//   score fragments and repacked in registers as the A operand (the
//   P -> P.V step of csrc/flash_attention.cu); the inter-chunk
//   C.state^T, with the fp32 state split into bf16 hi + lo parts read
//   straight from shared memory into B fragments; and the state update
//   (x w)^T.B, where w = exp(total - cum) dt scales the A fragments in
//   registers.
// - A block of four warps walks a chunk in passes of 128 rows i (64 at
//   hd 128): each warp holds the C rows of two 16-row m-tiles as A
//   fragments in registers for the whole pass, so every B and x
//   fragment it loads serves both.  The pass streams 64-row (B, x)
//   tiles j through a two-tile ring, the next tile in flight while this
//   one is computed, and skips the 16-column steps right of the warp's
//   last row.  The last pass of a chunk streams all of its tiles and
//   adds each tile's share of the state update as it goes, so every
//   tile is copied once per pass; at S <= 128 a call is one pass over
//   two tiles.
// - C, B and x arrive as bf16 rows by 16-byte `cp.async` from the
//   model's strided views; C is staged in the ring before the pass's
//   tiles.  Rows past len (and the columns that pad N to 16) are
//   zero-filled by the copy.  Rows are padded by 16 bytes so that the
//   eight rows an `ldmatrix` reads fall in eight bank groups.  y is
//   staged in the ring too and stored as whole rows of 16-byte vectors:
//   storing the fragments straight to the (B, S, H, hd) output wrote
//   half sectors and cost more than the products.
// - Tiles stay bf16 and the state fp32 in shared memory: 89.6 KB a
//   block at the serve shape, so two blocks share an SM and the 256
//   blocks run in one wave.
// - The inter-chunk term is not computed while the state is zero (the
//   first chunk, which at S <= chunk is the whole call).
// - One block owns one head.  Packing two heads of a group into a block,
//   so that the scores are computed once for both, was slower at the
//   serve shape: each head keeps its own fp32 state, so only one such
//   block fits on an SM (PERF.md).
// The fp32 body (training) is the training path below: four passes,
// chunk-parallel, every product on the tensor cores as 3xTF32, which
// holds 2e-5 where one TF32 product would not.
//
// Layout: x (B, H, S, hd), dt (B, H, S) fp32, B_ and C_ (B, G, S, N) and
// y (B, H, S, hd) are addressed through their (batch, head, seq) strides
// with the last dimension contiguous, so the model passes transposed
// views of its (B, S, H, hd) and (B, S, G, N) activations and nothing is
// copied; for bf16 every row starts on 16 bytes and N is a multiple of 8
// and at most 128 (the wrapper checks).  Head h reads group h / (H / G).  A (H,) fp32;
// the final state (B, H, hd, N) fp32 contiguous.
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

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  void* y;
  float* state;
  float* states;  // (B, H, n_chunks, hd, N) chunk-entry states, or null
  int H, G, S, N, cs;
  Strides xs, ds, bs, cs_, ys;
};

// The (P x N) state held in shared memory (row pitch ld) into the
// contiguous out.
__device__ __forceinline__ void store_state(float* out, const float* s, int ld, int P,
                                            int N, int tid, int nthreads) {
  for (int idx = tid; idx < P * N; idx += nthreads) out[idx] = s[(idx / N) * ld + idx % N];
}

// Where chunk s0 / cs of block (b, h) writes its entry state.
__device__ __forceinline__ float* entry_state(const Args& a, int b, int h, int s0, int P) {
  const int nc = (a.S + a.cs - 1) / a.cs;
  return a.states + (((long long)b * a.H + h) * nc + s0 / a.cs) * P * a.N;
}

// ---------------------------------------------------------------------
// bf16 body: tensor cores.

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
// m-tiles of 16 rows a warp: two, so that each B and x fragment serves
// both; one at hd 128, where two would not fit the registers.
template <int P>
__host__ __device__ constexpr int tc_mtiles() { return P <= 64 ? 2 : 1; }
template <int P>  // rows i of a pass
__host__ __device__ constexpr int tc_rows() { return kTcWarps * 16 * tc_mtiles<P>(); }
constexpr int kTj = 64;    // rows j of a (B, x) tile
constexpr int kMaxNK = 8;  // mma k-steps over N held in registers (N <= 128)

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
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
// c (16x8, fp32) += a (16x16, bf16) . b (16x8, bf16).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}
// Two bf16 values scaled by (s0, s1), rounded back to bf16.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float s0, float s1) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack_bf16(f.x * s0, f.y * s1);
}
// The fp32 pair (v.x, v.y) as bf16 hi and lo parts: hi + lo = v to
// about 2^-16 of |v|.
__device__ __forceinline__ void split_bf16(float2 v, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v.x - hf.x, v.y - hf.y);
}

// Shared-memory layout of the bf16 body, in elements: N padded to 16
// (the mma depth); bf16 rows of B and C (ldn) and of x (ldx) padded by
// 16 bytes; fp32 state rows (lds) padded by 8 floats, so the fragment
// reads of 16 lanes (4 rows x 4 pairs) hit 32 banks; the chunk's dt,
// cum and w over csp = cs rounded up to a pass.
struct TcLayout {
  int npad, ldn, ldx, lds, csp;
};
template <int P>
__host__ __device__ inline TcLayout tc_layout(int N, int cs) {
  constexpr int R = tc_rows<P>();
  const int npad = (N + 15) / 16 * 16;
  return TcLayout{npad, npad + 8, P + 8, npad + 8, (cs + R - 1) / R * R};
}
// Bytes of shared memory of one block (`kernels/ssd_scan.py`
// `smem_bytes` mirrors it): the fp32 state, dt / cum / w, and a ring
// of two (B, x) tiles, where each pass also stages its C and y rows.
template <int P>
size_t tc_smem_bytes(int N, int cs) {
  const TcLayout L = tc_layout<P>(N, cs);
  return 4 * ((size_t)P * L.lds + 3 * L.csp) + 2 * (size_t)2 * kTj * (L.ldn + L.ldx);
}

// Rows of one chunk, copied by the block's threads.
struct ChunkRows {
  int s0, len, tid;
  // n rows from chunk row r_lo into dst (pitch ld elements): nv 16-byte
  // vectors of data and nvp in all a row; rows past len and vectors past
  // nv are zero-filled.
  __device__ __forceinline__ void copy(__nv_bfloat16* dst, int ld,
                                       const __nv_bfloat16* src, long long st,
                                       int r_lo, int n, int nv, int nvp) const {
    for (int e = tid; e < n * nvp; e += kTcThreads) {
      const int r = e / nvp, v = e % nvp;
      const bool ok = r_lo + r < len && v < nv;
      cp_async16(dst + r * ld + v * 8,
                 src + (ok ? (long long)(s0 + r_lo + r) * st + v * 8 : 0), ok);
    }
  }
};

// The B and x rows of j-tile t into ring slot t % 2, as one group.
template <int P>
__device__ __forceinline__ void load_tile(const ChunkRows& rows, __nv_bfloat16* ring,
                                          const TcLayout& L, int NV,
                                          const __nv_bfloat16* Bb, long long bst,
                                          const __nv_bfloat16* xb, long long xst, int t) {
  __nv_bfloat16* dst = ring + (t & 1) * kTj * (L.ldn + L.ldx);
  rows.copy(dst, L.ldn, Bb, bst, t * kTj, kTj, NV, L.npad / 8);
  rows.copy(dst + kTj * L.ldn, L.ldx, xb, xst, t * kTj, kTj, P / 8, P / 8);
  cp_async_commit();
}

// One block: one (batch, head), four warps.
template <int P>
__global__ void __launch_bounds__(kTcThreads) ssd_bf16_kernel(Args a) {
  using bf16 = __nv_bfloat16;
  constexpr int PT = P / 8;   // y n-tiles
  constexpr int MT = P / 16;  // state row tiles
  constexpr int MI = tc_mtiles<P>();
  constexpr int kRows = tc_rows<P>();
  const int N = a.N, cs = a.cs;
  const TcLayout L = tc_layout<P>(N, cs);
  const int NV = N / 8, NVP = L.npad / 8;  // 16-byte vectors a row
  const int nk = L.npad / 16;              // mma k-steps over N
  const int NG = (L.npad + 63) / 64;       // 64-column slabs of the state
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sState = reinterpret_cast<float*>(smem_raw);  // [P][lds]
  float* sCum = sState + P * L.lds;                    // [csp]
  float* sDt = sCum + L.csp;                           // [csp]
  float* sW = sDt + L.csp;                             // [csp]
  bf16* sRing = reinterpret_cast<bf16*>(sW + L.csp);   // [2][kTj][ldn + ldx]
  bf16* sC = sRing;  // [kRows][ldn]: a pass's C rows, staged in the ring
  bf16* sY = sRing;  // [kRows][ldx]: a pass's y rows, staged in the ring
  const int slot_elems = kTj * (L.ldn + L.ldx);  // one (B, x) tile pair

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = h / (a.H / a.G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;  // fragment row, column pair
  const int lr = lane & 7, mb0 = (lane >> 3) & 1, mb1 = lane >> 4;
  const float A = a.A[h];
  const bf16* xb = static_cast<const bf16*>(a.x) + b * a.xs.b + h * a.xs.h;
  const float* db = a.dt + b * a.ds.b + h * a.ds.h;
  const bf16* Bb = static_cast<const bf16*>(a.Bm) + b * a.bs.b + grp * a.bs.h;
  const bf16* Cb = static_cast<const bf16*>(a.Cm) + b * a.cs_.b + grp * a.cs_.h;
  bf16* yb = static_cast<bf16*>(a.y) + b * a.ys.b + h * a.ys.h;

  for (int i = tid; i < P * L.lds; i += kTcThreads) sState[i] = 0.f;

  for (int s0 = 0; s0 < a.S; s0 += cs) {
    const int len = min(cs, a.S - s0);
    const int n_pass = (len + kRows - 1) / kRows;
    const ChunkRows rows{s0, len, tid};

    __syncthreads();  // the previous chunk is done with every buffer
    if (a.states)
      store_state(entry_state(a, b, h, s0, P), sState, L.lds, P, N, tid, kTcThreads);
    rows.copy(sC, L.ldn, Cb, a.cs_.s, 0, kRows, NV, NVP);
    cp_async_commit();
    for (int r = tid; r < L.csp; r += kTcThreads)
      sDt[r] = r < len ? db[(long long)(s0 + r) * a.ds.s] : 0.f;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of dt * A: each lane a run, then the warp
      const int per = L.csp / 32;
      const int lo = lane * per;
      float run = 0.f;
      for (int i = lo; i < lo + per; ++i) {
        run += sDt[i] * A;
        sCum[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      for (int i = lo; i < lo + per; ++i) sCum[i] += incl - run;
    }
    __syncthreads();
    const float total = sCum[len - 1];
    for (int r = tid; r < L.csp; r += kTcThreads)
      sW[r] = r < len ? clip_exp(total - sCum[r]) * sDt[r] : 0.f;

    for (int q = 0; q < n_pass; ++q) {
      // The pass's rows: warp w owns MI m-tiles of 16 rows from
      // i0 + 16 MI w, their C rows as A fragments in registers.
      const int i0 = q * kRows;
      const int wr = i0 + warp * 16 * MI;  // the warp's first row
      const bool live = wr < len;
      const int last_row = min(wr + 16 * MI - 1, len - 1);
      const bool last = q == n_pass - 1;
      // j-tiles: those left of the pass's rows, or all of the chunk in
      // the last pass, which also updates the state
      const int n_tiles = last ? (len + kTj - 1) / kTj : (i0 + kRows) / kTj;
      if (q > 0) {
        __syncthreads();  // the previous pass is done with the ring
        rows.copy(sC, L.ldn, Cb, a.cs_.s, i0, kRows, NV, NVP);
        cp_async_commit();
      }
      cp_async_wait<0>();
      __syncthreads();
      uint32_t cf[MI][kMaxNK][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int k = 0; k < kMaxNK; ++k)
          if (k < nk)
            ldmatrix_x4(cf[mi][k], sC + (wr - i0 + mi * 16 + lr + mb0 * 8) * L.ldn +
                                       k * 16 + mb1 * 8);
      __syncthreads();  // every warp holds its C: the ring is free
      load_tile<P>(rows, sRing, L, NV, Bb, a.bs.s, xb, a.xs.s, 0);
      if (n_tiles > 1) load_tile<P>(rows, sRing, L, NV, Bb, a.bs.s, xb, a.xs.s, 1);

      float ci[MI][2];  // cum at rows (mi, g) and (mi, g + 8)
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        ci[mi][0] = sCum[wr + mi * 16 + g];
        ci[mi][1] = sCum[wr + mi * 16 + g + 8];
      }
      float acc[MI][PT][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int n = 0; n < PT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;
      if (live && s0 > 0) {
        // inter-chunk: exp(cum_i) C_i . state, state as bf16 hi + lo
        const float* st = sState + g * L.lds + c2;
#pragma unroll
        for (int k = 0; k < kMaxNK; ++k) {
          if (k >= nk) break;
#pragma unroll
          for (int n = 0; n < PT; ++n) {
            uint32_t hi0, lo0, hi1, lo1;
            split_bf16(*reinterpret_cast<const float2*>(st + n * 8 * L.lds + k * 16), hi0, lo0);
            split_bf16(*reinterpret_cast<const float2*>(st + n * 8 * L.lds + k * 16 + 8), hi1, lo1);
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
              mma_bf16(acc[mi][n], cf[mi][k], hi0, hi1);
              mma_bf16(acc[mi][n], cf[mi][k], lo0, lo1);
            }
          }
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const float e0 = clip_exp(ci[mi][0]), e1 = clip_exp(ci[mi][1]);
#pragma unroll
          for (int n = 0; n < PT; ++n) {
            acc[mi][n][0] *= e0;
            acc[mi][n][1] *= e0;
            acc[mi][n][2] *= e1;
            acc[mi][n][3] *= e1;
          }
        }
      }

      for (int t = 0; t < n_tiles; ++t) {
        // tile t has landed for every thread, and every warp is done
        // with tile t - 1 (and with its inter-chunk reads of the state)
        if (t == 0 && n_tiles > 1)
          cp_async_wait<1>();
        else
          cp_async_wait<0>();
        __syncthreads();
        if (t >= 1 && t + 1 < n_tiles)
          load_tile<P>(rows, sRing, L, NV, Bb, a.bs.s, xb, a.xs.s, t + 1);
        const bf16* tB = sRing + (t & 1) * slot_elems;
        const bf16* tX = tB + kTj * L.ldn;
        const int j0 = t * kTj;

        // intra-chunk, 16 columns j at a time: scores C_i . B_j^T, then
        // M = scores * L * dt (masked) as a bf16 A fragment, times x_j;
        // each B and x fragment serves the warp's m-tiles
        const int kk_end = live && last_row >= j0 ? min(4, (last_row - j0) / 16 + 1) : 0;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk >= kk_end) break;
          float s[MI][2][4] = {};
#pragma unroll
          for (int k = 0; k < kMaxNK; ++k) {
            if (k >= nk) break;
            uint32_t bk[4];
            ldmatrix_x4(bk, tB + (kk * 16 + lr + mb1 * 8) * L.ldn + k * 16 + mb0 * 8);
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
              mma_bf16(s[mi][0], cf[mi][k], bk[0], bk[1]);
              mma_bf16(s[mi][1], cf[mi][k], bk[2], bk[3]);
            }
          }
          uint32_t pa[MI][4];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int j = j0 + kk * 16 + half * 8 + c2;
            const float2 cj = *reinterpret_cast<const float2*>(sCum + j);
            const float2 dj = *reinterpret_cast<const float2*>(sDt + j);
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
              float m[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int i = wr + mi * 16 + g + (e < 2 ? 0 : 8);
                const float d = fminf(fmaxf(ci[mi][e >> 1] - (e & 1 ? cj.y : cj.x), -60.f), 0.f);
                m[e] = j + (e & 1) <= i && i < len
                           ? s[mi][half][e] * __expf(d) * (e & 1 ? dj.y : dj.x)
                           : 0.f;
              }
              pa[mi][2 * half] = pack_bf16(m[0], m[1]);
              pa[mi][2 * half + 1] = pack_bf16(m[2], m[3]);
            }
          }
#pragma unroll
          for (int dn = 0; dn < P / 16; ++dn) {
            uint32_t bv[4];
            ldmatrix_x4_trans(bv, tX + (kk * 16 + lr + mb0 * 8) * L.ldx + dn * 16 + mb1 * 8);
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
              mma_bf16(acc[mi][2 * dn], pa[mi], bv[0], bv[1]);
              mma_bf16(acc[mi][2 * dn + 1], pa[mi], bv[2], bv[3]);
            }
          }
        }

        if (!last) continue;
        // state = exp(total) state + (x w)^T . B, this tile's share; each
        // warp owns 16 x 64 slabs of the state and adds into them in place
        const float* w = sW + j0 + c2;
        const int kmax = min(4, (len - j0 + 15) / 16);
        const float f = t == 0 ? clip_exp(total) : 1.f;
        for (int sl = warp; sl < MT * NG; sl += kTcWarps) {
          const int p0 = (sl % MT) * 16, n0 = (sl / MT) * 64;
          float up[8][4] = {};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if (kk >= kmax) break;
            uint32_t ax[4];  // (x w)^T: rows p, columns j
            ldmatrix_x4_trans(ax, tX + (kk * 16 + lr + mb1 * 8) * L.ldx + p0 + mb0 * 8);
            const float2 w0 = *reinterpret_cast<const float2*>(w + kk * 16);
            const float2 w1 = *reinterpret_cast<const float2*>(w + kk * 16 + 8);
            ax[0] = scale_bf16x2(ax[0], w0.x, w0.y);
            ax[1] = scale_bf16x2(ax[1], w0.x, w0.y);
            ax[2] = scale_bf16x2(ax[2], w1.x, w1.y);
            ax[3] = scale_bf16x2(ax[3], w1.x, w1.y);
#pragma unroll
            for (int np = 0; np < 4; ++np) {
              if (n0 + np * 16 >= L.npad) break;
              uint32_t bb[4];
              ldmatrix_x4_trans(bb, tB + (kk * 16 + lr + mb0 * 8) * L.ldn + n0 + np * 16 + mb1 * 8);
              mma_bf16(up[2 * np], ax, bb[0], bb[1]);
              mma_bf16(up[2 * np + 1], ax, bb[2], bb[3]);
            }
          }
          float* st = sState + (p0 + g) * L.lds + n0 + c2;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            if (n0 + n * 8 >= L.npad) break;
            float2* q0 = reinterpret_cast<float2*>(st + n * 8);
            float2* q1 = reinterpret_cast<float2*>(st + 8 * L.lds + n * 8);
            float2 v0 = *q0, v1 = *q1;
            v0.x = v0.x * f + up[n][0];
            v0.y = v0.y * f + up[n][1];
            v1.x = v1.x * f + up[n][2];
            v1.y = v1.y * f + up[n][3];
            *q0 = v0;
            *q1 = v1;
          }
        }
      }

      // y: staged in the ring as bf16 rows, then stored a 16-byte vector
      // a thread, whole rows at a time
      __syncthreads();  // every warp is done with the last tile
      if (live) {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int n = 0; n < PT; ++n) {
            bf16* yr = sY + (wr - i0 + mi * 16 + g) * L.ldx + n * 8 + c2;
            *reinterpret_cast<__nv_bfloat162*>(yr) =
                __floats2bfloat162_rn(acc[mi][n][0], acc[mi][n][1]);
            *reinterpret_cast<__nv_bfloat162*>(yr + 8 * L.ldx) =
                __floats2bfloat162_rn(acc[mi][n][2], acc[mi][n][3]);
          }
      }
      __syncthreads();
      for (int e = tid; e < kRows * (P / 8); e += kTcThreads) {
        const int r = e / (P / 8), v = e % (P / 8);
        if (i0 + r < len)
          *reinterpret_cast<uint4*>(yb + (long long)(s0 + i0 + r) * a.ys.s + v * 8) =
              *reinterpret_cast<const uint4*>(sY + r * L.ldx + v * 8);
      }
    }
  }
  __syncthreads();
  store_state(a.state + ((long long)b * a.H + h) * P * N, sState, L.lds, P, N, tid,
              kTcThreads);
}

// ---------------------------------------------------------------------

// The bf16 body for hd, its threads and its shared memory at (N, cs),
// with its dynamic shared-memory limit raised (`raise_smem`).
struct Plan {
  const void* kern;
  int threads;
  size_t smem;
};

int raise_smem(const void* kern);

template <int P>
int plan_bf16(int N, int cs, Plan& p) {
  p = Plan{(const void*)ssd_bf16_kernel<P>, kTcThreads, tc_smem_bytes<P>(N, cs)};
  return raise_smem(p.kern);
}

int plan_bf16_hd(int hd, int N, int cs, Plan& p) {
  switch (hd) {
    case 16: return plan_bf16<16>(N, cs, p);
    case 32: return plan_bf16<32>(N, cs, p);
    case 64: return plan_bf16<64>(N, cs, p);
    case 128: return plan_bf16<128>(N, cs, p);
    default: return -1;
  }
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
__global__ void __launch_bounds__(128) ssd_fwd_scores_kernel(TrainArgs a) {
  scores_tile<float>(a);
}
template <typename T>
__global__ void __launch_bounds__(128) ssd_bwd_scores_kernel(TrainArgs a) {
  scores_tile<T>(a);
}

// Forward: one chunk's S_loc = (x w)^T B (hd x N) of one (batch, head),
// summed over its 64-row tiles in shared memory; written where the chain
// will turn it into the next chunk's entry state (the final state for
// the last chunk).  Also the chunk's total.
template <int P>
__global__ void __launch_bounds__(256, 1) ssd_fwd_state_kernel(TrainArgs a) {
  constexpr int PP = pad_hd<P>(), lx = PP + 8;
  const int N = a.N, Np = pad32(N), ln = Np + 4, lb = Np + 8;
  const Tiles tl = tiles_of(a.cs);
  extern __shared__ float smem[];
  float* sAcc = smem;           // [PP][ln]
  float* sX = sAcc + PP * ln;   // [64][lx] x_j w_j
  float* sB = sX + 64 * lx;     // [64][lb]
  float* sDt = sB + 64 * lb;    // [cs64]
  float* sCum = sDt + tl.cs64;  // [cs64]
  float* sW = sCum + tl.cs64;   // [cs64]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, grp = h / (a.H / a.G);
  const long long bh = (long long)b * a.H + h;
  const int s0 = c * a.cs, len = min(a.cs, a.S - s0);
  const float* xb = static_cast<const float*>(a.x) + b * a.xs.b + h * a.xs.h;
  const float* Bb = static_cast<const float*>(a.Bm) + b * a.bs.b + grp * a.bs.h;
  for (int e = threadIdx.x; e < PP * ln; e += 256) sAcc[e] = 0.f;
  chunk_cum<256>(a.dt + b * a.ds.b + h * a.ds.h, a.ds.s, s0, len, a.A[h], sDt, sCum);
  const float total = sCum[len - 1];
  for (int r = threadIdx.x; r < len; r += 256) sW[r] = clip_exp(total - sCum[r]) * sDt[r];
  if (threadIdx.x == 0) a.tot[bh * a.nc + c] = total;
  const int warp = threadIdx.x >> 5, nct = Np / 32;
  for (int j0 = 0; j0 < len; j0 += 64) {
    __syncthreads();  // sW is written; the previous tile's readers are done
    stage<256>(sX, lx, 64, PP, xb + (long long)(s0 + j0) * a.xs.s, a.xs.s, len - j0, P,
               [&](int r) { return sW[j0 + r]; });
    stage<256>(sB, lb, 64, Np, Bb + (long long)(s0 + j0) * a.bs.s, a.bs.s, len - j0, N,
               One());
    __syncthreads();
    for (int tile = warp; tile < (PP / 32) * nct; tile += 8) {
      const int r0 = 32 * (tile / nct), c0 = 32 * (tile % nct);
      float acc[2][4][4];
      zero_tile(acc);
      warp_mma(acc, 64, [&](int r, int k) { return sX[k * lx + r0 + r]; },
               [&](int k, int cc) { return sB[k * lb + c0 + cc]; });
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sAcc[(r0 + frag_row(mi, e)) * ln + c0 + frag_col(ni, e)] += acc[mi][ni][e];
    }
  }
  __syncthreads();
  float* out = c + 1 < a.nc ? a.states + (bh * a.nc + c + 1) * P * N : a.state + bh * P * N;
  for (int e = threadIdx.x; e < P * N; e += 256) out[e] = sAcc[(e / N) * ln + e % N];
}

// Forward chain, one thread an element of one (batch, head)'s state:
// the entry state of chunk c + 1 = exp(total_c) (entry state of c) +
// S_loc of c, in place over the S_loc the state pass wrote.
__global__ void __launch_bounds__(256) ssd_fwd_chain_kernel(TrainArgs a) {
  const int PN = a.P * a.N, e = blockIdx.x * 256 + threadIdx.x;
  if (e >= PN) return;
  const long long bh = (long long)blockIdx.z * a.H + blockIdx.y;
  float* st = a.states + bh * a.nc * PN + e;
  const float* tot = a.tot + bh * a.nc;
  st[0] = 0.f;
  float carry = 0.f;
  for (int c0 = 1; c0 < a.nc; c0 += 8) {  // 8 chunks' loads in flight
    float loc[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) loc[u] = c0 + u < a.nc ? st[(long long)(c0 + u) * PN] : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = c0 + u;
      if (c >= a.nc) break;
      carry = clip_exp(tot[c - 1]) * carry + loc[u];
      st[(long long)c * PN] = carry;
    }
  }
  float* fin = a.state + bh * PN + e;
  *fin = clip_exp(tot[a.nc - 1]) * carry + *fin;
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

// Forward outputs of one 64-row tile i of one chunk of one (batch,
// head): M X over the tiles j <= i, M formed in shared memory from the
// scores, each tile's raw scores and x copied one tile ahead of the
// products; then exp(cum_i) C_i S_in^T.  Four warps; each holds its
// 32 x 32 tiles of y (two at hd 128) for the whole walk.
template <int P>
__global__ void __launch_bounds__(128, 2) ssd_fwd_out_kernel(TrainArgs a) {
  constexpr int PP = pad_hd<P>(), lx = PP + 8, NCT = PP / 32, TILES = 2 * NCT;
  constexpr int TPW = (TILES + 3) / 4;
  const int N = a.N, Np = pad32(N), ln = Np + 4;
  const Tiles tl = tiles_of(a.cs);
  extern __shared__ float smem[];
  float* sDt = smem;            // [cs64]
  float* sCum = sDt + tl.cs64;  // [cs64]
  float* sE = sCum + tl.cs64;   // [64] exp(cum_i)
  float* sM = sE + 64;          // [2][64][68]  scores, then M
  float* sX = sM + 2 * 64 * 68; // [2][64][lx]
  float* sC = sE + 64;          // [64][ln]     inter-chunk, over sM and sX
  float* sS = sC + 64 * ln;     // [PP][ln]
  const int c = blockIdx.x / tl.nt, it = tl.nt - 1 - blockIdx.x % tl.nt;
  const int h = blockIdx.y, b = blockIdx.z, grp = h / (a.H / a.G);
  const long long bh = (long long)b * a.H + h, bg = (long long)b * a.G + grp;
  const int s0 = c * a.cs, len = min(a.cs, a.S - s0), i0 = 64 * it;
  if (i0 >= len) return;
  const float* xb = static_cast<const float*>(a.x) + b * a.xs.b + h * a.xs.h;
  const float* Cb = static_cast<const float*>(a.Cm) + b * a.cs_.b + grp * a.cs_.h;
  const float* scb = a.sc + ((bg * a.nc + c) * tl.cs64 + i0) * tl.cs64;
  // tile jt's raw scores and x rows into buffer jt & 1, as one group
  auto fetch = [&](int jt) {
    copy_tile<128>(sM + (jt & 1) * 64 * 68, 68, 64, 64, scb + 64 * jt, tl.cs64, 64, 64);
    copy_tile<128>(sX + (jt & 1) * 64 * lx, lx, 64, PP, xb + (long long)(s0 + 64 * jt) * a.xs.s,
                   a.xs.s, len - 64 * jt, P);
    cp_async_commit();
  };
  fetch(0);
  chunk_cum<128>(a.dt + b * a.ds.b + h * a.ds.h, a.ds.s, s0, len, a.A[h], sDt, sCum);
  if (threadIdx.x < 64)
    sE[threadIdx.x] = i0 + threadIdx.x < len ? clip_exp(sCum[i0 + threadIdx.x]) : 0.f;
  const int warp = threadIdx.x >> 5;
  float acc[TPW][2][4][4];
#pragma unroll
  for (int tw = 0; tw < TPW; ++tw) zero_tile(acc[tw]);
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = 64 * jt;
    float* m = sM + (jt & 1) * 64 * 68;
    const float* x = sX + (jt & 1) * 64 * lx;
    if (jt < it) {
      fetch(jt + 1);  // into the buffer the previous tile's products left
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile jt is in (and sE)
    for (int e = threadIdx.x; e < 64 * 64; e += 128) {
      const int r = e >> 6, cc = e & 63, i = i0 + r, j = j0 + cc;
      float* v = m + r * 68 + cc;
      *v = j <= i && i < len ? *v * clip_exp(sCum[i] - sCum[j]) * sDt[j] : 0.f;
    }
    __syncthreads();  // M is formed
#pragma unroll
    for (int tw = 0; tw < TPW; ++tw) {
      const int tile = warp + 4 * tw;
      if (tile >= TILES) break;
      const int r0 = 32 * (tile / NCT), c0 = 32 * (tile % NCT);
      warp_mma(acc[tw], 64, [&](int r, int k) { return m[(r0 + r) * 68 + k]; },
               [&](int k, int cc) { return x[k * lx + c0 + cc]; });
    }
    __syncthreads();  // every warp is done with buffer jt & 1
  }
  if (c > 0) {  // inter-chunk: exp(cum_i) C_i . S_in (the state is zero in the first chunk)
    copy_tile<128>(sC, ln, 64, Np, Cb + (long long)(s0 + i0) * a.cs_.s, a.cs_.s, len - i0, N);
    copy_tile<128>(sS, ln, PP, Np, a.states + (bh * a.nc + c) * P * N, N, P, N);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int tw = 0; tw < TPW; ++tw) {
      const int tile = warp + 4 * tw;
      if (tile >= TILES) break;
      const int r0 = 32 * (tile / NCT), c0 = 32 * (tile % NCT);
      warp_mma(acc[tw], Np, [&](int r, int k) { return sC[(r0 + r) * ln + k] * sE[r0 + r]; },
               [&](int k, int cc) { return sS[(c0 + cc) * ln + k]; });
    }
  }
  float* yb = static_cast<float*>(a.y) + b * a.ys.b + h * a.ys.h;
#pragma unroll
  for (int tw = 0; tw < TPW; ++tw) {
    const int tile = warp + 4 * tw;
    if (tile >= TILES) break;
    const int r0 = 32 * (tile / NCT), c0 = 32 * (tile % NCT);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + r0 + frag_row(mi, e), p = c0 + frag_col(ni, e);
          if (i < len && p < P) yb[(long long)(s0 + i) * a.ys.s + p] = acc[tw][mi][ni][e];
        }
  }
}

// Backward (a): one chunk of one (batch, head): cum (kept for the other
// passes) and total; the chain's local term sum_i exp(cum_i) dy_i (x) C_i
// (hd x N, into dSo); q_i = exp(cum_i) <dy_i, C_i S_in^T>, the inter
// term's d(cum).
template <typename T, int P>
__global__ void __launch_bounds__(256, 1) ssd_bwd_local_kernel(TrainArgs a) {
  constexpr int PP = pad_hd<P>(), lx = PP + 8, NCT = PP / 32;
  const int N = a.N, Np = pad32(N), ln = Np + 4;
  const Tiles tl = tiles_of(a.cs);
  extern __shared__ float smem[];
  float* sS = smem;              // [PP][ln] S_in
  float* sAcc = sS + PP * ln;    // [PP][ln] the local term
  float* sC = sAcc + PP * ln;    // [64][ln]
  float* sDy = sC + 64 * ln;     // [64][lx] dy_i exp(cum_i)
  float* sQ = sDy + 64 * lx;     // [NCT][64]
  float* sDt = sQ + NCT * 64;    // [cs64]
  float* sCum = sDt + tl.cs64;   // [cs64]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, grp = h / (a.H / a.G);
  const long long bh = (long long)b * a.H + h;
  const int s0 = c * a.cs, len = min(a.cs, a.S - s0);
  const T* Cb = static_cast<const T*>(a.Cm) + b * a.cs_.b + grp * a.cs_.h;
  const T* dyb = static_cast<const T*>(a.dy) + b * a.dys.b + h * a.dys.h;
  chunk_cum<256>(a.dt + b * a.ds.b + h * a.ds.h, a.ds.s, s0, len, a.A[h], sDt, sCum);
  if (threadIdx.x == 0) a.tot[bh * a.nc + c] = sCum[len - 1];
  for (int r = threadIdx.x; r < len; r += 256) {
    a.cum[bh * a.S + s0 + r] = sCum[r];
    if (c == 0) a.q[bh * a.S + s0 + r] = 0.f;  // S_in = 0
  }
  if (c == 0) return;  // the first chunk's local term is not needed
  stage<256>(sS, ln, PP, Np, a.states + (bh * a.nc + c) * P * N, N, P, N, One());
  for (int e = threadIdx.x; e < PP * ln; e += 256) sAcc[e] = 0.f;
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3, nct = Np / 32;
  for (int i0 = 0; i0 < len; i0 += 64) {
    __syncthreads();  // the previous tile's readers are done
    stage<256>(sC, ln, 64, Np, Cb + (long long)(s0 + i0) * a.cs_.s, a.cs_.s, len - i0, N,
               One());
    stage<256>(sDy, lx, 64, PP, dyb + (long long)(s0 + i0) * a.dys.s, a.dys.s, len - i0, P,
               [&](int r) { return clip_exp(sCum[i0 + r]); });
    __syncthreads();
    // C S_in^T (64 x hd), dotted with dy exp(cum) row by row
    for (int tile = warp; tile < 2 * NCT; tile += 8) {
      const int r0 = 32 * (tile / NCT), c0 = 32 * (tile % NCT);
      float acc[2][4][4];
      zero_tile(acc);
      warp_mma(acc, Np, [&](int r, int k) { return sC[(r0 + r) * ln + k]; },
               [&](int k, int cc) { return sS[(c0 + cc) * ln + k]; });
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = r0 + frag_row(mi, 2 * hf);
          float s = 0.f;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 2 * hf; e < 2 * hf + 2; ++e)
              s += acc[mi][ni][e] * sDy[row * lx + c0 + frag_col(ni, e)];
          s = row_sum4(s);
          if (t == 0) sQ[(c0 / 32) * 64 + row] = s;
        }
    }
    // the local term += (dy exp(cum))^T C over this tile
    for (int tile = warp; tile < NCT * nct; tile += 8) {
      const int r0 = 32 * (tile / nct), c0 = 32 * (tile % nct);
      float acc[2][4][4];
      zero_tile(acc);
      warp_mma(acc, 64, [&](int r, int k) { return sDy[k * lx + r0 + r]; },
               [&](int k, int cc) { return sC[k * ln + c0 + cc]; });
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sAcc[(r0 + frag_row(mi, e)) * ln + c0 + frag_col(ni, e)] += acc[mi][ni][e];
    }
    __syncthreads();
    if (threadIdx.x < 64 && i0 + threadIdx.x < len) {
      float s = 0.f;
      for (int ct = 0; ct < NCT; ++ct) s += sQ[ct * 64 + threadIdx.x];
      a.q[bh * a.S + s0 + i0 + threadIdx.x] = s;
    }
  }
  __syncthreads();
  float* out = a.dSo + (bh * a.nc + c) * P * N;
  for (int e = threadIdx.x; e < P * N; e += 256) out[e] = sAcc[(e / N) * ln + e % N];
}

// Backward chain, one thread an element of one (batch, head): dS_out
// of each chunk right to left, in place over the local terms:
// dS_out[c - 1] = exp(total_c) dS_out[c] + local_c, dS_out[nc - 1] =
// dstate.
__global__ void __launch_bounds__(256) ssd_bwd_chain_kernel(TrainArgs a) {
  const int PN = a.P * a.N, e = blockIdx.x * 256 + threadIdx.x;
  if (e >= PN) return;
  const long long bh = (long long)blockIdx.z * a.H + blockIdx.y;
  float carry = a.dstate ? a.dstate[bh * PN + e] : 0.f;
  float* p = a.dSo + bh * a.nc * PN + e;
  const float* tot = a.tot + bh * a.nc;
  for (int c0 = a.nc - 1; c0 >= 0; c0 -= 8) {  // 8 chunks' loads in flight
    float loc[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) loc[u] = c0 - u > 0 ? p[(long long)(c0 - u) * PN] : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = c0 - u;
      if (c < 0) break;
      p[(long long)c * PN] = carry;
      carry = clip_exp(tot[c]) * carry + loc[u];
    }
  }
}

// Backward (b): the dscores of one tile pair of one (batch, group,
// chunk), summed over the heads of one split of the group in head
// order; for each head the tile's d(cum) terms R_ij = (dy_i . x_j)
// sc_ij L_ij: row sums sum_j dt_j R_ij, column sums sum_i R_ij and the
// paired dA term sum dt_j R_ij (cum_i - cum_j).
template <typename T, int P>
__global__ void __launch_bounds__(128) ssd_bwd_ds_kernel(TrainArgs a) {
  constexpr int PP = pad_hd<P>(), lr = PP + 4;
  const Tiles tl = tiles_of(a.cs);
  extern __shared__ float smem[];
  float* sSc = smem;             // [64][68] scores
  float* sDy = sSc + 64 * 68;    // [64][lr] dy_i
  float* sX = sDy + 64 * lr;     // [64][lr] x_j
  float* sCi = sX + 64 * lr;     // [64] cum_i
  float* sCj = sCi + 64;         // [64] cum_j
  float* sDtj = sCj + 64;        // [64] dt_j
  float* sRowR = sDtj + 64;      // [2][64]
  float* sColR = sRowR + 128;    // [2][64]
  float* sRed = sColR + 128;     // [4]
  const int pr = blockIdx.x / a.nsplit, sp = blockIdx.x % a.nsplit;
  int it, jt;
  pair_tiles(pr, it, jt);
  const int c = blockIdx.y, bg = blockIdx.z, b = bg / a.G, grp = bg % a.G;
  const int s0 = c * a.cs, len = min(a.cs, a.S - s0), i0 = 64 * it, j0 = 64 * jt;
  if (i0 >= len) return;
  const int hg = a.H / a.G, hps = (hg + a.nsplit - 1) / a.nsplit;
  const int h_lo = grp * hg + sp * hps, h_hi = min(h_lo + hps, (grp + 1) * hg);
  const float* scb = a.sc + (((long long)bg * a.nc + c) * tl.cs64 + i0) * tl.cs64 + j0;
  batched4<128>(
      64 * 16, [&](int e) { return ld4(scb + (long long)(e >> 4) * tl.cs64 + 4 * (e & 15)); },
      [&](int e, float4 v) { st4(sSc + (e >> 4) * 68 + 4 * (e & 15), v, 1.f); });
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int r0 = 32 * (warp >> 1), c0 = 32 * (warp & 1);
  float dS[2][4][4];
  zero_tile(dS);
  for (int h = h_lo; h < h_hi; ++h) {
    const long long bh = (long long)b * a.H + h;
    __syncthreads();  // the previous head's readers are done
    stage<128>(sDy, lr, 64, PP,
               static_cast<const T*>(a.dy) + b * a.dys.b + h * a.dys.h +
                   (long long)(s0 + i0) * a.dys.s,
               a.dys.s, len - i0, P, One());
    stage<128>(sX, lr, 64, PP,
               static_cast<const T*>(a.x) + b * a.xs.b + h * a.xs.h +
                   (long long)(s0 + j0) * a.xs.s,
               a.xs.s, len - j0, P, One());
    if (threadIdx.x < 64) {
      const int r = threadIdx.x;
      const float* cm = a.cum + bh * a.S + s0;
      sCi[r] = i0 + r < len ? cm[i0 + r] : 0.f;
      sCj[r] = j0 + r < len ? cm[j0 + r] : 0.f;
      sDtj[r] = j0 + r < len ? a.dt[b * a.ds.b + h * a.ds.h + (long long)(s0 + j0 + r) * a.ds.s]
                             : 0.f;
    }
    __syncthreads();
    float dm[2][4][4];
    zero_tile(dm);
    warp_mma(dm, PP, [&](int r, int k) { return sDy[(r0 + r) * lr + k]; },
             [&](int k, int cc) { return sX[(c0 + cc) * lr + k]; });
    float rowr[2][2] = {}, colr[4][2] = {}, dar = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + frag_row(mi, e), cc = c0 + frag_col(ni, e);
          const bool ok = j0 + cc <= i0 + r && i0 + r < len;
          const float d = sCi[r] - sCj[cc], dtj = sDtj[cc];
          const float v = ok ? dm[mi][ni][e] * clip_exp(d) : 0.f;
          const float R = v * sSc[r * 68 + cc];
          dS[mi][ni][e] += v * dtj;
          rowr[mi][e >> 1] += R * dtj;
          colr[ni][e & 1] += R;
          dar += R * dtj * d;
        }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float s = row_sum4(rowr[mi][hf]);
        if (t == 0) sRowR[(warp & 1) * 64 + r0 + 16 * mi + g + 8 * hf] = s;
      }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float s = col_sum8(colr[ni][q]);
        if (g == 0) sColR[(warp >> 1) * 64 + c0 + 8 * ni + 2 * t + q] = s;
      }
    dar = warp_sum(dar);
    if (lane == 0) sRed[warp] = dar;
    __syncthreads();
    const long long o = (bh * a.nc + c) * tl.npairs + pr;
    if (threadIdx.x < 64)
      a.rr[o * 64 + threadIdx.x] = sRowR[threadIdx.x] + sRowR[64 + threadIdx.x];
    else
      a.cr[o * 64 + threadIdx.x - 64] = sColR[threadIdx.x - 64] + sColR[threadIdx.x];
    if (threadIdx.x == 0) a.dar[o] = sRed[0] + sRed[1] + sRed[2] + sRed[3];
  }
  float* out = a.dS + ((((long long)sp * a.B * a.G + bg) * a.nc + c) * tl.cs64 + i0 + r0) *
                          tl.cs64 + j0 + c0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[(long long)frag_row(mi, e) * tl.cs64 + frag_col(ni, e)] = dS[mi][ni][e];
}

// Backward (c): dx of one 64-row tile j of one chunk of one (batch,
// head): M^T dy over the tiles i >= j, M formed in shared memory from the
// scores, each tile's raw scores and dy copied one tile ahead of the
// products; then w_j (B_j G^T), with dw_j = <x_j, B_j G^T>; on the first
// tile also <G, S_in>.
template <typename T, int P>
__global__ void __launch_bounds__(128, 2) ssd_bwd_dx_kernel(TrainArgs a) {
  constexpr int PP = pad_hd<P>(), lx = PP + 8, NCT = PP / 32, TILES = 2 * NCT;
  constexpr int TPW = (TILES + 3) / 4;
  const int N = a.N, Np = pad32(N), ln = Np + 4;
  const Tiles tl = tiles_of(a.cs);
  extern __shared__ float smem[];
  float* sDt = smem;              // [cs64]
  float* sCum = sDt + tl.cs64;    // [cs64]
  float* sRow = sCum + tl.cs64;   // [NCT][64]
  float* sRed = sRow + NCT * 64;  // [4]
  float* sM = sRed + 4;           // [2][64][72]  scores, then M
  float* sDy = sM + 2 * 64 * 72;  // [2][64][lx]
  float* sB = sRed + 4;           // [64][ln]     the state update's terms, over sM and sDy
  float* sG = sB + 64 * ln;       // [PP][ln]
  float* sX = sG + PP * ln;       // [64][lx]
  const int c = blockIdx.x / tl.nt, jt = blockIdx.x % tl.nt;
  const int h = blockIdx.y, b = blockIdx.z, grp = h / (a.H / a.G);
  const long long bh = (long long)b * a.H + h, bg = (long long)b * a.G + grp;
  const int s0 = c * a.cs, len = min(a.cs, a.S - s0), j0 = 64 * jt;
  if (j0 >= len) return;
  const int last = (len - 1) / 64;  // the last tile i
  const T* xb = static_cast<const T*>(a.x) + b * a.xs.b + h * a.xs.h;
  const T* Bb = static_cast<const T*>(a.Bm) + b * a.bs.b + grp * a.bs.h;
  const T* dyb = static_cast<const T*>(a.dy) + b * a.dys.b + h * a.dys.h;
  const float* scb = a.sc + (bg * a.nc + c) * tl.cs64 * tl.cs64 + j0;
  // tile it's raw scores and dy rows into buffer (it - jt) & 1, as one group
  auto fetch = [&](int it) {
    const int buf = (it - jt) & 1;
    copy_tile<128>(sM + buf * 64 * 72, 72, 64, 64, scb + (long long)64 * it * tl.cs64, tl.cs64,
                   64, 64);
    copy_tile<128>(sDy + buf * 64 * lx, lx, 64, PP, dyb + (long long)(s0 + 64 * it) * a.dys.s,
                   a.dys.s, len - 64 * it, P);
    cp_async_commit();
  };
  fetch(jt);
  for (int r = threadIdx.x; r < len; r += 128) {
    sDt[r] = a.dt[b * a.ds.b + h * a.ds.h + (long long)(s0 + r) * a.ds.s];
    sCum[r] = a.cum[bh * a.S + s0 + r];
  }
  const float total = a.tot[bh * a.nc + c];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  float acc[TPW][2][4][4];
#pragma unroll
  for (int tw = 0; tw < TPW; ++tw) zero_tile(acc[tw]);
  for (int it = jt; it <= last; ++it) {
    const int i0 = 64 * it;
    float* m = sM + ((it - jt) & 1) * 64 * 72;
    const float* dy = sDy + ((it - jt) & 1) * 64 * lx;
    if (it < last) {
      fetch(it + 1);  // into the buffer the previous tile's products left
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it is in (and sDt, sCum)
    for (int e = threadIdx.x; e < 64 * 64; e += 128) {
      const int r = e >> 6, cc = e & 63, i = i0 + r, j = j0 + cc;
      float* v = m + r * 72 + cc;
      *v = j <= i && i < len ? *v * clip_exp(sCum[i] - sCum[j]) * sDt[j] : 0.f;
    }
    __syncthreads();  // M is formed
#pragma unroll
    for (int tw = 0; tw < TPW; ++tw) {
      const int tile = warp + 4 * tw;
      if (tile >= TILES) break;
      const int r0 = 32 * (tile / NCT), c0 = 32 * (tile % NCT);
      warp_mma(acc[tw], 64, [&](int r, int k) { return m[k * 72 + r0 + r]; },
               [&](int k, int cc) { return dy[k * lx + c0 + cc]; });
    }
    __syncthreads();  // every warp is done with the buffer
  }
  // the state update's terms: dx_j += w_j (B_j G^T), dw_j = <x_j, B_j G^T>
  copy_tile<128>(sB, ln, 64, Np, Bb + (long long)(s0 + j0) * a.bs.s, a.bs.s, len - j0, N);
  copy_tile<128>(sG, ln, PP, Np, a.dSo + (bh * a.nc + c) * P * N, N, P, N);
  copy_tile<128>(sX, lx, 64, PP, xb + (long long)(s0 + j0) * a.xs.s, a.xs.s, len - j0, P);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int tw = 0; tw < TPW; ++tw) {
    const int tile = warp + 4 * tw;
    if (tile >= TILES) break;
    const int r0 = 32 * (tile / NCT), c0 = 32 * (tile % NCT);
    float bgt[2][4][4];
    zero_tile(bgt);
    warp_mma(bgt, Np, [&](int r, int k) { return sB[(r0 + r) * ln + k]; },
             [&](int k, int cc) { return sG[(c0 + cc) * ln + k]; });
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + frag_row(mi, 2 * hf), j = j0 + row;
        float s = 0.f;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 2 * hf; e < 2 * hf + 2; ++e)
            s += bgt[mi][ni][e] * sX[row * lx + c0 + frag_col(ni, e)];
        s = row_sum4(s);
        if (t == 0) sRow[(c0 / 32) * 64 + row] = s;
        const float w = j < len ? clip_exp(total - sCum[j]) * sDt[j] : 0.f;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 2 * hf; e < 2 * hf + 2; ++e) acc[tw][mi][ni][e] += w * bgt[mi][ni][e];
      }
  }
  if (jt == 0) {  // <G, S_in> (S_in is zero in the first chunk)
    float s = 0.f;
    if (c > 0) {
      const float* st = a.states + (bh * a.nc + c) * P * N;
      batched<128>(
          P * N, [&](int e) { return st[e]; },
          [&](int e, float v) { s += sG[(e / N) * ln + e % N] * v; });
    }
    s = warp_sum(s);
    if (lane == 0) sRed[warp] = s;
  }
  __syncthreads();
  if (jt == 0 && threadIdx.x == 0) a.gs[bh * a.nc + c] = sRed[0] + sRed[1] + sRed[2] + sRed[3];
  if (threadIdx.x < 64 && j0 + threadIdx.x < len) {
    float s = 0.f;
    for (int ct = 0; ct < NCT; ++ct) s += sRow[ct * 64 + threadIdx.x];
    a.dw[bh * a.S + s0 + j0 + threadIdx.x] = s;
  }
  T* dxb = static_cast<T*>(a.dx) + b * a.dxs.b + h * a.dxs.h;
#pragma unroll
  for (int tw = 0; tw < TPW; ++tw) {
    const int tile = warp + 4 * tw;
    if (tile >= TILES) break;
    const int r0 = 32 * (tile / NCT), c0 = 32 * (tile % NCT);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + r0 + frag_row(mi, e), p = c0 + frag_col(ni, e);
          if (j < len && p < P)
            dxb[(long long)(s0 + j) * a.dxs.s + p] = from_f32<T>(acc[tw][mi][ni][e]);
        }
  }
}

// Backward (d): dC (which 0) or dB (which 1) of one 64-row tile and 64
// columns of N of one chunk of one (batch, group): the heads' inter-chunk
// terms as one product over (head, hd), sum_h exp(cum_i) dy_i S_in
// (sum_h w_j x_j G), then the dscores summed over the splits times B_j
// (C_i) over the tiles j <= i (i >= j).
template <typename T, int P>
__global__ void __launch_bounds__(128, 2) ssd_bwd_dbdc_kernel(TrainArgs a) {
  constexpr int PP = pad_hd<P>(), la = PP + 4;
  const int N = a.N, nslab = (N + 63) / 64;
  const Tiles tl = tiles_of(a.cs);
  extern __shared__ float smem[];
  float* sScale = smem;              // [2][64]     the rows' scales
  float* sA = sScale + 128;          // [2][64][la] a head's rows
  float* sO = sA + 2 * 64 * la;      // [2][PP][72] its S_in or G, 64 columns
  float* sD = sScale + 128;          // [64][72]    dscores, over sA
  float* sE = sD + 64 * 72;          // [64][72]    B_j or C_i, 64 columns
  const int rt = blockIdx.x % tl.nt, ns = blockIdx.x / tl.nt % nslab;
  const int which = blockIdx.x / (tl.nt * nslab);
  const int c = blockIdx.y, bg = blockIdx.z, b = bg / a.G, grp = bg % a.G;
  const int s0 = c * a.cs, len = min(a.cs, a.S - s0), r0t = 64 * rt, n0 = 64 * ns;
  if (r0t >= len) return;
  const int hg = a.H / a.G, warp = threadIdx.x >> 5;
  const int wr = 32 * (warp >> 1), wc = 32 * (warp & 1);
  const Strides& st = which == 0 ? a.dys : a.xs;
  const T* rows = static_cast<const T*>(which == 0 ? a.dy : a.x) + b * st.b +
                  (long long)(s0 + r0t) * st.s;
  const float* mats = (which == 0 ? a.states : a.dSo) + (long long)c * P * N + n0;
  const long long mstride = (long long)a.nc * P * N;  // from one head's to the next
  // head k's scales (threads < 64) and tiles into buffer k & 1, one
  // head ahead of the products
  auto fetch = [&](int k) {
    const int h = grp * hg + k, buf = k & 1;
    const long long bh = (long long)b * a.H + h;
    if (threadIdx.x < 64) {
      const int row = r0t + threadIdx.x;
      float v = 0.f;
      if (row < len) {
        const float cm = a.cum[bh * a.S + s0 + row];
        v = which == 0 ? clip_exp(cm)
                       : clip_exp(a.tot[bh * a.nc + c] - cm) *
                             a.dt[b * a.ds.b + h * a.ds.h + (long long)(s0 + row) * a.ds.s];
      }
      sScale[64 * buf + threadIdx.x] = v;
    }
    copy_tile<128>(sA + buf * 64 * la, la, 64, PP, rows + h * st.h, st.s, len - r0t, P);
    copy_tile<128>(sO + buf * PP * 72, 72, PP, 64, mats + bh * mstride, N, P, N - n0);
    cp_async_commit();
  };
  float acc[2][4][4];
  zero_tile(acc);
  fetch(0);
  for (int k = 0; k < hg; ++k) {
    const int buf = k & 1;
    if (k + 1 < hg) {
      fetch(k + 1);  // into the buffer the last head's products left
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // head k's scales and tiles are in
    const float* tA = sA + buf * 64 * la;
    const float* tO = sO + buf * PP * 72;
    const float* sc = sScale + 64 * buf + wr;
    warp_mma(acc, PP, [&](int r, int kk) { return tA[(wr + r) * la + kk] * sc[r]; },
             [&](int kk, int cc) { return tO[kk * 72 + wc + cc]; });
    __syncthreads();  // every warp is done with buffer k & 1
  }
  const long long split = (long long)a.B * a.G * a.nc * tl.cs64 * tl.cs64;
  const float* dsb = a.dS + ((long long)bg * a.nc + c) * tl.cs64 * tl.cs64;
  const int o_lo = which == 0 ? 0 : rt, o_hi = which == 0 ? rt + 1 : (len + 63) / 64;
  for (int ot = o_lo; ot < o_hi; ++ot) {
    __syncthreads();  // the previous tile's readers are done
    const int i_0 = which == 0 ? r0t : 64 * ot, j_0 = which == 0 ? 64 * ot : r0t;
    batched4<128>(
        64 * 16,
        [&](int e) {
          const float* p = dsb + (long long)(i_0 + (e >> 4)) * tl.cs64 + j_0 + 4 * (e & 15);
          float4 s = ld4(p);
          for (int sp = 1; sp < a.nsplit; ++sp) {
            const float4 v = ld4(p + sp * split);
            s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
          }
          return s;
        },
        [&](int e, float4 v) { st4(sD + (e >> 4) * 72 + 4 * (e & 15), v, 1.f); });
    const Strides& st = which == 0 ? a.bs : a.cs_;
    const T* src = static_cast<const T*>(which == 0 ? a.Bm : a.Cm) + b * st.b + grp * st.h +
                   (long long)(s0 + 64 * ot) * st.s + n0;
    stage<128>(sE, 72, 64, 64, src, st.s, len - 64 * ot, N - n0, One());
    __syncthreads();
    if (which == 0)
      warp_mma(acc, 64, [&](int r, int kk) { return sD[(wr + r) * 72 + kk]; },
               [&](int kk, int cc) { return sE[kk * 72 + wc + cc]; });
    else
      warp_mma(acc, 64, [&](int r, int kk) { return sD[kk * 72 + wr + r]; },
               [&](int kk, int cc) { return sE[kk * 72 + wc + cc]; });
  }
  const Strides& os = which == 0 ? a.dcs : a.dbs;
  T* out = static_cast<T*>(which == 0 ? a.dC : a.dB) + b * os.b + grp * os.h;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0t + wr + frag_row(mi, e), n = n0 + wc + frag_col(ni, e);
        if (row < len && n < N)
          out[(long long)(s0 + row) * os.s + n] = from_f32<T>(acc[mi][ni][e]);
      }
}

// Backward (e): ddt of one chunk of one (batch, head) from the d(cum)
// terms the other passes left, by a reverse running sum; the chunk's dA
// partial from the paired terms.
__global__ void __launch_bounds__(256) ssd_bwd_dt_kernel(TrainArgs a) {
  const Tiles tl = tiles_of(a.cs);
  extern __shared__ float smem[];
  float* sDc = smem;            // [cs64] d(cum), direct terms aside
  float* sDd = sDc + tl.cs64;   // [cs64] ddt's direct terms
  float* sRed = sDd + tl.cs64;  // [2][8]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * a.H + h;
  const int s0 = c * a.cs, len = min(a.cs, a.S - s0), nt = (len + 63) / 64;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float A = a.A[h], total = a.tot[bh * a.nc + c], gsv = a.gs[bh * a.nc + c];
  const long long o = (bh * a.nc + c) * tl.npairs;
  float wdw = 0.f, pa = 0.f;
  for (int r = threadIdx.x; r < len; r += 256) {
    const long long k = bh * a.S + s0 + r;
    const float cm = a.cum[k], dtr = a.dt[b * a.ds.b + h * a.ds.h + (long long)(s0 + r) * a.ds.s];
    const int ti = r >> 6, rr = r & 63;
    float rowR = 0.f, colR = 0.f;
    for (int jt = 0; jt <= ti; ++jt) rowR += a.rr[(o + pair_index(ti, jt)) * 64 + rr];
    for (int it = ti; it < nt; ++it) colR += a.cr[(o + pair_index(it, ti)) * 64 + rr];
    const float q = a.q[k], dwr = a.dw[k], ew = clip_exp(total - cm), w = ew * dtr;
    sDd[r] = colR + ew * dwr;
    sDc[r] = q + rowR - dtr * colR - w * dwr;
    wdw += w * dwr;
    pa += q * cm + w * dwr * (total - cm);
  }
  wdw = warp_sum(wdw);
  pa = warp_sum(pa);
  if (lane == 0) {
    sRed[warp] = wdw;
    sRed[8 + warp] = pa;
  }
  __syncthreads();
  if (warp != 0) return;
  const float w8 = warp_sum(lane < 8 ? sRed[lane] : 0.f);
  const float p8 = warp_sum(lane < 8 ? sRed[8 + lane] : 0.f);
  float ar = 0.f;
  for (int p = lane; p < pair_index(nt, 0); p += 32) ar += a.dar[o + p];
  ar = warp_sum(ar);
  const float dtot = w8 + clip_exp(total) * gsv;
  const int per = (len + 31) / 32, lo = lane * per, hi = min(lo + per, len);
  float run = 0.f;
  for (int k = hi - 1; k >= lo; --k) {
    run += sDc[k] + (k == len - 1 ? dtot : 0.f);
    sDc[k] = run;
  }
  float incl = run;  // the runs of this lane and the lanes after it
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float v = __shfl_down_sync(0xffffffffu, incl, d);
    if (lane + d < 32) incl += v;
  }
  const float after = incl - run;
  float* ddt = a.ddt + bh * a.S + s0;
  for (int k = lo; k < hi; ++k) ddt[k] = sDd[k] + A * (sDc[k] + after);
  if (lane == 0) a.dAp[bh * a.nc + c] = (p8 + ar + clip_exp(total) * gsv * total) / A;
}

// Backward (f): dA, the chunks' partials summed over batch and chunk in
// order.
__global__ void __launch_bounds__(256) ssd_bwd_da_kernel(TrainArgs a) {
  for (int h = threadIdx.x; h < a.H; h += 256) {
    float s = 0.f;
    for (int b = 0; b < a.B; ++b)
      for (int c = 0; c < a.nc; ++c) s += a.dAp[((long long)b * a.H + h) * a.nc + c];
    a.dA[h] = s;
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

// The grids of the training path, (x, y, z) each: those of the
// forward's (scores, state, chain, out) and of the backward's (scores,
// local, ds, chain, dx, dbdc, dt, da) passes, in launch order
// (`fwd_plan` and `bwd_plan` mirror them).
void fwd_grids(int B, int H, int G, int P, int N, int cs, int nc, int* g) {
  const Tiles tl = tiles_of(cs);
  const int want[12] = {tl.npairs, nc, B * G, nc, H, B, (P * N + 255) / 256, H, B,
                        tl.nt * nc, H, B};
  for (int i = 0; i < 12; ++i) g[i] = want[i];
}
void bwd_grids(int B, int H, int G, int P, int N, int cs, int nc, int nsplit, int* g) {
  const Tiles tl = tiles_of(cs);
  const int want[24] = {tl.npairs, nc, B * G, nc, H, B,
                        tl.npairs * nsplit, nc, B * G, (P * N + 255) / 256, H, B,
                        tl.nt * nc, H, B, tl.nt * 2 * ((N + 63) / 64), nc, B * G,
                        nc, H, B, 1, 1, 1};
  for (int i = 0; i < 24; ++i) g[i] = want[i];
}
bool grids_cover(const int* grid, const int* want, int n) {
  for (int i = 0; i < n; ++i)
    if (grid[i] != want[i]) return false;
  return true;
}

template <int P>
int launch_fwd(TrainArgs& a, const int* grid, cudaStream_t s) {
  const TrainSmem sm = train_smem(P, a.N, a.cs);
  int err = run(ssd_fwd_scores_kernel, grid, 128, 4 * sm.scores, a, s);
  if (!err) err = run(ssd_fwd_state_kernel<P>, grid + 3, 256, 4 * sm.fwd_state, a, s);
  if (!err) err = run(ssd_fwd_chain_kernel, grid + 6, 256, 0, a, s);
  if (!err) err = run(ssd_fwd_out_kernel<P>, grid + 9, 128, 4 * sm.fwd_out, a, s);
  return err;
}

template <typename T, int P>
int launch_bwd(TrainArgs& a, const int* grid, cudaStream_t s) {
  const TrainSmem sm = train_smem(P, a.N, a.cs);
  int err = run(ssd_bwd_scores_kernel<T>, grid, 128, 4 * sm.scores, a, s);
  if (!err) err = run(ssd_bwd_local_kernel<T, P>, grid + 3, 256, 4 * sm.local, a, s);
  if (!err) err = run(ssd_bwd_ds_kernel<T, P>, grid + 6, 128, 4 * sm.ds, a, s);
  if (!err) err = run(ssd_bwd_chain_kernel, grid + 9, 256, 0, a, s);
  if (!err) err = run(ssd_bwd_dx_kernel<T, P>, grid + 12, 128, 4 * sm.dx, a, s);
  if (!err) err = run(ssd_bwd_dbdc_kernel<T, P>, grid + 15, 128, 4 * sm.dbdc, a, s);
  if (!err) err = run(ssd_bwd_dt_kernel, grid + 18, 256, 4 * sm.dt, a, s);
  if (!err) err = run(ssd_bwd_da_kernel, grid + 21, 256, 0, a, s);
  return err;
}

template <typename T>
int launch_bwd_hd(int hd, TrainArgs& a, const int* grid, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_bwd<T, 16>(a, grid, s);
    case 32: return launch_bwd<T, 32>(a, grid, s);
    case 64: return launch_bwd<T, 64>(a, grid, s);
    case 128: return launch_bwd<T, 128>(a, grid, s);
    default: return -1;
  }
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

// dtype: 0 = float32, 1 = bfloat16 (x, B_, C_ and y; dt, A and the state
// are float32).  Strides are in elements: (batch, head, seq) of x, dt,
// B_, C_ and y, in that order ("head" is the group axis of B_ and C_).
// cs is the chunk length, 1 <= cs <= S.  states, when not null, receives
// each chunk's entry state (B, H, ceil(S / cs), hd, N) fp32 contiguous,
// the first one zero (the backward's input; null when serving).
// bfloat16 is one launch of the serve body (scratch and grid unused);
// float32 runs the training path's four passes on the grids in grid[12]
// (`fwd_plan`), with fp32 scratch of the scores (B G, nc, cs64, cs64),
// the chunks' totals (B, H, nc) and, when states is null, the entry
// states.  Returns cudaGetLastError() after the launches, or -1 for an
// unsupported dtype / head size or grids that do not cover the shapes.
extern "C" int ssd_scan_fwd(int dtype, int hd, const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y, void* state, void* states,
                            int B, int H, int G, int S, int N, int cs,
                            const long long* strides, void* scratch, const int* grid,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* st = strides;
  if (dtype == 1) {
    Plan p;
    const int err = plan_bf16_hd(hd, N, cs, p);
    if (err != 0) return err;
    Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A), Bm,
           Cm, y, static_cast<float*>(state), static_cast<float*>(states), H, G, S, N, cs,
           strides_at(st, 0), strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
           strides_at(st, 4)};
    void* params[] = {&a};
    const cudaError_t e = cudaLaunchKernel(p.kern, dim3(H, B), dim3(p.threads), params,
                                           p.smem, s);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
  if (dtype != 0 || !hd_ok(hd) || cs < 1 || G < 1 || H % G || !grid || !scratch) return -1;
  const int nc = (S + cs - 1) / cs;
  int want[12];
  fwd_grids(B, H, G, hd, N, cs, nc, want);
  if (!grids_cover(grid, want, 12)) return -1;
  const Tiles tl = tiles_of(cs);
  Carve cv{static_cast<float*>(scratch)};
  TrainArgs a{};
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bm = Bm;
  a.Cm = Cm;
  a.y = y;
  a.state = static_cast<float*>(state);
  a.sc = cv.take((long long)B * G * nc * tl.cs64 * tl.cs64);
  a.tot = cv.take((long long)B * H * nc);
  a.states = states ? static_cast<float*>(states) : cv.take((long long)B * H * nc * hd * N);
  a.B = B, a.H = H, a.G = G, a.S = S, a.P = hd, a.N = N, a.cs = cs, a.nc = nc, a.nsplit = 1;
  a.xs = strides_at(st, 0), a.ds = strides_at(st, 1), a.bs = strides_at(st, 2);
  a.cs_ = strides_at(st, 3), a.ys = strides_at(st, 4);
  int err;
  switch (hd) {
    case 16: err = launch_fwd<16>(a, grid, s); break;
    case 32: err = launch_fwd<32>(a, grid, s); break;
    case 64: err = launch_fwd<64>(a, grid, s); break;
    default: err = launch_fwd<128>(a, grid, s); break;
  }
  return err != 0 ? err : (int)cudaGetLastError();
}

// The shared memory one block of (dtype, hd) takes at (N, cs), and how
// many such blocks fit on one SM: for bfloat16 the serve body's (pass
// 0); for float32 the training path's pass 0-3 (scores, state, chain,
// out).  Returns 0, or an error as ssd_scan_fwd does.
extern "C" int ssd_scan_occupancy(int dtype, int hd, int N, int cs, int pass,
                                  long long* smem, int* blocks) {
  if (dtype == 1) {
    Plan p;
    const int err = pass == 0 ? plan_bf16_hd(hd, N, cs, p) : -1;
    if (err != 0) return err;
    *smem = (long long)p.smem;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, p.kern, p.threads,
                                                               p.smem);
  }
  if (dtype != 0 || !hd_ok(hd) || pass < 0 || pass > 3) return -1;
  const TrainSmem sm = train_smem(hd, N, cs);
  const int words[4] = {sm.scores, sm.fwd_state, 0, sm.fwd_out};
  const int threads[4] = {128, 256, 256, 128};
  const void* kern[4] = {(const void*)ssd_fwd_scores_kernel, nullptr,
                         (const void*)ssd_fwd_chain_kernel, nullptr};
  switch (hd) {
    case 16: kern[1] = (const void*)ssd_fwd_state_kernel<16>; kern[3] = (const void*)ssd_fwd_out_kernel<16>; break;
    case 32: kern[1] = (const void*)ssd_fwd_state_kernel<32>; kern[3] = (const void*)ssd_fwd_out_kernel<32>; break;
    case 64: kern[1] = (const void*)ssd_fwd_state_kernel<64>; kern[3] = (const void*)ssd_fwd_out_kernel<64>; break;
    default: kern[1] = (const void*)ssd_fwd_state_kernel<128>; kern[3] = (const void*)ssd_fwd_out_kernel<128>; break;
  }
  *smem = 4LL * words[pass];
  const int err = raise_smem(kern[pass]);
  if (err != 0) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern[pass], threads[pass],
                                                             (size_t)*smem);
}

// The training path's shared memory at (hd, N, cs), in bytes, into
// smem[0..7]: scores, the forward's state and out passes, the
// backward's local, dx, ds, dbdc and dt passes (`fwd_plan` and
// `bwd_plan` mirror them).  Returns 0, or -1 for an unsupported head
// size.
extern "C" int ssd_scan_train_smem(int hd, int N, int cs, long long* smem) {
  if (!hd_ok(hd) || N < 1 || cs < 1) return -1;
  const TrainSmem sm = train_smem(hd, N, cs);
  const int w[8] = {sm.scores, sm.fwd_state, sm.fwd_out, sm.local, sm.dx, sm.ds, sm.dbdc, sm.dt};
  for (int i = 0; i < 8; ++i) smem[i] = 4LL * w[i];
  return 0;
}

// The backward of ssd_scan_fwd (K4-bwd) for dy (B, H, S, hd) and the final
// state's gradient dstate (B, H, hd, N) fp32 contiguous, or null: dx
// (x's dtype), ddt (B, H, S) fp32 contiguous, dB and dC (B, G, S, N) in
// x's dtype, dA (H,) fp32.  states: the forward's chunk-entry states.
// scratch: fp32, written before it is read, carved in order into the
// scores, the dscores of nsplit splits of each group's heads (each
// (B G, nc, cs64, cs64)), dS_out (B, H, nc, hd, N), cum, q and dw (B, H,
// S), the totals and <G, S_in> (B, H, nc), the d(cum) row and column
// sums (B, H, nc, npairs, 64), the paired dA terms (B, H, nc, npairs)
// and the dA partials (B, H, nc).  grid: the eight passes' grids
// (`bwd_plan`), which must cover the shapes.  Strides as for
// ssd_scan_fwd, of x, dt, B_, C_, dy, dx, dB, dC.  Returns
// cudaGetLastError() after the launches, or -1 for what it does not
// take.
extern "C" int ssd_scan_bwd(int dtype, int hd, const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* dy,
                            const void* states, const void* dstate, void* scratch, void* dx,
                            void* ddt, void* dB, void* dC, void* dA, int B, int H, int G,
                            int S, int N, int cs, int nc, int nsplit, const int* grid,
                            const long long* strides, void* stream) {
  if (!hd_ok(hd) || cs < 1 || G < 1 || H % G || nc != (S + cs - 1) / cs || nsplit < 1 ||
      nsplit > H / G)
    return -1;
  int want[24];
  bwd_grids(B, H, G, hd, N, cs, nc, nsplit, want);
  if (!grids_cover(grid, want, 24)) return -1;
  const Tiles tl = tiles_of(cs);
  const long long sq = (long long)B * G * nc * tl.cs64 * tl.cs64, bhs = (long long)B * H * S,
                  bhc = (long long)B * H * nc;
  Carve cv{static_cast<float*>(scratch)};
  TrainArgs a{};
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bm = Bm;
  a.Cm = Cm;
  a.dy = dy;
  a.states = const_cast<float*>(static_cast<const float*>(states));
  a.dstate = static_cast<const float*>(dstate);
  a.dx = dx;
  a.ddt = static_cast<float*>(ddt);
  a.dB = dB;
  a.dC = dC;
  a.dA = static_cast<float*>(dA);
  a.sc = cv.take(sq);
  a.dS = cv.take(nsplit * sq);
  a.dSo = cv.take(bhc * hd * N);
  a.cum = cv.take(bhs);
  a.q = cv.take(bhs);
  a.dw = cv.take(bhs);
  a.tot = cv.take(bhc);
  a.gs = cv.take(bhc);
  a.rr = cv.take(bhc * tl.npairs * 64);
  a.cr = cv.take(bhc * tl.npairs * 64);
  a.dar = cv.take(bhc * tl.npairs);
  a.dAp = cv.take(bhc);
  a.B = B, a.H = H, a.G = G, a.S = S, a.P = hd, a.N = N, a.cs = cs, a.nc = nc;
  a.nsplit = nsplit;
  const long long* st = strides;
  a.xs = strides_at(st, 0), a.ds = strides_at(st, 1), a.bs = strides_at(st, 2);
  a.cs_ = strides_at(st, 3), a.dys = strides_at(st, 4), a.dxs = strides_at(st, 5);
  a.dbs = strides_at(st, 6), a.dcs = strides_at(st, 7);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = -1;
  if (dtype == 0) err = launch_bwd_hd<float>(hd, a, grid, s);
  if (dtype == 1) err = launch_bwd_hd<__nv_bfloat16>(hd, a, grid, s);
  return err != 0 ? err : (int)cudaGetLastError();
}
