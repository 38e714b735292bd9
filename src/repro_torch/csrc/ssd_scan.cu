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
// The fp32 body (training) is the training path's four forward passes
// below, chunk-parallel, every product on the tensor cores as 3xTF32,
// which holds 2e-5 where one TF32 product would not; their machinery is
// in ssd_train.cuh (which describes the passes), the backward's passes
// in ssd_scan_bwd.cu, a library of its own.
//
// Layout: x (B, H, S, hd), dt (B, H, S) fp32, B_ and C_ (B, G, S, N) and
// y (B, H, S, hd) are addressed through their (batch, head, seq) strides
// with the last dimension contiguous, so the model passes transposed
// views of its (B, S, H, hd) and (B, S, G, N) activations and nothing is
// copied; for bf16 every row starts on 16 bytes and N is a multiple of 8
// and at most 128 (the wrapper checks).  Head h reads group h / (H / G).  A (H,) fp32;
// the final state (B, H, hd, N) fp32 contiguous.

#include "ssd_train.cuh"

namespace {

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

__global__ void __launch_bounds__(128) ssd_fwd_scores_kernel(TrainArgs a) {
  scores_tile<float>(a);
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

template <int P>
int launch_fwd(TrainArgs& a, const int* grid, cudaStream_t s) {
  const TrainSmem sm = train_smem(P, a.N, a.cs);
  int err = run(ssd_fwd_scores_kernel, grid, 128, 4 * sm.scores, a, s);
  if (!err) err = run(ssd_fwd_state_kernel<P>, grid + 3, 256, 4 * sm.fwd_state, a, s);
  if (!err) err = run(ssd_fwd_chain_kernel, grid + 6, 256, 0, a, s);
  if (!err) err = run(ssd_fwd_out_kernel<P>, grid + 9, 128, 4 * sm.fwd_out, a, s);
  return err;
}

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
