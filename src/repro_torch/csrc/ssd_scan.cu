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
// The fp32 body keeps fp32 CUDA-core FMAs (TF32 would not hold 2e-5):
// 64-row tiles of C against 64-row tiles of B and x, each thread a
// 4 x (hd/16) tile of y and a 4 x 4 tile of scores in registers.
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

// fp32 body: CUDA-core FMAs.
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kT = 64;         // rows i (and columns j) per tile
constexpr int kRA = kT / 16;   // tile rows per thread
constexpr int kTN = 64;        // state columns n per pass of the update

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

// Shared memory of one block, in floats (`kernels/ssd_scan.py`
// `smem_bytes` mirrors it and refuses shapes above the card's 227 KB).
size_t smem_floats(int P, int N, int cs) {
  const int NP = N + 1;
  return (size_t)P * NP + 2 * kT * NP + kT * (P + 1) + kT * (kT + 1) + 2 * cs;
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads) ssd_f32_kernel(Args a) {
  constexpr int PB = P / 16;  // y columns (and state rows) per thread
  const int N = a.N, NP = N + 1, cs = a.cs;
  extern __shared__ float smem[];
  float* sState = smem;             // [P][NP]
  float* sC = sState + P * NP;      // [kT][NP]
  float* sB = sC + kT * NP;         // [kT][NP]
  float* sX = sB + kT * NP;         // [kT][P + 1]
  float* sM = sX + kT * (P + 1);    // [kT][kT + 1]
  float* sCum = sM + kT * (kT + 1); // [cs]
  float* sDt = sCum + cs;           // [cs]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = h / (a.H / a.G);
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const float A = a.A[h];
  const T* xb = static_cast<const T*>(a.x) + b * a.xs.b + h * a.xs.h;
  const float* db = a.dt + b * a.ds.b + h * a.ds.h;
  const T* Bb = static_cast<const T*>(a.Bm) + b * a.bs.b + grp * a.bs.h;
  const T* Cb = static_cast<const T*>(a.Cm) + b * a.cs_.b + grp * a.cs_.h;
  T* yb = static_cast<T*>(a.y) + b * a.ys.b + h * a.ys.h;

  for (int i = t; i < P * NP; i += kThreads) sState[i] = 0.f;

  for (int s0 = 0; s0 < a.S; s0 += cs) {
    const int len = min(cs, a.S - s0);
    __syncthreads();  // the previous chunk is done with sDt, sCum, sB, sX
    if (a.states) store_state(entry_state(a, b, h, s0, P), sState, NP, P, N, t, kThreads);
    for (int i = t; i < len; i += kThreads) sDt[i] = db[(s0 + i) * a.ds.s];
    __syncthreads();
    if (t < 32) {  // inclusive scan of dt * A: each lane a run, then the warp
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
    const float total = sCum[len - 1];

    for (int i0 = 0; i0 < len; i0 += kT) {
      for (int idx = t; idx < kT * N; idx += kThreads) {
        const int r = idx / N, n = idx % N;
        const int i = i0 + r;
        sC[r * NP + n] = i < len ? to_f32(Cb[(s0 + i) * a.cs_.s + n]) : 0.f;
      }
      __syncthreads();

      // inter-chunk: exp(cum_i) C_i . state
      float acc[kRA][PB];
#pragma unroll
      for (int ra = 0; ra < kRA; ++ra)
#pragma unroll
        for (int pb = 0; pb < PB; ++pb) acc[ra][pb] = 0.f;
      for (int n = 0; n < N; ++n) {
        float c[kRA], st[PB];
#pragma unroll
        for (int ra = 0; ra < kRA; ++ra) c[ra] = sC[(ty + 16 * ra) * NP + n];
#pragma unroll
        for (int pb = 0; pb < PB; ++pb) st[pb] = sState[(tx + 16 * pb) * NP + n];
#pragma unroll
        for (int ra = 0; ra < kRA; ++ra)
#pragma unroll
          for (int pb = 0; pb < PB; ++pb) acc[ra][pb] += c[ra] * st[pb];
      }
#pragma unroll
      for (int ra = 0; ra < kRA; ++ra) {
        const int i = i0 + ty + 16 * ra;
        const float e = i < len ? clip_exp(sCum[i]) : 0.f;
#pragma unroll
        for (int pb = 0; pb < PB; ++pb) acc[ra][pb] *= e;
      }

      // intra-chunk, over the column tiles at or left of the diagonal
      const int j_end = min(i0 + kT, len);
      for (int j0 = 0; j0 < j_end; j0 += kT) {
        for (int idx = t; idx < kT * N; idx += kThreads) {
          const int r = idx / N, n = idx % N;
          const int j = j0 + r;
          sB[r * NP + n] = j < len ? to_f32(Bb[(s0 + j) * a.bs.s + n]) : 0.f;
        }
        for (int idx = t; idx < kT * P; idx += kThreads) {
          const int r = idx / P, d = idx % P;
          const int j = j0 + r;
          sX[r * (P + 1) + d] = j < len ? to_f32(xb[(s0 + j) * a.xs.s + d]) : 0.f;
        }
        __syncthreads();

        float sc[kRA][kRA];
#pragma unroll
        for (int ra = 0; ra < kRA; ++ra)
#pragma unroll
          for (int jb = 0; jb < kRA; ++jb) sc[ra][jb] = 0.f;
        for (int n = 0; n < N; ++n) {
          float c[kRA], bv[kRA];
#pragma unroll
          for (int ra = 0; ra < kRA; ++ra) c[ra] = sC[(ty + 16 * ra) * NP + n];
#pragma unroll
          for (int jb = 0; jb < kRA; ++jb) bv[jb] = sB[(tx + 16 * jb) * NP + n];
#pragma unroll
          for (int ra = 0; ra < kRA; ++ra)
#pragma unroll
            for (int jb = 0; jb < kRA; ++jb) sc[ra][jb] += c[ra] * bv[jb];
        }
#pragma unroll
        for (int ra = 0; ra < kRA; ++ra) {
          const int i = i0 + ty + 16 * ra;
#pragma unroll
          for (int jb = 0; jb < kRA; ++jb) {
            const int j = j0 + tx + 16 * jb;
            const bool ok = j <= i && i < len;  // j <= i < len
            sM[(ty + 16 * ra) * (kT + 1) + tx + 16 * jb] =
                ok ? sc[ra][jb] * clip_exp(sCum[i] - sCum[j]) * sDt[j] : 0.f;
          }
        }
        __syncthreads();

#pragma unroll 4
        for (int j = 0; j < kT; ++j) {
          float m[kRA], xv[PB];
#pragma unroll
          for (int ra = 0; ra < kRA; ++ra) m[ra] = sM[(ty + 16 * ra) * (kT + 1) + j];
#pragma unroll
          for (int pb = 0; pb < PB; ++pb) xv[pb] = sX[j * (P + 1) + tx + 16 * pb];
#pragma unroll
          for (int ra = 0; ra < kRA; ++ra)
#pragma unroll
            for (int pb = 0; pb < PB; ++pb) acc[ra][pb] += m[ra] * xv[pb];
        }
        __syncthreads();  // sB, sX, sM and sC are free again
      }

#pragma unroll
      for (int ra = 0; ra < kRA; ++ra) {
        const int i = i0 + ty + 16 * ra;
        if (i >= len) continue;
#pragma unroll
        for (int pb = 0; pb < PB; ++pb)
          yb[(s0 + i) * a.ys.s + tx + 16 * pb] = from_f32<T>(acc[ra][pb]);
      }
    }

    // state = exp(total) state + sum_j w_j x_j (x) B_j, w_j = exp(total - cum_j) dt_j
    const float decay = clip_exp(total);
    for (int i = t; i < P * NP; i += kThreads) sState[i] *= decay;
    for (int j0 = 0; j0 < len; j0 += kT) {
      __syncthreads();  // the scaling, or the previous tile's readers, are done
      for (int idx = t; idx < kT * N; idx += kThreads) {
        const int r = idx / N, n = idx % N;
        const int j = j0 + r;
        sB[r * NP + n] = j < len ? to_f32(Bb[(s0 + j) * a.bs.s + n]) : 0.f;
      }
      for (int idx = t; idx < kT * P; idx += kThreads) {
        const int r = idx / P, d = idx % P;
        const int j = j0 + r;
        sX[r * (P + 1) + d] =
            j < len ? to_f32(xb[(s0 + j) * a.xs.s + d]) *
                          clip_exp(total - sCum[j]) * sDt[j]
                    : 0.f;
      }
      __syncthreads();
      for (int n0 = 0; n0 < N; n0 += kTN) {
        float up[PB][kTN / 16];
#pragma unroll
        for (int pa = 0; pa < PB; ++pa)
#pragma unroll
          for (int nb = 0; nb < kTN / 16; ++nb) up[pa][nb] = 0.f;
#pragma unroll 4
        for (int j = 0; j < kT; ++j) {
          float xv[PB], bv[kTN / 16];
#pragma unroll
          for (int pa = 0; pa < PB; ++pa) xv[pa] = sX[j * (P + 1) + ty + 16 * pa];
#pragma unroll
          for (int nb = 0; nb < kTN / 16; ++nb) {
            const int n = n0 + tx + 16 * nb;
            bv[nb] = n < N ? sB[j * NP + n] : 0.f;
          }
#pragma unroll
          for (int pa = 0; pa < PB; ++pa)
#pragma unroll
            for (int nb = 0; nb < kTN / 16; ++nb) up[pa][nb] += xv[pa] * bv[nb];
        }
#pragma unroll
        for (int pa = 0; pa < PB; ++pa)
#pragma unroll
          for (int nb = 0; nb < kTN / 16; ++nb) {
            const int n = n0 + tx + 16 * nb;
            if (n < N) sState[(ty + 16 * pa) * NP + n] += up[pa][nb];
          }
      }
    }
  }
  __syncthreads();
  store_state(a.state + ((long long)b * a.H + h) * P * N, sState, NP, P, N, t, kThreads);
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

size_t f32_smem_bytes(int P, int N, int cs) { return sizeof(float) * smem_floats(P, N, cs); }

// The kernel for (dtype, hd), its threads and its shared memory
// at (N, cs), with the dynamic shared-memory limit raised to it.
struct Plan {
  const void* kern;
  int threads;
  size_t smem;
};

template <typename K>
int configure(K kern, size_t smem, size_t& done) {
  if (smem <= done) return 0;  // raised once per size; the launch is host-bound
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  done = smem;
  return 0;
}

template <int P>
int plan_f32(int N, int cs, Plan& p) {
  static size_t done = 0;
  p = Plan{(const void*)ssd_f32_kernel<float, P>, kThreads, f32_smem_bytes(P, N, cs)};
  return configure(ssd_f32_kernel<float, P>, p.smem, done);
}

template <int P>
int plan_bf16(int N, int cs, Plan& p) {
  static size_t done = 0;
  p = Plan{(const void*)ssd_bf16_kernel<P>, kTcThreads, tc_smem_bytes<P>(N, cs)};
  return configure(ssd_bf16_kernel<P>, p.smem, done);
}

template <int P>
int plan_hd(int dtype, int N, int cs, Plan& p) {
  if (dtype == 0) return plan_f32<P>(N, cs, p);
  if (dtype == 1) return plan_bf16<P>(N, cs, p);
  return -1;
}

int plan(int dtype, int hd, int N, int cs, Plan& p) {
  switch (hd) {
    case 16: return plan_hd<16>(dtype, N, cs, p);
    case 32: return plan_hd<32>(dtype, N, cs, p);
    case 64: return plan_hd<64>(dtype, N, cs, p);
    case 128: return plan_hd<128>(dtype, N, cs, p);
    default: return -1;
  }
}

// ---------------------------------------------------------------------
// Backward (K4-bwd): dx, ddt, dA, dB_ and dC_ of the scan for dy and the
// final state's gradient, in three passes, all fp32 CUDA-core math as the
// fp32 forward body (x, B_, C_ and dy may be bf16: they are read as T and
// widened).  Per chunk, with dS_out the gradient of the chunk's exit state
// and S_in its entry state (written by the forward):
//
//   (a) chain, one block a (b, h), right to left:
//       dS_in = exp(total) dS_out + sum_i exp(cum_i) dy_i (x) C_i,
//       which is the previous chunk's dS_out (the last one's is dstate).
//   (b) chunk, one block a (b, h, chunk), all chunks independent:
//       dC_i  = exp(cum_i) dy_i S_in + sum_{j<=i} dscores_ij B_j
//       dx_j  = w_j G B_j + sum_{i>=j} M_ij dy_i,   G = dS_out,
//       dB_j  = w_j G^T x_j + sum_{i>=j} dscores_ij C_i,
//       with M = scores L dt_j, dscores = (dy_i . x_j) L dt_j,
//       w_j = exp(total - cum_j) dt_j, and d(cum) from every exponent,
//       turned into d(dt A) by a reverse running sum within the chunk:
//       ddt = its direct terms + A d(dt A).  The dA partial is
//       sum_i d(cum_i) cum_i / A with each term of d(cum) paired with the
//       one it cancels (+q at i, -q at j: q (cum_i - cum_j) / A), so that
//       no running sum's rounding accumulates into it.
//       The i tiles at or below a j tile are walked with dx_j in
//       registers and dB_j in shared memory; dC_i is added into its
//       fp32 per-head partial in device memory, each element by one
//       thread, in a fixed order.
//   (c) reduce: dB_ and dC_ summed over the heads of each group, and dA
//       over (batch, chunk), in a fixed order: two calls give the same
//       bits (no atomics).
//
// What bounds it: at mamba2-1.3b's training shape (B 2, H 64, G 1, S 1024,
// hd 64, N 128, chunk 256) about 20 GFLOP against about 0.45 GB moved,
// so fp32 operations (0.3 ms at 67 TFLOP/s).  This first version stages
// 64-row tiles in shared memory and runs 4 x 4 register tiles of FMAs,
// one block of 256 threads an SM (PERF.md).

// Sums over the 16 lanes of a half warp (one tile row's threads), and
// over the warp: every lane gets the same bits.
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[ra][cb] += sum_{k < K} A[(ty + 16 ra) ars + k aks] Bv[k bks + (tx + 16 cb) bcs],
// a column tx + 16 cb >= ncol read as 0: a RA x CB register tile of a
// product of two fp32 tiles in shared memory.
template <int RA, int CB>
__device__ __forceinline__ void mm(float (&acc)[RA][CB], const float* A, int ars, int aks,
                                   const float* Bv, int bks, int bcs, int K, int ncol,
                                   int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[RA], bv[CB];
#pragma unroll
    for (int ra = 0; ra < RA; ++ra) av[ra] = A[(ty + 16 * ra) * ars + k * aks];
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) {
      const int col = tx + 16 * cb;
      bv[cb] = col < ncol ? Bv[k * bks + col * bcs] : 0.f;
    }
#pragma unroll
    for (int ra = 0; ra < RA; ++ra)
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) acc[ra][cb] += av[ra] * bv[cb];
  }
}

// kT rows of width w (rows >= rows read as 0) from src rows row0 + r
// (stride st elements) into dst (pitch ld), as fp32.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, long long st,
                                          int row0, int rows, int w, int t) {
  for (int idx = t; idx < kT * w; idx += kThreads) {
    const int r = idx / w, k = idx % w;
    dst[r * ld + k] = r < rows ? to_f32(src[(long long)(row0 + r) * st + k]) : 0.f;
  }
}

// sDt = dt over the chunk [s0, s0 + len) and sCum its inclusive running
// sum of dt A, as the forward computes it.  Ends synchronised.
__device__ void chunk_cum(const float* db, long long st, int s0, int len, float A,
                          float* sDt, float* sCum, int t) {
  for (int i = t; i < len; i += kThreads) sDt[i] = db[(long long)(s0 + i) * st];
  __syncthreads();
  if (t < 32) {
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

struct BwdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const void* dy;
  const float* states;  // (B, H, nc, hd, N) entry states from the forward
  const float* dstate;  // (B, H, hd, N), or null for a zero gradient
  float* dSo;           // (B, H, nc, hd, N) each chunk's dS_out, (a) -> (b)
  void* dx;
  float* ddt;  // (B, H, S)
  float* dBp;  // (B, H, S, N) per-head partials of dB_ and dC_
  float* dCp;
  float* dAp;  // (B, H, nc)
  void* dB;
  void* dC;
  float* dA;
  int H, G, S, N, cs, nc;
  Strides xs, ds, bs, cs_, dys, dxs, dbs, dcs;
};

// Shared memory of the backward kernels, in floats (`kernels/ssd_scan.py`
// `bwd_plan` mirrors them).  The chunk kernel's union holds S_in or G
// (hd x N), or the i tile's C and dy with the M, dscores and column
// partial tiles.
__host__ __device__ inline int bwd_union_floats(int P, int N) {
  const int tiles = kT * (N + 1) + kT * (P + 1) + 2 * kT * (kT + 1) + 16 * kT;
  return P * (N + 1) > tiles ? P * (N + 1) : tiles;
}
size_t chain_smem_floats(int P, int N, int cs) {
  return (size_t)P * (N + 1) + kT * (N + 1) + kT * (P + 1) + 2 * cs;
}
size_t chunk_smem_floats(int P, int N, int cs) {
  return (size_t)2 * kT * (N + 1) + kT * (P + 1) + bwd_union_floats(P, N) + 5 * cs + 16;
}

// (a) One block a (b, h): the chunks right to left, dS (hd x N) carried
// in shared memory; writes each chunk's dS_out.
template <typename T, int P>
__global__ void __launch_bounds__(kThreads) ssd_bwd_chain_kernel(BwdArgs a) {
  constexpr int PX = P + 1, PA = P / 16;
  const int N = a.N, NP = N + 1, cs = a.cs;
  extern __shared__ float smem[];
  float* sG = smem;           // [P][NP] the carry
  float* sC = sG + P * NP;    // [kT][NP]
  float* sDy = sC + kT * NP;  // [kT][PX] dy_i exp(cum_i)
  float* sDt = sDy + kT * PX; // [cs]
  float* sCum = sDt + cs;     // [cs]

  const int h = blockIdx.x, b = blockIdx.y;
  const int grp = h / (a.H / a.G);
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const float A = a.A[h];
  const long long bh = (long long)b * a.H + h;
  const float* db = a.dt + b * a.ds.b + h * a.ds.h;
  const T* Cb = static_cast<const T*>(a.Cm) + b * a.cs_.b + grp * a.cs_.h;
  const T* dyb = static_cast<const T*>(a.dy) + b * a.dys.b + h * a.dys.h;

  const float* ds0 = a.dstate ? a.dstate + bh * P * N : nullptr;
  for (int idx = t; idx < P * N; idx += kThreads)
    sG[(idx / N) * NP + idx % N] = ds0 ? ds0[idx] : 0.f;
  for (int c = a.nc - 1; c >= 0; --c) {
    __syncthreads();  // the carry is complete
    store_state(a.dSo + (bh * a.nc + c) * P * N, sG, NP, P, N, t, kThreads);
    if (c == 0) break;
    const int s0 = c * cs, len = min(cs, a.S - s0);
    chunk_cum(db, a.ds.s, s0, len, A, sDt, sCum, t);
    const float total = sCum[len - 1];
    for (int i0 = 0; i0 < len; i0 += kT) {
      if (i0 > 0) __syncthreads();  // the previous tile's readers are done
      const int rows = min(kT, len - i0);
      load_rows<T>(sC, NP, Cb, a.cs_.s, s0 + i0, rows, N, t);
      for (int idx = t; idx < kT * P; idx += kThreads) {
        const int r = idx / P, p = idx % P;
        sDy[r * PX + p] = r < rows ? to_f32(dyb[(long long)(s0 + i0 + r) * a.dys.s + p]) *
                                         clip_exp(sCum[i0 + r])
                                   : 0.f;
      }
      __syncthreads();
      // carry = exp(total) carry + dy'^T C over this tile, each thread its
      // own (p, n) elements
      const float f = i0 == 0 ? clip_exp(total) : 1.f;
      for (int n0 = 0; n0 < N; n0 += 64) {
        float up[PA][4] = {};
        mm<PA, 4>(up, sDy, 1, PX, sC + n0, NP, 1, kT, N - n0, ty, tx);
#pragma unroll
        for (int pa = 0; pa < PA; ++pa)
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
            const int n = n0 + tx + 16 * nb;
            if (n < N) {
              float* g = sG + (ty + 16 * pa) * NP + n;
              *g = *g * f + up[pa][nb];
            }
          }
      }
    }
  }
}

// (b) One block a (b, h, chunk).  Its shared memory holds one block an
// SM, so it may take every register a thread can have.
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_chunk_kernel(BwdArgs a) {
  constexpr int PX = P + 1, PB = P / 16, kTP = kT + 1;
  const int N = a.N, NP = N + 1, cs = a.cs;
  extern __shared__ float smem[];
  float* sB = smem;                           // [kT][NP] B_j
  float* sX = sB + kT * NP;                   // [kT][PX] x_j
  float* sDB = sX + kT * PX;                  // [kT][NP] dB_j
  float* sSt = sDB + kT * NP;                 // union: [P][NP] S_in, then G
  float* sC = sSt;                            //   [kT][NP] C_i
  float* sDy = sC + kT * NP;                  //   [kT][PX] dy_i
  float* sM = sDy + kT * PX;                  //   [kT][kTP] M
  float* sdS = sM + kT * kTP;                 //   [kT][kTP] dscores
  float* sCol = sdS + kT * kTP;               //   [16][kT] column partials
  float* sDt = sSt + bwd_union_floats(P, N);  // [cs]
  float* sCum = sDt + cs;                     // [cs]
  float* sDcum = sCum + cs;                   // [cs] d(cum) but the w dw terms
  float* sDdt = sDcum + cs;                   // [cs] ddt's direct terms
  float* sWd = sDdt + cs;                     // [cs] w_j dw_j
  float* sRed = sWd + cs;                     // [2][kThreads / 32]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (a.H / a.G);
  const int t = threadIdx.x, ty = t / 16, tx = t % 16, lane = t & 31, warp = t >> 5;
  const int s0 = c * cs, len = min(cs, a.S - s0);
  const float A = a.A[h];
  const long long bh = (long long)b * a.H + h;
  const T* xb = static_cast<const T*>(a.x) + b * a.xs.b + h * a.xs.h;
  const float* db = a.dt + b * a.ds.b + h * a.ds.h;
  const T* Bb = static_cast<const T*>(a.Bm) + b * a.bs.b + grp * a.bs.h;
  const T* Cb = static_cast<const T*>(a.Cm) + b * a.cs_.b + grp * a.cs_.h;
  const T* dyb = static_cast<const T*>(a.dy) + b * a.dys.b + h * a.dys.h;
  T* dxb = static_cast<T*>(a.dx) + b * a.dxs.b + h * a.dxs.h;
  const float* gS = a.states + (bh * a.nc + c) * P * N;  // S_in
  const float* gG = a.dSo + (bh * a.nc + c) * P * N;     // G = dS_out
  float* dCp = a.dCp + (bh * a.S + s0) * N;              // this chunk's rows
  float* dBp = a.dBp + (bh * a.S + s0) * N;

  for (int i = t; i < cs; i += kThreads) {
    sDcum[i] = 0.f;
    sDdt[i] = 0.f;
    sWd[i] = 0.f;
  }
  if (c > 0)
    for (int idx = t; idx < P * N; idx += kThreads) sSt[(idx / N) * NP + idx % N] = gS[idx];
  chunk_cum(db, a.ds.s, s0, len, A, sDt, sCum, t);
  const float total = sCum[len - 1];

  // A times this thread's share of the dA partial
  float dAs = 0.f;
  // 1. Inter-chunk: dC_i = exp(cum_i) dy_i S_in (zero in the first
  //    chunk), d(cum_i) += <C_i, dC_i>; C_i and dy_i staged in sB and sX.
  for (int i0 = 0; i0 < len; i0 += kT) {
    if (i0 > 0) __syncthreads();
    load_rows<T>(sB, NP, Cb, a.cs_.s, s0 + i0, min(kT, len - i0), N, t);
    load_rows<T>(sX, PX, dyb, a.dys.s, s0 + i0, min(kT, len - i0), P, t);
    __syncthreads();
    float dot[kRA] = {};
    for (int n0 = 0; n0 < N; n0 += 64) {
      float acc[kRA][4] = {};
      if (c > 0) mm<kRA, 4>(acc, sX, PX, 1, sSt + n0, NP, 1, P, N - n0, ty, tx);
#pragma unroll
      for (int ra = 0; ra < kRA; ++ra) {
        const int i = i0 + ty + 16 * ra;
        const float e = i < len ? clip_exp(sCum[i]) : 0.f;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const int n = n0 + tx + 16 * nb;
          if (i < len && n < N) {
            const float v = acc[ra][nb] * e;
            dCp[(long long)i * N + n] = v;
            dot[ra] += v * sB[(ty + 16 * ra) * NP + n];
          }
        }
      }
    }
#pragma unroll
    for (int ra = 0; ra < kRA; ++ra) {
      const float v = sum16(dot[ra]);
      const int i = i0 + ty + 16 * ra;
      if (tx == 0 && i < len) {
        sDcum[i] += v;
        dAs += v * sCum[i];
      }
    }
  }

  float gs = 0.f;  // this thread's share of <G, S_in>
  for (int j0 = 0; j0 < len; j0 += kT) {
    const int jrows = min(kT, len - j0);
    __syncthreads();  // every reader of the union, sB and sX is done
    for (int idx = t; idx < P * N; idx += kThreads) {
      const float g = gG[idx];
      sSt[(idx / N) * NP + idx % N] = g;
      if (j0 == 0 && c > 0) gs += g * gS[idx];
    }
    load_rows<T>(sB, NP, Bb, a.bs.s, s0 + j0, jrows, N, t);
    load_rows<T>(sX, PX, xb, a.xs.s, s0 + j0, jrows, P, t);
    __syncthreads();

    // 2. The state update's terms: dx_j = w_j G B_j, dw_j = <x_j, G B_j>,
    //    dB_j = w_j G^T x_j.
    float dxa[kRA][PB] = {};
    mm<kRA, PB>(dxa, sB, NP, 1, sSt, 1, NP, N, P, ty, tx);
    float wj[kRA];
#pragma unroll
    for (int ra = 0; ra < kRA; ++ra) {
      const int r = ty + 16 * ra, j = j0 + r;
      const float e = j < len ? clip_exp(total - sCum[j]) : 0.f;
      wj[ra] = j < len ? e * sDt[j] : 0.f;
      float dw = 0.f;
#pragma unroll
      for (int pb = 0; pb < PB; ++pb) {
        dw += sX[r * PX + tx + 16 * pb] * dxa[ra][pb];
        dxa[ra][pb] *= wj[ra];
      }
      dw = sum16(dw);
      if (tx == 0 && j < len) {
        sDdt[j] += e * dw;
        sWd[j] = wj[ra] * dw;
        dAs += wj[ra] * dw * (total - sCum[j]);
      }
    }
    for (int n0 = 0; n0 < N; n0 += 64) {
      float acc[kRA][4] = {};
      mm<kRA, 4>(acc, sX, PX, 1, sSt + n0, NP, 1, P, N - n0, ty, tx);
#pragma unroll
      for (int ra = 0; ra < kRA; ++ra)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const int n = n0 + tx + 16 * nb;
          if (n < N) sDB[(ty + 16 * ra) * NP + n] = wj[ra] * acc[ra][nb];
        }
    }

    // 3. Intra-chunk, over the i tiles at or below this j tile.
    for (int i0 = j0; i0 < len; i0 += kT) {
      const int irows = min(kT, len - i0);
      __syncthreads();  // G, or the previous i tile, is free
      load_rows<T>(sC, NP, Cb, a.cs_.s, s0 + i0, irows, N, t);
      load_rows<T>(sDy, PX, dyb, a.dys.s, s0 + i0, irows, P, t);
      __syncthreads();
      float sc[kRA][kRA] = {}, dm[kRA][kRA] = {};
      mm<kRA, kRA>(sc, sC, NP, 1, sB, 1, NP, N, kT, ty, tx);   // C_i . B_j
      mm<kRA, kRA>(dm, sDy, PX, 1, sX, 1, PX, P, kT, ty, tx);  // dy_i . x_j
      // M = sc L dt_j, dscores = dm L dt_j; R = dm sc L feeds ddt_j
      // (column sums) and d(cum): + sum_j dt_j R at i, - dt_j sum_i R at j
      float rq[kRA] = {}, colr[kRA] = {};
#pragma unroll
      for (int ra = 0; ra < kRA; ++ra) {
        const int ii = ty + 16 * ra, i = i0 + ii;
        const float ci = i < len ? sCum[i] : 0.f;
#pragma unroll
        for (int jb = 0; jb < kRA; ++jb) {
          const int jj = tx + 16 * jb, j = j0 + jj;
          const bool ok = j <= i && i < len;
          const float dc = ok ? ci - sCum[j] : 0.f;
          const float L = ok ? clip_exp(dc) : 0.f;
          const float dtj = ok ? sDt[j] : 0.f;
          const float R = dm[ra][jb] * sc[ra][jb] * L;
          sM[ii * kTP + jj] = sc[ra][jb] * L * dtj;
          sdS[ii * kTP + jj] = dm[ra][jb] * L * dtj;
          rq[ra] += dtj * R;
          colr[jb] += R;
          dAs += dtj * R * dc;
        }
      }
#pragma unroll
      for (int ra = 0; ra < kRA; ++ra) {
        const float v = sum16(rq[ra]);
        const int i = i0 + ty + 16 * ra;
        if (tx == 0 && i < len) sDcum[i] += v;
      }
#pragma unroll
      for (int jb = 0; jb < kRA; ++jb) sCol[ty * kT + tx + 16 * jb] = colr[jb];
      __syncthreads();
      if (t < kT && j0 + t < len) {
        float s = 0.f;
        for (int y = 0; y < 16; ++y) s += sCol[y * kT + t];
        sDdt[j0 + t] += s;
        sDcum[j0 + t] -= sDt[j0 + t] * s;
      }
      // dx_j += M^T dy_i
      mm<kRA, PB>(dxa, sM, 1, kTP, sDy, PX, 1, kT, P, ty, tx);
      for (int n0 = 0; n0 < N; n0 += 64) {
        // dB_j += dscores^T C_i
        float acc[kRA][4] = {};
        mm<kRA, 4>(acc, sdS, 1, kTP, sC + n0, NP, 1, kT, N - n0, ty, tx);
#pragma unroll
        for (int ra = 0; ra < kRA; ++ra)
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
            const int n = n0 + tx + 16 * nb;
            if (n < N) sDB[(ty + 16 * ra) * NP + n] += acc[ra][nb];
          }
        // dC_i += dscores B_j
        float acd[kRA][4] = {};
        mm<kRA, 4>(acd, sdS, kTP, 1, sB + n0, NP, 1, kT, N - n0, ty, tx);
#pragma unroll
        for (int ra = 0; ra < kRA; ++ra) {
          const int i = i0 + ty + 16 * ra;
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
            const int n = n0 + tx + 16 * nb;
            if (i < len && n < N) dCp[(long long)i * N + n] += acd[ra][nb];
          }
        }
      }
    }

    // dx_j and dB_j are complete
#pragma unroll
    for (int ra = 0; ra < kRA; ++ra) {
      const int r = ty + 16 * ra, j = j0 + r;
      if (j >= len) continue;
#pragma unroll
      for (int pb = 0; pb < PB; ++pb)
        dxb[(long long)(s0 + j) * a.dxs.s + tx + 16 * pb] = from_f32<T>(dxa[ra][pb]);
      for (int n = tx; n < N; n += 16) dBp[(long long)j * N + n] = sDB[r * NP + n];
    }
  }

  // d(total) = sum_j w_j dw_j + exp(total) <G, S_in>; then the reverse
  // running sum of d(cum) gives d(dt A) at every row
  gs = warp_sum(gs);
  dAs = warp_sum(dAs);
  if (lane == 0) {
    sRed[warp] = gs;
    sRed[kThreads / 32 + warp] = dAs;
  }
  __syncthreads();  // every update of sDcum, sDdt and sWd is done too
  if (warp == 0) {
    float u = 0.f;
    for (int j = lane; j < len; j += 32) u += sWd[j];
    u = warp_sum(u);
    const float g8 = warp_sum(lane < kThreads / 32 ? sRed[lane] : 0.f);
    const float a8 = warp_sum(lane < kThreads / 32 ? sRed[kThreads / 32 + lane] : 0.f);
    const float dtot = u + clip_exp(total) * g8;
    const int per = (len + 31) / 32, lo = lane * per, hi = min(lo + per, len);
    float run = 0.f;
    for (int k = hi - 1; k >= lo; --k) {
      run += sDcum[k] - sWd[k] + (k == len - 1 ? dtot : 0.f);
      sDcum[k] = run;
    }
    float incl = run;  // the runs of this lane and the lanes after it
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_down_sync(0xffffffffu, incl, o);
      if (lane + o < 32) incl += v;
    }
    const float after = incl - run;
    float* ddt = a.ddt + bh * a.S + s0;
    for (int k = lo; k < hi; ++k) ddt[k] = sDdt[k] + A * (sDcum[k] + after);
    // d(total) pairs with nothing: its term is d(total) total / A
    if (lane == 0) a.dAp[bh * a.nc + c] = (a8 + clip_exp(total) * g8 * total) / A;
  }
}

// (c) dB_, dC_ (B, G, S, N): the per-head partials summed over each
// group's heads in head order; dA (H,): the partials summed over batch
// and chunk in order.  One thread an element of (S, N).
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_reduce_kernel(BwdArgs a) {
  const int g = blockIdx.y, b = blockIdx.z;
  const int hg = a.H / a.G;
  if (blockIdx.x == 0 && g == 0 && b == 0)
    for (int h = threadIdx.x; h < a.H; h += kThreads) {
      float s = 0.f;
      for (int bb = 0; bb < (int)gridDim.z; ++bb)
        for (int c = 0; c < a.nc; ++c) s += a.dAp[((long long)bb * a.H + h) * a.nc + c];
      a.dA[h] = s;
    }
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= a.S * a.N) return;
  const int s = e / a.N, n = e % a.N;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < hg; ++k) {
    const long long off = ((long long)b * a.H + g * hg + k) * a.S * a.N + e;
    sb += a.dBp[off];
    sc += a.dCp[off];
  }
  static_cast<T*>(a.dB)[b * a.dbs.b + g * a.dbs.h + s * a.dbs.s + n] = from_f32<T>(sb);
  static_cast<T*>(a.dC)[b * a.dcs.b + g * a.dcs.h + s * a.dcs.s + n] = from_f32<T>(sc);
}

template <typename T, int P>
int launch_bwd(const BwdArgs& a, const int* grid, cudaStream_t stream) {
  static size_t done_chain = 0, done_chunk = 0;
  const size_t chain = sizeof(float) * chain_smem_floats(P, a.N, a.cs);
  const size_t chunk = sizeof(float) * chunk_smem_floats(P, a.N, a.cs);
  int err = configure(ssd_bwd_chain_kernel<T, P>, chain, done_chain);
  if (err != 0) return err;
  err = configure(ssd_bwd_chunk_kernel<T, P>, chunk, done_chunk);
  if (err != 0) return err;
  BwdArgs args = a;
  void* params[] = {&args};
  cudaError_t e = cudaLaunchKernel((const void*)ssd_bwd_chain_kernel<T, P>,
                                   dim3(grid[0], grid[1], grid[2]), dim3(kThreads), params,
                                   chain, stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernel((const void*)ssd_bwd_chunk_kernel<T, P>, dim3(grid[3], grid[4], grid[5]),
                       dim3(kThreads), params, chunk, stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernel((const void*)ssd_bwd_reduce_kernel<T>, dim3(grid[6], grid[7], grid[8]),
                       dim3(kThreads), params, 0, stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_hd(int hd, const BwdArgs& a, const int* grid, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_bwd<T, 16>(a, grid, stream);
    case 32: return launch_bwd<T, 32>(a, grid, stream);
    case 64: return launch_bwd<T, 64>(a, grid, stream);
    case 128: return launch_bwd<T, 128>(a, grid, stream);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B_, C_ and y; dt, A and the state
// are float32).  Strides are in elements: (batch, head, seq) of x, dt,
// B_, C_ and y, in that order ("head" is the group axis of B_ and C_).
// cs is the chunk length, 1 <= cs <= S.  states, when not null, receives
// each chunk's entry state (B, H, ceil(S / cs), hd, N) fp32 contiguous,
// the first one zero (the backward's input; null when serving).
// Returns cudaGetLastError() after the launch, or -1 for an unsupported
// dtype / head size.
extern "C" int ssd_scan_fwd(int dtype, int hd, const void* x,
                            const void* dt, const void* A, const void* Bm,
                            const void* Cm, void* y, void* state, void* states,
                            int B, int H, int G, int S, int N, int cs,
                            const long long* strides, void* stream) {
  Plan p;
  const int err = plan(dtype, hd, N, cs, p);
  if (err != 0) return err;
  const long long* st = strides;
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A), Bm,
         Cm, y, static_cast<float*>(state), static_cast<float*>(states), H, G, S, N, cs,
         Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
         Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
         Strides{st[12], st[13], st[14]}};
  void* params[] = {&a};
  const dim3 grid(H, B);
  const cudaError_t e = cudaLaunchKernel(p.kern, grid, dim3(p.threads), params,
                                         p.smem, static_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The shared memory one block of (dtype, hd) takes at (N, cs), and how
// many such blocks fit on one SM.  Returns 0, or an error as
// ssd_scan_fwd does.
extern "C" int ssd_scan_occupancy(int dtype, int hd, int N, int cs,
                                  long long* smem, int* blocks) {
  Plan p;
  const int err = plan(dtype, hd, N, cs, p);
  if (err != 0) return err;
  *smem = (long long)p.smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, p.kern, p.threads,
                                                             p.smem);
}

// The backward of ssd_scan_fwd (K4-bwd) for dy (B, H, S, hd) and the final
// state's gradient dstate (B, H, hd, N) fp32 contiguous, or null: dx
// (x's dtype), ddt (B, H, S) fp32 contiguous, dB and dC (B, G, S, N) in
// x's dtype, dA (H,) fp32.  states: the forward's chunk-entry states;
// dSo (B, H, nc, hd, N), dBp and dCp (B, H, S, N) and dAp (B, H, nc): fp32
// scratch, written before it is read.  grid: the chain, chunk and reduce
// grids (x, y, z each), which must be (H, B, 1), (nc, H, B) and
// (ceil(S N / 256), G, B) with nc = ceil(S / cs).  Strides as for
// ssd_scan_fwd, of x, dt, B_, C_, dy, dx, dB, dC.  Returns
// cudaGetLastError() after the three launches, or -1 for what it does
// not take.
extern "C" int ssd_scan_bwd(int dtype, int hd, const void* x, const void* dt,
                            const void* A, const void* Bm, const void* Cm,
                            const void* dy, const void* states, const void* dstate,
                            void* dSo, void* dBp, void* dCp, void* dAp, void* dx,
                            void* ddt, void* dB, void* dC, void* dA, int B, int H,
                            int G, int S, int N, int cs, int nc, const int* grid,
                            const long long* strides, void* stream) {
  if (cs < 1 || G < 1 || H % G || nc != (S + cs - 1) / cs) return -1;
  const int want[9] = {H, B, 1, nc, H, B, (S * N + kThreads - 1) / kThreads, G, B};
  for (int i = 0; i < 9; ++i)
    if (grid[i] != want[i]) return -1;
  const long long* st = strides;
  const BwdArgs a{x, static_cast<const float*>(dt), static_cast<const float*>(A), Bm, Cm,
                  dy, static_cast<const float*>(states), static_cast<const float*>(dstate),
                  static_cast<float*>(dSo), dx, static_cast<float*>(ddt),
                  static_cast<float*>(dBp), static_cast<float*>(dCp),
                  static_cast<float*>(dAp), dB, dC, static_cast<float*>(dA), H, G, S, N,
                  cs, nc, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
                  Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
                  Strides{st[12], st[13], st[14]}, Strides{st[15], st[16], st[17]},
                  Strides{st[18], st[19], st[20]}, Strides{st[21], st[22], st[23]}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd_hd<float>(hd, a, grid, s);
  if (dtype == 1) return launch_bwd_hd<__nv_bfloat16>(hd, a, grid, s);
  return -1;
}

// The shared memory of a chain and of a chunk block of the backward at
// (hd, N, cs), in bytes, into smem[0] and smem[1] (`bwd_plan` mirrors
// them).  Returns 0, or -1 for an unsupported head size.
extern "C" int ssd_scan_bwd_plan(int hd, int N, int cs, long long* smem) {
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128) return -1;
  smem[0] = (long long)(sizeof(float) * chain_smem_floats(hd, N, cs));
  smem[1] = (long long)(sizeof(float) * chunk_smem_floats(hd, N, cs));
  return 0;
}
