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
// What bounds it on this card: at the server's shapes (S = 128..200,
// hd 128 / 256, 10–12 heads) a call is about 0.2 GFLOP, a fraction of a
// microsecond on the bf16 tensor cores, and its inputs fit in L2.  It is
// bound by latency and by L2 traffic: every q-tile of every query head
// copies its KV prefix from L2 again (each K/V tile is read once per
// query head of its GQA group), and these copies overlap the math only
// in part.  The bf16 body:
// - Each warp owns 16 query rows (FlashAttention-2 style); a block of
//   kTcWarps warps owns kBQ = 32 rows, so the grid at S = 128 holds
//   160–192 blocks for 132 SMs.  The heaviest causal q-tiles launch
//   first.
// - Q·Kᵀ and P·V run on `mma.sync.m16n8k16` (bf16 in, fp32 out), with
//   operands read from shared memory by `ldmatrix` (`.trans` for V).
//   The online softmax runs on the accumulator fragments in registers
//   (row max and sum over 4-lane quads), and P turns into bf16 A
//   fragments in registers that feed P·V directly.
// - K and V tiles stay bf16 in shared memory, copied by 16-byte
//   `cp.async` into a ring of three tiles (two at hd 256, where a third
//   would leave room for one block an SM): the next tiles are in flight
//   while this one is computed.  Rows are padded by 16 bytes, so the
//   eight rows an `ldmatrix` reads fall in eight different bank groups.
// - Q stays in shared memory and is read per k-step, which keeps the
//   16 × hd fp32 accumulator (128 registers a thread at hd 256) the
//   only large thing in registers.
// Two variants were measured on the H100 and dropped: splitting a
// block's KV walk between two warp pairs, and packing a GQA group's
// heads into one block (which cuts the L2 traffic); neither was faster
// at S = 128.  `wgmma` and TMA are not used: a 64-row `wgmma` tile would
// leave at most 96 blocks at these shapes, and a TMA descriptor needs
// host work on every call for these strided views on a host-bound
// path.  They are the next step once prompts are long enough to be
// bound by the tensor cores.
// The fp32 body keeps fp32 CUDA-core math (TF32 would not hold 2e-5):
// 32 rows a block, 8 a warp, K padded by one float per row so 32 lanes
// reading 32 keys hit 32 banks.  Both bodies share the KV range and the
// mask: the causal / window bound sets the loop's limits, so fully
// masked KV tiles are never loaded, and the ragged edge (Sq or Sk not a
// multiple of the tile) is masked element by element: rows past Sq are
// not stored, keys past Sk are zero-filled and masked.
//
// Layout: q (B, H, Sq, hd), k/v (B, KV, Sk, hd), o (B, H, Sq, hd), each
// addressed through (batch, head, seq) strides with hd contiguous; for
// bf16 every row starts on 16 bytes (the wrapper checks).  The model
// passes permuted views of its (B, S, H, hd) activations and nothing is
// copied.  Query head h reads KV head h / (H / KV).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBQ = 32;  // query rows per block (both bodies)
constexpr int kBK = 32;  // keys per KV tile (both bodies)

struct Strides {
  long long b, h, s;
};

// The KV range [k_lo, k_hi) that any row of the q-tile starting at q0 can
// see: causal stops at the tile's last row, the window starts at the
// first row's window; k_lo is rounded down to a tile.
__device__ __forceinline__ void kv_range(int q0, int Sq, int Sk, int causal,
                                         int window, int& k_lo, int& k_hi) {
  const int q_last = min(q0 + kBQ, Sq) - 1;
  k_hi = causal ? min(Sk, q_last + 1) : Sk;
  k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  k_lo = (k_lo / kBK) * kBK;
}

__device__ __forceinline__ bool visible(int qi, int kj, int Sk, int causal,
                                        int window) {
  bool ok = kj < Sk;
  if (causal) ok = ok && kj <= qi;
  if (window > 0) ok = ok && kj > qi - window;
  return ok;
}

// ---------------------------------------------------------------------
// fp32 body: CUDA-core FMAs.

constexpr int kF32Warps = 4;
constexpr int kRowsPerWarp = kBQ / kF32Warps;

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

template <int HD>
__global__ void __launch_bounds__(kF32Warps * 32)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int H,
                 int KV, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                 Strides os, int causal, int window, float scale) {
  constexpr int DPL = (HD + 31) / 32;  // accumulator columns per lane
  constexpr int KPAD = HD + 1;         // padded K row: conflict-free reads
  extern __shared__ float smem[];
  float* sq = smem;                 // [kBQ][HD]
  float* sk = sq + kBQ * HD;        // [kBK][KPAD]
  float* sv = sk + kBK * KPAD;      // [kBK][HD]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nthreads = kF32Warps * 32;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  float* ob = o + b * os.b + h * os.h;

  for (int i = threadIdx.x; i < kBQ * HD; i += nthreads) {
    const int r = i / HD, d = i % HD;
    const int qi = q0 + r;
    sq[i] = qi < Sq ? qb[qi * qs.s + d] : 0.f;
  }
  int k_lo, k_hi;
  kv_range(q0, Sq, Sk, causal, window, k_lo, k_hi);

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
      sk[r * KPAD + d] = in ? kb[kj * ks.s + d] : 0.f;
      sv[r * HD + d] = in ? vb[kj * vs.s + d] : 0.f;
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
      const float sc = visible(qi, kj, Sk, causal, window) ? s[r] * scale : kNegInf;
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
    if (lse != nullptr && lane == 0)
      lse[((long long)b * H + h) * Sq + qi] = m[r] + logf(fmaxf(l[r], 1e-30f));
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) ob[qi * os.s + d] = acc[r][i] * inv;
    }
  }
}

// ---------------------------------------------------------------------
// bf16 body: tensor cores.

constexpr int kTcWarps = kBQ / 16;  // 16 query rows per warp

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
// c (16×8, fp32) += a (16×16, bf16) · b (16×8, bf16).
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

template <int HD>
__host__ __device__ constexpr int tc_ld() { return HD + 8; }  // padded row
// K/V tiles in the ring: three up to hd 128; two at hd 256, where a
// third would leave room for one block an SM.
template <int HD>
__host__ __device__ constexpr int tc_stages() { return HD <= 128 ? 3 : 2; }
template <int HD>
constexpr size_t tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * tc_ld<HD>() * (kBQ + 2 * tc_stages<HD>() * kBK);
}

template <int HD>
__global__ void __launch_bounds__(kTcWarps * 32)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  int H, int KV, int Sq, int Sk,
                  Strides qs, Strides ks, Strides vs, Strides os, int causal,
                  int window, float scale) {
  constexpr int LD = tc_ld<HD>();
  constexpr int ST = tc_stages<HD>();
  constexpr int NV = HD / 8;        // 16-byte vectors per row
  constexpr int NT = kBK / 8;       // score n-tiles per KV tile
  constexpr int ON = HD / 8;        // output n-tiles
  constexpr int kThreads = kTcWarps * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBQ][LD]
  __nv_bfloat16* sK = sQ + kBQ * LD;                               // [ST][kBK][LD]
  __nv_bfloat16* sV = sK + ST * kBK * LD;                          // [ST][kBK][LD]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + kvh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kvh * vs.h;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;

  int k_lo, k_hi;
  kv_range(q0, Sq, Sk, causal, window, k_lo, k_hi);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;

  for (int e = tid; e < kBQ * NV; e += kThreads) {
    const int r = e / NV, c = e % NV;
    const bool ok = q0 + r < Sq;
    cp_async16(sQ + r * LD + c * 8, qb + (ok ? q0 + r : 0) * qs.s + c * 8, ok);
  }
  auto load_tile = [&](int t, int buf) {
    const int k0 = k_lo + t * kBK;
    for (int e = tid; e < kBK * NV; e += kThreads) {
      const int r = e / NV, c = e % NV;
      const bool ok = k0 + r < Sk;
      const long long kj = ok ? k0 + r : 0;
      cp_async16(sK + (buf * kBK + r) * LD + c * 8, kb + kj * ks.s + c * 8, ok);
      cp_async16(sV + (buf * kBK + r) * LD + c * 8, vb + kj * vs.s + c * 8, ok);
    }
  };
  // The ring: tile t goes to buffer t % ST, and ST − 1 tiles are in
  // flight ahead of the one computed.  Every step commits one group
  // (empty past the last tile), so wait_group counts tiles.
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (t < n_tiles) load_tile(t, t);
    cp_async_commit();  // the first group also holds Q
  }

  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units
  const int r0 = q0 + warp * 16 + (lane >> 2);    // this thread's rows
  const int r1 = r0 + 8;
  float acc[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  // ldmatrix lane offsets: A (Q) and trans-B (V) take matrix (lane >> 3)
  // as rows +8 for bit 0 and columns +8 for bit 1; non-trans B (K) the
  // other way round.
  const int lr = lane & 7, mb0 = (lane >> 3) & 1, mb1 = lane >> 4;
  const __nv_bfloat16* qa = sQ + (warp * 16 + lr + mb0 * 8) * LD + mb1 * 8;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t % ST;
    cp_async_wait<ST - 2>();  // tile t has landed
    __syncthreads();          // ... for every thread, and tile t − 1 is consumed
    if (t + ST - 1 < n_tiles) load_tile(t + ST - 1, (t + ST - 1) % ST);
    cp_async_commit();
    const int k0 = k_lo + t * kBK;
    const __nv_bfloat16* kt = sK + buf * kBK * LD;
    const __nv_bfloat16* vt = sV + buf * kBK * LD;

    // S = Q · Kᵀ on the tensor cores.
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, qa + kk * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kt + (np * 16 + lr + mb1 * 8) * LD + kk * 16 + mb0 * 8);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // Mask, scale, and the online softmax on the fragments: a thread
    // holds columns 2·(lane % 4) + {0, 1} of each n-tile for rows r0, r1.
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
        const int qi = e < 2 ? r0 : r1;
        s[n][e] = visible(qi, kj, Sk, causal, window) ? s[n][e] * sl2 : kNegInf;
        if (e < 2) mx0 = fmaxf(mx0, s[n][e]);
        else mx1 = fmaxf(mx1, s[n][e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      ls0 += s[n][0] + s[n][1];
      ls1 += s[n][2] + s[n][3];
    }
    l0 = l0 * al0 + ls0;  // this thread's share of the row sum
    l1 = l1 * al1 + ls1;
#pragma unroll
    for (int n = 0; n < ON; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

    // O += P · V: P's accumulator fragments are the A fragments of the
    // next product once rounded to bf16.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < HD / 16; ++dn) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vt + (kk * 16 + lr + mb0 * 8) * LD + dn * 16 + mb1 * 8);
        mma_bf16(acc[2 * dn], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * dn + 1], pa, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();  // a block with no tile still copied Q

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (lse != nullptr && (lane & 3) == 0) {  // m, l are in log2 units
    float* lr_ = lse + ((long long)b * H + h) * Sq;
    if (r0 < Sq) lr_[r0] = (m0 + log2f(fmaxf(l0, 1e-30f))) * kLn2;
    if (r1 < Sq) lr_[r1] = (m1 + log2f(fmaxf(l1, 1e-30f))) * kLn2;
  }
  const int dc = (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < ON; ++n) {
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * os.s + n * 8 + dc) =
          __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * os.s + n * 8 + dc) =
          __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

// ---------------------------------------------------------------------
// Backward (FlashAttention-2): recompute P = exp(S·scale − lse) tile by
// tile from the forward's log-sum-exp, never the (Sq, Sk) matrix.
//
// - `bwd_dot_kernel`: D = rowsum(dO ∘ O) in fp32, one warp a row.
// - `bwd_dkdv_kernel`: one block a (batch, KV head, KV tile of kBK
//   keys).  It walks the G query heads of its GQA group and, for each,
//   the q tiles that can see its keys (the causal / window bounds of the
//   forward give the range), and accumulates dV += Pᵀ dO and
//   dK += dSᵀ Q · scale with dS = P ∘ (dO Vᵀ − D).  The group's sum stays
//   inside the block: no atomics, so the gradients are the same bits
//   from run to run.
// - `bwd_dq_kernel`: one block a (batch, head, q tile) walks the KV tiles
//   its rows see, dQ += dS K · scale.
// Both bodies work in fp32 on the CUDA cores for either input type
// (bf16 is widened as it is staged into shared memory).  The score tile
// is computed with lane j on key j and a warp on 4 query rows; the
// accumulation with 8 threads a row of the output tile, each on the
// columns d ≡ t (mod 8).  Shared rows are padded by one float, so the 32
// keys a warp reads fall in 32 banks.  At hd 256 a block holds 4 tiles
// of 32 × 257 floats and two 32 × 33 ones: 140 KB, one block an SM.
// What bounds it: shared-memory traffic of the CUDA-core products (about
// one load an FMA); the tensor cores (`mma.sync` / `wgmma`) are the next
// step.

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdRows = kBQ / kBwdWarps;  // score rows a warp
static_assert(kBQ == 32 && kBK == 32, "the backward maps a lane to a key");

__device__ __forceinline__ float ld_f32(const float* p) { return *p; }
__device__ __forceinline__ float ld_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st_val(float* p, float x) { *p = x; }
__device__ __forceinline__ void st_val(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int HD>
__host__ __device__ constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (4 * 32 * (HD + 1) + 2 * 32 * (32 + 1) + 2 * 32);
}

// Stage rows [r0, r0 + 32) of a (seq, hd) slice into a padded fp32 tile;
// rows at or past n are zero.
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           long long ss, int r0, int n) {
  for (int e = threadIdx.x; e < 32 * HD; e += kBwdThreads) {
    const int r = e / HD, c = e % HD;
    dst[r * (HD + 1) + c] = r0 + r < n ? ld_f32(src + (r0 + r) * ss + c) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
               float* __restrict__ dsum, int H, int Sq, int hd, Strides os,
               Strides ds) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kBwdWarps + warp;
  const int h = blockIdx.y, b = blockIdx.z;
  if (qi >= Sq) return;
  const T* orow = o + b * os.b + h * os.h + qi * os.s;
  const T* drow = dout + b * ds.b + h * ds.h + qi * ds.s;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc += ld_f32(orow + d) * ld_f32(drow + d);
  acc = warp_sum(acc);
  if (lane == 0) dsum[((long long)b * H + h) * Sq + qi] = acc;
}

// The score tile's entries of this thread: rows warp + 8 r (r < 4) and
// key lane; P and dS = P (dP − D) into sP, sdS ([32][33]).
template <int HD>
__device__ __forceinline__ void bwd_scores(
    const float* sQ, const float* sdO, const float* sK, const float* sV,
    const float* sL, const float* sD, float* sP, float* sdS, int q0, int k0,
    int Sq, int Sk, int causal, int window, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s[kBwdRows], dp[kBwdRows];
#pragma unroll
  for (int r = 0; r < kBwdRows; ++r) s[r] = dp[r] = 0.f;
  const float* krow = sK + lane * (HD + 1);
  const float* vrow = sV + lane * (HD + 1);
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    const float kd = krow[d], vd = vrow[d];
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) {
      const int i = warp + kBwdWarps * r;
      s[r] = fmaf(sQ[i * (HD + 1) + d], kd, s[r]);
      dp[r] = fmaf(sdO[i * (HD + 1) + d], vd, dp[r]);
    }
  }
  const int kj = k0 + lane;
#pragma unroll
  for (int r = 0; r < kBwdRows; ++r) {
    const int i = warp + kBwdWarps * r;
    const int qi = q0 + i;
    const bool vis = qi < Sq && visible(qi, kj, Sk, causal, window);
    const float p = vis ? expf(s[r] * scale - sL[i]) : 0.f;
    sP[i * 33 + lane] = p;
    sdS[i * 33 + lane] = p * (dp[r] - sD[i]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dsum,
                T* __restrict__ dk, T* __restrict__ dv, int H, int KV, int Sq,
                int Sk, Strides qs, Strides ks, Strides vs, Strides ds,
                Strides dks, Strides dvs, int causal, int window,
                float scale) {
  constexpr int LD = HD + 1, CPT = HD / 8;  // columns a thread
  extern __shared__ float bsm[];
  float* sK = bsm;
  float* sV = sK + 32 * LD;
  float* sQ = sV + 32 * LD;
  float* sdO = sQ + 32 * LD;
  float* sP = sdO + 32 * LD;
  float* sdS = sP + 32 * 33;
  float* sL = sdS + 32 * 33;
  float* sD = sL + 32;

  const int k0 = blockIdx.x * kBK;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, row = tid >> 3, col = tid & 7;

  stage_rows<T, HD>(sK, k + b * ks.b + kvh * ks.h, ks.s, k0, Sk);
  stage_rows<T, HD>(sV, v + b * vs.b + kvh * vs.h, vs.s, k0, Sk);
  float adk[CPT], adv[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) adk[c] = adv[c] = 0.f;

  // the q rows that can see keys [k0, k0 + kBK)
  const int q_lo = causal ? (k0 / kBQ) * kBQ : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + kBK - 1 + window) : Sq;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* db = dout + b * ds.b + h * ds.h;
    const float* lb = lse + ((long long)b * H + h) * Sq;
    const float* Db = dsum + ((long long)b * H + h) * Sq;
    for (int q0 = q_lo; q0 < q_hi; q0 += kBQ) {
      __syncthreads();  // the previous tile's readers are done
      stage_rows<T, HD>(sQ, qb, qs.s, q0, Sq);
      stage_rows<T, HD>(sdO, db, ds.s, q0, Sq);
      if (tid < 32) {
        sL[tid] = q0 + tid < Sq ? lb[q0 + tid] : 0.f;
        sD[tid] = q0 + tid < Sq ? Db[q0 + tid] : 0.f;
      }
      __syncthreads();
      bwd_scores<HD>(sQ, sdO, sK, sV, sL, sD, sP, sdS, q0, k0, Sq, Sk, causal,
                     window, scale);
      __syncthreads();
      // dV[row] += Σ_i P[i][row] dO[i];  dK[row] += Σ_i dS[i][row] Q[i]
      for (int i = 0; i < kBQ; ++i) {
        const float p = sP[i * 33 + row], dsv = sdS[i * 33 + row];
        const float* qr = sQ + i * LD + col;
        const float* dr = sdO + i * LD + col;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          adv[c] = fmaf(p, dr[8 * c], adv[c]);
          adk[c] = fmaf(dsv, qr[8 * c], adk[c]);
        }
      }
    }
  }
  const int kj = k0 + row;
  if (kj >= Sk) return;
  T* dkr = dk + b * dks.b + kvh * dks.h + kj * dks.s;
  T* dvr = dv + b * dvs.b + kvh * dvs.h + kj * dvs.s;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    st_val(dkr + col + 8 * c, adk[c] * scale);
    st_val(dvr + col + 8 * c, adv[c]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dsum,
              T* __restrict__ dq, int H, int KV, int Sq, int Sk, Strides qs,
              Strides ks, Strides vs, Strides ds, Strides dqs, int causal,
              int window, float scale) {
  constexpr int LD = HD + 1, CPT = HD / 8;
  extern __shared__ float bsm[];
  float* sQ = bsm;
  float* sdO = sQ + 32 * LD;
  float* sK = sdO + 32 * LD;
  float* sV = sK + 32 * LD;
  float* sP = sV + 32 * LD;
  float* sdS = sP + 32 * 33;
  float* sL = sdS + 32 * 33;
  float* sD = sL + 32;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, row = tid >> 3, col = tid & 7;

  stage_rows<T, HD>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  stage_rows<T, HD>(sdO, dout + b * ds.b + h * ds.h, ds.s, q0, Sq);
  if (tid < 32) {
    const long long base = ((long long)b * H + h) * Sq;
    sL[tid] = q0 + tid < Sq ? lse[base + q0 + tid] : 0.f;
    sD[tid] = q0 + tid < Sq ? dsum[base + q0 + tid] : 0.f;
  }
  float adq[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) adq[c] = 0.f;

  int k_lo, k_hi;
  kv_range(q0, Sq, Sk, causal, window, k_lo, k_hi);
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();
    stage_rows<T, HD>(sK, kb, ks.s, k0, Sk);
    stage_rows<T, HD>(sV, vb, vs.s, k0, Sk);
    __syncthreads();
    bwd_scores<HD>(sQ, sdO, sK, sV, sL, sD, sP, sdS, q0, k0, Sq, Sk, causal,
                   window, scale);
    __syncthreads();
    // dQ[row] += Σ_j dS[row][j] K[j]
    for (int j = 0; j < kBK; ++j) {
      const float dsv = sdS[row * 33 + j];
      const float* kr = sK + j * LD + col;
#pragma unroll
      for (int c = 0; c < CPT; ++c) adq[c] = fmaf(dsv, kr[8 * c], adq[c]);
    }
  }
  const int qi = q0 + row;
  if (qi >= Sq) return;
  T* dqr = dq + b * dqs.b + h * dqs.h + qi * dqs.s;
#pragma unroll
  for (int c = 0; c < CPT; ++c) st_val(dqr + col + 8 * c, adq[c] * scale);
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* dsum, void* dq,
               void* dk, void* dv, int B, int H, int KV, int Sq, int Sk,
               const Strides* st, int causal, int window, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<HD>();
  auto kdkdv = bwd_dkdv_kernel<T, HD>;
  auto kdq = bwd_dq_kernel<T, HD>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(
        kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dp = static_cast<const T*>(dout);
  // st: q, k, v, o, dout, dq, dk, dv
  bwd_dot_kernel<T><<<dim3((Sq + kBwdWarps - 1) / kBwdWarps, H, B),
                      kBwdThreads, 0, stream>>>(
      static_cast<const T*>(o), dp, dsum, H, Sq, HD, st[3], st[4]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kdkdv<<<dim3((Sk + kBK - 1) / kBK, KV, B), kBwdThreads, smem, stream>>>(
      qp, kp, vp, dp, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv), H,
      KV, Sq, Sk, st[0], st[1], st[2], st[4], st[6], st[7], causal, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kdq<<<dim3((Sq + kBQ - 1) / kBQ, H, B), kBwdThreads, smem, stream>>>(
      qp, kp, vp, dp, lse, dsum, static_cast<T*>(dq), H, KV, Sq, Sk, st[0],
      st[1], st[2], st[4], st[5], causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bwd(int hd, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, const float* lse,
                 float* dsum, void* dq, void* dk, void* dv, int B, int H,
                 int KV, int Sq, int Sk, const Strides* st, int causal,
                 int window, float scale, cudaStream_t s) {
#define BWD_CASE(HD)                                                        \
  case HD:                                                                  \
    return launch_bwd<T, HD>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H, \
                             KV, Sq, Sk, st, causal, window, scale, s);
  switch (hd) {
    BWD_CASE(16)
    BWD_CASE(32)
    BWD_CASE(64)
    BWD_CASE(128)
    BWD_CASE(256)
    default:
      return -1;
  }
#undef BWD_CASE
}

// ---------------------------------------------------------------------

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B,
               int H, int KV, int Sq, int Sk, Strides qs, Strides ks,
               Strides vs, Strides os, int causal, int window, float scale,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kBQ * HD + kBK * (HD + 1) + kBK * HD);
  auto kern = flash_f32_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kF32Warps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, KV, Sq,
      Sk, qs,
      ks, vs, os, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B,
                int H, int KV, int Sq, int Sk, Strides qs, Strides ks,
                Strides vs, Strides os, int causal, int window, float scale,
                cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<HD>();
  auto kern = flash_bf16_kernel<HD>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  using bf16 = __nv_bfloat16;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kTcWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, H, KV, Sq, Sk,
      qs,
      ks, vs, os, causal, window, scale);
  return (int)cudaGetLastError();
}

#define FLASH_DISPATCH(fn)                                                    \
  switch (hd) {                                                              \
    case 16: return fn<16>(q, k, v, o, lse, B, H, KV, Sq, Sk, qs, ks, vs, os, causal, window, scale, st);   \
    case 32: return fn<32>(q, k, v, o, lse, B, H, KV, Sq, Sk, qs, ks, vs, os, causal, window, scale, st);   \
    case 64: return fn<64>(q, k, v, o, lse, B, H, KV, Sq, Sk, qs, ks, vs, os, causal, window, scale, st);   \
    case 128: return fn<128>(q, k, v, o, lse, B, H, KV, Sq, Sk, qs, ks, vs, os, causal, window, scale, st); \
    case 256: return fn<256>(q, k, v, o, lse, B, H, KV, Sq, Sk, qs, ks, vs, os, causal, window, scale, st); \
    default: return -1;                                                      \
  }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  Returns
// cudaGetLastError() after the launch, or -1 for an unsupported
// dtype / head size.
extern "C" int flash_attention_fwd(
    int dtype, int hd, const void* q, const void* k, const void* v, void* o,
    void* lse_ptr, int B, int H, int KV, int Sq, int Sk, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long osb, long long osh, long long oss,
    int causal, int window, float scale, void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_ptr);
  if (dtype == 0) FLASH_DISPATCH(launch_f32)
  if (dtype == 1) FLASH_DISPATCH(launch_bf16)
  return -1;
}

// The backward of flash_attention_fwd (same dtype, hd, mask and scale).
// lse (B, H, Sq) fp32 is the forward's log-sum-exp; dsum (B, H, Sq) fp32
// is scratch for D.  strides: 24 (batch, head, seq) element strides, of
// q, k, v, o, dout, dq, dk, dv in that order, hd contiguous in each.
// dq, dk and dv are written whole (no accumulation into them).  Returns
// cudaGetLastError() after the last launch, or -1 for an unsupported
// dtype / head size.
extern "C" int flash_attention_bwd(
    int dtype, int hd, const void* q, const void* k, const void* v,
    const void* o, const void* dout, const void* lse, void* dsum, void* dq,
    void* dk, void* dv, int B, int H, int KV, int Sq, int Sk,
    const long long* strides, int causal, int window, float scale,
    void* stream) {
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* D = static_cast<float*>(dsum);
  if (dtype == 0)
    return dispatch_bwd<float>(hd, q, k, v, o, dout, l, D, dq, dk, dv, B, H,
                               KV, Sq, Sk, st, causal, window, scale, s);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16>(hd, q, k, v, o, dout, l, D, dq, dk, dv,
                                       B, H, KV, Sq, Sk, st, causal, window,
                                       scale, s);
  return -1;
}
