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
// tile from the forward's log-sum-exp, never the (Sq, Sk) matrix.  It
// differentiates what the reference leaves to XLA's autodiff (its
// attention_full / attention_windowed; the Pallas _flash_kernel has no
// backward).
//
// - `bwd_dot_kernel`: D = rowsum(dO ∘ O) in fp32, one warp a row.
// - `bwd_dq_kernel`: one block a (batch, head, q tile of 64 rows), 16
//   rows a warp; it walks the KV tiles its rows see and keeps
//   dQ += dS K · scale in registers.
// - `bwd_dkdv_kernel`: one block a (batch, query head, key tile of 64
//   keys), 16 keys a warp; it walks the q tiles that see its keys with
//   Sᵀ = K Qᵀ and dPᵀ = V dOᵀ, so Pᵀ and dSᵀ = Pᵀ ∘ (dPᵀ − D) come out
//   as accumulator fragments with the keys as rows, and feed
//   dV += Pᵀ dO and dK += dSᵀ Q from registers.  With G > 1 query heads
//   a KV head, each block writes its head's fp32 partial dK, dV to
//   scratch (B, H, Sk, hd), and `bwd_reduce_kernel` sums each group's G
//   partials in head order into dK, dV; with G = 1 the block writes
//   dK, dV itself.  One block a query head, not a GQA group, puts
//   B·H·Sk/64 blocks in the grid (768 at qwen2's training shape, 320 at
//   recurrentgemma's) and gives every block the same walk.
//
// What bounds it: the products, 10·hd operations a visible (query, key)
// pair, 14·hd as done here: both kernels compute the score tile.  That
// is the price of gradients with the same bits on every run without
// atomics: no block adds into another's output.  So the products run on
// the tensor cores:
// - bf16: `mma.sync.m16n8k16` (fp32 accumulators), operands read from
//   shared memory by `ldmatrix` (`.trans` for the [k][n] operands dO,
//   Q and K of the second products), as in the forward's bf16 body;
// - fp32: 3xTF32 on `mma.sync.m16n8k8.tf32`.  Each fp32 operand is
//   split, as it is read into a fragment, into its TF32 rounding and the
//   remainder (`split_tf32`), and a product is small·big + big·small +
//   big·big: about fp32's accuracy (within 2e-6 of max |d| against
//   the fp32 plain version on the H100, where fp32 FMAs on the CUDA
//   cores gave 2.6e-6) at three TF32 products.  The tensor core truncates as it
//   adds, so a partial of a few k-steps is summed there and added to
//   the running sum in fp32.  The second products take Pᵀ / dSᵀ / dS
//   from registers in the order the accumulator holds them (columns 2t,
//   2t + 1 as the A fragment's k = t, t + 4) and read B's rows in the
//   same order.  The fp32 body is bound by issue: about six instructions
//   (loads, splits, adds) go with each mma.
// The walked tiles (q and dO in the dK/dV kernel, K and V in the dQ
// kernel) are double-buffered with 16-byte `cp.async`, so the next
// tile's copy runs under this one's products.  Rows are padded (8 bf16
// or 4 floats), so the fragment reads of a warp fall in distinct banks.
// A walked tile has 16 rows in fp32 and at hd 256 (two blocks an SM up
// to hd 128), 32 otherwise.  At hd 256 a thread could not hold a warp's
// 16 × 256 accumulators, so two warps share each 16 rows, one on each
// half of hd, and add each other's score partials through shared
// memory (`add_partner`).  The heaviest blocks launch first (the first
// key tiles; the last q tiles).  `flash_attention_bwd_plan` reports
// these tiles, which the wrapper's `bwd_plan` mirrors; the grids and the
// partials' scratch come from `bwd_plan`, and `launch_bwd` refuses ones
// that do not cover the shapes.

constexpr int kBwdWarps = 4;            // warps a block, 16 rows each
constexpr int kBwdRows = 16 * kBwdWarps;  // keys (dK/dV) or q rows (dQ)
constexpr int kDotWarps = 8;            // rows a block of bwd_dot_kernel

// The walk's tile (q rows in dK/dV, keys in dQ), and the column groups
// of a block: at hd 256 two warps share each 16 rows, one on each half
// of hd (of the score's k and of the output's columns).
template <typename T, int HD>
__host__ __device__ constexpr int bwd_walk() {
  return (sizeof(T) == 4 || HD == 256) ? 16 : 32;
}
template <int HD>
__host__ __device__ constexpr int bwd_splits() { return HD == 256 ? 2 : 1; }
template <typename T>
__host__ __device__ constexpr int bwd_pad() { return sizeof(T) == 4 ? 4 : 8; }
// the score partials two column groups exchange: [warp][2][NT][4][32]
template <typename T, int HD>
__host__ __device__ constexpr int bwd_xchg_floats() {
  return bwd_splits<HD>() == 1
             ? 0
             : bwd_splits<HD>() * kBwdWarps * 2 * bwd_walk<T, HD>() / 8 * 4 * 32;
}
template <typename T, int HD>
__host__ __device__ constexpr int bwd_smem_bytes() {
  return (int)sizeof(T) * (HD + bwd_pad<T>()) *
             (2 * kBwdRows + 4 * bwd_walk<T, HD>()) +
         4 * bwd_xchg_floats<T, HD>();
}

__device__ __forceinline__ float ld_f32(const float* p) { return *p; }
__device__ __forceinline__ float ld_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// c (16×8) += a (16×8, tf32) · b (8×8, tf32)
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// k-steps of an fp32 score product the tensor core sums before the
// partial is added to the running sum in fp32: a partial every k-step
// is slower, none at all doubles the error (the three measured: PERF.md
// §6).
constexpr int kSsChunk = 4;

// x = big + small: big is x rounded to TF32 (its 13 low bits cleared,
// half away from zero) and small the exact remainder, a float whose 13
// low bits the tensor core ignores: |x − big − tf32(small)| < 2^-21 |x|,
// in three integer / float operations (two cvt.rna cost more: PERF.md
// §6).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}
// c += a · b by 3xTF32 (a: big ab, small as; b: big b0/b1, small s0/s1),
// the small products first
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ab,
                                           const uint32_t* as, uint32_t b0,
                                           uint32_t b1, uint32_t s0,
                                           uint32_t s1) {
  mma_tf32(c, as, b0, b1);
  mma_tf32(c, ab, s0, s1);
  mma_tf32(c, ab, b0, b1);
}

// A warp's c[16 × 8·NT] += A[16 × KD] · Bᵀ, with A's rows at a and B's
// (the n index) at b, both [row][k] with row pitch ld in shared memory.
template <typename T, int KD, int NT>
__device__ __forceinline__ void warp_ss(float (*c)[4], const T* a,
                                        const T* b, int ld) {
  const int lane = threadIdx.x & 31;
  if constexpr (sizeof(T) == 2) {
    static_assert(NT % 2 == 0 && KD % 16 == 0, "bf16 tiles");
    const int lr = lane & 7, mb0 = (lane >> 3) & 1, mb1 = lane >> 4;
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, a + (lr + mb0 * 8) * ld + kk * 16 + mb1 * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, b + (np * 16 + lr + mb1 * 8) * ld + kk * 16 + mb0 * 8);
        mma_bf16(c[2 * np], af, bf[0], bf[1]);
        mma_bf16(c[2 * np + 1], af, bf[2], bf[3]);
      }
    }
  } else {
    // partials of KC k-steps each, added to c in fp32
    constexpr int KC = kSsChunk < KD / 8 ? kSsChunk : KD / 8;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
    for (int k0 = 0; k0 < KD / 8; k0 += KC) {
      float p[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[n][e] = 0.f;
#pragma unroll
      for (int kk = k0; kk < k0 + KC; ++kk) {
        const float* ar = a + g * ld + kk * 8 + t;
        uint32_t ab[4], as[4];
        split_tf32(ar[0], ab[0], as[0]);
        split_tf32(ar[8 * ld], ab[1], as[1]);
        split_tf32(ar[4], ab[2], as[2]);
        split_tf32(ar[8 * ld + 4], ab[3], as[3]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float* br = b + (n * 8 + g) * ld + kk * 8 + t;
          uint32_t b0, b1, s0, s1;
          split_tf32(br[0], b0, s0);
          split_tf32(br[4], b1, s1);
          mma_3xtf32(p[n], ab, as, b0, b1, s0, s1);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[n][e] += p[n][e];
    }
  }
}

// A warp's c[16 × 8·NT] += P[16 × 8·NK] · B[8·NK × 8·NT]: P as NK
// accumulator fragments in registers (the k index is their column), B
// [k][n] with row pitch ld in shared memory.
template <typename T, int NK, int NT>
__device__ __forceinline__ void warp_rs(float (*c)[4], const float (*p)[4],
                                        const T* b, int ld) {
  const int lane = threadIdx.x & 31;
  if constexpr (sizeof(T) == 2) {
    static_assert(NT % 2 == 0 && NK % 2 == 0, "bf16 tiles");
    const int lr = lane & 7, mb0 = (lane >> 3) & 1, mb1 = lane >> 4;
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
      pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
      pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < NT / 2; ++dn) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, b + (kk * 16 + lr + mb0 * 8) * ld + dn * 16 + mb1 * 8);
        mma_bf16(c[2 * dn], pa, bv[0], bv[1]);
        mma_bf16(c[2 * dn + 1], pa, bv[2], bv[3]);
      }
    }
  } else {
    // The accumulator holds columns 2t, 2t+1 of each 8-column tile; they
    // are the A fragment's k = t and t + 4, so B's rows are read in that
    // order too (row 2t for b0, 2t + 1 for b1).  Each output tile sums
    // this call's NK k-steps on the tensor core, then adds to c in fp32.
    const int g = lane >> 2, t = lane & 3;
    uint32_t ab[NK][4], as[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      split_tf32(p[j][0], ab[j][0], as[j][0]);
      split_tf32(p[j][2], ab[j][1], as[j][1]);
      split_tf32(p[j][1], ab[j][2], as[j][2]);
      split_tf32(p[j][3], ab[j][3], as[j][3]);
    }
    const float* br = b + 2 * t * ld + g;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        uint32_t b0, b1, s0, s1;
        split_tf32(br[j * 8 * ld + n * 8], b0, s0);
        split_tf32(br[(j * 8 + 1) * ld + n * 8], b1, s1);
        mma_3xtf32(q, ab[j], as[j], b0, b1, s0, s1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) c[n][e] += q[e];
    }
  }
}

// Copy rows [r0, r0 + n) of a (seq, HD) slice into a padded tile with
// 16-byte cp.async; rows at or past `limit` are zero-filled.
template <typename T, int HD, int LD, int NTH>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long ss,
                                           int r0, int n, int limit) {
  constexpr int CH = 16 / sizeof(T), NV = HD / CH;
  for (int e = threadIdx.x; e < n * NV; e += NTH) {
    const int r = e / NV, c = e % NV;
    const bool ok = r0 + r < limit;
    cp_async16(dst + r * LD + c * CH, src + (ok ? r0 + r : 0) * ss + c * CH,
               ok);
  }
}

__device__ __forceinline__ void st_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void st_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// With two column groups, each warp of a pair has the score partials of
// its half of hd: add the partner's (IEEE addition commutes, so both
// warps hold the same sums).  Ends with the block's barrier.
template <int NS, int NT>
__device__ __forceinline__ void add_partner(float (*s)[4], float (*dp)[4],
                                            float* sx) {
  if constexpr (NS == 2) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* mine = sx + warp * 2 * NT * 4 * 32;
    const float* other = sx + (warp ^ kBwdWarps) * 2 * NT * 4 * 32;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mine[((0 * NT + n) * 4 + e) * 32 + lane] = s[n][e];
        mine[((1 * NT + n) * 4 + e) * 32 + lane] = dp[n][e];
      }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] += other[((0 * NT + n) * 4 + e) * 32 + lane];
        dp[n][e] += other[((1 * NT + n) * 4 + e) * 32 + lane];
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(kDotWarps * 32)
bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
               float* __restrict__ dsum, int H, int Sq, int hd, Strides os,
               Strides ds) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kDotWarps + warp;
  const int h = blockIdx.y, b = blockIdx.z;
  if (qi >= Sq) return;
  const T* orow = o + b * os.b + h * os.h + qi * os.s;
  const T* drow = dout + b * ds.b + h * ds.h + qi * ds.s;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc += ld_f32(orow + d) * ld_f32(drow + d);
  acc = warp_sum(acc);
  if (lane == 0) dsum[((long long)b * H + h) * Sq + qi] = acc;
}

// grid (B·H, ceil(Sk / 64)), NS·4 warps; part: fp32 (2, B, H, Sk, HD)
// scratch for G > 1, else null and dk / dv are written directly.
template <typename T, int HD>
__global__ void __launch_bounds__(kBwdWarps * 32 * bwd_splits<HD>())
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dsum,
                float* __restrict__ part, T* __restrict__ dk,
                T* __restrict__ dv, int B, int H, int KV, int Sq, int Sk,
                Strides qs, Strides ks, Strides vs, Strides ds, Strides dks,
                Strides dvs, int causal, int window, float scale) {
  constexpr int LD = HD + bwd_pad<T>();
  constexpr int BQ = bwd_walk<T, HD>();
  constexpr int NS = bwd_splits<HD>();
  constexpr int NTH = kBwdWarps * 32 * NS;
  constexpr int HO = HD / NS;   // a warp's columns (and its score's k)
  constexpr int NT = BQ / 8;    // score n-tiles: q columns
  constexpr int ON = HO / 8;    // output n-tiles
  extern __shared__ __align__(16) unsigned char bwd_smem_raw[];
  T* sK = reinterpret_cast<T*>(bwd_smem_raw);  // [64][LD]
  T* sV = sK + kBwdRows * LD;                   // [64][LD]
  T* sQ = sV + kBwdRows * LD;                   // [2][BQ][LD]
  T* sdO = sQ + 2 * BQ * LD;                    // [2][BQ][LD]
  float* sX = reinterpret_cast<float*>(sdO + 2 * BQ * LD);

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int k0 = blockIdx.y * kBwdRows;  // the first key tiles are heaviest
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = warp % kBwdWarps, cg = warp / kBwdWarps;  // rows, columns
  const int t4 = lane & 3;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* db = dout + b * ds.b + h * ds.h;
  const float* lb = lse + ((long long)b * H + h) * Sq;
  const float* Db = dsum + ((long long)b * H + h) * Sq;

  // the q rows that can see keys [k0, k0 + 64)
  const int q_lo = causal ? (k0 / BQ) * BQ : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + kBwdRows - 1 + window) : Sq;
  const int n_qt = q_hi > q_lo ? (q_hi - q_lo + BQ - 1) / BQ : 0;

  stage_rows<T, HD, LD, NTH>(sK, k + b * ks.b + kvh * ks.h, ks.s, k0, kBwdRows, Sk);
  stage_rows<T, HD, LD, NTH>(sV, v + b * vs.b + kvh * vs.h, vs.s, k0, kBwdRows, Sk);
  if (n_qt > 0) {
    stage_rows<T, HD, LD, NTH>(sQ, qb, qs.s, q_lo, BQ, Sq);
    stage_rows<T, HD, LD, NTH>(sdO, db, ds.s, q_lo, BQ, Sq);
  }
  cp_async_commit();

  float adk[ON][4], adv[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
  const int kj0 = k0 + rw * 16 + (lane >> 2), kj1 = kj0 + 8;
  const int c0 = cg * HO;  // this warp's half of hd
  const T* aK = sK + rw * 16 * LD + c0;
  const T* aV = sV + rw * 16 * LD + c0;

  for (int it = 0; it < n_qt; ++it) {
    const int q0 = q_lo + it * BQ, buf = it & 1;
    if (it + 1 < n_qt) {
      stage_rows<T, HD, LD, NTH>(sQ + (buf ^ 1) * BQ * LD, qb, qs.s, q0 + BQ, BQ, Sq);
      stage_rows<T, HD, LD, NTH>(sdO + (buf ^ 1) * BQ * LD, db, ds.s, q0 + BQ, BQ, Sq);
    }
    cp_async_commit();
    float lc[NT][2], dc[NT][2];  // lse and D of this thread's q columns
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = q0 + n * 8 + 2 * t4 + e;
        lc[n][e] = qi < Sq ? lb[qi] : 0.f;
        dc[n][e] = qi < Sq ? Db[qi] : 0.f;
      }
    cp_async_wait<1>();  // tile `it` has landed
    __syncthreads();
    const T* tQ = sQ + buf * BQ * LD + c0;
    const T* tdO = sdO + buf * BQ * LD + c0;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    warp_ss<T, HO, NT>(s, aK, tQ, LD);    // Sᵀ = K Qᵀ
    warp_ss<T, HO, NT>(dp, aV, tdO, LD);  // dPᵀ = V dOᵀ
    add_partner<NS, NT>(s, dp, sX);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + n * 8 + 2 * t4 + (e & 1);
        const int kj = e < 2 ? kj0 : kj1;
        const bool vis = qi < Sq && visible(qi, kj, Sk, causal, window);
        const float p = vis ? expf(s[n][e] * scale - lc[n][e & 1]) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - dc[n][e & 1]);
      }
    warp_rs<T, NT, ON>(adv, s, tdO, LD);  // dV += Pᵀ dO
    warp_rs<T, NT, ON>(adk, dp, tQ, LD);  // dK += dSᵀ Q
    __syncthreads();  // buffer `buf` and the partials are free again
  }
  cp_async_wait<0>();  // a block with no q tile still copied K and V

  // rows kj0 (e 0, 1) and kj1 (e 2, 3); columns c0 + 8n + 2·t4 + {0, 1}
  if (part != nullptr) {
    float* pk = part + ((long long)b * H + h) * Sk * HD;
    float* pv = pk + (long long)B * H * Sk * HD;
#pragma unroll
    for (int n = 0; n < ON; ++n) {
      const int col = c0 + n * 8 + 2 * t4;
      if (kj0 < Sk) {
        st_pair(pk + (long long)kj0 * HD + col, adk[n][0] * scale, adk[n][1] * scale);
        st_pair(pv + (long long)kj0 * HD + col, adv[n][0], adv[n][1]);
      }
      if (kj1 < Sk) {
        st_pair(pk + (long long)kj1 * HD + col, adk[n][2] * scale, adk[n][3] * scale);
        st_pair(pv + (long long)kj1 * HD + col, adv[n][2], adv[n][3]);
      }
    }
  } else {
    T* dkb = dk + b * dks.b + kvh * dks.h;
    T* dvb = dv + b * dvs.b + kvh * dvs.h;
#pragma unroll
    for (int n = 0; n < ON; ++n) {
      const int col = c0 + n * 8 + 2 * t4;
      if (kj0 < Sk) {
        st_pair(dkb + kj0 * dks.s + col, adk[n][0] * scale, adk[n][1] * scale);
        st_pair(dvb + kj0 * dvs.s + col, adv[n][0], adv[n][1]);
      }
      if (kj1 < Sk) {
        st_pair(dkb + kj1 * dks.s + col, adk[n][2] * scale, adk[n][3] * scale);
        st_pair(dvb + kj1 * dvs.s + col, adv[n][2], adv[n][3]);
      }
    }
  }
}

// grid (ceil(B·KV·Sk·hd / 4 / 256), 2): y = 0 sums the dK partials, 1 the
// dV partials; each thread four columns of one key, its group's G heads
// added in head order.
template <typename T>
__global__ void __launch_bounds__(256)
bwd_reduce_kernel(const float* __restrict__ part, T* __restrict__ dk,
                  T* __restrict__ dv, int B, int H, int KV, int Sk, int hd,
                  Strides dks, Strides dvs) {
  const long long n4 = (long long)B * KV * Sk * hd / 4;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n4) return;
  const int hd4 = hd / 4, G = H / KV;
  const int c = (int)(i % hd4) * 4;
  const int kj = (int)((i / hd4) % Sk);
  const int kvh = (int)((i / ((long long)hd4 * Sk)) % KV);
  const int b = (int)(i / ((long long)hd4 * Sk * KV));
  const float* src = part + (long long)blockIdx.y * B * H * Sk * hd +
                     (((long long)b * H + kvh * G) * Sk + kj) * hd + c;
  const long long hstep = (long long)Sk * hd;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int g = 1; g < G; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(src + g * hstep);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const Strides os = blockIdx.y ? dvs : dks;
  T* dst = (blockIdx.y ? dv : dk) + b * os.b + kvh * os.h + kj * os.s + c;
  st_pair(dst, acc.x, acc.y);
  st_pair(dst + 2, acc.z, acc.w);
}

// grid (B·H, ceil(Sq / 64)), NS·4 warps.
template <typename T, int HD>
__global__ void __launch_bounds__(kBwdWarps * 32 * bwd_splits<HD>())
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dsum,
              T* __restrict__ dq, int H, int KV, int Sq, int Sk, Strides qs,
              Strides ks, Strides vs, Strides ds, Strides dqs, int causal,
              int window, float scale) {
  constexpr int LD = HD + bwd_pad<T>();
  constexpr int BK = bwd_walk<T, HD>();
  constexpr int NS = bwd_splits<HD>();
  constexpr int NTH = kBwdWarps * 32 * NS;
  constexpr int HO = HD / NS;  // a warp's columns (and its score's k)
  constexpr int NT = BK / 8;   // score n-tiles: keys
  constexpr int ON = HO / 8;   // output n-tiles
  extern __shared__ __align__(16) unsigned char bwd_smem_raw[];
  T* sQ = reinterpret_cast<T*>(bwd_smem_raw);  // [64][LD]
  T* sdO = sQ + kBwdRows * LD;                  // [64][LD]
  T* sK = sdO + kBwdRows * LD;                  // [2][BK][LD]
  T* sV = sK + 2 * BK * LD;                     // [2][BK][LD]
  float* sX = reinterpret_cast<float*>(sV + 2 * BK * LD);

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBwdRows;  // heaviest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = warp % kBwdWarps, cg = warp / kBwdWarps;  // rows, columns
  const int t4 = lane & 3;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  // the keys any row of the tile sees, from a tile boundary
  const int q_last = min(q0 + kBwdRows, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = ((window > 0 ? max(0, q0 - window + 1) : 0) / BK) * BK;
  const int n_kt = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  stage_rows<T, HD, LD, NTH>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, kBwdRows, Sq);
  stage_rows<T, HD, LD, NTH>(sdO, dout + b * ds.b + h * ds.h, ds.s, q0, kBwdRows, Sq);
  if (n_kt > 0) {
    stage_rows<T, HD, LD, NTH>(sK, kb, ks.s, k_lo, BK, Sk);
    stage_rows<T, HD, LD, NTH>(sV, vb, vs.s, k_lo, BK, Sk);
  }
  cp_async_commit();

  const int r0 = q0 + rw * 16 + (lane >> 2), r1 = r0 + 8;
  const long long base = ((long long)blockIdx.x) * Sq;
  const float l0 = r0 < Sq ? lse[base + r0] : 0.f;
  const float l1 = r1 < Sq ? lse[base + r1] : 0.f;
  const float d0 = r0 < Sq ? dsum[base + r0] : 0.f;
  const float d1 = r1 < Sq ? dsum[base + r1] : 0.f;
  float adq[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[n][e] = 0.f;
  const int c0 = cg * HO;  // this warp's half of hd
  const T* aQ = sQ + rw * 16 * LD + c0;
  const T* adO = sdO + rw * 16 * LD + c0;

  for (int it = 0; it < n_kt; ++it) {
    const int kt0 = k_lo + it * BK, buf = it & 1;
    if (it + 1 < n_kt) {
      stage_rows<T, HD, LD, NTH>(sK + (buf ^ 1) * BK * LD, kb, ks.s, kt0 + BK, BK, Sk);
      stage_rows<T, HD, LD, NTH>(sV + (buf ^ 1) * BK * LD, vb, vs.s, kt0 + BK, BK, Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* tK = sK + buf * BK * LD + c0;
    const T* tV = sV + buf * BK * LD + c0;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    warp_ss<T, HO, NT>(s, aQ, tK, LD);    // S = Q Kᵀ
    warp_ss<T, HO, NT>(dp, adO, tV, LD);  // dP = dO Vᵀ
    add_partner<NS, NT>(s, dp, sX);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = kt0 + n * 8 + 2 * t4 + (e & 1);
        const int qi = e < 2 ? r0 : r1;
        const bool vis = qi < Sq && visible(qi, kj, Sk, causal, window);
        const float p = vis ? expf(s[n][e] * scale - (e < 2 ? l0 : l1)) : 0.f;
        dp[n][e] = p * (dp[n][e] - (e < 2 ? d0 : d1));
      }
    warp_rs<T, NT, ON>(adq, dp, tK, LD);  // dQ += dS K
    __syncthreads();
  }
  cp_async_wait<0>();

  T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int n = 0; n < ON; ++n) {
    const int col = c0 + n * 8 + 2 * t4;
    if (r0 < Sq) st_pair(dqb + r0 * dqs.s + col, adq[n][0] * scale, adq[n][1] * scale);
    if (r1 < Sq) st_pair(dqb + r1 * dqs.s + col, adq[n][2] * scale, adq[n][3] * scale);
  }
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* dsum, float* part,
               long long part_floats, void* dq, void* dk, void* dv, int B,
               int H, int KV, int Sq, int Sk, const int* grids,
               const Strides* st, int causal, int window, float scale,
               cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes<T, HD>();
  auto kdkdv = bwd_dkdv_kernel<T, HD>;
  auto kdq = bwd_dq_kernel<T, HD>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(
        kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  // The caller's plan (the wrapper's `bwd_plan`): a dQ block for each
  // (batch, head) and q tile, a dK/dV block for each (batch, head) and
  // key tile, and the partials' floats when a KV head serves G > 1 heads.
  const long long want_part =
      H / KV > 1 ? 2LL * B * H * Sk * HD : 0;
  if (grids[0] != B * H || grids[2] != B * H ||
      (long long)grids[1] * kBwdRows < Sq ||
      (long long)(grids[1] - 1) * kBwdRows >= Sq ||
      (long long)grids[3] * kBwdRows < Sk ||
      (long long)(grids[3] - 1) * kBwdRows >= Sk ||
      part_floats != want_part || (part != nullptr) != (want_part > 0))
    return -1;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dp = static_cast<const T*>(dout);
  T* dkp = static_cast<T*>(dk);
  T* dvp = static_cast<T*>(dv);
  // st: q, k, v, o, dout, dq, dk, dv
  bwd_dot_kernel<T><<<dim3((Sq + kDotWarps - 1) / kDotWarps, H, B),
                      kDotWarps * 32, 0, stream>>>(
      static_cast<const T*>(o), dp, dsum, H, Sq, HD, st[3], st[4]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int nth = kBwdWarps * 32 * bwd_splits<HD>();
  kdq<<<dim3(grids[0], grids[1]), nth, smem, stream>>>(
      qp, kp, vp, dp, lse, dsum, static_cast<T*>(dq), H, KV, Sq, Sk, st[0],
      st[1], st[2], st[4], st[5], causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kdkdv<<<dim3(grids[2], grids[3]), nth, smem, stream>>>(
      qp, kp, vp, dp, lse, dsum, part, dkp, dvp, B, H, KV, Sq, Sk, st[0],
      st[1], st[2], st[4], st[6], st[7], causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return (int)err;
  const long long n4 = (long long)B * KV * Sk * HD / 4;
  bwd_reduce_kernel<T><<<dim3((unsigned)((n4 + 255) / 256), 2), 256, 0,
                         stream>>>(part, dkp, dvp, B, H, KV, Sk, HD, st[6],
                                   st[7]);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bwd(int hd, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, const float* lse,
                 float* dsum, float* part, long long part_floats, void* dq,
                 void* dk, void* dv, int B, int H, int KV, int Sq, int Sk,
                 const int* grids, const Strides* st, int causal,
                 int window, float scale, cudaStream_t s) {
#define BWD_CASE(HD)                                                       \
  case HD:                                                                 \
    return launch_bwd<T, HD>(q, k, v, o, dout, lse, dsum, part,            \
                             part_floats, dq, dk, dv, B, H, KV, Sq, Sk,    \
                             grids, st, causal, window, scale, s);
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

template <typename T, int HD>
void bwd_plan_of(int* out) {
  out[0] = kBwdRows;             // keys a dK/dV block, q rows a dQ block
  out[1] = bwd_walk<T, HD>();    // rows of a walked tile
  out[2] = HD / bwd_splits<HD>();  // hd columns a warp
  out[3] = bwd_smem_bytes<T, HD>();
  out[4] = kBwdWarps * 32 * bwd_splits<HD>();  // threads a block
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
// is scratch for D; part is fp32 scratch of part_floats = 2·B·H·Sk·hd
// floats for the per-head partial dK, dV when H > KV, and null (0 floats)
// when H == KV.  grids: the (x, y) blocks of the dQ kernel, then of the
// dK/dV kernel, from the wrapper's plan: B·H by the q tiles, B·H by the
// key tiles of kBwdRows rows.  strides:
// 24 (batch, head, seq) element strides, of q, k, v, o, dout, dq, dk, dv
// in that order, hd contiguous in each; q, k, v and dout rows start on
// 16 bytes, and dq, dk, dv rows on 8.  dq, dk and dv are written whole
// (no accumulation into them).  Returns cudaGetLastError() after the
// last launch, or -1 for an unsupported dtype / head size, or grids or
// a part that do not match the shapes.
extern "C" int flash_attention_bwd(
    int dtype, int hd, const void* q, const void* k, const void* v,
    const void* o, const void* dout, const void* lse, void* dsum, void* part,
    long long part_floats, void* dq, void* dk, void* dv, int B, int H,
    int KV, int Sq, int Sk, const int* grids, const long long* strides,
    int causal, int window, float scale, void* stream) {
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* D = static_cast<float*>(dsum);
  float* P = static_cast<float*>(part);
  if (dtype == 0)
    return dispatch_bwd<float>(hd, q, k, v, o, dout, l, D, P, part_floats,
                               dq, dk, dv, B, H, KV, Sq, Sk, grids, st,
                               causal, window, scale, s);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16>(hd, q, k, v, o, dout, l, D, P,
                                       part_floats, dq, dk, dv, B, H, KV, Sq,
                                       Sk, grids, st, causal, window, scale,
                                       s);
  return -1;
}

// The backward's launch plan for (dtype, hd), into out[5]: rows a block
// (keys of a dK/dV block, q rows of a dQ block), rows of a walked tile,
// dK/dV columns a block, dynamic shared memory bytes a block (both
// kernels), threads a block.  Returns 0, or -1 for an unsupported dtype /
// head size.  The wrapper's `bwd_plan` mirrors it.
extern "C" int flash_attention_bwd_plan(int dtype, int hd, int* out) {
#define PLAN_CASE(T, HD) \
  case HD:               \
    bwd_plan_of<T, HD>(out); \
    return 0;
  if (dtype == 0) switch (hd) {
      PLAN_CASE(float, 16) PLAN_CASE(float, 32) PLAN_CASE(float, 64)
      PLAN_CASE(float, 128) PLAN_CASE(float, 256)
    }
  if (dtype == 1) switch (hd) {
      PLAN_CASE(__nv_bfloat16, 16) PLAN_CASE(__nv_bfloat16, 32)
      PLAN_CASE(__nv_bfloat16, 64) PLAN_CASE(__nv_bfloat16, 128)
      PLAN_CASE(__nv_bfloat16, 256)
    }
#undef PLAN_CASE
  return -1;
}
