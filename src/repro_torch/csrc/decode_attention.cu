// Decode attention for Hopper (sm_90a): one new token per sequence over
// its KV cache, the GQA group's query rows handled together, the cache
// split across blocks (flash-decoding).  Two kernels: `decode_kernel`
// over a bf16 / fp32 cache and `decode_int8_kernel` over an int8 cache,
// which also writes the new token's quantized k and v into the cache.
//
// `decode_kernel` replaces the Pallas TPU kernel `_decode_kernel`
// (src/repro/kernels/decode_attention.py).  That kernel packed the
// query-head group into the sublane axis, walked the KV blocks of one
// (batch, KV head) in order on one core with (m, l, acc) in VMEM
// scratch, and skipped blocks past `pos`.
//
// What bounds it on this card: at the server's shapes (B 4, one or two
// KV heads, a 144-slot cache, hd 128 / 256) a call reads well under a
// megabyte, so the byte bound is a fraction of a microsecond and the
// kernel is bound by latency: the launch, how many loads are in flight
// at once, and the chains of dependent steps after them (shuffles,
// shared-memory round trips, the merge's L2 reads).  One block per
// (batch, KV head) would leave 4–8 of the 132 SMs busy, each walking the
// cache one tile after another.
//
// The design:
// - Grid (n_split, KV, B).  The host does not know `pos` (it lives on
//   the device), so it cuts the cache length C into n_split chunks of
//   `chunk` slots (a multiple of kT) chosen so that B·KV·n_split covers
//   the SMs; `kernels/decode_attention.py:split_plan` is the plan.  A
//   block clips its chunk to the visible range [pos − window + 1, pos];
//   a chunk wholly outside it writes an empty partial (m = −1e30, l = 0).
// - q and kT slots of K and V at a time arrive by 16-byte `cp.async`
//   copies into shared memory, issued before any math (q before `pos` is
//   read), and the next kT slots while this tile is computed.
// - Scores: eight lanes per slot, each lane a few 16-byte vectors of the
//   row, kRowBlock query rows at a time so that their products and
//   shuffles interleave.  Then one max and one sum per query row per
//   tile, 16 lanes per row.  Any G is taken in one pass: q, the scores
//   and the accumulator of all G rows live in shared memory, and for P·V
//   each thread owns a pair of output columns for a slice of the rows.
// - Merge in the same launch (`finish`): each block writes its partial
//   (m, l, acc) to scratch, fences, and counts itself on a per-(batch,
//   KV head) counter; the last block to arrive merges the n_split
//   partials into the output and sets the counter back to 0.  Its loads
//   are issued before their values are used: one thread per (split, row)
//   for the weights, kMergeBatch splits × kMergeCols vectors per thread
//   for the output.  The counters start at zero (the wrapper keeps them
//   per device and stream) and every launch leaves them at zero.  With
//   n_split = 1 the block writes the output directly.
// Tensor cores would add nothing here: the arithmetic is 4·G·hd flops
// per slot and the kernel waits on latency, not on math.
//
// `decode_int8_kernel` replaces the reference's int8-cache decode step
// (kv_cache_dtype="int8": src/repro/models/attention.py quantizes the new
// token's k and v, writes them into the cache, dequantizes the whole
// cache and attends with einsums; it reaches no pallas_call).  At a long
// cache it is bound by the cache's bytes (hd int8 bytes and two fp32
// scales a slot and KV head, half of bf16's), and at the serve shape by
// latency, as K3.  Its design:
// - The write.  Of the blocks of one (batch, KV head), the one whose
//   chunk covers `slot` quantizes the new token's k (warp 0) and v (warp
//   1) as the reference does — amax by a warp reduction, scale = amax /
//   127 + 1e-12, x / scale rounded half to even and clamped to ±127, with
//   __fdiv_rn / __fadd_rn so the bits are the plain version's — and
//   writes the int8 rows and the scales to the cache.  Its copy of that
//   slot's tile may hold the old row, so once the tile has landed the
//   warp that reads that slot puts the new row and scales in its place
//   (a __syncwarp, not a block barrier).  No other block reads the slot.
// - Tiles of kT8 = 32 slots (4 KB of K at hd 128), four stages of
//   `cp.async` in flight, one block barrier a tile.  The rows of a tile
//   are stored with their 16-byte chunks XOR-swizzled, so that the
//   lanes that read one chunk of eight rows hit 32 different banks.
// - The warps work apart: warp w takes slots 8w..8w+7 of every tile and
//   keeps its own online softmax (m, l) and accumulator, so the scores,
//   the softmax step and P·V need no block barrier; the warps' states
//   are combined once at the end, as the splits are.
// - Dequantized in registers as each product consumes the tile, as the
//   reference rounds it, T(float(x) · scale): an int8 byte becomes a
//   float exactly by a byte permute into 2^23 + 128 + x and one
//   subtraction (no I2F, which runs at a sixteenth of the FMA rate).
//   Q·Kᵀ: lanes (quarter of the row, slot) each hold the slot's 16
//   bytes of one chunk at a time and up to kRB8 query rows; P·V: a lane
//   holds 4 (hd 128) or 8 (hd 256) output columns over the warp's 8
//   slots.
// - Its own split plan (`split_plan_int8`): a block walks at most about
//   32 tiles, so a long cache takes more than one wave of blocks.
// The products stay on the CUDA cores: q may be fp32, which tensor cores
// would take only as TF32.
//
// Layout: q (B, KV, G, hd) and k/v (B, KV, S, hd) are addressed through
// their (batch, head, row) strides with hd contiguous; every row must
// start on 16 bytes (the wrapper checks the pointers and the strides).
// The model passes a view of its fused projection output and a permuted
// view of its (B, S, KV, hd) cache, and nothing is copied; pos (B,)
// int32; o (B, KV, G, hd) contiguous.  The int8 cache's scales are (B,
// KV, S) views with their own strides; the new token's k and v (B, KV,
// hd) in q's dtype, through their (batch, head) strides; slot (B,) int32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kT = 16;          // slots per tile (TILE of the wrapper's plan)
constexpr int kRowBlock = 4;    // query rows a thread accumulates at once
constexpr int kMaxSplit = 64;   // MAX_SPLIT of the wrapper's plan
constexpr int kMergeBatch = 8;  // splits whose partials a thread loads at once
constexpr int kMergeCols = 2;   // output vectors a thread merges at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ float2 pair_f32(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_f32(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// 16-byte asynchronous copy global → shared; `valid` false zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
// 4-byte asynchronous copy global → shared (a scale); `valid` false
// zero-fills.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Strides {
  long long b, h, s;
};


// The end of a block: with n_split = 1 the output, normalised by l;
// otherwise the block's partial (m, l, acc) to scratch, and the last
// block of the (batch, KV head) to arrive merges the n_split partials.
// sAcc (G, HD), sM, sL (G) hold the block's state; sW has 2·G·n_split
// floats.
template <typename T, int HD>
__device__ __forceinline__ void finish(
    const float* sAcc, const float* sM, const float* sL, float* sW,
    int* s_last, T* __restrict__ o, float* __restrict__ part_o,
    float* __restrict__ part_ml, int* __restrict__ counters, int pair,
    int split, int n_split, int G, int tid) {
  T* ob = o + (long long)pair * G * HD;
  if (n_split == 1) {
    for (int e = tid; e < G * HD; e += kThreads)
      ob[e] = from_f32<T>(sAcc[e] / fmaxf(sL[e / HD], 1e-30f));
    return;
  }

  // Write this block's partial, then count it in.
  float* po = part_o + ((long long)pair * n_split + split) * G * HD;
  float* pml = part_ml + ((long long)pair * n_split + split) * G * 2;
  for (int e = tid * 4; e < G * HD; e += kThreads * 4)
    *reinterpret_cast<float4*>(po + e) = *reinterpret_cast<const float4*>(sAcc + e);
  for (int g = tid; g < G; g += kThreads) {
    pml[2 * g] = sM[g];
    pml[2 * g + 1] = sL[g];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *s_last = atomicAdd(counters + pair, 1) == n_split - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();

  // The last block merges the n_split partials of this (batch, KV head).
  // Every load is issued before its value is used: one thread per
  // (split, row) reads that split's (m, l); then each thread reads
  // kMergeBatch splits of kMergeCols of its output vectors at once.
  const float* pml0 = part_ml + (long long)pair * n_split * G * 2;
  const float* po0 = part_o + (long long)pair * n_split * G * HD;
  float* sWl = sW + G * n_split;
  for (int f = tid; f < G * n_split; f += kThreads) {  // f = s·G + g
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(pml0 + 2 * f));
    sW[f] = ml.y > 0.f ? ml.x : kNegInf;
    sWl[f] = ml.y;
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float mx = kNegInf;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, sW[s * G + g]);
    float den = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float l = sWl[s * G + g];
      const float w = l > 0.f ? expf(sW[s * G + g] - mx) : 0.f;
      sW[s * G + g] = w;  // the split's weight, normalised below
      den += l * w;
    }
    const float inv = 1.f / fmaxf(den, 1e-30f);
    for (int s = 0; s < n_split; ++s) sW[s * G + g] *= inv;
  }
  __syncthreads();
  constexpr int kStep = kThreads * 4;  // floats between a thread's vectors
  for (int e0 = tid * 4; e0 < G * HD; e0 += kMergeCols * kStep) {
    float4 acc[kMergeCols];
#pragma unroll
    for (int c = 0; c < kMergeCols; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_split; s0 += kMergeBatch) {
      float4 x[kMergeCols][kMergeBatch];
#pragma unroll
      for (int c = 0; c < kMergeCols; ++c)
#pragma unroll
        for (int i = 0; i < kMergeBatch; ++i) {
          const int e = e0 + c * kStep;
          x[c][i] = s0 + i < n_split && e < G * HD
              ? __ldcg(reinterpret_cast<const float4*>(po0 + (long long)(s0 + i) * G * HD + e))
              : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int c = 0; c < kMergeCols; ++c) {
        const int g = min(e0 + c * kStep, G * HD - 1) / HD;
#pragma unroll
        for (int i = 0; i < kMergeBatch; ++i) {
          const float w = s0 + i < n_split ? sW[(s0 + i) * G + g] : 0.f;
          acc[c].x += w * x[c][i].x;
          acc[c].y += w * x[c][i].y;
          acc[c].z += w * x[c][i].z;
          acc[c].w += w * x[c][i].w;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kMergeCols; ++c) {
      const int e = e0 + c * kStep;
      if (e < G * HD) {
        ob[e] = from_f32<T>(acc[c].x);
        ob[e + 1] = from_f32<T>(acc[c].y);
        ob[e + 2] = from_f32<T>(acc[c].z);
        ob[e + 3] = from_f32<T>(acc[c].w);
      }
    }
  }
  if (tid == 0) counters[pair] = 0;  // every block of this pair has counted
}

template <typename T, int HD>
__host__ __device__ constexpr size_t tile_bytes() {
  return 2 * 2 * kT * HD * sizeof(T);  // K and V, two buffers each
}
inline size_t smem_bytes(size_t tiles, size_t esize, int G, int HD,
                         int n_split) {
  const size_t floats = (size_t)G * HD + (size_t)G * kT + 3 * (size_t)G +
                        (n_split > 1 ? 2 * (size_t)G * n_split : 0);
  const size_t q_at = (tiles + 4 * floats + 15) / 16 * 16;
  return q_at + esize * G * HD;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ pos,
              T* __restrict__ o, float* __restrict__ part_o,
              float* __restrict__ part_ml, int* __restrict__ counters, int KV,
              int G, int S, int chunk, Strides qs, Strides ks, Strides vs,
              int window, float scale) {
  constexpr int VE = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int NV = HD / VE;         // vectors per row
  constexpr int VPL = (NV + 7) / 8;   // vectors per lane (8 lanes a row)
  constexpr int NCP = HD / 2;         // column pairs of the output
  constexpr int GS = NCP >= kThreads ? 1 : kThreads / NCP;  // row slices
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);                       // [2][kT][HD]
  T* sV = sK + 2 * kT * HD;                                 // [2][kT][HD]
  float* sAcc = reinterpret_cast<float*>(smem + tile_bytes<T, HD>());  // [G][HD]
  float* sS = sAcc + G * HD;                                // [G][kT]
  float* sAlpha = sS + G * kT;                              // [G]
  float* sM = sAlpha + G;                                   // [G]
  float* sL = sM + G;                                       // [G]
  float* sW = sL + G;                                       // [2][n_split][G]
  T* sQ = reinterpret_cast<T*>(  // [G][HD], on 16 bytes as smem_bytes places it
      smem + (reinterpret_cast<unsigned char*>(
                  sW + (gridDim.x > 1 ? 2 * G * gridDim.x : 0)) - smem + 15) / 16 * 16);
  __shared__ int s_last;

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pair = b * KV + kvh;

  const T* qb = q + b * qs.b + kvh * qs.h;
  for (int e = tid; e < G * NV; e += kThreads) {  // in flight while pos is read
    const int g = e / NV, c = e % NV;
    cp_async16(sQ + g * HD + c * VE, qb + g * qs.s + c * VE, true);
  }
  cp_async_commit();

  // The visible slots of this chunk, [elo, ehi]; tile t holds slots
  // elo + t·kT .. elo + t·kT + kT − 1, those past ehi zero-filled.
  const int p = pos[b];
  const int c0 = split * chunk;
  const int elo = max(c0, window > 0 ? p - window + 1 : 0);
  const int ehi = min(min(c0 + chunk, S) - 1, p);
  const int n_tiles = elo <= ehi ? (ehi - elo + kT) / kT : 0;

  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  auto load_tile = [&](int t, int buf) {
    const int j0 = elo + t * kT;
    for (int e = tid; e < kT * NV; e += kThreads) {
      const int j = e / NV, c = e % NV;
      const bool ok = j0 + j <= ehi;
      const long long row = ok ? j0 + j : elo;
      cp_async16(sK + (buf * kT + j) * HD + c * VE, kb + row * ks.s + c * VE, ok);
      cp_async16(sV + (buf * kT + j) * HD + c * VE, vb + row * vs.s + c * VE, ok);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) load_tile(0, 0);

  for (int e = tid; e < G * HD; e += kThreads) sAcc[e] = 0.f;
  for (int g = tid; g < G; g += kThreads) {
    sM[g] = kNegInf;
    sL[g] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_tile(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int nj = min(kT, ehi - (elo + t * kT) + 1);  // live slots

    // Scores: 8 lanes per position; kRowBlock query rows at a time, so
    // that their products and shuffles interleave.
    {
      const int jj = warp * 4 + (lane >> 3);  // kWarps · 4 == kT
      const int lp = lane & 7;
      float kf[VPL][VE];
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int c = min(lp + 8 * i, NV - 1);  // lanes past the row repeat it
        const uint4 raw = *reinterpret_cast<const uint4*>(
            sK + (buf * kT + jj) * HD + c * VE);
        const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int u = 0; u < VE; ++u)
          kf[i][u] = lp + 8 * i < NV ? to_f32(x[u]) : 0.f;
      }
      for (int g0 = 0; g0 < G; g0 += kRowBlock) {
        float part[kRowBlock];
#pragma unroll
        for (int r = 0; r < kRowBlock; ++r) {
          const int g = min(g0 + r, G - 1);
          part[r] = 0.f;
#pragma unroll
          for (int i = 0; i < VPL; ++i) {
            const int c = min(lp + 8 * i, NV - 1);
            const uint4 raw = *reinterpret_cast<const uint4*>(sQ + g * HD + c * VE);
            const T* qr = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int u = 0; u < VE; ++u) part[r] += to_f32(qr[u]) * kf[i][u];
          }
        }
#pragma unroll
        for (int off = 4; off > 0; off >>= 1)
#pragma unroll
          for (int r = 0; r < kRowBlock; ++r)
            part[r] += __shfl_xor_sync(0xffffffffu, part[r], off);
        if (lp == 0) {
#pragma unroll
          for (int r = 0; r < kRowBlock; ++r)
            if (g0 + r < G)
              sS[(g0 + r) * kT + jj] = jj < nj ? part[r] * scale : kNegInf;
        }
      }
    }
    __syncthreads();

    // One max and one sum per query row for the whole tile: 16 lanes per
    // row, two rows per warp.
    {
      const int half = lane >> 4, hl = lane & 15;  // kT == 16
      for (int g2 = 2 * warp; g2 < G; g2 += 2 * kWarps) {
        const int g = g2 + half;
        const bool row = g < G;
        const float s = row ? sS[g * kT + hl] : kNegInf;
        float mx = s;
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = row ? sM[g] : kNegInf;
        const float m_new = fmaxf(m_old, mx);
        const float pj = hl < nj ? expf(s - m_new) : 0.f;
        float psum = pj;
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, off);
        if (row) {
          sS[g * kT + hl] = pj;
          if (hl == 0) {
            const float alpha = expf(m_old - m_new);
            sAlpha[g] = alpha;
            sL[g] = sL[g] * alpha + psum;
            sM[g] = m_new;
          }
        }
      }
    }
    __syncthreads();

    // acc = acc · alpha + P · V: a thread owns a column pair and the rows
    // g ≡ its slice (mod GS), kRowBlock of them at a time.  Slots past nj
    // have p = 0 and zero-filled V rows.
    const T* vt = sV + buf * kT * HD;
    for (int cp = tid % NCP; cp < NCP; cp += kThreads) {
      for (int g0 = tid / NCP; g0 < G; g0 += GS * kRowBlock) {
        float2 a[kRowBlock];
        int gr[kRowBlock];
#pragma unroll
        for (int r = 0; r < kRowBlock; ++r) {
          gr[r] = min(g0 + r * GS, G - 1);
          a[r] = pair_f32(sAcc + gr[r] * HD + 2 * cp);
          const float al = sAlpha[gr[r]];
          a[r].x *= al;
          a[r].y *= al;
        }
#pragma unroll
        for (int j = 0; j < kT; ++j) {
          const float2 vj = pair_f32(vt + j * HD + 2 * cp);
#pragma unroll
          for (int r = 0; r < kRowBlock; ++r) {
            const float pj = sS[gr[r] * kT + j];
            a[r].x += pj * vj.x;
            a[r].y += pj * vj.y;
          }
        }
#pragma unroll
        for (int r = 0; r < kRowBlock; ++r)
          if (g0 + r * GS < G)
            *reinterpret_cast<float2*>(sAcc + gr[r] * HD + 2 * cp) = a[r];
      }
    }
    __syncthreads();  // the next tile's copy reuses this buffer
  }
  cp_async_wait<0>();  // an empty block's copy of q
  finish<T, HD>(sAcc, sM, sL, sW, &s_last, o, part_o, part_ml, counters,
                pair, split, n_split, G, tid);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* o, float* part_o, float* part_ml, int* counters, int B,
           int KV, int G, int S, int chunk, int n_split, const Strides* st,
           int window, float scale, cudaStream_t stream) {
  static size_t configured = 48 * 1024;  // opt-in above the default
  const size_t smem = smem_bytes(tile_bytes<T, HD>(), sizeof(T), G, HD, n_split);
  auto kern = decode_kernel<T, HD>;
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  dim3 grid(n_split, KV, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, static_cast<T*>(o), part_o, part_ml,
      counters, KV, G, S, chunk, st[0], st[1], st[2], window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const int* pos, void* o, float* po, float* pml, int* cnt,
                int B, int KV, int G, int S, int chunk, int n_split,
                const Strides* st, int window, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, pos, o, po, pml, cnt, B, KV, G, S, chunk, n_split, st, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, pos, o, po, pml, cnt, B, KV, G, S, chunk, n_split, st, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, pos, o, po, pml, cnt, B, KV, G, S, chunk, n_split, st, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, pos, o, po, pml, cnt, B, KV, G, S, chunk, n_split, st, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, pos, o, po, pml, cnt, B, KV, G, S, chunk, n_split, st, window, scale, s);
    default: return -1;
  }
}

// ---------------------------------------------------------------------
// K3 over an int8 cache, with the new token's quantize-and-write.
// ---------------------------------------------------------------------
constexpr int kT8 = 32;                  // slots a tile (TILE_INT8)
constexpr int kSlotsW = kT8 / kWarps;    // slots of a tile a warp takes
constexpr int kLPS = 32 / kSlotsW;       // Q·Kᵀ lanes a slot
constexpr int kRB8 = 8;                  // query rows a lane sums at once
constexpr int kMaxSplit8 = 128;          // MAX_SPLIT_INT8 of the plan
constexpr int kStages8 = 4;              // tiles in flight (`cp.async`)

// Output columns a lane holds in P·V, and the sub-groups a warp's slots
// split into where a row is narrower than 32 lanes × 4 columns.
template <int HD> __host__ __device__ constexpr int cpl8() {
  return HD >= 128 ? HD / 32 : 4;
}
template <int HD> __host__ __device__ constexpr int sg8() {
  return HD >= 128 ? 1 : 128 / HD;
}
template <int HD> __host__ __device__ constexpr size_t stage8_bytes() {
  return 2 * (size_t)kT8 * HD + 2 * (size_t)kT8 * sizeof(float);
}

// Where chunk c of tile row j lies: chunks XOR-swizzled so that eight
// consecutive rows' chunk c fall on eight different 16-byte bank groups.
template <int NV>
__device__ __forceinline__ int swz(int j, int c) {
  return NV >= 8 ? c ^ (j & 7) : c ^ ((j * NV / 8) & (NV - 1));
}

// Four signed bytes of w dequantized: T(float(x) · scale), returned as
// floats.  x ^ 0x80 is x + 128 as a byte; as the low byte of 2^23's
// bits it makes the float 2^23 + 128 + x, and one exact subtraction
// leaves x.
template <typename T>
__device__ __forceinline__ void dequant4(unsigned w, float sc, float* f) {
  const unsigned u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __fmul_rn(
        __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)),
                  8388736.f),
        sc);
  if constexpr (!std::is_same<T, float>::value) {  // to bf16, two at once
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const float2 r =
          __bfloat1622float2(__floats2bfloat162_rn(f[i], f[i + 1]));
      f[i] = r.x;
      f[i + 1] = r.y;
    }
  }
}

template <int HD>
__host__ __device__ constexpr int nacc8() { return kWarps * sg8<HD>(); }

// Shared memory of one block, in bytes: the stages, the new token's two
// rows, then the floats: q (G, HD), the accumulators (nacc8, G, HD), the
// warps' probabilities (kWarps, kSlotsW, G padded to kRB8), their m, l
// and alpha (kWarps, G each), the combined m and l (G each), the two new
// scales and the merge's weights (2, n_split, G).
template <int HD>
size_t smem8_bytes(int G, int n_split) {
  const size_t GP = (G + kRB8 - 1) / kRB8 * kRB8;
  const size_t floats = (size_t)G * HD * (1 + nacc8<HD>()) +
                        kWarps * (kSlotsW * GP + 3 * (size_t)G) +
                        2 * (size_t)G + 2 +
                        (n_split > 1 ? 2 * (size_t)G * n_split : 0);
  return kStages8 * stage8_bytes<HD>() + 2 * HD + 4 * floats;
}

// Three blocks an SM: registers for 128 threads x 3 blocks, which
// ptxas meets without a spill.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 3)
decode_int8_kernel(const T* __restrict__ q, int8_t* __restrict__ k,
                   int8_t* __restrict__ v, float* __restrict__ k_scale,
                   float* __restrict__ v_scale, const int* __restrict__ pos,
                   const T* __restrict__ k_new, const T* __restrict__ v_new,
                   const int* __restrict__ slot, T* __restrict__ o,
                   float* __restrict__ part_o, float* __restrict__ part_ml,
                   int* __restrict__ counters, int KV, int G, int S,
                   int chunk, Strides qs, Strides ks, Strides vs,
                   Strides kss, Strides vss, Strides kns, Strides vns,
                   int window, float scale) {
  constexpr int NS = kStages8;
  constexpr int NV = HD / 16;            // 16-byte chunks a row
  constexpr int NVQ = (NV + kLPS - 1) / kLPS;  // chunks a Q·Kᵀ lane takes
  constexpr int CPL = cpl8<HD>(), SG = sg8<HD>();
  constexpr int LPR = 32 / SG;           // P·V lanes a row
  const int GP = (G + kRB8 - 1) / kRB8 * kRB8;  // rows of sP, padded
  constexpr size_t STAGE = stage8_bytes<HD>();
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sNew = reinterpret_cast<int8_t*>(smem + NS * STAGE);  // [2][HD]
  float* sQ = reinterpret_cast<float*>(sNew + 2 * HD);          // [G][HD]
  float* sAcc = sQ + G * HD;                   // [nacc8][G][HD]
  float* sP = sAcc + nacc8<HD>() * G * HD;     // [kWarps][kSlotsW][GP]
  float* sMW = sP + kWarps * kSlotsW * GP;     // [kWarps][G]
  float* sLW = sMW + kWarps * G;               // [kWarps][G]
  float* sAW = sLW + kWarps * G;               // [kWarps][G]
  float* sM = sAW + kWarps * G;                // [G]
  float* sL = sM + G;                          // [G]
  float* sNewS = sL + G;                       // [2]
  float* sW = sNewS + 2;                       // [2][n_split][G]
  __shared__ int s_last;

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pair = b * KV + kvh;

  const T* qb = q + b * qs.b + kvh * qs.h;
  for (int e = tid; e < G * HD; e += kThreads)
    sQ[e] = to_f32(qb[(e / HD) * qs.s + e % HD]);

  // The visible slots of this chunk, [elo, ehi]; tile t holds slots
  // elo + t·kT8 .. elo + t·kT8 + kT8 − 1, those past ehi zero-filled.
  const int p = pos[b];
  const int c0 = split * chunk;
  const int elo = max(c0, window > 0 ? p - window + 1 : 0);
  const int ehi = min(min(c0 + chunk, S) - 1, p);
  const int n_tiles = elo <= ehi ? (ehi - elo + kT8) / kT8 : 0;

  int8_t* kb = k + b * ks.b + kvh * ks.h;
  int8_t* vb = v + b * vs.b + kvh * vs.h;
  float* ksb = k_scale + b * kss.b + kvh * kss.h;
  float* vsb = v_scale + b * vss.b + kvh * vss.h;
  auto load_tile = [&](int t, int s) {
    int8_t* sK = reinterpret_cast<int8_t*>(smem + s * STAGE);
    int8_t* sV = sK + kT8 * HD;
    float* sKs = reinterpret_cast<float*>(sV + kT8 * HD);
    const int j0 = elo + t * kT8;
    for (int e = tid; e < kT8 * NV; e += kThreads) {
      const int j = e / NV, c = e % NV;
      const bool ok = j0 + j <= ehi;
      const long long row = ok ? j0 + j : elo;
      const int d = (j * NV + swz<NV>(j, c)) * 16;
      cp_async16(sK + d, kb + row * ks.s + c * 16, ok);
      cp_async16(sV + d, vb + row * vs.s + c * 16, ok);
    }
    if (tid < 2 * kT8) {  // one k and one v scale a slot
      const int j = tid % kT8;
      const bool is_v = tid >= kT8, ok = j0 + j <= ehi;
      const long long row = ok ? j0 + j : elo;
      cp_async4(sKs + tid, is_v ? vsb + row * vss.s : ksb + row * kss.s, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }

  // The new token: the block whose chunk covers its slot quantizes its k
  // (warp 0) and v (warp 1) and writes them to the cache.
  const int ws = slot ? slot[b] : -1;
  const bool writes = slot && ws >= c0 && ws < c0 + chunk;
  if (writes && warp < 2) {
    constexpr int PER = (HD + 31) / 32;
    const T* src = warp == 0 ? k_new + b * kns.b + kvh * kns.h
                             : v_new + b * vns.b + kvh * vns.h;
    float x[PER];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int d = lane + 32 * i;
      x[i] = d < HD ? to_f32(src[d]) : 0.f;
      amax = fmaxf(amax, fabsf(x[i]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float sc = __fadd_rn(__fdiv_rn(amax, 127.f), 1e-12f);
    int8_t* dst = warp == 0 ? kb + ws * ks.s : vb + ws * vs.s;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) {
        const float r = fminf(fmaxf(rintf(__fdiv_rn(x[i], sc)), -127.f), 127.f);
        const int8_t q8 = static_cast<int8_t>(r);
        dst[d] = q8;
        sNew[warp * HD + d] = q8;
      }
    }
    if (lane == 0) {
      (warp == 0 ? ksb[ws * kss.s] : vsb[ws * vss.s]) = sc;
      sNewS[warp] = sc;
    }
  }

  for (int e = tid; e < nacc8<HD>() * G * HD; e += kThreads) sAcc[e] = 0.f;
  for (int e = tid; e < kWarps * G; e += kThreads) {
    sMW[e] = kNegInf;
    sLW[e] = 0.f;
  }

  // Q·Kᵀ: lane (h, jl) takes part h of the row of slot jl
  const int jl = lane % kSlotsW, h = lane / kSlotsW;
  const int sub = lane / LPR, cq = lane % LPR;  // P·V: slot sub-group, columns
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // tile t has landed; every warp is done with t − 1
    if (t + NS - 1 < n_tiles) load_tile(t + NS - 1, (t + NS - 1) % NS);
    cp_async_commit();
    int8_t* sK = reinterpret_cast<int8_t*>(smem + (t % NS) * STAGE);
    int8_t* sV = sK + kT8 * HD;
    float* sKs = reinterpret_cast<float*>(sV + kT8 * HD);
    float* sVs = sKs + kT8;
    const int j0 = elo + t * kT8;
    const int nj = min(kT8, ehi - j0 + 1);  // live slots
    const int jw = warp * kSlotsW;          // this warp's first slot

    // The new token's slot, if this tile holds it: its warp puts the new
    // rows and scales in place of what the copy brought.
    if (writes && ws >= j0 && ws - j0 < nj && (ws - j0) / kSlotsW == warp) {
      const int j = ws - j0;
      for (int e = lane; e < 2 * NV; e += 32) {
        const int c = e % NV;
        int8_t* d = (e < NV ? sK : sV) + (j * NV + swz<NV>(j, c)) * 16;
        *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(
            sNew + (e < NV ? 0 : HD) + c * 16);
      }
      if (lane == 0) {
        sKs[j] = sNewS[0];
        sVs[j] = sNewS[1];
      }
      __syncwarp();
    }

    // Scores of the warp's kSlotsW slots and its softmax step, kRB8
    // rows at a time: lane (h, jl) sums the chunks of part h of slot
    // jw + jl; the rows' reductions interleave, level by level.
    {
      const int j = jw + jl;
      const bool live = j < nj;
      const float ksc = sKs[j];
      for (int g0 = 0; g0 < G; g0 += kRB8) {
        const int nr = min(kRB8, G - g0);
        float part[kRB8];
#pragma unroll
        for (int r = 0; r < kRB8; ++r) part[r] = 0.f;
#pragma unroll
        for (int i = 0; i < NVQ; ++i) {
          const int c = h * NVQ + i;
          if (c >= NV) break;
          const uint4 raw = *reinterpret_cast<const uint4*>(
              sK + (j * NV + swz<NV>(j, c)) * 16);
          float kf[16];
          dequant4<T>(raw.x, ksc, kf);
          dequant4<T>(raw.y, ksc, kf + 4);
          dequant4<T>(raw.z, ksc, kf + 8);
          dequant4<T>(raw.w, ksc, kf + 12);
#pragma unroll
          for (int r = 0; r < kRB8; ++r) {
            if (r >= nr) break;
            const float4* qr =
                reinterpret_cast<const float4*>(sQ + (g0 + r) * HD + c * 16);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float4 qv = qr[u];
              part[r] += qv.x * kf[4 * u] + qv.y * kf[4 * u + 1] +
                         qv.z * kf[4 * u + 2] + qv.w * kf[4 * u + 3];
            }
          }
        }
        float mx[kRB8], ps[kRB8];
#pragma unroll
        for (int off = kSlotsW; off < 32; off <<= 1)
#pragma unroll
          for (int r = 0; r < kRB8; ++r)
            part[r] += __shfl_xor_sync(0xffffffffu, part[r], off);
#pragma unroll
        for (int r = 0; r < kRB8; ++r) {
          part[r] = live ? part[r] * scale : kNegInf;
          mx[r] = part[r];
        }
#pragma unroll
        for (int off = kSlotsW / 2; off > 0; off >>= 1)
#pragma unroll
          for (int r = 0; r < kRB8; ++r)
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
        float* mw = sMW + warp * G + g0;
        float* lw = sLW + warp * G + g0;
#pragma unroll
        for (int r = 0; r < kRB8; ++r) {
          const float m_old = r < nr ? mw[r] : kNegInf;
          mx[r] = fmaxf(m_old, mx[r]);  // the row's new m
          ps[r] = live ? expf(part[r] - mx[r]) : 0.f;
          part[r] = expf(m_old - mx[r]);  // now the row's alpha
        }
        float* pw = sP + (warp * kSlotsW + jl) * GP + g0;
#pragma unroll
        for (int r = 0; r < kRB8; ++r)
          if (h == 0 && r < nr) pw[r] = ps[r];
#pragma unroll
        for (int off = kSlotsW / 2; off > 0; off >>= 1)
#pragma unroll
          for (int r = 0; r < kRB8; ++r)
            ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], off);
        __syncwarp();  // every lane has read m_old
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < kRB8; ++r) {
            if (r >= nr) break;
            sAW[warp * G + g0 + r] = part[r];
            lw[r] = lw[r] * part[r] + ps[r];
            mw[r] = mx[r];
          }
        }
      }
    }
    __syncwarp();

    // acc = acc · alpha + P · V over the warp's slots: lane (sub, cq)
    // holds columns cq·CPL .. cq·CPL + CPL − 1 of slots jj ≡ sub (mod
    // SG).  Slots past nj have p = 0 and zero-filled V rows.
    {
      float* acc = sAcc + (warp * SG + sub) * G * HD + cq * CPL;
      const int c = cq * CPL / 16, off = cq * CPL % 16;
      for (int g0 = 0; g0 < G; g0 += kRB8) {
        const int nr = min(kRB8, G - g0);
        float4 a[kRB8][CPL / 4];
#pragma unroll
        for (int r = 0; r < kRB8; ++r) {
          if (r >= nr) break;
          const float al = sAW[warp * G + g0 + r];
#pragma unroll
          for (int i = 0; i < CPL / 4; ++i) {
            const float4 x =
                *reinterpret_cast<const float4*>(acc + (g0 + r) * HD + 4 * i);
            a[r][i] = make_float4(x.x * al, x.y * al, x.z * al, x.w * al);
          }
        }
        for (int jj = sub; jj < kSlotsW; jj += SG) {
          const int j = jw + jj;
          const int8_t* vr = sV + (j * NV + swz<NV>(j, c)) * 16 + off;
          float vf[CPL];
#pragma unroll
          for (int i = 0; i < CPL; i += 4)
            dequant4<T>(*reinterpret_cast<const unsigned*>(vr + i), sVs[j],
                        vf + i);
          const float4* pp = reinterpret_cast<const float4*>(
              sP + (warp * kSlotsW + jj) * GP + g0);
          const float4 p0 = pp[0], p1 = pp[1];
          const float pr[kRB8] = {p0.x, p0.y, p0.z, p0.w,
                                  p1.x, p1.y, p1.z, p1.w};
#pragma unroll
          for (int r = 0; r < kRB8; ++r) {
            if (r >= nr) break;
#pragma unroll
            for (int i = 0; i < CPL / 4; ++i) {
              a[r][i].x += pr[r] * vf[4 * i];
              a[r][i].y += pr[r] * vf[4 * i + 1];
              a[r][i].z += pr[r] * vf[4 * i + 2];
              a[r][i].w += pr[r] * vf[4 * i + 3];
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRB8; ++r) {
          if (r >= nr) break;
#pragma unroll
          for (int i = 0; i < CPL / 4; ++i)
            *reinterpret_cast<float4*>(acc + (g0 + r) * HD + 4 * i) = a[r][i];
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // The warps' states combined, each weighted by exp(m_w − m), into
  // accumulator 0 in place (element e is this thread's alone).
  for (int g = tid; g < G; g += kThreads) {
    float m = kNegInf;
    for (int w = 0; w < kWarps; ++w)
      if (sLW[w * G + g] > 0.f) m = fmaxf(m, sMW[w * G + g]);
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float lw = sLW[w * G + g];
      const float f = lw > 0.f ? expf(sMW[w * G + g] - m) : 0.f;
      sAW[w * G + g] = f;
      l += lw * f;
    }
    sM[g] = m;
    sL[g] = l;
  }
  __syncthreads();
  for (int e = tid; e < G * HD; e += kThreads) {
    const int g = e / HD;
    float x = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      float aw = 0.f;
      for (int s = 0; s < SG; ++s) aw += sAcc[(w * SG + s) * G * HD + e];
      x += sAW[w * G + g] * aw;
    }
    sAcc[e] = x;
  }
  __syncthreads();
  finish<T, HD>(sAcc, sM, sL, sW, &s_last, o, part_o, part_ml, counters,
                pair, split, n_split, G, tid);
}

// The pointers and strides of one int8 call; st[0..6] are the strides of
// q, k, v, k_scale, v_scale, k_new and v_new.
struct Int8Args {
  const void* q;
  int8_t *k, *v;
  float *k_scale, *v_scale;
  const int* pos;
  const void *k_new, *v_new;
  const int* slot;
  void* o;
  float *part_o, *part_ml;
  int* counters;
  Strides st[7];
};

template <typename T, int HD>
int launch_int8(const Int8Args& a, int B, int KV, int G, int S, int chunk,
                int n_split, int window, float scale, cudaStream_t stream) {
  static size_t configured = 48 * 1024;  // opt-in above the default
  const size_t smem = smem8_bytes<HD>(G, n_split);
  auto kern = decode_int8_kernel<T, HD>;
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  dim3 grid(n_split, KV, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), a.k, a.v, a.k_scale, a.v_scale, a.pos,
      static_cast<const T*>(a.k_new), static_cast<const T*>(a.v_new), a.slot,
      static_cast<T*>(a.o), a.part_o, a.part_ml, a.counters, KV, G, S, chunk,
      a.st[0], a.st[1], a.st[2], a.st[3], a.st[4], a.st[5], a.st[6], window,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_int8(int hd, const Int8Args& a, int B, int KV, int G, int S,
                  int chunk, int n_split, int window, float scale,
                  cudaStream_t s) {
  switch (hd) {
    case 16: return launch_int8<T, 16>(a, B, KV, G, S, chunk, n_split, window, scale, s);
    case 32: return launch_int8<T, 32>(a, B, KV, G, S, chunk, n_split, window, scale, s);
    case 64: return launch_int8<T, 64>(a, B, KV, G, S, chunk, n_split, window, scale, s);
    case 128: return launch_int8<T, 128>(a, B, KV, G, S, chunk, n_split, window, scale, s);
    case 256: return launch_int8<T, 256>(a, B, KV, G, S, chunk, n_split, window, scale, s);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements: the
// (batch, head, row) strides of q, then of k, then of v.  The cache is
// cut into n_split chunks of `chunk` positions (a multiple of 16); with
// n_split > 1, part_o holds B·KV·n_split·G·hd floats and part_ml
// B·KV·n_split·G·2, and counters B·KV ints that are zero on entry (and
// are zero again on exit).  Returns cudaGetLastError() after the launch,
// or -1 for an unsupported dtype / head size, a group size below 1 or a
// bad split.
extern "C" int decode_attention_fwd(int dtype, int hd, const void* q,
                                    const void* k, const void* v,
                                    const void* pos, void* o, void* part_o,
                                    void* part_ml, void* counters, int B,
                                    int KV, int G, int S, int chunk,
                                    int n_split, long long qsb, long long qsh,
                                    long long qsg, long long ksb,
                                    long long ksh, long long kss,
                                    long long vsb, long long vsh,
                                    long long vss, int window, float scale,
                                    void* stream) {
  if (G < 1 || n_split < 1 || n_split > kMaxSplit || chunk < 1 || chunk % kT ||
      (long long)chunk * n_split < S || (n_split > 1 && !(part_o && part_ml && counters)))
    return -1;
  const Strides st[3] = {{qsb, qsh, qsg}, {ksb, ksh, kss}, {vsb, vsh, vss}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  int* cnt = static_cast<int*>(counters);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, p, o, po, pml, cnt, B, KV, G, S,
                              chunk, n_split, st, window, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, p, o, po, pml, cnt, B, KV,
                                      G, S, chunk, n_split, st, window, scale,
                                      s);
  return -1;
}

// The same over an int8 cache: k and v int8 (strides in elements, that
// is bytes), k_scale and v_scale float32 (B, KV, S) views with their own
// (batch, head, row) strides; q, o and the new token's k_new, v_new (B,
// KV, hd) in `dtype`, with their (batch, head) strides; slot (B,) int32.
// With k_new, v_new and slot (all three, or none), the block whose chunk
// covers slot[b] writes the new token's quantized rows and scales there
// before the attention reads them.  The cache is cut into n_split ≤ 128
// chunks of `chunk` positions (a multiple of 32).  Returns as above, or
// -1 without both scales or with some but not all of the new token's
// operands.
extern "C" int decode_attention_int8_fwd(
    int dtype, int hd, const void* q, void* k, void* v, void* k_scale,
    void* v_scale, const void* pos, const void* k_new, const void* v_new,
    const void* slot, void* o, void* part_o, void* part_ml, void* counters,
    int B, int KV, int G, int S, int chunk, int n_split, long long qsb,
    long long qsh, long long qsg, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long kssb,
    long long kssh, long long ksss, long long vssb, long long vssh,
    long long vsss, long long knb, long long knh, long long vnb,
    long long vnh, int window, float scale, void* stream) {
  const bool some = k_new || v_new || slot, all = k_new && v_new && slot;
  if (G < 1 || n_split < 1 || n_split > kMaxSplit8 || chunk < 1 ||
      chunk % kT8 || (long long)chunk * n_split < S ||
      (n_split > 1 && !(part_o && part_ml && counters)) ||
      !(k_scale && v_scale) || some != all)
    return -1;
  const Int8Args a{q, static_cast<int8_t*>(k), static_cast<int8_t*>(v),
                   static_cast<float*>(k_scale), static_cast<float*>(v_scale),
                   static_cast<const int*>(pos), k_new, v_new,
                   static_cast<const int*>(slot), o,
                   static_cast<float*>(part_o), static_cast<float*>(part_ml),
                   static_cast<int*>(counters),
                   {{qsb, qsh, qsg}, {ksb, ksh, kss}, {vsb, vsh, vss},
                    {kssb, kssh, ksss}, {vssb, vssh, vsss}, {knb, knh, 0},
                    {vnb, vnh, 0}}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_int8<float>(hd, a, B, KV, G, S, chunk, n_split, window,
                                scale, s);
  if (dtype == 1)
    return dispatch_int8<__nv_bfloat16>(hd, a, B, KV, G, S, chunk, n_split,
                                        window, scale, s);
  return -1;
}
