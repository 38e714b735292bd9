// Decode attention for Hopper (sm_90a): one new token per sequence over
// its KV cache, the GQA group's query rows handled together, the cache
// split across blocks (flash-decoding).
//
// Replaces the Pallas TPU kernel `_decode_kernel`
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
// - Merge in the same launch: each block writes its partial (m, l, acc)
//   to scratch, fences, and counts itself on a per-(batch, KV head)
//   counter; the last block to arrive merges the n_split partials into
//   the output and sets the counter back to 0.  Its loads are issued
//   before their values are used: one thread per (split, row) for the
//   weights, kMergeBatch splits × kMergeCols vectors per thread for the
//   output.  The counters start at zero (the wrapper keeps them per
//   device and stream) and every launch leaves them at zero.  With
//   n_split = 1 the block writes the output directly.
// Tensor cores would add nothing here: the arithmetic is 4·G·hd flops
// per slot and the kernel waits on latency, not on math.
//
// The int8 cache (`decode_attention_int8_fwd`, the reference's
// kv_cache_dtype="int8": src/repro/models/attention.py dequantizes the
// whole cache every step and attends with einsums) is the same kernel
// with the cache's element type C = int8_t: the rows arrive by the same
// 16-byte `cp.async` copies (hd bytes a row) and each slot's k and v
// scales by 4-byte ones, into the same two-buffer ring.  Once a tile has
// landed, one pass dequantizes it into a T tile in shared memory as the
// reference rounds it, T(float(x) · scale), and the rest runs on that
// tile unchanged.  At a long cache the kernel is bound by bytes, and
// these are half of the bf16 cache's (plus 8 bytes of scales a slot and
// KV head); nothing is written back.
//
// Layout: q (B, KV, G, hd) and k/v (B, KV, S, hd) are addressed through
// their (batch, head, row) strides with hd contiguous; every row must
// start on 16 bytes (the wrapper checks the pointers and the strides).
// The model passes a view of its fused projection output and a permuted
// view of its (B, S, KV, hd) cache, and nothing is copied; pos (B,)
// int32; o (B, KV, G, hd) contiguous.
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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// 4-byte asynchronous copy global → shared (a scale); `valid` false
// zero-fills.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Strides {
  long long b, h, s;
};

template <typename C>
constexpr bool kQuant = std::is_same<C, int8_t>::value;

// Shared memory of the tiles of one block, in bytes: K and V, two
// buffers each, in the cache's type C; an int8 cache adds the slots' k
// and v scales (two buffers each) and one dequantized K and V tile in T.
template <typename T, typename C, int HD>
__host__ __device__ constexpr size_t tile_bytes() {
  return 2 * 2 * kT * HD * sizeof(C) +
         (kQuant<C> ? 2 * 2 * kT * sizeof(float) + 2 * kT * HD * sizeof(T) : 0);
}
inline size_t smem_bytes(size_t tiles, size_t esize, int G, int HD,
                         int n_split) {
  const size_t floats = (size_t)G * HD + (size_t)G * kT + 3 * (size_t)G +
                        (n_split > 1 ? 2 * (size_t)G * n_split : 0);
  const size_t q_at = (tiles + 4 * floats + 15) / 16 * 16;
  return q_at + esize * G * HD;
}

// C is the cache's element type: T, or int8_t with the fp32 scales
// k_scale and v_scale (addressed through kss and vss; unused otherwise).
template <typename T, typename C, int HD>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const C* __restrict__ k,
              const C* __restrict__ v, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale, const int* __restrict__ pos,
              T* __restrict__ o, float* __restrict__ part_o,
              float* __restrict__ part_ml, int* __restrict__ counters, int KV,
              int G, int S, int chunk, Strides qs, Strides ks, Strides vs,
              Strides kss, Strides vss, int window, float scale) {
  constexpr int VE = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int NV = HD / VE;         // vectors per row
  constexpr int VC = 16 / sizeof(C);  // cache elements per 16-byte copy
  constexpr int NVC = HD / VC;        // copies per cache row
  constexpr int VPL = (NV + 7) / 8;   // vectors per lane (8 lanes a row)
  constexpr int NCP = HD / 2;         // column pairs of the output
  constexpr int GS = NCP >= kThreads ? 1 : kThreads / NCP;  // row slices
  extern __shared__ __align__(16) unsigned char smem[];
  C* sK = reinterpret_cast<C*>(smem);                       // [2][kT][HD]
  C* sV = sK + 2 * kT * HD;                                 // [2][kT][HD]
  float* sKs = reinterpret_cast<float*>(sV + 2 * kT * HD);  // [2][kT], int8
  float* sVs = sKs + 2 * kT;                                // [2][kT], int8
  T* sKd = reinterpret_cast<T*>(sVs + 2 * kT);              // [kT][HD], int8
  T* sVd = sKd + kT * HD;                                   // [kT][HD], int8
  float* sAcc = reinterpret_cast<float*>(smem + tile_bytes<T, C, HD>());  // [G][HD]
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

  const C* kb = k + b * ks.b + kvh * ks.h;
  const C* vb = v + b * vs.b + kvh * vs.h;
  auto load_tile = [&](int t, int buf) {
    const int j0 = elo + t * kT;
    for (int e = tid; e < kT * NVC; e += kThreads) {
      const int j = e / NVC, c = e % NVC;
      const bool ok = j0 + j <= ehi;
      const long long row = ok ? j0 + j : elo;
      cp_async16(sK + (buf * kT + j) * HD + c * VC, kb + row * ks.s + c * VC, ok);
      cp_async16(sV + (buf * kT + j) * HD + c * VC, vb + row * vs.s + c * VC, ok);
    }
    if constexpr (kQuant<C>) {  // one k and one v scale a slot
      if (tid < 2 * kT) {
        const int j = tid % kT;
        const bool is_v = tid >= kT, ok = j0 + j <= ehi;
        const long long row = ok ? j0 + j : elo;
        const float* src = is_v ? v_scale + b * vss.b + kvh * vss.h + row * vss.s
                                : k_scale + b * kss.b + kvh * kss.h + row * kss.s;
        cp_async4((is_v ? sVs : sKs) + buf * kT + j, src, ok);
      }
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

    // The tile the math reads: the ring's buffer, or for an int8 cache
    // its dequantization, rounded to T as the reference rounds it.
    const T* kt;
    const T* vt;
    if constexpr (kQuant<C>) {
      for (int e = tid; e < kT * HD / 4; e += kThreads) {
        const int j = 4 * e / HD, d = 4 * e % HD;
        const char4 k4 = reinterpret_cast<const char4*>(sK + buf * kT * HD)[e];
        const char4 v4 = reinterpret_cast<const char4*>(sV + buf * kT * HD)[e];
        const float sk = sKs[buf * kT + j], sv = sVs[buf * kT + j];
        T* kd = sKd + j * HD + d;
        T* vd = sVd + j * HD + d;
        kd[0] = from_f32<T>(static_cast<float>(k4.x) * sk);
        kd[1] = from_f32<T>(static_cast<float>(k4.y) * sk);
        kd[2] = from_f32<T>(static_cast<float>(k4.z) * sk);
        kd[3] = from_f32<T>(static_cast<float>(k4.w) * sk);
        vd[0] = from_f32<T>(static_cast<float>(v4.x) * sv);
        vd[1] = from_f32<T>(static_cast<float>(v4.y) * sv);
        vd[2] = from_f32<T>(static_cast<float>(v4.z) * sv);
        vd[3] = from_f32<T>(static_cast<float>(v4.w) * sv);
      }
      __syncthreads();
      kt = sKd;
      vt = sVd;
    } else {
      kt = sK + buf * kT * HD;
      vt = sV + buf * kT * HD;
    }

    // Scores: 8 lanes per position; kRowBlock query rows at a time, so
    // that their products and shuffles interleave.
    {
      const int jj = warp * 4 + (lane >> 3);  // kWarps · 4 == kT
      const int lp = lane & 7;
      float kf[VPL][VE];
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int c = min(lp + 8 * i, NV - 1);  // lanes past the row repeat it
        const uint4 raw = *reinterpret_cast<const uint4*>(kt + jj * HD + c * VE);
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
  if (tid == 0) s_last = atomicAdd(counters + pair, 1) == n_split - 1;
  __syncthreads();
  if (!s_last) return;
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

// The pointers and strides of one call: q, k, v and, for an int8 cache,
// the scales; st[0..4] are the strides of q, k, v, k_scale, v_scale.
struct Args {
  const void *q, *k, *v;
  const float *k_scale, *v_scale;
  const int* pos;
  void* o;
  float *part_o, *part_ml;
  int* counters;
  Strides st[5];
};

template <typename T, typename C, int HD>
int launch(const Args& a, int B, int KV, int G, int S, int chunk, int n_split,
           int window, float scale, cudaStream_t stream) {
  static size_t configured = 48 * 1024;  // opt-in above the default
  const size_t smem = smem_bytes(tile_bytes<T, C, HD>(), sizeof(T), G, HD, n_split);
  auto kern = decode_kernel<T, C, HD>;
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  dim3 grid(n_split, KV, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const C*>(a.k),
      static_cast<const C*>(a.v), a.k_scale, a.v_scale, a.pos,
      static_cast<T*>(a.o), a.part_o, a.part_ml, a.counters, KV, G, S, chunk,
      a.st[0], a.st[1], a.st[2], a.st[3], a.st[4], window, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename C>
int dispatch_hd(int hd, const Args& a, int B, int KV, int G, int S, int chunk,
                int n_split, int window, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, C, 16>(a, B, KV, G, S, chunk, n_split, window, scale, s);
    case 32: return launch<T, C, 32>(a, B, KV, G, S, chunk, n_split, window, scale, s);
    case 64: return launch<T, C, 64>(a, B, KV, G, S, chunk, n_split, window, scale, s);
    case 128: return launch<T, C, 128>(a, B, KV, G, S, chunk, n_split, window, scale, s);
    case 256: return launch<T, C, 256>(a, B, KV, G, S, chunk, n_split, window, scale, s);
    default: return -1;
  }
}

// dtype 0: T = float, 1: T = bfloat16; the cache holds T, or int8_t
// when `quant`.
int dispatch(int dtype, bool quant, int hd, const Args& a, int B, int KV,
             int G, int S, int chunk, int n_split, int window, float scale,
             void* stream) {
  if (G < 1 || n_split < 1 || n_split > kMaxSplit || chunk < 1 || chunk % kT ||
      (long long)chunk * n_split < S ||
      (n_split > 1 && !(a.part_o && a.part_ml && a.counters)) ||
      (quant && !(a.k_scale && a.v_scale)))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return quant ? dispatch_hd<float, int8_t>(hd, a, B, KV, G, S, chunk, n_split, window, scale, s)
                 : dispatch_hd<float, float>(hd, a, B, KV, G, S, chunk, n_split, window, scale, s);
  if (dtype == 1)
    return quant ? dispatch_hd<__nv_bfloat16, int8_t>(hd, a, B, KV, G, S, chunk, n_split, window, scale, s)
                 : dispatch_hd<__nv_bfloat16, __nv_bfloat16>(hd, a, B, KV, G, S, chunk, n_split, window, scale, s);
  return -1;
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
  const Args a{q, k, v, nullptr, nullptr, static_cast<const int*>(pos), o,
               static_cast<float*>(part_o), static_cast<float*>(part_ml),
               static_cast<int*>(counters),
               {{qsb, qsh, qsg}, {ksb, ksh, kss}, {vsb, vsh, vss}, {0, 0, 0}, {0, 0, 0}}};
  return dispatch(dtype, false, hd, a, B, KV, G, S, chunk, n_split, window,
                  scale, stream);
}

// The same over an int8 cache: k and v int8 (strides in elements, that
// is bytes), k_scale and v_scale float32 (B, KV, S) views with their own
// (batch, head, row) strides; q and o in `dtype`.  Returns as above, or
// -1 without both scales.
extern "C" int decode_attention_int8_fwd(
    int dtype, int hd, const void* q, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const void* pos, void* o,
    void* part_o, void* part_ml, void* counters, int B, int KV, int G, int S,
    int chunk, int n_split, long long qsb, long long qsh, long long qsg,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long kssb, long long kssh, long long ksss,
    long long vssb, long long vssh, long long vsss, int window, float scale,
    void* stream) {
  const Args a{q, k, v, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), static_cast<const int*>(pos),
               o, static_cast<float*>(part_o), static_cast<float*>(part_ml),
               static_cast<int*>(counters),
               {{qsb, qsh, qsg}, {ksb, ksh, kss}, {vsb, vsh, vss},
                {kssb, kssh, ksss}, {vssb, vssh, vsss}}};
  return dispatch(dtype, true, hd, a, B, KV, G, S, chunk, n_split, window,
                  scale, stream);
}
