// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssd_kernel`
// (src/repro/kernels/ssd_scan.py).  That kernel's grid walked the chunks
// of one (batch, head) in order and carried the (hd x N) fp32 state in
// VMEM scratch between grid steps; a whole chunk's working set (x, B, C,
// the cs x cs scores and the state: cs^2 + 3 cs N + hd N floats) sat in
// VMEM at once.  Blocks of a CUDA grid run in no order, so here one block
// owns one (batch, head) and walks its chunks in a loop, with the state
// in shared memory for the whole walk.  At mamba2's chunk 256, N 128 and
// hd 64 the Pallas working set is about 690 KB, three times what a block
// may hold, so every chunk is tiled: 64-row tiles of C (rows i) against
// 64-row tiles of B and x (columns j), the scores of one tile pair kept
// in shared memory.  Per chunk of length len (the last one may be short):
//
//   cum_i  = sum_{k <= i} dt_k A                      (running log-decay)
//   y_i    = exp(cum_i) C_i . state                   (inter-chunk)
//          + sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j   (intra)
//   state  = exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j
//
// with every exponent clipped to [-60, 0] as the reference clips it.
// Rows past S are never loaded or stored: the ragged tail is masked, not
// padded, so any S is taken.  The final state is a second output (the
// decode cache starts from it).
//
// What bounds it: operations.  Per (batch, head) and chunk the scores
// take len^2 N, the y product len^2 hd and the inter term and the state
// update 2 len hd N multiply-adds (about half of the square terms are
// masked and skipped tile by tile), all in fp32 on CUDA cores; the bytes
// (x, B, C read once, y written once) are a few MB.  Each thread holds a
// 4 x (hd/16) tile of y and a 4 x 4 tile of scores in registers, so a
// multiply-add costs half a shared-memory load; shared rows are padded by
// one float so that 16 lanes reading 16 rows hit 16 banks.  wgmma for
// the two chunk products is later work.
//
// Layout: x (B, H, S, hd), dt (B, H, S) fp32, B_ and C_ (B, G, S, N) and
// y (B, H, S, hd) are addressed through their (batch, head, seq) strides
// with the last dimension contiguous, so the model passes transposed
// views of its (B, S, H, hd) and (B, S, G, N) activations and nothing is
// copied.  Head h reads group h / (H / G).  A (H,) fp32; the final state
// (B, H, hd, N) fp32 contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
  int H, G, S, N, cs;
  Strides xs, ds, bs, cs_, ys;
};

// Shared memory of one block, in floats (`kernels/ssd_scan.py`
// `smem_bytes` mirrors it and refuses shapes above the card's 227 KB).
size_t smem_floats(int P, int N, int cs) {
  const int NP = N + 1;
  return (size_t)P * NP + 2 * kT * NP + kT * (P + 1) + kT * (kT + 1) + 2 * cs;
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads) ssd_kernel(Args a) {
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
  float* so = a.state + ((long long)b * a.H + h) * P * N;
  for (int idx = t; idx < P * N; idx += kThreads)
    so[idx] = sState[(idx / N) * NP + idx % N];
}

template <typename T, int P>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(P, a.N, a.cs);
  auto kern = ssd_kernel<T, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.H, B);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const Args& a, int B, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(a, B, s);
    case 32: return launch<T, 32>(a, B, s);
    case 64: return launch<T, 64>(a, B, s);
    case 128: return launch<T, 128>(a, B, s);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B_, C_ and y; dt, A and the state
// are float32).  Strides are in elements: (batch, head, seq) of x, dt,
// B_, C_ and y, in that order ("head" is the group axis of B_ and C_).
// cs is the chunk length, 1 <= cs <= S.  Returns cudaGetLastError()
// after the launch, or -1 for an unsupported dtype / head size.
extern "C" int ssd_scan_fwd(int dtype, int hd, const void* x, const void* dt,
                            const void* A, const void* Bm, const void* Cm,
                            void* y, void* state, int B, int H, int G, int S,
                            int N, int cs, const long long* strides,
                            void* stream) {
  const long long* st = strides;
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A), Bm,
         Cm, y, static_cast<float*>(state), H, G, S, N, cs,
         Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
         Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
         Strides{st[12], st[13], st[14]}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd<float>(hd, a, B, s);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(hd, a, B, s);
  return -1;
}
