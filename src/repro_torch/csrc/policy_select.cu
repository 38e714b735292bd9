// ModiPick selection for Hopper (sm_90a): stages 1-3 and the
// inverse-CDF draw as one set of per-row device functions, and three
// kernels on them.
//
// Replaces, from src/repro/kernels/policy_select.py:
// - `_probs_kernel` (the Pallas TPU kernel behind `modipick_probs`):
//   stage 3, the Eq. 3-4 utilities of a given (B, n) eligibility
//   matrix, normalised per row -> `probs_kernel`;
// - `_fused_select` (jitted jnp around that kernel): stages 1-2, the
//   stage-3 probabilities and the draw -> `fused_kernel`;
// - `charged_select` / `_charged_step` (a `lax.scan` over the batch whose
//   carry is the per-replica wait ledger) -> `charged_kernel`.
// The TPU kernel rode the pool on the 128-lane axis and the batch on
// sublanes, one (bb, 128) tile a grid step, because a TPU core does
// vector work on whole tiles.
//
// What bounds them on this card: neither bytes nor operations.  At the
// server's shape (B 8192, n 3) a pass moves ~0.3 MB and does some 20
// flops a (request, model) pair: 0.1 us at 3.35 TB/s.  What a call pays
// is its launches and its host dispatch, so the design is to make the
// whole selection ONE launch that reads the pool and the budget rows and
// writes the picks, with every intermediate in registers:
// - one thread takes one request row; the pool (mu, sigma, the accuracy
//   weights clamp(acc, eps)^gamma, rank; n <= 128) is staged in shared
//   memory once a block and read there by every row (a broadcast);
// - the (B, n) eligibility and probability matrices of the pipeline are
//   never written; the utilities are recomputed pass by pass (mass,
//   normalised total, draw) rather than stored;
// - `probs_kernel` keeps K1's interface (a given eligibility matrix in,
//   the probability matrix out): the block stages its (rows x n) tile in
//   shared memory with coalesced loads, each thread overwrites its own
//   row there with its probabilities, and the block stores the tile
//   coalesced again.  The row pitch is odd (n | 1), so a warp's threads
//   reading their rows' element j hit 32 different banks.
// - The charged pass is sequential along the batch (request i sees the
//   charges of 0..i-1), so ONE warp walks the whole batch with the
//   (R,) ledger and the (R x n) candidate mask in shared memory.  Its
//   lanes compute the models' waits and the admission test in parallel
//   and, after the pick, the least-loaded capable replica (a warp
//   argmin); lane 0 runs the per-row selection.  The budget rows are
//   staged in shared memory kChunk requests at a time, so no request
//   waits on a load from device memory.
//
// The float operations are those of the plain versions
// (kernels/ref.py), one for one and in the same order: `__fadd_rn`,
// `__fsub_rn`, `__fmul_rn` and `__fdiv_rn` are never contracted into an
// FMA, and `/` is IEEE round-to-nearest as in PyTorch.  Sums over the
// pool run model by model in pool order.  gamma == 1 calls no pow; for
// other gamma, powf and torch.pow may round differently (torch.pow
// special-cases exponents such as 2), so there the kernel and the plain
// version agree to a tolerance, not to the bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-9f;   // EPS in kernels/policy_select.py
constexpr int kRows = 64;       // rows (threads) a block: probs, fused
constexpr int kWarp = 32;
constexpr int kChunk = 256;     // requests staged at once: charged
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// torch.clamp_min: a NaN passes through.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// The accuracy weight clamp_min(acc, eps)^gamma of Eq. 3.
__device__ __forceinline__ float acc_weight(float acc, float gamma) {
  const float a = clamp_min(acc, kEps);
  return gamma == 1.f ? a : powf(a, gamma);
}

// The pool as the kernels read it: operands in shared memory.  `Shifted`
// adds the charged pass's per-model waits to mu (the shifted-mu view).
struct Pool {
  const float *mu, *sig, *w, *rank;
  __device__ __forceinline__ float m(int j) const { return mu[j]; }
};
struct Shifted {
  const float *mu, *sig, *w, *rank, *wq;
  __device__ __forceinline__ float m(int j) const {
    return __fadd_rn(mu[j], wq[j]);
  }
};

// One request's stages 1-2.
struct Window {
  float tu, lo, hi;
  int base;       // the stage-1 base; 0 where there is none, as argmin gives
  bool has_base;
};

// Stage 1: Eq. 2 eligibility (mu + sigma < t_u and mu - sigma < t_l);
// the base is the eligible model of least rank, the first index winning
// a tie.  Stage 2: the window |t_l - mu_base| + sigma_base around t_l.
template <class P>
__device__ __forceinline__ Window stages12(const P& p, int n, float tu,
                                           float tl) {
  Window r;
  r.tu = tu;
  r.base = 0;
  r.has_base = false;
  float best = inf();
  for (int j = 0; j < n; ++j) {
    const float mu = p.m(j), sig = p.sig[j];
    if (__fadd_rn(mu, sig) < tu && __fsub_rn(mu, sig) < tl) {
      r.has_base = true;
      if (p.rank[j] < best) {
        best = p.rank[j];
        r.base = j;
      }
    }
  }
  const float half =
      __fadd_rn(fabsf(__fsub_rn(tl, p.m(r.base))), p.sig[r.base]);
  r.lo = __fsub_rn(tl, half);
  r.hi = __fadd_rn(tl, half);
  return r;
}

// Stage-2 membership of model j, the base forced in.
template <class P>
__device__ __forceinline__ bool eligible(const P& p, const Window& r, int j) {
  const float mu = p.m(j);
  return r.has_base &&
         (j == r.base || (r.lo <= mu && mu <= r.hi &&
                          __fadd_rn(mu, p.sig[j]) < r.tu));
}

// Eq. 3-4: w_j (t_u - (mu_j + sigma_j)) / max(|t_l - mu_j|, eps).
template <class P>
__device__ __forceinline__ float utility(const P& p, int j, float tu,
                                         float tl) {
  const float mu = p.m(j);
  const float num = __fsub_rn(tu, __fadd_rn(mu, p.sig[j]));
  const float den = clamp_min(fabsf(__fsub_rn(tl, mu)), kEps);
  return __fdiv_rn(__fmul_rn(p.w[j], num), den);
}

// Stage 3's row mass: the eligible utilities and the eligible count,
// summed model by model in pool order.  A row is degenerate where the
// mass is not finite or not positive.
struct Mass {
  float total, cnt;
  bool good;
};

template <class P, class E>
__device__ __forceinline__ Mass mass(const P& p, const E& elig, int n,
                                     float tu, float tl) {
  Mass s;
  s.total = 0.f;
  s.cnt = 0.f;
  for (int j = 0; j < n; ++j) {
    const bool e = elig(j);
    s.total = __fadd_rn(s.total, e ? utility(p, j, tu, tl) : 0.f);
    s.cnt = __fadd_rn(s.cnt, e ? 1.f : 0.f);
  }
  s.good = fabsf(s.total) < inf() && s.total > 0.f;
  return s;
}

// Model j's normalised stage-3 probability; a degenerate row is uniform
// over its eligible models.
template <class P, class E>
__device__ __forceinline__ float prob(const P& p, const E& elig,
                                      const Mass& s, int j, float tu,
                                      float tl) {
  const bool e = elig(j);
  if (s.good) return __fdiv_rn(e ? utility(p, j, tu, tl) : 0.f, s.total);
  return __fdiv_rn(e ? 1.f : 0.f, clamp_min(s.cnt, 1.f));
}

// The inverse-CDF draw: the first index whose pool-order running sum of
// weight(j) exceeds r01 * total (total: that sum's last value), else the
// base.
template <class F>
__device__ __forceinline__ int draw(const F& weight, int n, float total,
                                    float r01, int base) {
  const float thresh = __fmul_rn(r01, total);
  if (!(total > thresh)) return base;
  float c = 0.f;
  for (int j = 0; j < n; ++j) {
    c = __fadd_rn(c, weight(j));
    if (c > thresh) return j;
  }
  return base;
}

// Stage the pool's n models into shared memory (mu, sig, w, rank).
__device__ __forceinline__ Pool stage_pool(float* s, const float* mu,
                                           const float* sig, const float* acc,
                                           const float* rank, int n,
                                           float gamma) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    s[j] = mu[j];
    s[n + j] = sig[j];
    s[2 * n + j] = acc_weight(acc[j], gamma);
    if (rank) s[3 * n + j] = rank[j];
  }
  return Pool{s, s + n, s + 2 * n, s + 3 * n};
}

// K1: the (B, n) probability matrix of a given eligibility matrix.
// grid = ceil(B / kRows), block = kRows; dynamic shared memory: the
// pool (3 n floats) and the block's (kRows x (n | 1)) tile.
__global__ void __launch_bounds__(kRows)
probs_kernel(const float* __restrict__ mu, const float* __restrict__ sig,
             const float* __restrict__ acc, const float* __restrict__ tu,
             const float* __restrict__ tl, const float* __restrict__ elig,
             float* __restrict__ out, int B, int n, float gamma) {
  extern __shared__ float smem[];
  const Pool p = stage_pool(smem, mu, sig, acc, nullptr, n, gamma);
  float* tile = smem + 3 * n;
  const int ld = n | 1;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, (long long)B - row0);
  const float* src = elig + row0 * n;
  for (int i = threadIdx.x; i < rows * n; i += kRows)
    tile[(i / n) * ld + i % n] = src[i];
  __syncthreads();
  if ((int)threadIdx.x < rows) {
    const long long b = row0 + threadIdx.x;
    float* row = tile + threadIdx.x * ld;
    const float t_u = tu[b], t_l = tl[b];
    const auto e = [&](int j) { return row[j] > 0.f; };
    const Mass s = mass(p, e, n, t_u, t_l);
    // Each p_j reads only row[j] before it is overwritten.
    for (int j = 0; j < n; ++j) row[j] = prob(p, e, s, j, t_u, t_l);
  }
  __syncthreads();
  float* dst = out + row0 * n;
  for (int i = threadIdx.x; i < rows * n; i += kRows)
    dst[i] = tile[(i / n) * ld + i % n];
}

// B2: stages 1-2, K1's probabilities and the draw -> (B,) picks, -1
// where no base exists.  grid = ceil(B / kRows), block = kRows; dynamic
// shared memory: the pool (4 n floats).
__global__ void __launch_bounds__(kRows)
fused_kernel(const float* __restrict__ mu, const float* __restrict__ sig,
             const float* __restrict__ acc, const float* __restrict__ rank,
             const float* __restrict__ tu, const float* __restrict__ tl,
             const float* __restrict__ r01, int* __restrict__ out, int B,
             int n, float gamma) {
  extern __shared__ float smem[];
  const Pool p = stage_pool(smem, mu, sig, acc, rank, n, gamma);
  __syncthreads();
  const long long b = (long long)blockIdx.x * kRows + threadIdx.x;
  if (b >= B) return;
  const float t_u = tu[b], t_l = tl[b];
  const Window r = stages12(p, n, t_u, t_l);
  if (!r.has_base) {
    out[b] = -1;
    return;
  }
  const auto e = [&](int j) { return eligible(p, r, j); };
  const Mass s = mass(p, e, n, t_u, t_l);
  const auto pj = [&](int j) { return prob(p, e, s, j, t_u, t_l); };
  float total = 0.f;
  for (int j = 0; j < n; ++j) total = __fadd_rn(total, pj(j));
  out[b] = draw(pj, n, total, r01[b], r.base);
}

// B3: the charged sequential-greedy pass.  One warp walks the batch in
// order; grid = 1, block = kWarp.  Dynamic shared memory (floats, then
// bytes): the pool and the charge mu (5 n), the models' raw and clamped
// waits (2 n), the ledger and the speeds (2 R), the staged rows
// (4 kChunk), and the candidate mask transposed to (R x n) bytes.
// Outputs: ints (3, B) = picks, replica, w_chosen's bits; flags (2, B) =
// admitted, has_base.
__global__ void __launch_bounds__(kWarp)
charged_kernel(const float* __restrict__ mu, const float* __restrict__ sig,
               const float* __restrict__ acc, const float* __restrict__ rank,
               const float* __restrict__ mu_charge,
               const uint8_t* __restrict__ cand,
               const float* __restrict__ speed,
               const float* __restrict__ rep_wait,
               const float* __restrict__ tu, const float* __restrict__ tl,
               const float* __restrict__ r01, const float* __restrict__ lim,
               int* __restrict__ ints, uint8_t* __restrict__ flags, int B,
               int n, int R, float gamma, float slack, int include_mu,
               int fastest) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const Pool p0 = stage_pool(smem, mu, sig, acc, rank, n, gamma);
  float* sMuC = smem + 4 * n;
  float* sWqRaw = sMuC + n;
  float* sWq = sWqRaw + n;
  float* sLedger = sWq + n;
  float* sSpeed = sLedger + R;
  float* sRows = sSpeed + R;  // (4, kChunk): t_u, t_l, r01, lim
  uint8_t* sCand = reinterpret_cast<uint8_t*>(sRows + 4 * kChunk);
  for (int j = lane; j < n; j += kWarp) sMuC[j] = mu_charge[j];
  for (int r = lane; r < R; r += kWarp) {
    sLedger[r] = rep_wait[r];
    sSpeed[r] = speed[r];
  }
  for (int i = lane; i < n * R; i += kWarp)
    sCand[(i % R) * n + i / R] = cand[i];
  const Shifted p{p0.mu, p0.sig, p0.w, p0.rank, sWq};
  int* picks = ints;
  int* replica = ints + B;
  float* w_chosen = reinterpret_cast<float*>(ints + 2 * B);

  for (int c0 = 0; c0 < B; c0 += kChunk) {
    const int rows = min(kChunk, B - c0);
    __syncwarp();
    for (int k = lane; k < rows; k += kWarp) {
      sRows[k] = tu[c0 + k];
      sRows[kChunk + k] = tl[c0 + k];
      sRows[2 * kChunk + k] = r01[c0 + k];
      sRows[3 * kChunk + k] = lim[c0 + k];
    }
    __syncwarp();
    for (int k = 0; k < rows; ++k) {
      const int i = c0 + k;
      const float t_u = sRows[k], t_l = sRows[kChunk + k];
      const float lim_i = sRows[3 * kChunk + k];
      // Each model's wait: the least over its candidate replicas; a
      // model with no finite wait is not shifted.  Admission: some
      // model has W + slack (+ mu) < lim.
      bool ok = false;
      for (int j = lane; j < n; j += kWarp) {
        float wr = inf();
        for (int r = 0; r < R; ++r) {
          const float v = sLedger[r];
          if (sCand[r * n + j] && v < wr) wr = v;
        }
        sWqRaw[j] = wr;
        sWq[j] = fabsf(wr) < inf() ? wr : 0.f;
        float cost = __fadd_rn(wr, slack);
        if (include_mu) cost = __fadd_rn(cost, sMuC[j]);
        ok |= cost < lim_i;
      }
      const bool admitted = __any_sync(kAll, ok);
      __syncwarp();
      // Selection on mu + W (lane 0): the reference's unnormalised
      // weights, uniform over the eligible models on a degenerate row.
      int pick = fastest;
      bool has_base = false;
      if (lane == 0) {
        const Window win = stages12(p, n, t_u, t_l);
        has_base = win.has_base;
        if (has_base) {
          const auto e = [&](int j) { return eligible(p, win, j); };
          const Mass s = mass(p, e, n, t_u, t_l);
          const auto wj = [&](int j) {
            const bool ej = e(j);
            if (s.good) return ej ? utility(p, j, t_u, t_l) : 0.f;
            return ej ? 1.f : 0.f;
          };
          pick = draw(wj, n, s.good ? s.total : s.cnt,
                      sRows[2 * kChunk + k], win.base);
        }
      }
      pick = __shfl_sync(kAll, pick, 0);
      // The least-loaded capable replica, the first index winning a tie
      // (with no finite candidate, index 0, as argmin gives).
      float bv = inf();
      int bi = R;
      for (int r = lane; r < R; r += kWarp) {
        const float v = sCand[r * n + pick] ? sLedger[r] : inf();
        if (bi == R || v < bv) {
          bv = v;
          bi = r;
        }
      }
      for (int off = kWarp / 2; off; off >>= 1) {
        const float ov = __shfl_xor_sync(kAll, bv, off);
        const int oi = __shfl_xor_sync(kAll, bi, off);
        if (ov < bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        const float delta =
            admitted ? __fdiv_rn(sMuC[pick], sSpeed[bi]) : 0.f;
        sLedger[bi] = __fadd_rn(sLedger[bi], delta);
        float wmin = inf();
        for (int j = 0; j < n; ++j) wmin = sWqRaw[j] < wmin ? sWqRaw[j] : wmin;
        picks[i] = pick;
        replica[i] = bi;
        w_chosen[i] = admitted ? sWq[pick] : wmin;
        flags[i] = admitted;
        flags[B + i] = has_base;
      }
      __syncwarp();
    }
  }
}

// The charged block's shared memory (``charged_smem_bytes`` in
// kernels/policy_select.py mirrors it for CPU calls;
// ``charged_select_smem`` below reports it to the wrapper on the card).
long long charged_smem(int n, int R) {
  return (long long)sizeof(float) * (7 * n + 2 * R + 4 * kChunk) +
         (long long)n * R;
}

}  // namespace

// All pointers are float32 device arrays unless named otherwise: mu,
// sig, acc, rank (n,); t_u, t_l, r01, lim (B,); elig and out (B, n)
// row-major.  Each returns cudaGetLastError() after its launch (0 when
// B is 0 and nothing is launched).

extern "C" int modipick_probs_fwd(const float* mu, const float* sig,
                                  const float* acc, const float* tu,
                                  const float* tl, const float* elig,
                                  float* out, int B, int n, float gamma,
                                  void* stream) {
  if (B <= 0) return 0;
  const int smem = (int)sizeof(float) * (3 * n + kRows * (n | 1));
  probs_kernel<<<(B + kRows - 1) / kRows, kRows, smem,
                 static_cast<cudaStream_t>(stream)>>>(mu, sig, acc, tu, tl,
                                                      elig, out, B, n, gamma);
  return (int)cudaGetLastError();
}

// out: (B,) int32 picks, -1 where no base exists.
extern "C" int fused_select_fwd(const float* mu, const float* sig,
                                const float* acc, const float* rank,
                                const float* tu, const float* tl,
                                const float* r01, int* out, int B, int n,
                                float gamma, void* stream) {
  if (B <= 0) return 0;
  fused_kernel<<<(B + kRows - 1) / kRows, kRows,
                 (int)sizeof(float) * 4 * n,
                 static_cast<cudaStream_t>(stream)>>>(mu, sig, acc, rank, tu,
                                                      tl, r01, out, B, n,
                                                      gamma);
  return (int)cudaGetLastError();
}

// mu_charge (n,); cand (n, R) uint8 0/1; speed, rep_wait (R,).  ints
// (3, B) int32: picks, replica, w_chosen (float32 bits); flags (2, B)
// uint8: admitted, has_base.  rep_wait is read, never written.
extern "C" int charged_select_fwd(
    const float* mu, const float* sig, const float* acc, const float* rank,
    const float* mu_charge, const uint8_t* cand, const float* speed,
    const float* rep_wait, const float* tu, const float* tl,
    const float* r01, const float* lim, int* ints, uint8_t* flags, int B,
    int n, int R, float gamma, float slack, int include_mu, int fastest,
    void* stream) {
  if (B <= 0) return 0;
  const int smem = (int)charged_smem(n, R);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        charged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  charged_kernel<<<1, kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      mu, sig, acc, rank, mu_charge, cand, speed, rep_wait, tu, tl, r01, lim,
      ints, flags, B, n, R, gamma, slack, include_mu, fastest);
  return (int)cudaGetLastError();
}

// The charged block's shared memory at (n, R) and the most a block of
// ``device`` may have (cudaDevAttrMaxSharedMemoryPerBlockOptin).
extern "C" int charged_select_smem(int device, int n, int R, long long* smem,
                                   int* limit) {
  *smem = charged_smem(n, R);
  return (int)cudaDeviceGetAttribute(
      limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}
