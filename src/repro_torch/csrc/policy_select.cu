// ModiPick selection for Hopper (sm_90a): stages 1-3 and the
// inverse-CDF draw as one set of per-row device functions, and four
// kernels on them.
//
// Replaces, from src/repro/kernels/policy_select.py:
// - `_probs_kernel` (the Pallas TPU kernel behind `modipick_probs`):
//   stage 3, the Eq. 3-4 utilities of a given (B, n) eligibility
//   matrix, normalised per row -> `probs_kernel`;
// - `_fused_select` (jitted jnp around that kernel): stages 1-2, the
//   stage-3 probabilities and the draw -> `fused_kernel`;
// - `charged_select` / `_charged_step` (a `lax.scan` over the batch whose
//   carry is the per-replica wait ledger) -> `charged_kernel`;
// - `_classed_select` (premodel: each request's mu/sigma row gathered by
//   its input class, plus per-model queue shifts) and `fleet_select_body`
//   (vmapped over the fleet's cells), both jitted jnp -> `stacked_kernel`.
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
//   charges of 0..i-1), so it is a chain of B requests that ONE warp
//   walks, and what bounds it is the chain's length in cycles.  The
//   models live in the warp's lanes with their state in registers, and
//   every stage runs across the lanes (see `charged_kernel`): a request
//   costs a vote, a 64-bit warp argmin, one pool-order sum over n, a
//   few shuffles and one ledger read-modify-write, after which only the
//   models the charged replica serves rescan their own replicas (a
//   compact candidate list, not an (R x n) mask).  The budget rows are
//   staged in shared memory kChunk requests at a time, and the outputs
//   leave kChunk at a time, coalesced.
// - The stacked selection gives each request a pool row of its own (its
//   class's row, or its cell's), so no one pool is staged: each thread
//   reads its row from device memory, where the K (or C) rows of at
//   most a few kB stay in L1 and L2 for the whole launch.  acc and rank
//   are shared by every row (a row stride of 0: classed) or have a row
//   each (stride n: the fleet, whose padded lanes carry PAD_MU and
//   PAD_RANK and are never eligible).
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

// The pool as the kernels read it: `Pool`, operands in shared memory;
// `Shifted` adds the charged pass's per-model waits to mu (the shifted-mu
// view).
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

// The accuracy weights of a pool row in device memory, computed as read.
struct AccWeights {
  const float* acc;
  float gamma;
  __device__ __forceinline__ float operator[](int j) const {
    return acc_weight(acc[j], gamma);
  }
};

// `Stacked`: one request's own pool row, read from device memory, with
// the optional per-model shifts added to mu (none: `shift` is null).
struct Stacked {
  const float *mu, *sig;
  AccWeights w;
  const float *rank, *shift;
  __device__ __forceinline__ float m(int j) const {
    return shift ? __fadd_rn(mu[j], shift[j]) : mu[j];
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

// B3: the charged sequential-greedy pass, ONE warp over the whole batch
// in order (grid = 1, block = kWarp), with the models in its lanes: lane
// l holds models j = l + 32 t, t < T = ceil(n / 32), and each model's
// state for the whole launch (`Lanes`).  Request i's chain:
// - admission: each lane tests its models' W + slack (+ mu) < lim, one
//   vote;
// - stage 1: Eq. 2 per lane, then the base as a warp argmin on (rank,
//   index): each model's place in that order is ranked once a launch,
//   so the argmin is one hardware min-reduction over 32-bit keys;
// - stage 2 and the utilities: each lane for its models, once;
// - the pool-order mass and CDF: the utilities go to shared memory and
//   every lane runs the one sequential sum c_j = c_{j-1} + u_j
//   (__fadd_rn) on them, four loads at a time, keeping c_j at its own
//   models.  The total is the last c, the draw the first set bit of a
//   ballot of c_j > thresh.  A degenerate row counts its
//   eligible models by popcounts of the eligibility ballot (an integer
//   sum, exact);
// - the replica: each model keeps the first replica of least wait among
//   its candidates beside that wait and the charge a pick of it adds
//   there (mu_charge / speed, divided once a launch for every candidate
//   pair), so the pick's replica and charge are a shuffle each;
// - the charge: one ledger write in shared memory, then the models that
//   replica serves (its row of the inverse candidate list) rescan their
//   own replicas, four loads at a time;
// - a shed row's w_chosen, the least raw wait, is a min-reduction.
// The next request's budget row is read while this one is judged, and
// the outputs are staged kChunk requests at a time and stored
// coalesced.
// The candidate lists (`lists`, int32): the model rows' offsets (n + 1),
// their replicas in ascending order (nnz), the replica rows' offsets
// (R + 1) and their models in ascending order (nnz).
// Shared memory (4-byte words, then bytes): the lanes' state when it
// lives there (NT == 0: kLaneArrays x 32 T), the utilities (32 T), the
// staged rows (4 kChunk), the ledger and the speeds (2 R), the
// candidates' charges and the model rows' replicas (2 nnz), the replica
// rows' offsets and models (R + 1 + nnz), the staged outputs (3 kChunk
// words, 2 kChunk bytes).
constexpr int kLaneArrays = 13;  // the per-model arrays of `Lanes`
constexpr int kLaneSlots = 4;    // slots a lane holds in registers

// One lane's models and their state.  NT > 0: in registers (n <= 32 NT;
// loops over t unroll, so every index is static); NT == 0: in shared
// memory at [a][t][lane], any n.
template <int NT>
struct Lanes {
  static constexpr int kSlots = NT;
  float mu_[NT], sig_[NT], w_[NT], muc_[NT], wr_[NT], ms_[NT], c_[NT],
      dq_[NT];
  int pre_[NT], key_[NT], ri_[NT], rs_[NT], rl_[NT];
  __device__ Lanes(float*, int, int) {}
  __device__ float& mu(int t) { return mu_[t]; }
  __device__ float& sig(int t) { return sig_[t]; }
  __device__ float& w(int t) { return w_[t]; }     // accuracy weight
  __device__ float& muc(int t) { return muc_[t]; }
  __device__ float& wr(int t) { return wr_[t]; }   // raw wait
  __device__ float& ms(int t) { return ms_[t]; }   // mu + wait
  __device__ float& c(int t) { return c_[t]; }     // running sum
  __device__ int& pre(int t) { return pre_[t]; }   // eligible up to here
  __device__ float& dq(int t) { return dq_[t]; }   // charge at ri
  __device__ int& key(int t) { return key_[t]; }   // place in rank order
  __device__ int& ri(int t) { return ri_[t]; }     // least-wait replica
  __device__ int& rs(int t) { return rs_[t]; }     // candidate row
  __device__ int& rl(int t) { return rl_[t]; }
};
template <>
struct Lanes<0> {
  static constexpr int kSlots = 1 << 30;
  float* s;
  int stride, lane;
  __device__ Lanes(float* smem, int T, int l)
      : s(smem), stride(kWarp * T), lane(l) {}
  __device__ float& f(int a, int t) { return s[a * stride + t * kWarp + lane]; }
  __device__ int& i(int a, int t) {
    return reinterpret_cast<int*>(s)[a * stride + t * kWarp + lane];
  }
  __device__ float& mu(int t) { return f(0, t); }
  __device__ float& sig(int t) { return f(1, t); }
  __device__ float& w(int t) { return f(2, t); }
  __device__ float& muc(int t) { return f(3, t); }
  __device__ float& wr(int t) { return f(4, t); }
  __device__ float& ms(int t) { return f(5, t); }
  __device__ float& c(int t) { return f(6, t); }
  __device__ float& dq(int t) { return f(7, t); }
  __device__ int& pre(int t) { return i(8, t); }
  __device__ int& key(int t) { return i(9, t); }
  __device__ int& ri(int t) { return i(10, t); }
  __device__ int& rs(int t) { return i(11, t); }
  __device__ int& rl(int t) { return i(12, t); }
};

// The operands of one charged launch (pointers to device memory).
struct ChargedArgs {
  const float *mu, *sig, *acc, *rank, *mu_charge;
  const int* lists;
  const float *speed, *rep_wait, *tu, *tl, *r01, *lim;
  int* ints;
  uint8_t* flags;
  int B, n, R, nnz;
  float gamma, slack;
  int include_mu, fastest;
};

// A float's bits as an unsigned integer of the same order (-0 taken as
// +0), and back.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(__fadd_rn(x, 0.f));
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float from_order_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Model slot t's least wait over its candidate replicas, the first
// replica that has it (replica 0 where none is finite, as argmin gives)
// and the charge a pick of it adds there; and its shifted mu (a model
// with no finite wait is not shifted).  The candidates are read four at
// a time, so that their loads overlap.
template <class L>
__device__ __forceinline__ void refresh(L& st, int t, const float* ledger,
                                        const int* cols, const float* dqs,
                                        float dq0) {
  float best = inf();
  int bi = 0;
  float dq = dq0;
  const int e1 = st.rs(t) + st.rl(t);
  for (int e = st.rs(t); e < e1; e += 4) {
    int r[4];
    float v[4], d[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) r[q] = e + q < e1 ? cols[e + q] : -1;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = r[q] >= 0 ? ledger[r[q]] : inf();
      d[q] = r[q] >= 0 ? dqs[e + q] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (v[q] < best) {
        best = v[q];
        bi = r[q];
        dq = d[q];
      }
  }
  st.wr(t) = best;
  st.ri(t) = bi;
  st.dq(t) = dq;
  st.ms(t) = __fadd_rn(st.mu(t), fabsf(best) < inf() ? best : 0.f);
}

// Slot s's value of a per-model array, for a slot index that is uniform
// across the warp but not known at compile time.
#define LANE_AT(st, field, s, T, out)                                  \
  _Pragma("unroll") for (int t_ = 0; t_ < L::kSlots && t_ < (T); ++t_) \
      if (t_ == (s)) out = st.field(t_);

template <int NT>
__global__ void __launch_bounds__(kWarp) charged_kernel(ChargedArgs a) {
  using L = Lanes<NT>;
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int n = a.n, R = a.R, nnz = a.nnz, B = a.B;
  const int T = (n + kWarp - 1) / kWarp;
  float* sU = smem + (NT == 0 ? kLaneArrays * kWarp * T : 0);  // (32 T)
  float* sRows = sU + kWarp * T;   // (4, kChunk): t_u, t_l, r01, lim
  float* sLedger = sRows + 4 * kChunk;
  float* sSpeed = sLedger + R;
  float* sDq = sSpeed + R;         // (nnz): the candidates' charges
  int* sCols = reinterpret_cast<int*>(sDq + nnz);
  int* sRptr = sCols + nnz;
  int* sRmod = sRptr + R + 1;
  int* sOut = sRmod + nnz;    // (3, kChunk): pick, replica, w_chosen
  uint8_t* sFlag = reinterpret_cast<uint8_t*>(sOut + 3 * kChunk);
  const int* rowptr = a.lists;
  const int* cols = rowptr + n + 1;
  for (int r = lane; r < R; r += kWarp) {
    sLedger[r] = a.rep_wait[r];
    sSpeed[r] = a.speed[r];
  }
  for (int e = lane; e < nnz; e += kWarp) {
    sCols[e] = cols[e];
    sRmod[e] = cols[nnz + R + 1 + e];
  }
  for (int r = lane; r <= R; r += kWarp) sRptr[r] = cols[nnz + r];
  L st(smem, T, lane);
  float dq0[NT > 0 ? NT : 1];  // the charge at replica 0, NT > 0
#pragma unroll
  for (int t = 0; t < L::kSlots && t < T; ++t) {
    const int j = lane + kWarp * t;
    if (j < n) {
      st.mu(t) = a.mu[j];
      st.sig(t) = a.sig[j];
      st.w(t) = acc_weight(a.acc[j], a.gamma);
      st.muc(t) = a.mu_charge[j];
      st.rs(t) = rowptr[j];
      st.rl(t) = rowptr[j + 1] - rowptr[j];
      // the place of j in the order of (rank, index)
      const float rj = a.rank[j];
      int key = 0;
      for (int k = 0; k < n; ++k) {
        const float rk = a.rank[k];
        key += rk < rj || (rk == rj && k < j);
      }
      st.key(t) = key;
    }
  }
  __syncwarp();
  for (int e = lane; e < nnz; e += kWarp) {
    // the charge of model m at candidate e: m is the row that holds e
    int lo = 0, hi = n - 1;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (rowptr[mid + 1] <= e) lo = mid + 1;
      else hi = mid;
    }
    sDq[e] = __fdiv_rn(a.mu_charge[lo], sSpeed[sCols[e]]);
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < L::kSlots && t < T; ++t) {
    if (lane + kWarp * t < n) {
      const float d0 = __fdiv_rn(st.muc(t), sSpeed[0]);
      if (NT > 0) dq0[NT > 0 ? t : 0] = d0;
      refresh(st, t, sLedger, sCols, sDq, d0);
    }
  }
  const unsigned lanes_le = 0xffffffffu >> (kWarp - 1 - lane);

  for (int c0 = 0; c0 < B; c0 += kChunk) {
    const int rows = min(kChunk, B - c0);
    __syncwarp();
    for (int k = lane; k < rows; k += kWarp) {
      sRows[k] = a.tu[c0 + k];
      sRows[kChunk + k] = a.tl[c0 + k];
      sRows[2 * kChunk + k] = a.r01[c0 + k];
      sRows[3 * kChunk + k] = a.lim[c0 + k];
    }
    __syncwarp();
    float t_u = sRows[0], t_l = sRows[kChunk];
    float r01 = sRows[2 * kChunk], lim = sRows[3 * kChunk];
    for (int k = 0; k < rows; ++k) {
      const float ledger0 = sLedger[0];
      // Admission: some model has W + slack (+ mu) < lim.  Stage 1:
      // the eligible model of least (rank, index) on mu + W.
      bool ok = false;
      unsigned key = 0xffffffffu;
#pragma unroll
      for (int t = 0; t < L::kSlots && t < T; ++t) {
        if (lane + kWarp * t < n) {
          float cost = __fadd_rn(st.wr(t), a.slack);
          if (a.include_mu) cost = __fadd_rn(cost, st.muc(t));
          ok |= cost < lim;
          const float m = st.ms(t), sg = st.sig(t);
          if (__fadd_rn(m, sg) < t_u && __fsub_rn(m, sg) < t_l)
            key = min(key, (unsigned)st.key(t));
        }
      }
      const bool admitted = __any_sync(kAll, ok);
      key = __reduce_min_sync(kAll, key);
      const bool has_base = key != 0xffffffffu;
      int pick = a.fastest;
      if (has_base) {
        int base = 0;
#pragma unroll
        for (int t = 0; t < L::kSlots && t < T; ++t) {
          const unsigned at = __ballot_sync(
              kAll, lane + kWarp * t < n && st.key(t) == (int)key);
          if (at) base = kWarp * t + __ffs(at) - 1;
        }
        float mb = 0.f, sb = 0.f;
        LANE_AT(st, ms, base / kWarp, T, mb);
        LANE_AT(st, sig, base / kWarp, T, sb);
        mb = __shfl_sync(kAll, mb, base % kWarp);
        sb = __shfl_sync(kAll, sb, base % kWarp);
        const float half = __fadd_rn(fabsf(__fsub_rn(t_l, mb)), sb);
        const float lo = __fsub_rn(t_l, half), hi = __fadd_rn(t_l, half);
        // Stage 2 and the Eq. 3-4 utilities, once a model; the running
        // count of eligible models for a degenerate row.
        int cnt = 0;
#pragma unroll
        for (int t = 0; t < L::kSlots && t < T; ++t) {
          const int j = lane + kWarp * t;
          const float m = st.ms(t), sg = st.sig(t);
          const bool e = j < n && (j == base || (lo <= m && m <= hi &&
                                                 __fadd_rn(m, sg) < t_u));
          // in every lane, so the warp never diverges; a lane without an
          // eligible model divides 0 by 1
          const float num = e ? __fsub_rn(t_u, __fadd_rn(m, sg)) : 0.f;
          const float den = e ? clamp_min(fabsf(__fsub_rn(t_l, m)), kEps)
                              : 1.f;
          sU[j] = __fdiv_rn(__fmul_rn(e ? st.w(t) : 0.f, num), den);
          const unsigned eb = __ballot_sync(kAll, e);
          st.pre(t) = cnt + __popc(eb & lanes_le);
          cnt += __popc(eb);
        }
        __syncwarp();
        // The mass and the CDF: one sum in pool order, run by every
        // lane, four utilities a load and the next four loaded ahead;
        // each lane keeps c at its own models.
        float c = 0.f;
#pragma unroll
        for (int t = 0; t < L::kSlots && t < T; ++t) {  // 32 models a slot
          const int l1 = min(n, kWarp * (t + 1));
          float ct = 0.f;
          float4 next = *reinterpret_cast<const float4*>(sU + kWarp * t);
          for (int l0 = kWarp * t; l0 < l1; l0 += 4) {
            const float4 u4 = next;
            if (l0 + 4 < l1)
              next = *reinterpret_cast<const float4*>(sU + l0 + 4);
            const float ul[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int l = l0 + q;
              c = l < l1 ? __fadd_rn(c, ul[q]) : c;
              ct = l == lane + kWarp * t ? c : ct;
            }
          }
          st.c(t) = ct;
        }
        const bool good = fabsf(c) < inf() && c > 0.f;
        const float total = good ? c : (float)cnt;
        const float thresh = __fmul_rn(r01, total);
        pick = base;
        if (total > thresh) {
          bool found = false;
#pragma unroll
          for (int t = 0; t < L::kSlots && t < T; ++t) {
            const int j = lane + kWarp * t;
            const bool over = j < n && (good ? st.c(t) > thresh
                                             : (float)st.pre(t) > thresh);
            const unsigned d = __ballot_sync(kAll, over);
            if (!found && d) {
              pick = kWarp * t + __ffs(d) - 1;
              found = true;
            }
          }
        }
      }
      // The pick's least-loaded capable replica, its wait and the charge.
      int bi = 0;
      float wr_p = 0.f, dq_p = 0.f;
      LANE_AT(st, ri, pick / kWarp, T, bi);
      LANE_AT(st, wr, pick / kWarp, T, wr_p);
      LANE_AT(st, dq, pick / kWarp, T, dq_p);
      bi = __shfl_sync(kAll, bi, pick % kWarp);
      wr_p = __shfl_sync(kAll, wr_p, pick % kWarp);
      dq_p = __shfl_sync(kAll, dq_p, pick % kWarp);
      float w_chosen = fabsf(wr_p) < inf() ? wr_p : 0.f;
      // the next request's row, read while this one is charged
      const int kn = min(k + 1, rows - 1);
      t_u = sRows[kn];
      t_l = sRows[kChunk + kn];
      r01 = sRows[2 * kChunk + kn];
      lim = sRows[3 * kChunk + kn];
      if (admitted) {
        // The charge, then the models bi serves recompute their wait.
        // Where the pick has a replica of finite or -inf wait, bi holds
        // that wait; otherwise bi is replica 0.
        const float v = __fadd_rn(wr_p < inf() ? wr_p : ledger0, dq_p);
        const int e0 = sRptr[bi], e1 = sRptr[bi + 1];
        sLedger[bi] = v;  // every lane writes the same value
        __syncwarp();
        for (int e = e0; e < e1; ++e) {
          const int m = sRmod[e];
          if (m % kWarp == lane) {
#pragma unroll
            for (int t = 0; t < L::kSlots && t < T; ++t)
              if (t == m / kWarp)
                refresh(st, t, sLedger, sCols, sDq,
                        NT > 0 ? dq0[NT > 0 ? t : 0]
                               : __fdiv_rn(st.muc(t), sSpeed[0]));
          }
        }
        __syncwarp();
      } else {
        unsigned wmin = 0xffffffffu;
#pragma unroll
        for (int t = 0; t < L::kSlots && t < T; ++t)
          if (lane + kWarp * t < n) wmin = min(wmin, order_key(st.wr(t)));
        w_chosen = from_order_key(__reduce_min_sync(kAll, wmin));
      }
      sOut[k] = pick;  // the same values from every lane
      sOut[kChunk + k] = bi;
      sOut[2 * kChunk + k] = __float_as_int(w_chosen);
      sFlag[k] = admitted;
      sFlag[kChunk + k] = has_base;
    }
    __syncwarp();
    for (int k = lane; k < rows; k += kWarp) {
      a.ints[c0 + k] = sOut[k];
      a.ints[B + c0 + k] = sOut[kChunk + k];
      a.ints[2 * B + c0 + k] = sOut[2 * kChunk + k];
      a.flags[c0 + k] = sFlag[k];
      a.flags[B + c0 + k] = sFlag[kChunk + k];
    }
  }
}
#undef LANE_AT

// B4: stages 1-3 and the draw with a pool row per request -> (B,) picks
// and has_base flags.  Request b reads pool row row[b] of mu and sig (P,
// n) and of acc and rank (row stride acc_stride: 0 or n); shift (n,) or
// null.  The weights are the charged pass's unnormalised ones (uniform
// over the eligible models on a degenerate row).  Where no base exists
// the pick is, with `fallback`, the first index of least (shifted) mu in
// the row, else -1.  grid = ceil(B / kRows), block = kRows; no shared
// memory.
__global__ void __launch_bounds__(kRows)
stacked_kernel(const float* __restrict__ mu, const float* __restrict__ sig,
               const float* __restrict__ acc, const float* __restrict__ rank,
               const int* __restrict__ row, const float* __restrict__ shift,
               const float* __restrict__ tu, const float* __restrict__ tl,
               const float* __restrict__ r01, int* __restrict__ out,
               uint8_t* __restrict__ has, int B, int n, int acc_stride,
               float gamma, int fallback) {
  const long long b = (long long)blockIdx.x * kRows + threadIdx.x;
  if (b >= B) return;
  const long long r = row[b];
  const Stacked p{mu + r * n, sig + r * n,
                  AccWeights{acc + r * acc_stride, gamma},
                  rank + r * acc_stride, shift};
  const float t_u = tu[b], t_l = tl[b];
  const Window win = stages12(p, n, t_u, t_l);
  has[b] = win.has_base;
  if (!win.has_base) {
    int pick = -1;
    if (fallback) {
      pick = 0;
      float best = p.m(0);
      for (int j = 1; j < n; ++j) {
        const float v = p.m(j);
        if (v < best) {
          best = v;
          pick = j;
        }
      }
    }
    out[b] = pick;
    return;
  }
  const auto e = [&](int j) { return eligible(p, win, j); };
  const Mass s = mass(p, e, n, t_u, t_l);
  const auto wj = [&](int j) {
    const bool ej = e(j);
    if (s.good) return ej ? utility(p, j, t_u, t_l) : 0.f;
    return ej ? 1.f : 0.f;
  };
  out[b] = draw(wj, n, s.good ? s.total : s.cnt, r01[b], win.base);
}

// The charged block's shared memory at n models over R replicas with nnz
// (model, replica) candidate pairs (``charged_smem_bytes`` in
// kernels/policy_select.py mirrors it for CPU calls;
// ``charged_select_smem`` below reports it to the wrapper on the card).
long long charged_smem(int n, int R, int nnz) {
  const long long T = (n + kWarp - 1) / kWarp;
  const long long lanes = n > kWarp * kLaneSlots ? kLaneArrays * kWarp * T : 0;
  return (long long)sizeof(float) * (lanes + 3LL * R + 1 + 3LL * nnz +
                                     kWarp * T + 7 * kChunk) +
         2 * kChunk;
}

template <int NT>
int launch_charged(const ChargedArgs& a, long long smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        charged_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  charged_kernel<NT><<<1, kWarp, smem, stream>>>(a);
  return (int)cudaGetLastError();
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

// mu_charge (n,); lists: int32 candidate lists with nnz (model, replica)
// pairs, laid out as `charged_kernel` reads them; speed, rep_wait (R,).
// ints (3, B) int32: picks, replica, w_chosen (float32 bits); flags (2,
// B) uint8: admitted, has_base.  rep_wait is read, never written.  The
// lanes hold their models in registers up to 32 x kLaneSlots models.
extern "C" int charged_select_fwd(
    const float* mu, const float* sig, const float* acc, const float* rank,
    const float* mu_charge, const int* lists, const float* speed,
    const float* rep_wait, const float* tu, const float* tl,
    const float* r01, const float* lim, int* ints, uint8_t* flags, int B,
    int n, int R, int nnz, float gamma, float slack, int include_mu,
    int fastest, void* stream) {
  if (B <= 0) return 0;
  const ChargedArgs a{mu, sig, acc, rank, mu_charge, lists, speed, rep_wait,
                      tu, tl, r01, lim, ints, flags, B, n, R, nnz, gamma,
                      slack, include_mu, fastest};
  const long long smem = charged_smem(n, R, nnz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= kWarp) return launch_charged<1>(a, smem, s);
  if (n <= kWarp * kLaneSlots) return launch_charged<kLaneSlots>(a, smem, s);
  return launch_charged<0>(a, smem, s);
}

// mu, sig (P, n); acc, rank (P, n) with acc_stride n, or (n,) with 0;
// row (B,) int32 in [0, P); shift (n,) or null; out (B,) int32; has (B,)
// uint8.
extern "C" int stacked_select_fwd(const float* mu, const float* sig,
                                  const float* acc, const float* rank,
                                  const int* row, const float* shift,
                                  const float* tu, const float* tl,
                                  const float* r01, int* out, uint8_t* has,
                                  int B, int n, int acc_stride, float gamma,
                                  int fallback, void* stream) {
  if (B <= 0) return 0;
  stacked_kernel<<<(B + kRows - 1) / kRows, kRows, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      mu, sig, acc, rank, row, shift, tu, tl, r01, out, has, B, n,
      acc_stride, gamma, fallback);
  return (int)cudaGetLastError();
}

// The charged block's shared memory at (n, R, nnz) and the most a block
// of ``device`` may have (cudaDevAttrMaxSharedMemoryPerBlockOptin).
extern "C" int charged_select_smem(int device, int n, int R, int nnz,
                                   long long* smem, int* limit) {
  *smem = charged_smem(n, R, nnz);
  return (int)cudaDeviceGetAttribute(
      limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}
