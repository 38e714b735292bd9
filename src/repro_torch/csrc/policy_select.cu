// ModiPick selection for Hopper (sm_90a): stages 1-3 and the
// inverse-CDF draw, as four kernels.
//
// Replaces, from src/repro/kernels/policy_select.py:
// - `_probs_kernel` (the Pallas TPU kernel behind `modipick_probs`):
//   stage 3, the Eq. 3-4 utilities of a given (B, n) eligibility
//   matrix, normalised per row -> `probs_kernel`;
// - `_fused_select` (jitted jnp around that kernel): stages 1-2, the
//   stage-3 probabilities and the draw -> `select_kernel<true, ...>`;
// - `charged_select` / `_charged_step` (a `lax.scan` over the batch whose
//   carry is the per-replica wait ledger) -> `charged_kernel`;
// - `_classed_select` (premodel: each request's mu/sigma row gathered by
//   its input class, plus per-model queue shifts) and `fleet_select_body`
//   (vmapped over the fleet's cells), both jitted jnp ->
//   `select_kernel<false, ...>`.
// The TPU kernel rode the pool on the 128-lane axis and the batch on
// sublanes, one (bb, 128) tile a grid step, because a TPU core does
// vector work on whole tiles.
//
// What bounds them on this card: neither bytes nor operations.  At the
// engine's burst (B 200, n 11) a fused call moves ~3 kB and does some 20
// flops a (request, model) pair: 0.001 us at 3.35 TB/s.  What a call pays is
// its launch and, inside it, how long one request's work stays
// serialised: a pool-order sum of n dependent adds (twice where the draw
// is normalised), Eq. 3-4's divisions, and the loads that feed them.  So
// each selection is ONE launch that reads the pool and the budget rows
// and writes the picks, and inside it a request's models are spread over
// the lanes of a warp:
// - `select_kernel` (B2 and B4, one template): a request takes a segment
//   of L lanes, L the next power of two >= n up to 32; 32 / L requests
//   share a warp, and lane l of a segment holds models l + L t.  Each
//   lane loads its models once; stage 1 is a segment min-reduction over
//   (rank, index); stage 2 and Eq. 3-4 run once a model, one division
//   each; the pool-order sums stay sequential, for the bits, so the
//   utilities go to the warp's shared memory and every lane of the
//   segment runs the one chain on them, four loads at a time; a
//   degenerate row counts its eligible models with popcounts of the
//   segment's ballot; the draw is the first set bit of a ballot.  Four
//   warps a block, so that a 200-request burst at n 11 spreads over 25
//   SMs.  Where a batch fills the card on its own (B 100,000), latency
//   no longer bounds a call but the instructions issued do, and each
//   lane's share of a request's collectives is overhead: such a request
//   takes fewer lanes, each with up to four models (`select_plan`).
//   The lanes hold their models in registers up to four a lane; past
//   that their state lives in the warp's shared memory (`Slots<0>`).
// - `probs_kernel` (K1) keeps its interface (a given eligibility matrix
//   in, the probability matrix out) and its per-row walk: the block
//   stages its (rows x n) tile in shared memory with coalesced loads,
//   each thread overwrites its own row there with its probabilities, and
//   the block stores the tile coalesced again.  The row pitch is odd (n |
//   1), so a warp's threads reading their rows' element j hit 32
//   different banks.  64 rows a block, fewer where the tile would not fit.
// - The charged pass is sequential along the batch (request i sees the
//   charges of 0..i-1), so it is a chain of B requests that ONE warp
//   walks, and what bounds it is the chain's length in cycles.  The
//   models live in the warp's lanes with their state in registers, and
//   every stage runs across the lanes (see `charged_kernel`): a request
//   costs a vote, a 32-bit warp min-reduction, one pool-order sum over n, a
//   few shuffles and one ledger read-modify-write, after which only the
//   models the charged replica serves rescan their own replicas (a
//   compact candidate list, not an (R x n) mask).  The budget rows are
//   staged in shared memory kChunk requests at a time, and the outputs
//   leave kChunk at a time, coalesced.
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

#include <algorithm>

namespace {

constexpr float kEps = 1e-9f;   // EPS in kernels/policy_select.py
constexpr int kRows = 64;       // rows (threads) a block at most: probs
constexpr int kWarp = 32;
constexpr int kChunk = 256;     // requests staged at once: charged
constexpr unsigned kAll = 0xffffffffu;
constexpr long long kDefaultSmem = 48 * 1024;  // without an opt-in

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

// The pool as K1 reads it, in shared memory.
struct Pool {
  const float *mu, *sig, *w;
};

// Eq. 3-4: w_j (t_u - (mu_j + sigma_j)) / max(|t_l - mu_j|, eps).
__device__ __forceinline__ float utility(const Pool& p, int j, float tu,
                                         float tl) {
  const float mu = p.mu[j];
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

template <class E>
__device__ __forceinline__ Mass mass(const Pool& p, const E& elig, int n,
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
template <class E>
__device__ __forceinline__ float prob(const Pool& p, const E& elig,
                                      const Mass& s, int j, float tu,
                                      float tl) {
  const bool e = elig(j);
  if (s.good) return __fdiv_rn(e ? utility(p, j, tu, tl) : 0.f, s.total);
  return __fdiv_rn(e ? 1.f : 0.f, clamp_min(s.cnt, 1.f));
}

// K1: the (B, n) probability matrix of a given eligibility matrix.
// grid = ceil(B / rows), block = rows (<= kRows) threads, a row each;
// dynamic shared memory: the pool (3 n floats) and the block's (rows x
// (n | 1)) tile.
__global__ void __launch_bounds__(kRows)
probs_kernel(const float* __restrict__ mu, const float* __restrict__ sig,
             const float* __restrict__ acc, const float* __restrict__ tu,
             const float* __restrict__ tl, const float* __restrict__ elig,
             float* __restrict__ out, int B, int n, float gamma) {
  extern __shared__ float smem[];
  const int nrows = blockDim.x;
  for (int j = threadIdx.x; j < n; j += nrows) {
    smem[j] = mu[j];
    smem[n + j] = sig[j];
    smem[2 * n + j] = acc_weight(acc[j], gamma);
  }
  const Pool p{smem, smem + n, smem + 2 * n};
  float* tile = smem + 3 * n;
  const int ld = n | 1;
  const long long row0 = (long long)blockIdx.x * nrows;
  const int rows = (int)min((long long)nrows, (long long)B - row0);
  const float* src = elig + row0 * n;
  for (int i = threadIdx.x; i < rows * n; i += nrows)
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
  for (int i = threadIdx.x; i < rows * n; i += nrows)
    dst[i] = tile[(i / n) * ld + i % n];
}

// K1's shared memory at n models and `rows` rows a block.
long long probs_smem(int n, long long rows) {
  return (long long)sizeof(float) * (3LL * n + rows * (n | 1));
}

// K1's launch at B rows of n models under a block limit of `limit`
// bytes: rows a block (as many as fit, at most kRows; 0 where one row
// does not fit), blocks, shared memory.
struct ProbsPlan {
  long long rows, blocks, smem;
};
ProbsPlan probs_plan(int B, int n, long long limit) {
  ProbsPlan p;
  p.rows = std::max(0LL, std::min((long long)kRows,
                                   (limit - probs_smem(n, 0)) /
                                       ((long long)sizeof(float) * (n | 1))));
  p.smem = probs_smem(n, p.rows);
  p.blocks = p.rows > 0 ? (B + p.rows - 1) / p.rows : 0;
  return p;
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

// B2 and B4: stages 1-3 and the draw, a segment of L lanes a request
// (see the note at the head).  kFused (B2): one pool for every request,
// the draw on stage 3's normalised probabilities, -1 where a request has
// no base.  Otherwise (B4): request b's own pool row row[b] of mu and
// sig (P, n), of acc and rank at row stride acc_stride (0 or n), mu
// shifted by `shift` (n,) where it is not null, the draw on the
// unnormalised weights (uniform over the eligible models on a
// degenerate row), and where no base exists, with `fallback`, the first
// index of least (shifted) mu in the row, else -1; has[b] the base flag.
struct SelectArgs {
  const float *mu, *sig, *acc, *rank;
  const int* row;
  const float *shift, *tu, *tl, *r01;
  int* out;
  uint8_t* has;
  int B, n, acc_stride;
  float gamma;
  int fallback;
};

constexpr int kSelWarps = 4;    // warps a block: fused, stacked
constexpr int kSelSlots = 4;    // slots a lane holds in registers
constexpr int kSelArrays = 6;   // a warp's arrays past that: `Slots<0>`
                                // and the utilities
// Warps that fill the card: about 16 on each of an H100's 132 SMs.  A
// batch that gives a launch this many warps with fewer lanes a request
// takes fewer (see `select_plan`).
constexpr long long kFillWarps = 2048;

// Collectives over a request's segment of L lanes (a lane alone needs
// none).  Every one runs under the whole warp's mask: under a mask of
// one segment, `redux.sync` serialised the warp's segments on the H100,
// so a segment below 32 lanes takes its minimum by xor-shuffles.
template <int L>
__device__ __forceinline__ unsigned seg_min(unsigned x) {
  if constexpr (L == kWarp) {
    return __reduce_min_sync(kAll, x);
  } else {
#pragma unroll
    for (int o = L / 2; o > 0; o /= 2) x = min(x, __shfl_xor_sync(kAll, x, o));
    return x;
  }
}
template <int L>
__device__ __forceinline__ unsigned seg_ballot(unsigned segmask, bool p) {
  if constexpr (L == 1) return p ? segmask : 0u;
  else return __ballot_sync(kAll, p) & segmask;
}
template <int L>
__device__ __forceinline__ float seg_shfl(float v, int src) {
  if constexpr (L == 1) return v;
  else return __shfl_sync(kAll, v, src, L);
}

// One lane's models (slot t: model sl + L t) and their state.  NT > 0:
// in registers (loops over t unroll, so every index is static); NT == 0:
// in the warp's shared memory at [a][t][lane], any n.
template <int NT>
struct Slots {
  static constexpr int kSlots = NT;
  float m_[NT], s_[NT], a_[NT], c_[NT];
  int e_[NT];
  __device__ Slots(float*, int, int) {}
  __device__ float& m(int t) { return m_[t]; }  // mu (+ shift)
  __device__ float& s(int t) { return s_[t]; }  // sigma
  __device__ float& a(int t) { return a_[t]; }  // acc as read
  __device__ float& c(int t) { return c_[t]; }  // running sum at the model
  __device__ int& e(int t) { return e_[t]; }    // stage-2 eligible
};
template <>
struct Slots<0> {
  static constexpr int kSlots = 1 << 30;
  float* p;
  int stride, lane;
  __device__ Slots(float* s, int T, int l) : p(s), stride(kWarp * T), lane(l) {}
  __device__ float& f(int a, int t) { return p[a * stride + t * kWarp + lane]; }
  __device__ float& m(int t) { return f(0, t); }
  __device__ float& s(int t) { return f(1, t); }
  __device__ float& a(int t) { return f(2, t); }
  __device__ float& c(int t) { return f(3, t); }
  __device__ int& e(int t) {
    return reinterpret_cast<int*>(p)[4 * stride + t * kWarp + lane];
  }
};

// The pool-order running sum of the segment's values v[0, n) in shared
// memory, run by every lane of the segment, four loads at a time:
// returns the total, and sets each slot's c to the sum up to and
// including its model.
template <int L, class S>
__device__ __forceinline__ float running_sum(const float* v, int n, int T,
                                             int sl, S& st) {
  float c = 0.f;
#pragma unroll
  for (int t = 0; t < S::kSlots && t < T; ++t) {
    const int l0 = L * t, l1 = min(n, L * (t + 1)), mine = l0 + sl;
    float ct = 0.f;
    if constexpr (L >= 4) {
      float4 next = *reinterpret_cast<const float4*>(v + l0);
      for (int l = l0; l < l1; l += 4) {
        const float4 u4 = next;
        if (l + 4 < l1) next = *reinterpret_cast<const float4*>(v + l + 4);
        const float ul[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          c = l + q < l1 ? __fadd_rn(c, ul[q]) : c;
          ct = l + q == mine ? c : ct;
        }
      }
    } else {
      for (int l = l0; l < l1; ++l) {
        c = __fadd_rn(c, v[l]);
        ct = l == mine ? c : ct;
      }
    }
    st.c(t) = ct;
  }
  return c;
}

// grid x block as `select_plan` gives; every lane runs every step (a
// lane past B works on the last request and stores nothing), so that
// the warp's collectives see all 32 lanes.
template <bool kFused, int L, int NT>
__global__ void __launch_bounds__(kWarp * kSelWarps)
select_kernel(SelectArgs a) {
  using S = Slots<NT>;
  extern __shared__ float smem[];
  constexpr int kPer = kWarp / L;  // requests a warp
  constexpr unsigned kSegBits = L == kWarp ? kAll : (1u << (L % kWarp)) - 1u;
  const int n = a.n;
  const int T = (n + L - 1) / L;  // slots a lane
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int seg = lane / L, sl = lane % L;
  const unsigned segmask = kSegBits << (seg * L);
  const long long b =
      ((long long)blockIdx.x * (blockDim.x / kWarp) + warp) * kPer + seg;
  const bool live = b < a.B;
  const long long bb = live ? b : a.B - 1;
  // The request's row first, before any load that depends on it.
  const float t_u = a.tu[bb], t_l = a.tl[bb], r01 = a.r01[bb];
  const long long r = kFused ? 0 : a.row[bb];
  const float* mu = a.mu + r * n;
  const float* sig = a.sig + r * n;
  const float* acc = a.acc + r * a.acc_stride;
  const float* rank = a.rank + r * a.acc_stride;
  float* wbase = smem + (long long)warp * (NT == 0 ? kSelArrays : 1) *
                            kWarp * T;
  float* v = wbase + seg * L * T;  // the segment's utilities, pool order
  S st(wbase + kWarp * T, T, lane);

  // Stage 1: Eq. 2 per model; the base is the eligible model of least
  // (rank, index), a segment min-reduction over the rank's order key and
  // then over the index.
  unsigned kbest = 0xffffffffu;
  int jbest = 0;
  float mb = 0.f, sb = 0.f;
#pragma unroll
  for (int t = 0; t < S::kSlots && t < T; ++t) {
    const int j = sl + L * t;
    float m = 0.f, s = 0.f, ac = 0.f, rk = 0.f;
    if (j < n) {
      m = mu[j];
      s = sig[j];
      ac = acc[j];
      rk = rank[j];
      if (!kFused && a.shift) m = __fadd_rn(m, a.shift[j]);
    }
    st.m(t) = m;
    st.s(t) = s;
    st.a(t) = ac;
    const unsigned k = order_key(rk);
    if (j < n && __fadd_rn(m, s) < t_u && __fsub_rn(m, s) < t_l &&
        k < kbest) {
      kbest = k;
      jbest = j;
      mb = m;
      sb = s;
    }
  }
  const unsigned kmin = seg_min<L>(kbest);
  const bool has_base = kmin != 0xffffffffu;
  const unsigned jmin =
      seg_min<L>(has_base && kbest == kmin ? (unsigned)jbest : 0xffffffffu);
  const int base = has_base ? (int)jmin : 0;
  mb = seg_shfl<L>(mb, base % L);
  sb = seg_shfl<L>(sb, base % L);

  // Stage 2 (the window around t_l, the base forced in) and the Eq. 3-4
  // utilities, once a model; a lane without an eligible model divides 0
  // by 1.  The eligible count of the segment, by popcounts.
  const float half = __fadd_rn(fabsf(__fsub_rn(t_l, mb)), sb);
  const float lo = __fsub_rn(t_l, half), hi = __fadd_rn(t_l, half);
  int cnt = 0;
#pragma unroll
  for (int t = 0; t < S::kSlots && t < T; ++t) {
    const int j = sl + L * t;
    const float m = st.m(t), s = st.s(t);
    const bool e = has_base && j < n &&
                   (j == base || (lo <= m && m <= hi && __fadd_rn(m, s) < t_u));
    const float num = e ? __fsub_rn(t_u, __fadd_rn(m, s)) : 0.f;
    const float den = e ? clamp_min(fabsf(__fsub_rn(t_l, m)), kEps) : 1.f;
    const float w = e ? acc_weight(st.a(t), a.gamma) : 0.f;
    v[j] = __fdiv_rn(__fmul_rn(w, num), den);
    st.e(t) = e;
    cnt += __popc(seg_ballot<L>(segmask, e));
  }
  __syncwarp();
  const float mass = running_sum<L>(v, n, T, sl, st);
  const bool good = fabsf(mass) < inf() && mass > 0.f;
  float total;
  if constexpr (kFused) {
    // Stage 3's probabilities over the utilities, then their running sum.
    __syncwarp();
    const float uniform = __fdiv_rn(1.f, clamp_min((float)cnt, 1.f));
#pragma unroll
    for (int t = 0; t < S::kSlots && t < T; ++t) {
      const int j = sl + L * t;
      const bool e = st.e(t);
      v[j] = good ? (e ? __fdiv_rn(v[j], mass) : 0.f) : (e ? uniform : 0.f);
    }
    __syncwarp();
    total = running_sum<L>(v, n, T, sl, st);
  } else {
    total = good ? mass : (float)cnt;
  }

  // The draw: the first model whose running sum exceeds r01 * total,
  // else the base.  A degenerate B4 row weighs its eligible models 1
  // each, so its running sum is the count of eligible models so far.
  const float thresh = __fmul_rn(r01, total);
  const bool draws = total > thresh;
  const unsigned lanes_le = 0xffffffffu >> (kWarp - 1 - lane);
  int pick = base, before = 0;
  bool found = false;
#pragma unroll
  for (int t = 0; t < S::kSlots && t < T; ++t) {
    const int j = sl + L * t;
    bool over = st.c(t) > thresh;
    if (!kFused) {
      const unsigned eb = seg_ballot<L>(segmask, st.e(t));
      over = good ? over
                  : (float)(before + __popc(eb & lanes_le)) > thresh;
      before += __popc(eb);
    }
    const unsigned d = seg_ballot<L>(segmask, draws && j < n && over);
    if (!found && d) {
      pick = L * t + __ffs(d) - 1 - seg * L;
      found = true;
    }
  }

  // No base: -1, or (B4 with `fallback`) the first index of least mu.
  int miss = -1;
  if (!kFused && a.fallback) {
    unsigned km = 0xffffffffu;
    int jm = 0;
#pragma unroll
    for (int t = 0; t < S::kSlots && t < T; ++t) {
      const int j = sl + L * t;
      const unsigned k = order_key(st.m(t));
      if (j < n && k < km) {
        km = k;
        jm = j;
      }
    }
    const unsigned kl = seg_min<L>(km);
    miss = (int)seg_min<L>(km == kl ? (unsigned)jm : 0xffffffffu);
  }
  if (live && sl == 0) {
    a.out[b] = has_base ? pick : miss;
    if (!kFused) a.has[b] = has_base;
  }
}

// The fused and stacked kernels' launch at B requests of n models under a
// block limit of `limit` bytes: lanes a request and slots a lane,
// requests a warp, warps a block (0 where one warp does not fit),
// blocks, shared memory.  A request takes the next power of two >= n
// lanes, at most 32, one model a lane up to 32; while the launch would
// still have kFillWarps warps with half the lanes, and each lane would
// still hold its models in registers, it takes half.
struct SelectPlan {
  long long lanes, slots, per_warp, warps, blocks, smem;
};
// A warp's shared memory at T slots a lane: the utilities (32 T
// floats), and past kSelSlots slots the lanes' state too.
long long select_warp_smem(long long T) {
  return (long long)sizeof(float) * (T > kSelSlots ? kSelArrays : 1) *
         kWarp * T;
}
SelectPlan select_plan(int B, int n, long long limit) {
  const auto warps_at = [&](long long L) {
    return (B + kWarp / L - 1) / (kWarp / L);
  };
  SelectPlan p;
  p.lanes = 1;
  while (p.lanes < n && p.lanes < kWarp) p.lanes *= 2;
  while (p.lanes > 1 && (n + p.lanes / 2 - 1) / (p.lanes / 2) <= kSelSlots &&
         warps_at(p.lanes / 2) >= kFillWarps)
    p.lanes /= 2;
  p.slots = (n + p.lanes - 1) / p.lanes;
  p.per_warp = kWarp / p.lanes;
  const long long warps = warps_at(p.lanes);
  const long long wsm = select_warp_smem(p.slots);
  p.warps = std::min({(long long)kSelWarps, warps, limit / wsm});
  p.blocks = p.warps > 0 ? (warps + p.warps - 1) / p.warps : 0;
  p.smem = p.warps * wsm;
  return p;
}

// The opt-in shared memory a block of the current device may have.
long long smem_optin() {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return limit;
}

template <class K>
int launch(K kernel, long long blocks, long long threads, long long smem,
           cudaStream_t stream, const SelectArgs& a) {
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, (unsigned)threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kFused, int L>
int launch_lanes(const SelectArgs& a, const SelectPlan& p, cudaStream_t s) {
  const long long th = p.warps * kWarp;
  if (p.slots == 1)
    return launch(select_kernel<kFused, L, 1>, p.blocks, th, p.smem, s, a);
  if (p.slots <= kSelSlots)
    return launch(select_kernel<kFused, L, kSelSlots>, p.blocks, th, p.smem,
                  s, a);
  if constexpr (L == kWarp)
    return launch(select_kernel<kFused, L, 0>, p.blocks, th, p.smem, s, a);
  return (int)cudaErrorInvalidValue;
}

template <bool kFused>
int launch_select(const SelectArgs& a, cudaStream_t s) {
  // the opt-in limit is asked for only where the default might bind
  const SelectPlan d = select_plan(a.B, a.n, kDefaultSmem);
  const long long full = std::min((long long)kSelWarps,
                                  (a.B + d.per_warp - 1) / d.per_warp);
  const SelectPlan p =
      d.warps < full ? select_plan(a.B, a.n, smem_optin()) : d;
  if (p.warps < 1) return (int)cudaErrorInvalidValue;
  switch (p.lanes) {
    case 1: return launch_lanes<kFused, 1>(a, p, s);
    case 2: return launch_lanes<kFused, 2>(a, p, s);
    case 4: return launch_lanes<kFused, 4>(a, p, s);
    case 8: return launch_lanes<kFused, 8>(a, p, s);
    case 16: return launch_lanes<kFused, 16>(a, p, s);
  }
  return launch_lanes<kFused, kWarp>(a, p, s);
}

}  // namespace

// All pointers are float32 device arrays unless named otherwise: mu,
// sig, acc, rank (n,); t_u, t_l, r01, lim (B,); elig and out (B, n)
// row-major.  Each returns cudaGetLastError() after its launch (0 when
// B is 0 and nothing is launched; cudaErrorInvalidValue, launching
// nothing, where the pool does not fit a block: the wrappers refuse such
// a pool first).

extern "C" int modipick_probs_fwd(const float* mu, const float* sig,
                                  const float* acc, const float* tu,
                                  const float* tl, const float* elig,
                                  float* out, int B, int n, float gamma,
                                  void* stream) {
  if (B <= 0) return 0;
  const ProbsPlan p = probs_plan(
      B, n, probs_smem(n, kRows) > kDefaultSmem ? smem_optin() : kDefaultSmem);
  if (p.rows < 1) return (int)cudaErrorInvalidValue;
  if (p.smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        probs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)p.smem);
    if (err != cudaSuccess) return (int)err;
  }
  probs_kernel<<<(unsigned)p.blocks, (unsigned)p.rows, p.smem,
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
  const SelectArgs a{mu, sig, acc, rank, nullptr, nullptr, tu, tl, r01,
                     out, nullptr, B, n, 0, gamma, 0};
  return launch_select<true>(a, static_cast<cudaStream_t>(stream));
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
  const SelectArgs a{mu, sig, acc, rank, row, shift, tu, tl, r01,
                     out, has, B, n, acc_stride, gamma, fallback};
  return launch_select<false>(a, static_cast<cudaStream_t>(stream));
}

// The charged block's shared memory at (n, R, nnz) and the most a block
// of ``device`` may have (cudaDevAttrMaxSharedMemoryPerBlockOptin).
extern "C" int charged_select_smem(int device, int n, int R, int nnz,
                                   long long* smem, int* limit) {
  *smem = charged_smem(n, R, nnz);
  return (int)cudaDeviceGetAttribute(
      limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// K1's launch at (B, n) on ``device``: rows a block, blocks, shared
// memory, and the most a block of ``device`` may have
// (cudaDevAttrMaxSharedMemoryPerBlockOptin); ``probs_plan`` in
// kernels/policy_select.py mirrors it.
extern "C" int probs_plan_query(int device, int B, int n, long long* out) {
  int limit = 0;
  const int err = (int)cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const ProbsPlan p = probs_plan(B, n, limit);
  const long long v[4] = {p.rows, p.blocks, p.smem, limit};
  for (int i = 0; i < 4; ++i) out[i] = v[i];
  return err;
}

// The fused and stacked kernels' launch at (B, n) on ``device``: lanes
// a request, slots a lane, requests a warp, warps a block, blocks,
// shared memory, and the most a block may have; ``select_plan`` in kernels/policy_select.py
// mirrors it.
extern "C" int select_plan_query(int device, int B, int n, long long* out) {
  int limit = 0;
  const int err = (int)cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const SelectPlan p = select_plan(B, n, limit);
  const long long v[7] = {p.lanes, p.slots, p.per_warp, p.warps,
                          p.blocks, p.smem, limit};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return err;
}
