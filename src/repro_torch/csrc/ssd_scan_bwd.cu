// The backward of the Mamba-2 SSD chunked scan (K4-bwd) for Hopper
// (sm_90a): the gradients of ssd_scan.cu's forward, on the fp32 training
// path's machinery (ssd_train.cuh, whose note describes the passes).
// Built as a library of its own, so that it compiles beside the forward
// rather than after it.

#include "ssd_train.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(128) ssd_bwd_scores_kernel(TrainArgs a) {
  scores_tile<T>(a);
}

// Backward (a): one chunk of one (batch, head): cum (kept for the other
// passes) and total; the chain's local term sum_i exp(cum_i) dy_i (x) C_i
// (hd x N, into dSo); q_i = exp(cum_i) <dy_i, C_i S_in^T>, the inter
// term's d(cum).
template <typename T, int P>
__global__ void __launch_bounds__(256, 1) ssd_bwd_local_kernel(TrainArgs a) {
  constexpr int PP = pad_hd<P>(), lx = PP + 8, NCT = PP / 32;
  const int N = a.N, Np = pad32(N), ln = Np + 4;
  const Tiles tl = tiles_of(a.cs);
  extern __shared__ float smem[];
  float* sS = smem;              // [PP][ln] S_in
  float* sAcc = sS + PP * ln;    // [PP][ln] the local term
  float* sC = sAcc + PP * ln;    // [64][ln]
  float* sDy = sC + 64 * ln;     // [64][lx] dy_i exp(cum_i)
  float* sQ = sDy + 64 * lx;     // [NCT][64]
  float* sDt = sQ + NCT * 64;    // [cs64]
  float* sCum = sDt + tl.cs64;   // [cs64]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, grp = h / (a.H / a.G);
  const long long bh = (long long)b * a.H + h;
  const int s0 = c * a.cs, len = min(a.cs, a.S - s0);
  const T* Cb = static_cast<const T*>(a.Cm) + b * a.cs_.b + grp * a.cs_.h;
  const T* dyb = static_cast<const T*>(a.dy) + b * a.dys.b + h * a.dys.h;
  chunk_cum<256>(a.dt + b * a.ds.b + h * a.ds.h, a.ds.s, s0, len, a.A[h], sDt, sCum);
  if (threadIdx.x == 0) a.tot[bh * a.nc + c] = sCum[len - 1];
  for (int r = threadIdx.x; r < len; r += 256) {
    a.cum[bh * a.S + s0 + r] = sCum[r];
    if (c == 0) a.q[bh * a.S + s0 + r] = 0.f;  // S_in = 0
  }
  if (c == 0) return;  // the first chunk's local term is not needed
  stage<256>(sS, ln, PP, Np, a.states + (bh * a.nc + c) * P * N, N, P, N, One());
  for (int e = threadIdx.x; e < PP * ln; e += 256) sAcc[e] = 0.f;
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3, nct = Np / 32;
  for (int i0 = 0; i0 < len; i0 += 64) {
    __syncthreads();  // the previous tile's readers are done
    stage<256>(sC, ln, 64, Np, Cb + (long long)(s0 + i0) * a.cs_.s, a.cs_.s, len - i0, N,
               One());
    stage<256>(sDy, lx, 64, PP, dyb + (long long)(s0 + i0) * a.dys.s, a.dys.s, len - i0, P,
               [&](int r) { return clip_exp(sCum[i0 + r]); });
    __syncthreads();
    // C S_in^T (64 x hd), dotted with dy exp(cum) row by row
    for (int tile = warp; tile < 2 * NCT; tile += 8) {
      const int r0 = 32 * (tile / NCT), c0 = 32 * (tile % NCT);
      float acc[2][4][4];
      zero_tile(acc);
      warp_mma(acc, Np, [&](int r, int k) { return sC[(r0 + r) * ln + k]; },
               [&](int k, int cc) { return sS[(c0 + cc) * ln + k]; });
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = r0 + frag_row(mi, 2 * hf);
          float s = 0.f;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 2 * hf; e < 2 * hf + 2; ++e)
              s += acc[mi][ni][e] * sDy[row * lx + c0 + frag_col(ni, e)];
          s = row_sum4(s);
          if (t == 0) sQ[(c0 / 32) * 64 + row] = s;
        }
    }
    // the local term += (dy exp(cum))^T C over this tile
    for (int tile = warp; tile < NCT * nct; tile += 8) {
      const int r0 = 32 * (tile / nct), c0 = 32 * (tile % nct);
      float acc[2][4][4];
      zero_tile(acc);
      warp_mma(acc, 64, [&](int r, int k) { return sDy[k * lx + r0 + r]; },
               [&](int k, int cc) { return sC[k * ln + c0 + cc]; });
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sAcc[(r0 + frag_row(mi, e)) * ln + c0 + frag_col(ni, e)] += acc[mi][ni][e];
    }
    __syncthreads();
    if (threadIdx.x < 64 && i0 + threadIdx.x < len) {
      float s = 0.f;
      for (int ct = 0; ct < NCT; ++ct) s += sQ[ct * 64 + threadIdx.x];
      a.q[bh * a.S + s0 + i0 + threadIdx.x] = s;
    }
  }
  __syncthreads();
  float* out = a.dSo + (bh * a.nc + c) * P * N;
  for (int e = threadIdx.x; e < P * N; e += 256) out[e] = sAcc[(e / N) * ln + e % N];
}

// Backward chain, one thread an element of one (batch, head): dS_out
// of each chunk right to left, in place over the local terms:
// dS_out[c - 1] = exp(total_c) dS_out[c] + local_c, dS_out[nc - 1] =
// dstate.
__global__ void __launch_bounds__(256) ssd_bwd_chain_kernel(TrainArgs a) {
  const int PN = a.P * a.N, e = blockIdx.x * 256 + threadIdx.x;
  if (e >= PN) return;
  const long long bh = (long long)blockIdx.z * a.H + blockIdx.y;
  float carry = a.dstate ? a.dstate[bh * PN + e] : 0.f;
  float* p = a.dSo + bh * a.nc * PN + e;
  const float* tot = a.tot + bh * a.nc;
  for (int c0 = a.nc - 1; c0 >= 0; c0 -= 8) {  // 8 chunks' loads in flight
    float loc[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) loc[u] = c0 - u > 0 ? p[(long long)(c0 - u) * PN] : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = c0 - u;
      if (c < 0) break;
      p[(long long)c * PN] = carry;
      carry = clip_exp(tot[c]) * carry + loc[u];
    }
  }
}

// Backward (b): the dscores of one tile pair of one (batch, group,
// chunk), summed over the heads of one split of the group in head
// order; for each head the tile's d(cum) terms R_ij = (dy_i . x_j)
// sc_ij L_ij: row sums sum_j dt_j R_ij, column sums sum_i R_ij and the
// paired dA term sum dt_j R_ij (cum_i - cum_j).
template <typename T, int P>
__global__ void __launch_bounds__(128) ssd_bwd_ds_kernel(TrainArgs a) {
  constexpr int PP = pad_hd<P>(), lr = PP + 4;
  const Tiles tl = tiles_of(a.cs);
  extern __shared__ float smem[];
  float* sSc = smem;             // [64][68] scores
  float* sDy = sSc + 64 * 68;    // [64][lr] dy_i
  float* sX = sDy + 64 * lr;     // [64][lr] x_j
  float* sCi = sX + 64 * lr;     // [64] cum_i
  float* sCj = sCi + 64;         // [64] cum_j
  float* sDtj = sCj + 64;        // [64] dt_j
  float* sRowR = sDtj + 64;      // [2][64]
  float* sColR = sRowR + 128;    // [2][64]
  float* sRed = sColR + 128;     // [4]
  const int pr = blockIdx.x / a.nsplit, sp = blockIdx.x % a.nsplit;
  int it, jt;
  pair_tiles(pr, it, jt);
  const int c = blockIdx.y, bg = blockIdx.z, b = bg / a.G, grp = bg % a.G;
  const int s0 = c * a.cs, len = min(a.cs, a.S - s0), i0 = 64 * it, j0 = 64 * jt;
  if (i0 >= len) return;
  const int hg = a.H / a.G, hps = (hg + a.nsplit - 1) / a.nsplit;
  const int h_lo = grp * hg + sp * hps, h_hi = min(h_lo + hps, (grp + 1) * hg);
  const float* scb = a.sc + (((long long)bg * a.nc + c) * tl.cs64 + i0) * tl.cs64 + j0;
  batched4<128>(
      64 * 16, [&](int e) { return ld4(scb + (long long)(e >> 4) * tl.cs64 + 4 * (e & 15)); },
      [&](int e, float4 v) { st4(sSc + (e >> 4) * 68 + 4 * (e & 15), v, 1.f); });
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int r0 = 32 * (warp >> 1), c0 = 32 * (warp & 1);
  float dS[2][4][4];
  zero_tile(dS);
  for (int h = h_lo; h < h_hi; ++h) {
    const long long bh = (long long)b * a.H + h;
    __syncthreads();  // the previous head's readers are done
    stage<128>(sDy, lr, 64, PP,
               static_cast<const T*>(a.dy) + b * a.dys.b + h * a.dys.h +
                   (long long)(s0 + i0) * a.dys.s,
               a.dys.s, len - i0, P, One());
    stage<128>(sX, lr, 64, PP,
               static_cast<const T*>(a.x) + b * a.xs.b + h * a.xs.h +
                   (long long)(s0 + j0) * a.xs.s,
               a.xs.s, len - j0, P, One());
    if (threadIdx.x < 64) {
      const int r = threadIdx.x;
      const float* cm = a.cum + bh * a.S + s0;
      sCi[r] = i0 + r < len ? cm[i0 + r] : 0.f;
      sCj[r] = j0 + r < len ? cm[j0 + r] : 0.f;
      sDtj[r] = j0 + r < len ? a.dt[b * a.ds.b + h * a.ds.h + (long long)(s0 + j0 + r) * a.ds.s]
                             : 0.f;
    }
    __syncthreads();
    float dm[2][4][4];
    zero_tile(dm);
    warp_mma(dm, PP, [&](int r, int k) { return sDy[(r0 + r) * lr + k]; },
             [&](int k, int cc) { return sX[(c0 + cc) * lr + k]; });
    float rowr[2][2] = {}, colr[4][2] = {}, dar = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + frag_row(mi, e), cc = c0 + frag_col(ni, e);
          const bool ok = j0 + cc <= i0 + r && i0 + r < len;
          const float d = sCi[r] - sCj[cc], dtj = sDtj[cc];
          const float v = ok ? dm[mi][ni][e] * clip_exp(d) : 0.f;
          const float R = v * sSc[r * 68 + cc];
          dS[mi][ni][e] += v * dtj;
          rowr[mi][e >> 1] += R * dtj;
          colr[ni][e & 1] += R;
          dar += R * dtj * d;
        }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float s = row_sum4(rowr[mi][hf]);
        if (t == 0) sRowR[(warp & 1) * 64 + r0 + 16 * mi + g + 8 * hf] = s;
      }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float s = col_sum8(colr[ni][q]);
        if (g == 0) sColR[(warp >> 1) * 64 + c0 + 8 * ni + 2 * t + q] = s;
      }
    dar = warp_sum(dar);
    if (lane == 0) sRed[warp] = dar;
    __syncthreads();
    const long long o = (bh * a.nc + c) * tl.npairs + pr;
    if (threadIdx.x < 64)
      a.rr[o * 64 + threadIdx.x] = sRowR[threadIdx.x] + sRowR[64 + threadIdx.x];
    else
      a.cr[o * 64 + threadIdx.x - 64] = sColR[threadIdx.x - 64] + sColR[threadIdx.x];
    if (threadIdx.x == 0) a.dar[o] = sRed[0] + sRed[1] + sRed[2] + sRed[3];
  }
  float* out = a.dS + ((((long long)sp * a.B * a.G + bg) * a.nc + c) * tl.cs64 + i0 + r0) *
                          tl.cs64 + j0 + c0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[(long long)frag_row(mi, e) * tl.cs64 + frag_col(ni, e)] = dS[mi][ni][e];
}

// Backward (c): dx of one 64-row tile j of one chunk of one (batch,
// head): M^T dy over the tiles i >= j, M formed in shared memory from the
// scores, each tile's raw scores and dy copied one tile ahead of the
// products; then w_j (B_j G^T), with dw_j = <x_j, B_j G^T>; on the first
// tile also <G, S_in>.
template <typename T, int P>
__global__ void __launch_bounds__(128, 2) ssd_bwd_dx_kernel(TrainArgs a) {
  constexpr int PP = pad_hd<P>(), lx = PP + 8, NCT = PP / 32, TILES = 2 * NCT;
  constexpr int TPW = (TILES + 3) / 4;
  const int N = a.N, Np = pad32(N), ln = Np + 4;
  const Tiles tl = tiles_of(a.cs);
  extern __shared__ float smem[];
  float* sDt = smem;              // [cs64]
  float* sCum = sDt + tl.cs64;    // [cs64]
  float* sRow = sCum + tl.cs64;   // [NCT][64]
  float* sRed = sRow + NCT * 64;  // [4]
  float* sM = sRed + 4;           // [2][64][72]  scores, then M
  float* sDy = sM + 2 * 64 * 72;  // [2][64][lx]
  float* sB = sRed + 4;           // [64][ln]     the state update's terms, over sM and sDy
  float* sG = sB + 64 * ln;       // [PP][ln]
  float* sX = sG + PP * ln;       // [64][lx]
  const int c = blockIdx.x / tl.nt, jt = blockIdx.x % tl.nt;
  const int h = blockIdx.y, b = blockIdx.z, grp = h / (a.H / a.G);
  const long long bh = (long long)b * a.H + h, bg = (long long)b * a.G + grp;
  const int s0 = c * a.cs, len = min(a.cs, a.S - s0), j0 = 64 * jt;
  if (j0 >= len) return;
  const int last = (len - 1) / 64;  // the last tile i
  const T* xb = static_cast<const T*>(a.x) + b * a.xs.b + h * a.xs.h;
  const T* Bb = static_cast<const T*>(a.Bm) + b * a.bs.b + grp * a.bs.h;
  const T* dyb = static_cast<const T*>(a.dy) + b * a.dys.b + h * a.dys.h;
  const float* scb = a.sc + (bg * a.nc + c) * tl.cs64 * tl.cs64 + j0;
  // tile it's raw scores and dy rows into buffer (it - jt) & 1, as one group
  auto fetch = [&](int it) {
    const int buf = (it - jt) & 1;
    copy_tile<128>(sM + buf * 64 * 72, 72, 64, 64, scb + (long long)64 * it * tl.cs64, tl.cs64,
                   64, 64);
    copy_tile<128>(sDy + buf * 64 * lx, lx, 64, PP, dyb + (long long)(s0 + 64 * it) * a.dys.s,
                   a.dys.s, len - 64 * it, P);
    cp_async_commit();
  };
  fetch(jt);
  for (int r = threadIdx.x; r < len; r += 128) {
    sDt[r] = a.dt[b * a.ds.b + h * a.ds.h + (long long)(s0 + r) * a.ds.s];
    sCum[r] = a.cum[bh * a.S + s0 + r];
  }
  const float total = a.tot[bh * a.nc + c];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  float acc[TPW][2][4][4];
#pragma unroll
  for (int tw = 0; tw < TPW; ++tw) zero_tile(acc[tw]);
  for (int it = jt; it <= last; ++it) {
    const int i0 = 64 * it;
    float* m = sM + ((it - jt) & 1) * 64 * 72;
    const float* dy = sDy + ((it - jt) & 1) * 64 * lx;
    if (it < last) {
      fetch(it + 1);  // into the buffer the previous tile's products left
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it is in (and sDt, sCum)
    for (int e = threadIdx.x; e < 64 * 64; e += 128) {
      const int r = e >> 6, cc = e & 63, i = i0 + r, j = j0 + cc;
      float* v = m + r * 72 + cc;
      *v = j <= i && i < len ? *v * clip_exp(sCum[i] - sCum[j]) * sDt[j] : 0.f;
    }
    __syncthreads();  // M is formed
#pragma unroll
    for (int tw = 0; tw < TPW; ++tw) {
      const int tile = warp + 4 * tw;
      if (tile >= TILES) break;
      const int r0 = 32 * (tile / NCT), c0 = 32 * (tile % NCT);
      warp_mma(acc[tw], 64, [&](int r, int k) { return m[k * 72 + r0 + r]; },
               [&](int k, int cc) { return dy[k * lx + c0 + cc]; });
    }
    __syncthreads();  // every warp is done with the buffer
  }
  // the state update's terms: dx_j += w_j (B_j G^T), dw_j = <x_j, B_j G^T>
  copy_tile<128>(sB, ln, 64, Np, Bb + (long long)(s0 + j0) * a.bs.s, a.bs.s, len - j0, N);
  copy_tile<128>(sG, ln, PP, Np, a.dSo + (bh * a.nc + c) * P * N, N, P, N);
  copy_tile<128>(sX, lx, 64, PP, xb + (long long)(s0 + j0) * a.xs.s, a.xs.s, len - j0, P);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int tw = 0; tw < TPW; ++tw) {
    const int tile = warp + 4 * tw;
    if (tile >= TILES) break;
    const int r0 = 32 * (tile / NCT), c0 = 32 * (tile % NCT);
    float bgt[2][4][4];
    zero_tile(bgt);
    warp_mma(bgt, Np, [&](int r, int k) { return sB[(r0 + r) * ln + k]; },
             [&](int k, int cc) { return sG[(c0 + cc) * ln + k]; });
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + frag_row(mi, 2 * hf), j = j0 + row;
        float s = 0.f;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 2 * hf; e < 2 * hf + 2; ++e)
            s += bgt[mi][ni][e] * sX[row * lx + c0 + frag_col(ni, e)];
        s = row_sum4(s);
        if (t == 0) sRow[(c0 / 32) * 64 + row] = s;
        const float w = j < len ? clip_exp(total - sCum[j]) * sDt[j] : 0.f;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 2 * hf; e < 2 * hf + 2; ++e) acc[tw][mi][ni][e] += w * bgt[mi][ni][e];
      }
  }
  if (jt == 0) {  // <G, S_in> (S_in is zero in the first chunk)
    float s = 0.f;
    if (c > 0) {
      const float* st = a.states + (bh * a.nc + c) * P * N;
      batched<128>(
          P * N, [&](int e) { return st[e]; },
          [&](int e, float v) { s += sG[(e / N) * ln + e % N] * v; });
    }
    s = warp_sum(s);
    if (lane == 0) sRed[warp] = s;
  }
  __syncthreads();
  if (jt == 0 && threadIdx.x == 0) a.gs[bh * a.nc + c] = sRed[0] + sRed[1] + sRed[2] + sRed[3];
  if (threadIdx.x < 64 && j0 + threadIdx.x < len) {
    float s = 0.f;
    for (int ct = 0; ct < NCT; ++ct) s += sRow[ct * 64 + threadIdx.x];
    a.dw[bh * a.S + s0 + j0 + threadIdx.x] = s;
  }
  T* dxb = static_cast<T*>(a.dx) + b * a.dxs.b + h * a.dxs.h;
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
          const int j = j0 + r0 + frag_row(mi, e), p = c0 + frag_col(ni, e);
          if (j < len && p < P)
            dxb[(long long)(s0 + j) * a.dxs.s + p] = from_f32<T>(acc[tw][mi][ni][e]);
        }
  }
}

// Backward (d): dC (which 0) or dB (which 1) of one 64-row tile and 64
// columns of N of one chunk of one (batch, group): the heads' inter-chunk
// terms as one product over (head, hd), sum_h exp(cum_i) dy_i S_in
// (sum_h w_j x_j G), then the dscores summed over the splits times B_j
// (C_i) over the tiles j <= i (i >= j).
template <typename T, int P>
__global__ void __launch_bounds__(128, 2) ssd_bwd_dbdc_kernel(TrainArgs a) {
  constexpr int PP = pad_hd<P>(), la = PP + 4;
  const int N = a.N, nslab = (N + 63) / 64;
  const Tiles tl = tiles_of(a.cs);
  extern __shared__ float smem[];
  float* sScale = smem;              // [2][64]     the rows' scales
  float* sA = sScale + 128;          // [2][64][la] a head's rows
  float* sO = sA + 2 * 64 * la;      // [2][PP][72] its S_in or G, 64 columns
  float* sD = sScale + 128;          // [64][72]    dscores, over sA
  float* sE = sD + 64 * 72;          // [64][72]    B_j or C_i, 64 columns
  const int rt = blockIdx.x % tl.nt, ns = blockIdx.x / tl.nt % nslab;
  const int which = blockIdx.x / (tl.nt * nslab);
  const int c = blockIdx.y, bg = blockIdx.z, b = bg / a.G, grp = bg % a.G;
  const int s0 = c * a.cs, len = min(a.cs, a.S - s0), r0t = 64 * rt, n0 = 64 * ns;
  if (r0t >= len) return;
  const int hg = a.H / a.G, warp = threadIdx.x >> 5;
  const int wr = 32 * (warp >> 1), wc = 32 * (warp & 1);
  const Strides& st = which == 0 ? a.dys : a.xs;
  const T* rows = static_cast<const T*>(which == 0 ? a.dy : a.x) + b * st.b +
                  (long long)(s0 + r0t) * st.s;
  const float* mats = (which == 0 ? a.states : a.dSo) + (long long)c * P * N + n0;
  const long long mstride = (long long)a.nc * P * N;  // from one head's to the next
  // head k's scales (threads < 64) and tiles into buffer k & 1, one
  // head ahead of the products
  auto fetch = [&](int k) {
    const int h = grp * hg + k, buf = k & 1;
    const long long bh = (long long)b * a.H + h;
    if (threadIdx.x < 64) {
      const int row = r0t + threadIdx.x;
      float v = 0.f;
      if (row < len) {
        const float cm = a.cum[bh * a.S + s0 + row];
        v = which == 0 ? clip_exp(cm)
                       : clip_exp(a.tot[bh * a.nc + c] - cm) *
                             a.dt[b * a.ds.b + h * a.ds.h + (long long)(s0 + row) * a.ds.s];
      }
      sScale[64 * buf + threadIdx.x] = v;
    }
    copy_tile<128>(sA + buf * 64 * la, la, 64, PP, rows + h * st.h, st.s, len - r0t, P);
    copy_tile<128>(sO + buf * PP * 72, 72, PP, 64, mats + bh * mstride, N, P, N - n0);
    cp_async_commit();
  };
  float acc[2][4][4];
  zero_tile(acc);
  fetch(0);
  for (int k = 0; k < hg; ++k) {
    const int buf = k & 1;
    if (k + 1 < hg) {
      fetch(k + 1);  // into the buffer the last head's products left
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // head k's scales and tiles are in
    const float* tA = sA + buf * 64 * la;
    const float* tO = sO + buf * PP * 72;
    const float* sc = sScale + 64 * buf + wr;
    warp_mma(acc, PP, [&](int r, int kk) { return tA[(wr + r) * la + kk] * sc[r]; },
             [&](int kk, int cc) { return tO[kk * 72 + wc + cc]; });
    __syncthreads();  // every warp is done with buffer k & 1
  }
  const long long split = (long long)a.B * a.G * a.nc * tl.cs64 * tl.cs64;
  const float* dsb = a.dS + ((long long)bg * a.nc + c) * tl.cs64 * tl.cs64;
  const int o_lo = which == 0 ? 0 : rt, o_hi = which == 0 ? rt + 1 : (len + 63) / 64;
  for (int ot = o_lo; ot < o_hi; ++ot) {
    __syncthreads();  // the previous tile's readers are done
    const int i_0 = which == 0 ? r0t : 64 * ot, j_0 = which == 0 ? 64 * ot : r0t;
    batched4<128>(
        64 * 16,
        [&](int e) {
          const float* p = dsb + (long long)(i_0 + (e >> 4)) * tl.cs64 + j_0 + 4 * (e & 15);
          float4 s = ld4(p);
          for (int sp = 1; sp < a.nsplit; ++sp) {
            const float4 v = ld4(p + sp * split);
            s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
          }
          return s;
        },
        [&](int e, float4 v) { st4(sD + (e >> 4) * 72 + 4 * (e & 15), v, 1.f); });
    const Strides& st = which == 0 ? a.bs : a.cs_;
    const T* src = static_cast<const T*>(which == 0 ? a.Bm : a.Cm) + b * st.b + grp * st.h +
                   (long long)(s0 + 64 * ot) * st.s + n0;
    stage<128>(sE, 72, 64, 64, src, st.s, len - 64 * ot, N - n0, One());
    __syncthreads();
    if (which == 0)
      warp_mma(acc, 64, [&](int r, int kk) { return sD[(wr + r) * 72 + kk]; },
               [&](int kk, int cc) { return sE[kk * 72 + wc + cc]; });
    else
      warp_mma(acc, 64, [&](int r, int kk) { return sD[kk * 72 + wr + r]; },
               [&](int kk, int cc) { return sE[kk * 72 + wc + cc]; });
  }
  const Strides& os = which == 0 ? a.dcs : a.dbs;
  T* out = static_cast<T*>(which == 0 ? a.dC : a.dB) + b * os.b + grp * os.h;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0t + wr + frag_row(mi, e), n = n0 + wc + frag_col(ni, e);
        if (row < len && n < N)
          out[(long long)(s0 + row) * os.s + n] = from_f32<T>(acc[mi][ni][e]);
      }
}

// Backward (e): ddt of one chunk of one (batch, head) from the d(cum)
// terms the other passes left, by a reverse running sum; the chunk's dA
// partial from the paired terms.
__global__ void __launch_bounds__(256) ssd_bwd_dt_kernel(TrainArgs a) {
  const Tiles tl = tiles_of(a.cs);
  extern __shared__ float smem[];
  float* sDc = smem;            // [cs64] d(cum), direct terms aside
  float* sDd = sDc + tl.cs64;   // [cs64] ddt's direct terms
  float* sRed = sDd + tl.cs64;  // [2][8]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * a.H + h;
  const int s0 = c * a.cs, len = min(a.cs, a.S - s0), nt = (len + 63) / 64;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float A = a.A[h], total = a.tot[bh * a.nc + c], gsv = a.gs[bh * a.nc + c];
  const long long o = (bh * a.nc + c) * tl.npairs;
  float wdw = 0.f, pa = 0.f;
  for (int r = threadIdx.x; r < len; r += 256) {
    const long long k = bh * a.S + s0 + r;
    const float cm = a.cum[k], dtr = a.dt[b * a.ds.b + h * a.ds.h + (long long)(s0 + r) * a.ds.s];
    const int ti = r >> 6, rr = r & 63;
    float rowR = 0.f, colR = 0.f;
    for (int jt = 0; jt <= ti; ++jt) rowR += a.rr[(o + pair_index(ti, jt)) * 64 + rr];
    for (int it = ti; it < nt; ++it) colR += a.cr[(o + pair_index(it, ti)) * 64 + rr];
    const float q = a.q[k], dwr = a.dw[k], ew = clip_exp(total - cm), w = ew * dtr;
    sDd[r] = colR + ew * dwr;
    sDc[r] = q + rowR - dtr * colR - w * dwr;
    wdw += w * dwr;
    pa += q * cm + w * dwr * (total - cm);
  }
  wdw = warp_sum(wdw);
  pa = warp_sum(pa);
  if (lane == 0) {
    sRed[warp] = wdw;
    sRed[8 + warp] = pa;
  }
  __syncthreads();
  if (warp != 0) return;
  const float w8 = warp_sum(lane < 8 ? sRed[lane] : 0.f);
  const float p8 = warp_sum(lane < 8 ? sRed[8 + lane] : 0.f);
  float ar = 0.f;
  for (int p = lane; p < pair_index(nt, 0); p += 32) ar += a.dar[o + p];
  ar = warp_sum(ar);
  const float dtot = w8 + clip_exp(total) * gsv;
  const int per = (len + 31) / 32, lo = lane * per, hi = min(lo + per, len);
  float run = 0.f;
  for (int k = hi - 1; k >= lo; --k) {
    run += sDc[k] + (k == len - 1 ? dtot : 0.f);
    sDc[k] = run;
  }
  float incl = run;  // the runs of this lane and the lanes after it
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float v = __shfl_down_sync(0xffffffffu, incl, d);
    if (lane + d < 32) incl += v;
  }
  const float after = incl - run;
  float* ddt = a.ddt + bh * a.S + s0;
  for (int k = lo; k < hi; ++k) ddt[k] = sDd[k] + A * (sDc[k] + after);
  if (lane == 0) a.dAp[bh * a.nc + c] = (p8 + ar + clip_exp(total) * gsv * total) / A;
}

// Backward (f): dA, the chunks' partials summed over batch and chunk in
// order.
__global__ void __launch_bounds__(256) ssd_bwd_da_kernel(TrainArgs a) {
  for (int h = threadIdx.x; h < a.H; h += 256) {
    float s = 0.f;
    for (int b = 0; b < a.B; ++b)
      for (int c = 0; c < a.nc; ++c) s += a.dAp[((long long)b * a.H + h) * a.nc + c];
    a.dA[h] = s;
  }
}

// The grids of the backward's (scores, local, ds, chain, dx, dbdc,
// dt, da) passes, (x, y, z) each, in launch order (`bwd_plan`
// mirrors them).
void bwd_grids(int B, int H, int G, int P, int N, int cs, int nc, int nsplit, int* g) {
  const Tiles tl = tiles_of(cs);
  const int want[24] = {tl.npairs, nc, B * G, nc, H, B,
                        tl.npairs * nsplit, nc, B * G, (P * N + 255) / 256, H, B,
                        tl.nt * nc, H, B, tl.nt * 2 * ((N + 63) / 64), nc, B * G,
                        nc, H, B, 1, 1, 1};
  for (int i = 0; i < 24; ++i) g[i] = want[i];
}

template <typename T, int P>
int launch_bwd(TrainArgs& a, const int* grid, cudaStream_t s) {
  const TrainSmem sm = train_smem(P, a.N, a.cs);
  int err = run(ssd_bwd_scores_kernel<T>, grid, 128, 4 * sm.scores, a, s);
  if (!err) err = run(ssd_bwd_local_kernel<T, P>, grid + 3, 256, 4 * sm.local, a, s);
  if (!err) err = run(ssd_bwd_ds_kernel<T, P>, grid + 6, 128, 4 * sm.ds, a, s);
  if (!err) err = run(ssd_bwd_chain_kernel, grid + 9, 256, 0, a, s);
  if (!err) err = run(ssd_bwd_dx_kernel<T, P>, grid + 12, 128, 4 * sm.dx, a, s);
  if (!err) err = run(ssd_bwd_dbdc_kernel<T, P>, grid + 15, 128, 4 * sm.dbdc, a, s);
  if (!err) err = run(ssd_bwd_dt_kernel, grid + 18, 256, 4 * sm.dt, a, s);
  if (!err) err = run(ssd_bwd_da_kernel, grid + 21, 256, 0, a, s);
  return err;
}

template <typename T>
int launch_bwd_hd(int hd, TrainArgs& a, const int* grid, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_bwd<T, 16>(a, grid, s);
    case 32: return launch_bwd<T, 32>(a, grid, s);
    case 64: return launch_bwd<T, 64>(a, grid, s);
    case 128: return launch_bwd<T, 128>(a, grid, s);
    default: return -1;
  }
}

}  // namespace

// The backward of ssd_scan_fwd (K4-bwd) for dy (B, H, S, hd) and the final
// state's gradient dstate (B, H, hd, N) fp32 contiguous, or null: dx
// (x's dtype), ddt (B, H, S) fp32 contiguous, dB and dC (B, G, S, N) in
// x's dtype, dA (H,) fp32.  states: the forward's chunk-entry states.
// scratch: fp32, written before it is read, carved in order into the
// scores, the dscores of nsplit splits of each group's heads (each
// (B G, nc, cs64, cs64)), dS_out (B, H, nc, hd, N), cum, q and dw (B, H,
// S), the totals and <G, S_in> (B, H, nc), the d(cum) row and column
// sums (B, H, nc, npairs, 64), the paired dA terms (B, H, nc, npairs)
// and the dA partials (B, H, nc).  grid: the eight passes' grids
// (`bwd_plan`), which must cover the shapes.  Strides as for
// ssd_scan_fwd, of x, dt, B_, C_, dy, dx, dB, dC.  Returns
// cudaGetLastError() after the launches, or -1 for what it does not
// take.
extern "C" int ssd_scan_bwd(int dtype, int hd, const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* dy,
                            const void* states, const void* dstate, void* scratch, void* dx,
                            void* ddt, void* dB, void* dC, void* dA, int B, int H, int G,
                            int S, int N, int cs, int nc, int nsplit, const int* grid,
                            const long long* strides, void* stream) {
  if (!hd_ok(hd) || cs < 1 || G < 1 || H % G || nc != (S + cs - 1) / cs || nsplit < 1 ||
      nsplit > H / G)
    return -1;
  int want[24];
  bwd_grids(B, H, G, hd, N, cs, nc, nsplit, want);
  if (!grids_cover(grid, want, 24)) return -1;
  const Tiles tl = tiles_of(cs);
  const long long sq = (long long)B * G * nc * tl.cs64 * tl.cs64, bhs = (long long)B * H * S,
                  bhc = (long long)B * H * nc;
  Carve cv{static_cast<float*>(scratch)};
  TrainArgs a{};
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bm = Bm;
  a.Cm = Cm;
  a.dy = dy;
  a.states = const_cast<float*>(static_cast<const float*>(states));
  a.dstate = static_cast<const float*>(dstate);
  a.dx = dx;
  a.ddt = static_cast<float*>(ddt);
  a.dB = dB;
  a.dC = dC;
  a.dA = static_cast<float*>(dA);
  a.sc = cv.take(sq);
  a.dS = cv.take(nsplit * sq);
  a.dSo = cv.take(bhc * hd * N);
  a.cum = cv.take(bhs);
  a.q = cv.take(bhs);
  a.dw = cv.take(bhs);
  a.tot = cv.take(bhc);
  a.gs = cv.take(bhc);
  a.rr = cv.take(bhc * tl.npairs * 64);
  a.cr = cv.take(bhc * tl.npairs * 64);
  a.dar = cv.take(bhc * tl.npairs);
  a.dAp = cv.take(bhc);
  a.B = B, a.H = H, a.G = G, a.S = S, a.P = hd, a.N = N, a.cs = cs, a.nc = nc;
  a.nsplit = nsplit;
  const long long* st = strides;
  a.xs = strides_at(st, 0), a.ds = strides_at(st, 1), a.bs = strides_at(st, 2);
  a.cs_ = strides_at(st, 3), a.dys = strides_at(st, 4), a.dxs = strides_at(st, 5);
  a.dbs = strides_at(st, 6), a.dcs = strides_at(st, 7);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = -1;
  if (dtype == 0) err = launch_bwd_hd<float>(hd, a, grid, s);
  if (dtype == 1) err = launch_bwd_hd<__nv_bfloat16>(hd, a, grid, s);
  return err != 0 ? err : (int)cudaGetLastError();
}
