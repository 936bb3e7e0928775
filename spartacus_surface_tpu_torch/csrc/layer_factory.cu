// Kernels K1 and K1d: the per-layer operator factory.
//
// Replace the TPU kernel pallas_layer_thin_double
// (spartacus_surface_tpu/ops/pallas_layer.py:788) in both of its branches:
//   K1  (layer_factory_kernel): the structured branch, _layer_kernel_structured
//       :495 + _extract_double :350 + _schur_int_kernel :212, taken when
//       nd >= 2 ndir and nd >= 2 (pallas_layer.py:855);
//   K1d (layer_factory_dense_kernel): the dense branch, _layer_kernel :268,
//       taken otherwise: every 1-stream shortwave solve (nd = ndir = nreg)
//       and the 1-stream, 1-region longwave one (nd = ndir = 1).
// Both serve the shortwave (ndir = nreg, int_direct on) and the longwave
// emission pseudo-beam of pallas_lw_layer_tiles :1013 (ndir = 1, gamma0 = 0,
// gamma3 = b, int_direct off: gamma0 is singular, so the direct-beam
// integrals are neither computed nor written).  Plain versions:
// ops/layer_kernel.py layer_factory_plain / lw_layer_factory_plain
// (ops/layer_matrices.py).
//
// K1, per element (batch element, layer):
//   1. Gamma*dz in the basis K = [[I, I], [I, -I]] of the two diffuse blocks,
//      where the diffuse part becomes anti-diagonal [[0, Bm], [Cm, 0]] with
//      Bm = g2 - g1, Cm = -(g1 + g2);
//   2. K = ceil(log2(||Gamma dz||_inf / theta)) capped at n_double, scale by
//      2^-K;
//   3. half-size Pade-7: even powers of the anti-diagonal block are
//      diag(W^k, W'^k) with W = Bm Cm, W' = Cm Bm, and the direct column is
//      carried through the power recurrence; solve (V - U) X = 2 U for
//      X = F - I at size 2 nd, undo the transform with a butterfly and add
//      I.  Solving for F - I rather than F keeps the identity out of the
//      butterfly: the off-diagonal blocks of F are O(dz 2^-K) differences
//      of its O(1) diagonal blocks, and in float32 that cancellation,
//      doubled K times, cost R up to 20x the plain version's error (1-stream
//      longwave, K ~ 8);
//   4. thin-layer R, T, Sup, Sdn, E from the blocks of F, then this
//      element's own K adding-doubling steps;
//   5. block-Schur Gamma^-1 integrals int_diff and, with int_direct,
//      int_dir and int_dir_diff.
// K1d replaces steps 1-3 by the full N = 2 nd + ndir matrix: assemble
// [[-g1, -g2, -g3], [g2, g1, g3], [0, 0, g0]] dz, the same per-element K,
// A^2, A^4, A^6, U = A (b7 A^6 + b5 A^4 + b3 A^2 + b1 I) and a size-N solve
// for F; steps 4-5 are the same device functions (extract_double,
// schur_ints).  All solves are pivot-free.
//
// K1's design on the H100.  One team of TS lanes of a warp per element (TS
// the power of two >= nd, at most 32: 8 at nd = 8, 4 elements a warp; 16 at
// nd = 12 and 16; 32 at nd = 24), TS a template parameter.  A lane owns the
// rows lane, lane + TS, ... of every matrix it writes; a product is row
// parallel (tmm: the lane's row of A in registers, B read whole from shared
// memory as a broadcast), the pivot-free LU eliminates with one broadcast
// pivot row a step and back-substitutes by columns (tsolve), and the team
// syncs with __syncwarp(team mask), never a block barrier.  The element's
// working set lives in a slab of shared memory sized by its live set
// (slab_layout: ~11 nd^2 + 11 nd ndir + 8 ndir^2, the Pade and column
// recurrence stage; 984 floats at nd = 8, ndir = 2), with odd row strides
// for the nd-wide matrices so a team's lanes reading their rows hit
// distinct banks, and a slab stride that puts the teams of a warp TS banks
// apart for their broadcasts.  Nothing goes to device memory but the
// operands (read once or twice) and the results.  What bounds it: shared
// memory per SM, which sets the resident elements (56 at the headline in
// float32, 12 at nd = 12 in float64), with few warps to hide the latency
// of each lane's chain of shared-memory loads and FMAs; and the doubling
// counts, which differ between the teams of a warp: each team loops its
// own K (the lanes of a team share K, so its syncs are uniform), the warp
// runs its largest, and the teams meet again (__syncwarp over the warp's
// live lanes) before the Schur integrals.  A slab above the card's shared
// memory per block (nd > ~45 in float64) goes to a global scratch of one
// slab per resident team, which the wrapper allocates.
//
// The order of the elements (K1 and K1d).  A block holds its slabs until
// its slowest team is done, so a block whose teams' K differ (a night
// column's direct beam at the clamped cosine 1e-6 takes ~20 steps, a day
// column's 2-5) runs its largest K with the other slabs idle.  So the
// teams take the elements as A.order lists them: the order pass
// (factory_order_kernel, one thread an element, K by K1's norm) keys each
// element by its window of consecutive places and its K, and the wrapper
// sorts the keys on the card, so that each window's elements come longest
// first and a block's teams run alike counts.  A window holds as many
// elements as the card runs at once, so the operand and result sectors
// that a window's elements share stay in L2 while it runs: one order of
// the whole launch by K, which scatters every sector's elements over the
// launch, ran K1 at urban_mix's and rami5's shapes 12-49 % slower than
// windows of the card's resident teams (NVIDIA H100).  An element reads and writes only
// at its own (l, b), so the results do not depend on the order.
//
// K1d's design on the H100 is K1's: one team of TS lanes per element (TS
// the power of two >= nd, at most 4: 1, 2, 4 at the solver's nd = 1, 2, 3,
// so a lane takes about three rows of the N-row products at N = 3, 6, 9),
// the same team forms (tmm, tsolve, team_max) and the same extraction and
// Schur functions, one launch over all L*B elements and no workspace.  Its
// slab (dense_slab_layout) holds F, Gamma dz and the three Pade powers, N
// x N each at the odd row stride N | 1 (5 N (N | 1) entries: 405 at N = 9,
// 1,620 B in float32, 3,240 B in float64); the extraction's workspaces
// overlay the dead Gamma dz and powers, and the Schur integrals' operand
// copies and workspaces the whole slab.  What bounds it: shared memory per
// SM and the registers of a lane (a row of the left factor of each N-wide
// product in registers), which set the resident teams; and, as for K1, the
// doubling counts that differ within a warp (the longwave pseudo-beam's
// norm covers the emission column b = O(10^2) W m^-2 per unit height, so
// its elements take several more steps than the shortwave's).  K1d has no
// global-slab kernel: a slab above a block's shared memory (N > ~75 in
// float64, far beyond the solver's N <= 9) has no launch configuration,
// and the launch raises (cudaErrorInvalidConfiguration).  It replaces the
// one-thread-per-element body whose workspace lay in a chunked global
// buffer (up to 495 rows an element), which every access went to device
// memory for.

#include "common.cuh"

namespace spx {

template <typename T>
struct FactoryArgs {
  const T *g0, *g1, *g2, *g3, *dz;  // [L, rows, B] and dz [L, B]
  T *R, *Tm, *E, *Sup, *Sdn, *idiff, *idir, *idd;  // [L, rows, B]
  // K1: null, or one slab per resident team where a slab exceeds the
  // shared memory of a block; K1d: null
  T* ws;
  // the elements in the order the teams take them (the order pass's:
  // window by window, longest doubling count first); null in the order
  // pass itself
  const long long* order;
  int nd, ndir, n_double, int_direct;  // int_direct 0: idir, idd unused
  T theta;
  long long B, n;  // batch; this launch covers elements 0 .. n - 1 (L*B)
};

// Diagonal Pade [7/7] coefficients.
template <typename T>
SPX_DEV T pade(int k) {
  const double b[8] = {17297280.0, 8648640.0, 1995840.0, 277200.0,
                       25200.0,    1512.0,    56.0,      1.0};
  return T(b[k]);
}

// The largest v over the team's lanes (fmax is exact in any order).
template <int TS, typename T>
SPX_DEV T team_max(const Team<TS>& tm, T v) {
#ifdef __CUDACC__
  SPX_UNROLL
  for (int off = TS / 2; off > 0; off >>= 1)
    v = fmax(v, __shfl_xor_sync(tm.mask, v, off));
#endif
  return v;
}

// A lane's part of the row-sum norm of an element's Gamma dz (K1's step
// 2): (sum |g1| + sum |g2| + sum |g3|) dz over its rows lane, lane + TS,
// ... of the diffuse block, sum |g0| dz over those of the direct block;
// the largest part over the team's lanes is the norm.
template <int TS, class M, typename T>
SPX_DEV T gamma_norm_part(const Team<TS>& tm, int nd, int ndir, M g0, M g1, M g2,
                          M g3, T s) {
  T nrm = T(0);
  for (int i = tm.lane; i < nd; i += TS) {
    T r1 = T(0), r2 = T(0), r3 = T(0);
    for (int k = 0; k < nd; ++k) {
      r1 += fabs(g1(i, k));
      r2 += fabs(g2(i, k));
    }
    for (int e = 0; e < ndir; ++e) r3 += fabs(g3(i, e));
    nrm = fmax(nrm, (r1 + r2 + r3) * s);
  }
  for (int i = tm.lane; i < ndir; i += TS) {
    T r0 = T(0);
    for (int e = 0; e < ndir; ++e) r0 += fabs(g0(i, e));
    nrm = fmax(nrm, r0 * s);
  }
  return nrm;
}

// An element's doubling count from the row-sum norm of its Gamma dz:
// ceil(log2(nrm / theta)), clamped to [0, n_double].
template <typename T>
SPX_DEV int doubling_count(T nrm, T theta, int n_double) {
  return int(fmin(fmax(ceil(log2(fmax(nrm, T(1e-30)) / theta)), T(0)), T(n_double)));
}

// The order pass's body: element j's sort key, its window j / window
// above 255 - K in the low byte, K its doubling count by K1's norm (for a
// K1d element the same but where its own norm, summed over the assembled
// Gamma dz, rounds across a step; at most 255).  Sorted ascending and
// stable, the keys list each window's elements longest first.
template <typename T>
SPX_DEV int order_key(const FactoryArgs<T>& A, long long j, long long window) {
  const int nd = A.nd, ndir = A.ndir;
  const long long l = j / A.B, b = j % A.B;
  auto op = [&](const T* p, int rows, int ld) {
    return mat(Col<T>{const_cast<T*>(p) + l * rows * A.B + b, A.B}, ld);
  };
  const int K = doubling_count(
      gamma_norm_part(Team<1>{0, 0u}, nd, ndir, op(A.g0, ndir * ndir, ndir),
                      op(A.g1, nd * nd, nd), op(A.g2, nd * nd, nd),
                      op(A.g3, nd * ndir, ndir), A.dz[l * A.B + b]),
      A.theta, A.n_double);
  return (int)(j / window) << 8 | (255 - (K < 255 ? K : 255));
}

// Workspaces of extract_double: W1 (nd x nd), W2 (nd x (nd + ndir)), W3a-c
// (nd x ndir), R, Tt, TMP, TT (nd x nd), Sup, Sdn, SMID, SUPE (nd x ndir),
// E, E2 (ndir x ndir).
template <class M>
struct ExtractWs {
  M W1, W2, W3a, W3b, W3c, R, Tt, TMP, TT, Sup, Sdn, SMID, SUPE, E, E2;
};

// Thin-layer extraction from F = expm(Gamma s) (its first 2 nd rows, and
// its direct block F33) plus nK adding-doubling steps; writes R, T, E, Sup,
// Sdn.  TT may overlay F (F is dead after the first step).  Ends with a
// team sync.
template <int TS, int CAP, class MF, class M, class MO>
SPX_DEV void extract_double(const Team<TS>& tm, int nd, int ndir, int nK,
                            MF F, MF F33, const ExtractWs<M>& w, MO r_out,
                            MO t_out, MO e_out, MO sup_out, MO sdn_out) {
  using T = elem_t<M>;
  const int mx = nd + ndir;
  // X = F11^-1 [F12 | F13]
  for (int i = tm.lane; i < nd; i += TS) {
    for (int j = 0; j < nd; ++j) w.W1(i, j) = F(i, j);
    for (int j = 0; j < mx; ++j) w.W2(i, j) = F(i, nd + j);
  }
  tm.sync();
  tsolve(tm, w.W1, w.W2, nd, mx);
  // R = -X1, Sup = -X2; T = F22 - F21 X1, Sdn = F23 - F21 X2; E = F33
  for (int i = tm.lane; i < nd; i += TS) {
    for (int j = 0; j < nd; ++j) w.R(i, j) = -w.W2(i, j);
    for (int e = 0; e < ndir; ++e) w.Sup(i, e) = -w.W2(i, nd + e);
    for (int j = 0; j < mx; ++j) {
      T acc = F(nd + i, nd + j);
      for (int k = 0; k < nd; ++k) acc -= F(nd + i, k) * w.W2(k, j);
      if (j < nd)
        w.Tt(i, j) = acc;
      else
        w.Sdn(i, j - nd) = acc;
    }
  }
  for (int i = tm.lane; i < ndir; i += TS)
    for (int e = 0; e < ndir; ++e) w.E(i, e) = F33(i, e);
  tm.sync();

  for (int step = 0; step < nK; ++step) {
    // SupE = Sup E; S_mid = Sdn + R SupE
    tmm<TS, CAP>(tm, w.SUPE, w.Sup, w.E, nd, ndir, ndir);
    tcopy(tm, w.SMID, w.Sdn, nd, ndir);
    tmm<TS, CAP>(tm, w.SMID, w.R, w.SUPE, nd, nd, ndir, true);
    // (I - R R) [Vt | Vs] = [T | S_mid]
    tmm<TS, CAP>(tm, w.W1, w.R, w.R, nd, nd, nd);
    for (int i = tm.lane; i < nd; i += TS) {
      for (int j = 0; j < nd; ++j) {
        w.W1(i, j) = T(i == j) - w.W1(i, j);
        w.W2(i, j) = w.Tt(i, j);
      }
      for (int e = 0; e < ndir; ++e) w.W2(i, nd + e) = w.SMID(i, e);
    }
    tm.sync();
    tsolve(tm, w.W1, w.W2, nd, mx);
    // TMP = R Vt; W3a = R Vs + SupE
    tmm<TS, CAP>(tm, w.TMP, w.R, w.W2, nd, nd, nd);
    tcopy(tm, w.W3a, w.SUPE, nd, ndir);
    tmm<TS, CAP>(tm, w.W3a, w.R, w.W2.sub(0, nd), nd, nd, ndir, true);
    // R' = R + T TMP -> W1; T' = T Vt -> TT;
    // Sup' = Sup + T W3a -> W3b; Sdn' = T Vs + Sdn E -> W3c
    tcopy(tm, w.W1, w.R, nd, nd);
    tmm<TS, CAP>(tm, w.W1, w.Tt, w.TMP, nd, nd, nd, true);
    tmm<TS, CAP>(tm, w.TT, w.Tt, w.W2, nd, nd, nd);
    tcopy(tm, w.W3b, w.Sup, nd, ndir);
    tmm<TS, CAP>(tm, w.W3b, w.Tt, w.W3a, nd, nd, ndir, true);
    tmm<TS, CAP>(tm, w.W3c, w.Tt, w.W2.sub(0, nd), nd, nd, ndir);
    tmm<TS, CAP>(tm, w.W3c, w.Sdn, w.E, nd, ndir, ndir, true);
    tmm<TS, CAP>(tm, w.E2, w.E, w.E, ndir, ndir, ndir);
    for (int i = tm.lane; i < nd; i += TS) {
      for (int j = 0; j < nd; ++j) {
        w.R(i, j) = w.W1(i, j);
        w.Tt(i, j) = w.TT(i, j);
      }
      for (int e = 0; e < ndir; ++e) {
        w.Sup(i, e) = w.W3b(i, e);
        w.Sdn(i, e) = w.W3c(i, e);
      }
    }
    for (int i = tm.lane; i < ndir; i += TS)
      for (int e = 0; e < ndir; ++e) w.E(i, e) = w.E2(i, e);
    tm.sync();
  }
  for (int i = tm.lane; i < nd; i += TS) {
    for (int j = 0; j < nd; ++j) {
      r_out(i, j) = w.R(i, j);
      t_out(i, j) = w.Tt(i, j);
    }
    for (int e = 0; e < ndir; ++e) {
      sup_out(i, e) = w.Sup(i, e);
      sdn_out(i, e) = w.Sdn(i, e);
    }
  }
  for (int i = tm.lane; i < ndir; i += TS)
    for (int e = 0; e < ndir; ++e) e_out(i, e) = w.E(i, e);
  tm.sync();
}

// Block-Schur Gamma^-1 integral matrices (radtool_schur.F90:45-51), with
// five nd x nd workspaces G, Fs, W1, W2, W3 (used as ndir-column matrices
// of row stride ldr in the direct part); the direct-beam ones (which need
// inv(g0)) only with int_direct.  Ends with a team sync.
template <int TS, int CAP, class MG, class M, class MO>
SPX_DEV void schur_ints(const Team<TS>& tm, int nd, int ndir, int ldr,
                        bool int_direct, MG g0, MG g1, MG g2, MG g3, M G,
                        M Fs, M W1, M W2, M W3, MO idiff, MO idir, MO idd) {
  using T = elem_t<M>;
  tcopy(tm, W1, g1, nd, nd);  // W2 = inv(g1)
  teye(tm, W2, nd);
  tsolve(tm, W1, W2, nd, nd);
  tmm<TS, CAP>(tm, G, W2, g2, nd, nd, nd);   // inv(g1) g2
  tmm<TS, CAP>(tm, Fs, g2, W2, nd, nd, nd);  // g2 inv(g1)
  tmm<TS, CAP>(tm, W1, g2, G, nd, nd, nd);   // Schur complement g1 - g2 inv(g1) g2
  for (int i = tm.lane; i < nd; i += TS)
    for (int j = 0; j < nd; ++j) W1(i, j) = g1(i, j) - W1(i, j);
  teye(tm, W3, nd);  // W3 = g1i
  tsolve(tm, W1, W3, nd, nd);
  tmm<TS, CAP>(tm, G, W3, Fs, nd, nd, nd);  // g2i = g1i g2 inv(g1)
  for (int i = tm.lane; i < nd; i += TS)
    for (int j = 0; j < nd; ++j) idiff(i, j) = G(i, j) - W3(i, j);
  tm.sync();
  if (!int_direct) return;
  const M W1d{W1.v, ldr}, W2d{W2.v, ldr}, Fsd{Fs.v, ldr};
  tcopy(tm, W1d, g0, ndir, ndir);  // W2d = g0i
  teye(tm, W2d, ndir);
  tsolve(tm, W1d, W2d, ndir, ndir);
  for (int i = tm.lane; i < ndir; i += TS)
    for (int e = 0; e < ndir; ++e) idir(i, e) = -W2d(i, e);
  tmm<TS, CAP>(tm, Fsd, g3, W2d, nd, ndir, ndir);  // g3 g0i
  for (int i = tm.lane; i < nd; i += TS)
    for (int e = 0; e < ndir; ++e) {
      T acc = T(0);
      for (int k = 0; k < nd; ++k) acc += (W3(i, k) - G(i, k)) * Fsd(k, e);
      idd(i, e) = T(2) * acc;
    }
  tm.sync();
}

// K1's per-element slab: offsets (in elements) of its matrices and their
// row strides.  Stages: 1-2 assembly, Pade, direct block, column
// recurrences and the (V - U) solve; 3 extraction and doubling; 4 Schur
// integrals.  The direct block (dblk: D D2 D4 D6 VD UD M X33, X33 becoming
// F33) lives through stage 3's start; the V - U matrix (vmu) holds VW, P12,
// P21, VWp as its blocks; the right-hand side F overlays the stage-1
// temporaries (bm .. tmp); stage 3 takes the dead vmu and xy slots where a
// matrix fits, else the room after F, with TT over F; stage 4 starts over.
struct Slab {
  int ldn, ld2, ldN, ldm;  // row strides of nd-, 2 nd-, N-, nd+ndir-wide
  int dblk, vmu, xy, bm, cm, bv, w, wp, w2, wp2, tmp, f;
  int w1, w2x, r, t, tmq, tt, sup, sdn, smid, supe, w3a, w3b, w3c, e, e2;
  int g0, g1, g2, g3, sg, sf, s1, s2, s3;
  int size;
};

inline Slab slab_layout(int nd, int ndir) {
  Slab S{};
  const int N = 2 * nd + ndir;
  S.ldn = nd | 1;
  S.ld2 = (2 * nd) | 1;
  S.ldN = N | 1;
  S.ldm = (nd + ndir) | 1;
  const int sq = nd * S.ldn, rc = nd * ndir, dd = ndir * ndir;
  int o = 0;
  auto take = [&o](int rows) { const int at = o; o += rows; return at; };
  S.dblk = take(8 * dd);
  const int base = o;
  S.vmu = take(2 * nd * S.ld2);
  S.xy = take(10 * rc);
  const int reg2 = o;
  S.bm = take(sq), S.cm = take(sq), S.bv = take(rc);
  S.w = take(sq), S.wp = take(sq), S.w2 = take(sq), S.wp2 = take(sq);
  S.tmp = take(sq);
  S.f = reg2;
  const int end_f = reg2 + 2 * nd * S.ldN;
  int size = o > end_f ? o : end_f;
  int oa = base, ob = end_f;
  auto take3 = [&](int rows) {
    int at;
    if (oa + rows <= reg2) {
      at = oa;
      oa += rows;
    } else {
      at = ob;
      ob += rows;
    }
    return at;
  };
  S.w1 = take3(sq), S.w2x = take3(nd * S.ldm), S.r = take3(sq);
  S.t = take3(sq), S.tmq = take3(sq);
  S.sup = take3(rc), S.sdn = take3(rc), S.smid = take3(rc), S.supe = take3(rc);
  S.w3a = take3(rc), S.w3b = take3(rc), S.w3c = take3(rc);
  S.e = take3(dd), S.e2 = take3(dd);
  S.tt = S.f;
  size = ob > size ? ob : size;
  o = base;
  S.g0 = take(dd), S.g1 = take(sq), S.g2 = take(sq), S.g3 = take(rc);
  S.sg = take(sq), S.sf = take(sq), S.s1 = take(sq), S.s2 = take(sq);
  S.s3 = take(sq);
  S.size = o > size ? o : size;
  return S;
}

// K1, one element j (a team of TS lanes; TS = 1 on the host) with its slab.
// `live` names the lanes of the warp whose teams run this body now: they
// meet after the doubling steps, where their K differ, so the warp runs the
// Schur integrals once for all its teams rather than once per K.  Ends with
// a team sync, so the team may take its next element.
template <int TS, int CAP, typename T>
SPX_DEV void layer_factory_team(const FactoryArgs<T>& A, const Slab& S,
                                const Team<TS>& tm, long long j, T* slab,
                                unsigned live) {
  const int nd = A.nd, ndir = A.ndir, N = 2 * nd + ndir;
  const int n2 = nd * nd, nr = nd * ndir, d2 = ndir * ndir;
  const long long l = j / A.B, b = j % A.B;
  auto op = [&](const T* p, int rows, int ld) {
    return mat(Col<T>{const_cast<T*>(p) + l * rows * A.B + b, A.B}, ld);
  };
  const auto g0 = op(A.g0, d2, ndir), g1 = op(A.g1, n2, nd),
             g2 = op(A.g2, n2, nd), g3 = op(A.g3, nr, ndir);
  const T s = A.dz[l * A.B + b];
  const Sh<T> sm{slab};
  auto at = [&](int off, int ld) { return mat(sm.at(off), ld); };
  const int ldn = S.ldn;
  const auto Bm = at(S.bm, ldn), Cm = at(S.cm, ldn), bv = at(S.bv, ndir);
  const auto D = at(S.dblk, ndir), D2 = at(S.dblk + d2, ndir),
             D4 = at(S.dblk + 2 * d2, ndir), D6 = at(S.dblk + 3 * d2, ndir),
             VD = at(S.dblk + 4 * d2, ndir), UD = at(S.dblk + 5 * d2, ndir),
             M = at(S.dblk + 6 * d2, ndir), X33 = at(S.dblk + 7 * d2, ndir);
  auto xy = [&](int k) { return at(S.xy + k * nr, ndir); };
  const auto x2 = xy(0), y2 = xy(1), x3 = xy(2), y3 = xy(3), x4 = xy(4),
             y4 = xy(5), x5 = xy(6), y5 = xy(7), x6 = xy(8), y6 = xy(9);
  // late-stage quantities reuse finished recurrence slots
  const auto xv = x3, yv = y3, xu = x5, yu = y5, u13 = x2, u23 = y2;
  const auto W = at(S.w, ldn), Wp = at(S.wp, ldn), W2 = at(S.w2, ldn),
             Wp2 = at(S.wp2, ldn), TMP = at(S.tmp, ldn);
  // V - U: [[VW, -P12], [-P21, VWp]], its blocks computed in place
  const auto VMU = at(S.vmu, S.ld2);
  const auto VW = VMU, P12 = VMU.sub(0, nd), P21 = VMU.sub(nd, 0),
             VWp = VMU.sub(nd, nd);

  // ---- assembly in the transformed basis, scaled by dz
  for (int i = tm.lane; i < nd; i += TS) {
    for (int k = 0; k < nd; ++k) {
      const T g1r = g1(i, k) * s, g2r = g2(i, k) * s;
      Bm(i, k) = g2r - g1r;
      Cm(i, k) = -(g1r + g2r);
    }
    for (int e = 0; e < ndir; ++e) bv(i, e) = T(-2) * g3(i, e) * s;
  }
  for (int i = tm.lane; i < ndir; i += TS)
    for (int e = 0; e < ndir; ++e) D(i, e) = g0(i, e) * s;

  // ---- per-element scaling from the row-sum norm of the dense Gamma dz
  const T nrm = team_max(tm, gamma_norm_part(tm, nd, ndir, g0, g1, g2, g3, s));
  const int nK = doubling_count(nrm, A.theta, A.n_double);
  const T fac = ldexp(T(1), -nK);
  for (int i = tm.lane; i < nd; i += TS) {
    for (int k = 0; k < nd; ++k) Bm(i, k) *= fac;
    for (int k = 0; k < nd; ++k) Cm(i, k) *= fac;
    for (int e = 0; e < ndir; ++e) bv(i, e) *= fac;
  }
  for (int i = tm.lane; i < ndir; i += TS)
    for (int e = 0; e < ndir; ++e) D(i, e) *= fac;
  tm.sync();

  // ---- half-size powers and the even/odd Pade polynomials
  tmm<TS, CAP>(tm, W, Bm, Cm, nd, nd, nd);
  tmm<TS, CAP>(tm, Wp, Cm, Bm, nd, nd, nd);
  tmm<TS, CAP>(tm, W2, W, W, nd, nd, nd);
  tmm<TS, CAP>(tm, Wp2, Wp, Wp, nd, nd, nd);
  tmm<TS, CAP>(tm, TMP, W, W2, nd, nd, nd);  // W^3
  for (int i = tm.lane; i < nd; i += TS) {
    for (int k = 0; k < nd; ++k) {
      VW(i, k) = pade<T>(2) * W(i, k) + pade<T>(4) * W2(i, k) + pade<T>(6) * TMP(i, k);
      P12(i, k) = pade<T>(3) * W(i, k) + pade<T>(5) * W2(i, k) + pade<T>(7) * TMP(i, k);
    }
    VW(i, i) += pade<T>(0);
    P12(i, i) += pade<T>(1);
  }
  tm.sync();
  tmm<TS, CAP>(tm, P21, Cm, P12, nd, nd, nd);  // P21 = Cm u(W)
  tmm<TS, CAP>(tm, TMP, Wp, Wp2, nd, nd, nd);  // W'^3
  for (int i = tm.lane; i < nd; i += TS) {
    for (int k = 0; k < nd; ++k) {
      VWp(i, k) = pade<T>(2) * Wp(i, k) + pade<T>(4) * Wp2(i, k) + pade<T>(6) * TMP(i, k);
      TMP(i, k) = pade<T>(3) * Wp(i, k) + pade<T>(5) * Wp2(i, k) + pade<T>(7) * TMP(i, k);
    }
    VWp(i, i) += pade<T>(0);
    TMP(i, i) += pade<T>(1);
  }
  tm.sync();
  tmm<TS, CAP>(tm, P12, Bm, TMP, nd, nd, nd);  // P12 = Bm u(W')

  // ---- direct block: X33 = F33 - I = (vd - D ud)^-1 2 D ud
  tmm<TS, CAP>(tm, D2, D, D, ndir, ndir, ndir);
  tmm<TS, CAP>(tm, D4, D2, D2, ndir, ndir, ndir);
  tmm<TS, CAP>(tm, D6, D2, D4, ndir, ndir, ndir);
  for (int i = tm.lane; i < ndir; i += TS) {
    for (int e = 0; e < ndir; ++e) {
      VD(i, e) = pade<T>(2) * D2(i, e) + pade<T>(4) * D4(i, e) + pade<T>(6) * D6(i, e);
      UD(i, e) = pade<T>(3) * D2(i, e) + pade<T>(5) * D4(i, e) + pade<T>(7) * D6(i, e);
    }
    VD(i, i) += pade<T>(0);
    UD(i, i) += pade<T>(1);
  }
  tm.sync();
  tmm<TS, CAP>(tm, D2, D, UD, ndir, ndir, ndir);  // U33 = D ud
  for (int i = tm.lane; i < ndir; i += TS)
    for (int e = 0; e < ndir; ++e) {
      M(i, e) = VD(i, e) - D2(i, e);
      X33(i, e) = T(2) * D2(i, e);
    }
  tm.sync();
  tsolve(tm, M, X33, ndir, ndir);

  // ---- direct-coupling column recurrences
  tmm<TS, CAP>(tm, x2, Bm, bv, nd, nd, ndir);         // x2 = Bm b
  tmm<TS, CAP>(tm, y2, bv, D, nd, ndir, ndir);        // y2 = b D
  tmm<TS, CAP>(tm, x3, x2, D, nd, ndir, ndir);        // x3 = x2 D
  tmm<TS, CAP>(tm, y3, Wp, bv, nd, nd, ndir);         // y3 = W' b + y2 D
  tmm<TS, CAP>(tm, y3, y2, D, nd, ndir, ndir, true);
  tmm<TS, CAP>(tm, x4, W, x2, nd, nd, ndir);          // x4 = W x2 + x3 D
  tmm<TS, CAP>(tm, x4, x3, D, nd, ndir, ndir, true);
  tmm<TS, CAP>(tm, y4, y3, D, nd, ndir, ndir);        // y4 = y3 D
  tmm<TS, CAP>(tm, x5, x4, D, nd, ndir, ndir);        // x5 = x4 D
  tmm<TS, CAP>(tm, y5, Wp2, bv, nd, nd, ndir);        // y5 = W'^2 b + y4 D
  tmm<TS, CAP>(tm, y5, y4, D, nd, ndir, ndir, true);
  tmm<TS, CAP>(tm, x6, W2, x2, nd, nd, ndir);         // x6 = W^2 x2 + x5 D
  tmm<TS, CAP>(tm, x6, x5, D, nd, ndir, ndir, true);
  tmm<TS, CAP>(tm, y6, y5, D, nd, ndir, ndir);        // y6 = y5 D
  for (int i = tm.lane; i < nd; i += TS)
    for (int e = 0; e < ndir; ++e) {
      const T vx = pade<T>(2) * x2(i, e) + pade<T>(4) * x4(i, e) + pade<T>(6) * x6(i, e);
      const T vy = pade<T>(2) * y2(i, e) + pade<T>(4) * y4(i, e) + pade<T>(6) * y6(i, e);
      const T ux = pade<T>(3) * x2(i, e) + pade<T>(5) * x4(i, e) + pade<T>(7) * x6(i, e);
      const T uy = pade<T>(3) * y2(i, e) + pade<T>(5) * y4(i, e) + pade<T>(7) * y6(i, e);
      xv(i, e) = vx;
      yv(i, e) = vy;
      xu(i, e) = ux;
      yu(i, e) = uy;
    }
  tm.sync();
  tmm<TS, CAP>(tm, u13, Bm, yu, nd, nd, ndir);        // U13 = Bm yu
  tmm<TS, CAP>(tm, u23, Cm, xu, nd, nd, ndir);        // U23 = Cm xu + b ud
  tmm<TS, CAP>(tm, u23, bv, UD, nd, ndir, ndir, true);

  // ---- V - U (negate the off-diagonal blocks in place); RHS 2 U with the
  // direct column pre-corrected by X33, in F over the dead temporaries
  const auto F = at(S.f, S.ldN);
  for (int i = tm.lane; i < nd; i += TS) {
    for (int k = 0; k < nd; ++k) {
      F(i, k) = T(0);
      F(i, nd + k) = T(2) * P12(i, k);
      F(nd + i, k) = T(2) * P21(i, k);
      F(nd + i, nd + k) = T(0);
      P12(i, k) = -P12(i, k);
      P21(i, k) = -P21(i, k);
    }
    for (int e = 0; e < ndir; ++e) {
      T top = T(2) * u13(i, e);
      T mid = T(2) * u23(i, e);
      for (int f = 0; f < ndir; ++f) {
        top -= (xv(i, f) - u13(i, f)) * X33(f, e);
        mid -= (yv(i, f) - u23(i, f)) * X33(f, e);
      }
      F(i, 2 * nd + e) = top;
      F(nd + i, 2 * nd + e) = mid;
    }
  }
  tm.sync();
  tsolve(tm, VMU, F, 2 * nd, N);

  // ---- undo the similarity (butterfly) and add I; F33 = X33 + I
  for (int i = tm.lane; i < nd; i += TS) {
    for (int k = 0; k < nd; ++k) {
      const T f11 = F(i, k), f12 = F(i, nd + k);
      const T f21 = F(nd + i, k), f22 = F(nd + i, nd + k);
      const T sa = f11 + f21, sb = f12 + f22, da = f11 - f21, db = f12 - f22;
      F(i, k) = T(0.5) * (sa + sb);
      F(i, nd + k) = T(0.5) * (sa - sb);
      F(nd + i, k) = T(0.5) * (da + db);
      F(nd + i, nd + k) = T(0.5) * (da - db);
    }
    for (int e = 0; e < ndir; ++e) {
      const T fx = F(i, 2 * nd + e), fy = F(nd + i, 2 * nd + e);
      F(i, 2 * nd + e) = T(0.5) * (fx + fy);
      F(nd + i, 2 * nd + e) = T(0.5) * (fx - fy);
    }
    F(i, i) += T(1);
    F(nd + i, nd + i) += T(1);
  }
  for (int i = tm.lane; i < ndir; i += TS)
    for (int e = 0; e < ndir; ++e) X33(i, e) = X33(i, e) + T(i == e);
  tm.sync();

  // ---- extraction + doubling, then the Schur integrals on the operands
  // copied into the slab
  const ExtractWs<Mat<Sh<T>>> ws{
      at(S.w1, ldn),  at(S.w2x, S.ldm), at(S.w3a, ndir), at(S.w3b, ndir),
      at(S.w3c, ndir), at(S.r, ldn),    at(S.t, ldn),    at(S.tmq, ldn),
      at(S.tt, ldn),  at(S.sup, ndir),  at(S.sdn, ndir), at(S.smid, ndir),
      at(S.supe, ndir), at(S.e, ndir),  at(S.e2, ndir)};
  extract_double<TS, CAP>(tm, nd, ndir, nK, F, X33, ws, op(A.R, n2, nd),
                          op(A.Tm, n2, nd), op(A.E, d2, ndir),
                          op(A.Sup, nr, ndir), op(A.Sdn, nr, ndir));
#ifdef __CUDACC__
  if (TS < 32) __syncwarp(live);
#endif
  const auto G0 = at(S.g0, ndir), G1 = at(S.g1, ldn), G2 = at(S.g2, ldn),
             G3 = at(S.g3, ndir);
  for (int i = tm.lane; i < nd; i += TS) {
    for (int k = 0; k < nd; ++k) {
      G1(i, k) = g1(i, k);
      G2(i, k) = g2(i, k);
    }
    for (int e = 0; e < ndir; ++e) G3(i, e) = g3(i, e);
  }
  for (int i = tm.lane; i < ndir; i += TS)
    for (int e = 0; e < ndir; ++e) G0(i, e) = g0(i, e);
  tm.sync();
  const auto none = mat(Col<T>{nullptr, A.B}, 0);
  schur_ints<TS, CAP>(tm, nd, ndir, ndir, A.int_direct != 0, G0, G1, G2, G3,
                      at(S.sg, ldn), at(S.sf, ldn), at(S.s1, ldn),
                      at(S.s2, ldn), at(S.s3, ldn), op(A.idiff, n2, nd),
                      A.int_direct ? op(A.idir, d2, ndir) : none,
                      A.int_direct ? op(A.idd, nr, ndir) : none);
}

// K1d's per-element slab: offsets (in elements) of its matrices and their
// row strides.  Stage 1-3 (assembly, Pade, the size-N solve): F, Gamma dz
// (G) and the powers A^2, A^4, A^6 (W1, W2, W3; W1 becomes V - U, W2 U),
// N x N each at the odd row stride ldN; stage 4 (extraction and doubling)
// over the dead G .. W3, with TT over F (dead after the first step); stage
// 5 (Schur integrals) starts over, its five workspaces large enough for
// the direct part's ndir-column matrices.
struct DenseSlab {
  int ldN, ldn, ldm;  // row strides of N-, nd-, nd+ndir-wide
  int f, g, w1, w2, w3;
  int x1, x2, x3a, x3b, x3c, r, t, tmq, sup, sdn, smid, supe, e, e2;
  int g0, g1, g2, g3, sg, sf, s1, s2, s3;
  int size;
};

inline DenseSlab dense_slab_layout(int nd, int ndir) {
  DenseSlab S{};
  const int N = 2 * nd + ndir;
  S.ldN = N | 1;
  S.ldn = nd | 1;
  S.ldm = (nd + ndir) | 1;
  const int nn = N * S.ldN, sq = nd * S.ldn, rc = nd * ndir, dd = ndir * ndir;
  int o = 0;
  auto take = [&o](int rows) { const int at = o; o += rows; return at; };
  S.f = take(nn), S.g = take(nn), S.w1 = take(nn), S.w2 = take(nn), S.w3 = take(nn);
  int size = o;
  o = S.g;
  S.x1 = take(sq), S.x2 = take(nd * S.ldm), S.x3a = take(rc), S.x3b = take(rc);
  S.x3c = take(rc), S.r = take(sq), S.t = take(sq), S.tmq = take(sq);
  S.sup = take(rc), S.sdn = take(rc), S.smid = take(rc), S.supe = take(rc);
  S.e = take(dd), S.e2 = take(dd);
  size = o > size ? o : size;
  o = 0;
  int ws = sq > dd ? sq : dd;
  ws = ws > rc ? ws : rc;
  S.g0 = take(dd), S.g1 = take(sq), S.g2 = take(sq), S.g3 = take(rc);
  S.sg = take(ws), S.sf = take(ws), S.s1 = take(ws), S.s2 = take(ws), S.s3 = take(ws);
  S.size = o > size ? o : size;
  return S;
}

// K1d, one element j (a team of TS lanes; TS = 1 on the host) with its
// slab: dense Pade-7 expm of the whole N x N Gamma dz (pallas_layer.py:268),
// then K1's extraction, doubling and Schur integrals.  `live` as for
// layer_factory_team.  A lane owns rows i and nd + i of Gamma dz for its
// i < nd and row 2 nd + i for its i < ndir through the assembly, the norm
// and the scaling, then the rows lane, lane + TS, ... of every N x N
// matrix.  Ends with a team sync.
template <int TS, int CAP, typename T>
SPX_DEV void layer_factory_dense_team(const FactoryArgs<T>& A, const DenseSlab& S,
                                      const Team<TS>& tm, long long j, T* slab,
                                      unsigned live) {
  const int nd = A.nd, ndir = A.ndir, N = 2 * nd + ndir;
  const int n2 = nd * nd, nr = nd * ndir, d2 = ndir * ndir;
  const long long l = j / A.B, b = j % A.B;
  auto op = [&](const T* p, int rows, int ld) {
    return mat(Col<T>{const_cast<T*>(p) + l * rows * A.B + b, A.B}, ld);
  };
  const auto g0 = op(A.g0, d2, ndir), g1 = op(A.g1, n2, nd),
             g2 = op(A.g2, n2, nd), g3 = op(A.g3, nr, ndir);
  const T s = A.dz[l * A.B + b];
  const Sh<T> sm{slab};
  auto at = [&](int off, int ld) { return mat(sm.at(off), ld); };
  const int ldn = S.ldn;
  const auto F = at(S.f, S.ldN), G = at(S.g, S.ldN), W1 = at(S.w1, S.ldN),
             W2 = at(S.w2, S.ldN), W3 = at(S.w3, S.ldN);
  auto row_sum = [&](int i) {
    T r = T(0);
    for (int k = 0; k < N; ++k) r += fabs(G(i, k));
    return r;
  };

  // ---- assemble Gamma dz = [[-g1, -g2, -g3], [g2, g1, g3], [0, 0, g0]] dz
  // and the row-sum norm
  T nrm = T(0);
  for (int i = tm.lane; i < nd; i += TS) {
    for (int k = 0; k < nd; ++k) {
      const T g1r = g1(i, k) * s, g2r = g2(i, k) * s;
      G(i, k) = -g1r;
      G(i, nd + k) = -g2r;
      G(nd + i, k) = g2r;
      G(nd + i, nd + k) = g1r;
    }
    for (int e = 0; e < ndir; ++e) {
      const T g3r = g3(i, e) * s;
      G(i, 2 * nd + e) = -g3r;
      G(nd + i, 2 * nd + e) = g3r;
    }
    nrm = fmax(nrm, row_sum(i));
    nrm = fmax(nrm, row_sum(nd + i));
  }
  for (int i = tm.lane; i < ndir; i += TS) {
    for (int k = 0; k < 2 * nd; ++k) G(2 * nd + i, k) = T(0);
    for (int e = 0; e < ndir; ++e) G(2 * nd + i, 2 * nd + e) = g0(i, e) * s;
    nrm = fmax(nrm, row_sum(2 * nd + i));
  }
  nrm = team_max(tm, nrm);
  const int nK = doubling_count(nrm, A.theta, A.n_double);
  const T fac = ldexp(T(1), -nK);
  for (int i = tm.lane; i < nd; i += TS)
    for (int k = 0; k < N; ++k) {
      G(i, k) *= fac;
      G(nd + i, k) *= fac;
    }
  for (int i = tm.lane; i < ndir; i += TS)
    for (int k = 0; k < N; ++k) G(2 * nd + i, k) *= fac;
  tm.sync();

  // ---- Pade-7: V = b6 A6 + b4 A4 + b2 A2 + b0 I in F,
  // U = A (b7 A6 + b5 A4 + b3 A2 + b1 I) in W2; solve (V - U) F = (V + U)
  tmm<TS, CAP>(tm, W1, G, G, N, N, N);    // A2
  tmm<TS, CAP>(tm, W2, W1, W1, N, N, N);  // A4
  tmm<TS, CAP>(tm, W3, W1, W2, N, N, N);  // A6
  for (int i = tm.lane; i < N; i += TS) {
    for (int k = 0; k < N; ++k) {
      F(i, k) = pade<T>(6) * W3(i, k) + pade<T>(4) * W2(i, k) + pade<T>(2) * W1(i, k);
      W3(i, k) = pade<T>(7) * W3(i, k) + pade<T>(5) * W2(i, k) + pade<T>(3) * W1(i, k);
    }
    F(i, i) += pade<T>(0);
    W3(i, i) += pade<T>(1);
  }
  tm.sync();
  tmm<TS, CAP>(tm, W2, G, W3, N, N, N);  // U
  for (int i = tm.lane; i < N; i += TS)
    for (int k = 0; k < N; ++k) {
      W1(i, k) = F(i, k) - W2(i, k);
      F(i, k) += W2(i, k);
    }
  tm.sync();
  tsolve(tm, W1, F, N, N);  // F = expm(Gamma dz 2^-K)

  // ---- extraction + doubling, then the Schur integrals on the operands
  // copied into the slab
  const ExtractWs<Mat<Sh<T>>> ws{
      at(S.x1, ldn),  at(S.x2, S.ldm), at(S.x3a, ndir), at(S.x3b, ndir),
      at(S.x3c, ndir), at(S.r, ldn),   at(S.t, ldn),    at(S.tmq, ldn),
      at(S.f, ldn),   at(S.sup, ndir), at(S.sdn, ndir), at(S.smid, ndir),
      at(S.supe, ndir), at(S.e, ndir), at(S.e2, ndir)};
  extract_double<TS, CAP>(tm, nd, ndir, nK, F, F.sub(2 * nd, 2 * nd), ws,
                          op(A.R, n2, nd), op(A.Tm, n2, nd), op(A.E, d2, ndir),
                          op(A.Sup, nr, ndir), op(A.Sdn, nr, ndir));
#ifdef __CUDACC__
  if (TS < 32) __syncwarp(live);
#endif
  const auto G0 = at(S.g0, ndir), G1 = at(S.g1, ldn), G2 = at(S.g2, ldn),
             G3 = at(S.g3, ndir);
  for (int i = tm.lane; i < nd; i += TS) {
    for (int k = 0; k < nd; ++k) {
      G1(i, k) = g1(i, k);
      G2(i, k) = g2(i, k);
    }
    for (int e = 0; e < ndir; ++e) G3(i, e) = g3(i, e);
  }
  for (int i = tm.lane; i < ndir; i += TS)
    for (int e = 0; e < ndir; ++e) G0(i, e) = g0(i, e);
  tm.sync();
  const auto none = mat(Col<T>{nullptr, A.B}, 0);
  schur_ints<TS, CAP>(tm, nd, ndir, ndir, A.int_direct != 0, G0, G1, G2, G3,
                      at(S.sg, ldn), at(S.sf, ldn), at(S.s1, ldn),
                      at(S.s2, ldn), at(S.s3, ldn), op(A.idiff, n2, nd),
                      A.int_direct ? op(A.idir, d2, ndir) : none,
                      A.int_direct ? op(A.idd, nr, ndir) : none);
}

template <typename T>
FactoryArgs<T> factory_args(void* g0, void* g1, void* g2, void* g3, void* dz,
                            void* R, void* Tm, void* E, void* Sup, void* Sdn,
                            void* idiff, void* idir, void* idd, void* ws,
                            void* order, int nd, int ndir, int n_double,
                            int int_direct, double theta, long long B, long long n) {
  return FactoryArgs<T>{(const T*)g0, (const T*)g1, (const T*)g2,
                        (const T*)g3, (const T*)dz, (T*)R, (T*)Tm, (T*)E,
                        (T*)Sup, (T*)Sdn, (T*)idiff, (T*)idir, (T*)idd,
                        (T*)ws, (const long long*)order, nd, ndir, n_double,
                        int_direct, T(theta), B, n};
}

// The order pass's operands: the factory's inputs, no outputs, no order.
template <typename T>
FactoryArgs<T> order_args(void* g0, void* g1, void* g2, void* g3, void* dz, int nd,
                          int ndir, int n_double, double theta, long long B,
                          long long n) {
  return factory_args<T>(g0, g1, g2, g3, dz, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nd,
                         ndir, n_double, 0, theta, B, n);
}

}  // namespace spx

#define SPX_FACTORY_PARAMS                                                    \
  void *g0, void *g1, void *g2, void *g3, void *dz, void *R, void *Tm,       \
      void *E, void *Sup, void *Sdn, void *idiff, void *idir, void *idd,     \
      void *ws, void *order, int nd, int ndir, int n_double, int int_direct, \
      double theta, long long B, long long n
#define SPX_FACTORY_ARGS                                                      \
  g0, g1, g2, g3, dz, R, Tm, E, Sup, Sdn, idiff, idir, idd, ws, order, nd,   \
      ndir, n_double, int_direct, theta, B, n
// the order pass: the factory's operands, then its output (an int32 key
// an element) and the elements of a window
#define SPX_ORDER_PARAMS                                                      \
  void *g0, void *g1, void *g2, void *g3, void *dz, void *keys, int nd,      \
      int ndir, int n_double, double theta, long long B, long long n,        \
      long long window
#define SPX_ORDER_ARGS                                                        \
  g0, g1, g2, g3, dz, keys, nd, ndir, n_double, theta, B, n, window

#ifndef __CUDACC__
// The order pass in a host build (host_check.cpp, host_count.cpp): each
// element's key, one element at a time.
template <typename T>
static void order_host(SPX_ORDER_PARAMS) {
  const auto A = spx::order_args<T>(g0, g1, g2, g3, dz, nd, ndir, n_double, theta, B, n);
  for (long long j = 0; j < n; ++j) ((int*)keys)[j] = spx::order_key(A, j, window);
}
#endif

// K1d's team products keep a row of the left factor in registers up to this
// width (N <= 9 in every solver configuration)
#define SPX_DENSE_CAP 16

#ifdef __CUDACC__
// The source compiles in parts, one nvcc each, started together
// (ops/cuda_build.py PARTS): SPX_PART_TS16, SPX_PART_TS32_F32 and
// SPX_PART_TS32_F64 instantiate K1 at those team sizes, SPX_PART_DENSE K1d
// at every team size; the main part (no macro) the rest and the C
// interface.
#if defined(SPX_PART_TS16) || defined(SPX_PART_TS32_F32) || \
    defined(SPX_PART_TS32_F64) || defined(SPX_PART_DENSE)
#define SPX_PART_SIDE
#endif

// The body of K1's and K1d's team kernels: teams of TS lanes, blockDim.x /
// TS of them a block, each looping over the places j = its index, + the
// grid's teams, ... of the order A.order and running the element there;
// the slab in dynamic shared memory, or (GLOBAL, K1 at TS = 32 only) in
// the wrapper's scratch at A.ws.  Every lane of the warp takes each round,
// so the teams with an element know one another (live); body(tm, e, slab,
// live) runs element e, reading its operands and writing its results at
// its own (l, b).
template <typename T, int TS, bool GLOBAL, class F>
__device__ __forceinline__ void factory_teams(const spx::FactoryArgs<T>& A, int stride, F body) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int per_block = blockDim.x / TS, team = threadIdx.x / TS;
  const unsigned ones = (unsigned)((1ull << TS) - 1ull);
  const spx::Team<TS> tm{(int)(threadIdx.x % TS),
                         ones << ((threadIdx.x % 32) / TS * TS)};
  const long long first = (long long)blockIdx.x * per_block + team;
  const long long step = (long long)gridDim.x * per_block;
  T* slab = GLOBAL ? A.ws + first * stride
                   : reinterpret_cast<T*>(smem_raw) + team * stride;
  for (long long j = first;; j += step) {
    const unsigned live = __ballot_sync(0xffffffffu, j < A.n);
    if (live == 0) break;
    if (j < A.n) body(tm, A.order[j], slab, live);
  }
}

// The order pass: each element's sort key (spx::order_key), one thread an
// element, so that a warp reads 32 neighbouring columns of each operand
// row.
template <typename T>
__global__ void factory_order_kernel(spx::FactoryArgs<T> A, long long window, int* keys) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j < A.n) keys[j] = spx::order_key(A, j, window);
}

// K1 at team size TS.
template <typename T, int TS, bool GLOBAL>
__global__ void layer_factory_kernel(spx::FactoryArgs<T> A, spx::Slab S,
                                     int stride) {
  factory_teams<T, TS, GLOBAL>(A, stride, [&](const spx::Team<TS>& tm, long long j,
                                              T* slab, unsigned live) {
    spx::layer_factory_team<TS, TS>(A, S, tm, j, slab, live);
  });
}

// K1d at team size TS.
template <typename T, int TS>
__global__ void layer_factory_dense_kernel(spx::FactoryArgs<T> A, spx::DenseSlab S,
                                           int stride) {
  factory_teams<T, TS, false>(A, stride, [&](const spx::Team<TS>& tm, long long j,
                                             T* slab, unsigned live) {
    spx::layer_factory_dense_team<TS, SPX_DENSE_CAP>(A, S, tm, j, slab, live);
  });
}

// K1 at team size TS: with `configure`, its configuration for A.nd, A.ndir
// and A.n (spx::team_config: the slab of slab_layout, the global-slab
// kernel at TS = 32 only) written to info; else the launch that info
// describes.
template <typename T, int TS>
static int run_k1(const spx::FactoryArgs<T>& A, cudaStream_t stream,
                  long long* info, int configure) {
  auto* ks = &layer_factory_kernel<T, TS, false>;
  decltype(ks) kg = TS == 32 ? &layer_factory_kernel<T, TS, TS == 32> : nullptr;
  const spx::Slab S = spx::slab_layout(A.nd, A.ndir);
  if (info == nullptr) return (int)cudaErrorInvalidValue;
  if (configure) return (int)spx::team_config<T, TS>(ks, kg, S.size, 0, A.n, info);
  if (info[8] && A.ws == nullptr) return (int)cudaErrorInvalidValue;
  return spx::team_launch(ks, kg, info, stream, A, S, (int)(info[3] / sizeof(T)));
}

#define SPX_K1_ENTRY(name, T, TS)                                             \
  extern "C" int name(const void* A, void* stream, long long* info,          \
                      int configure) {                                        \
    return run_k1<T, TS>(*(const spx::FactoryArgs<T>*)A,                      \
                         (cudaStream_t)stream, info, configure);              \
  }
#if defined(SPX_PART_TS16)
SPX_K1_ENTRY(spx_k1_ts16_f32, float, 16)
SPX_K1_ENTRY(spx_k1_ts16_f64, double, 16)
#elif defined(SPX_PART_TS32_F32)
SPX_K1_ENTRY(spx_k1_ts32_f32, float, 32)
#elif defined(SPX_PART_TS32_F64)
SPX_K1_ENTRY(spx_k1_ts32_f64, double, 32)
#elif defined(SPX_PART_DENSE)
// K1d at team size TS, as run_k1 (no global-slab kernel: where no block
// fits, team_config returns cudaErrorInvalidConfiguration).
template <typename T, int TS>
static int run_k1d(const spx::FactoryArgs<T>& A, cudaStream_t stream,
                   long long* info, int configure) {
  auto* k = &layer_factory_dense_kernel<T, TS>;
  const spx::DenseSlab S = spx::dense_slab_layout(A.nd, A.ndir);
  if (info == nullptr) return (int)cudaErrorInvalidValue;
  if (configure)
    return (int)spx::team_config<T, TS>(k, (decltype(k)) nullptr, S.size, 0, A.n, info);
  return spx::team_launch(k, (decltype(k)) nullptr, info, stream, A, S,
                          (int)(info[3] / sizeof(T)));
}

// K1d by team size: the power of two >= nd, at most 4.
template <typename T>
static int run_dense(const void* a, void* stream, long long* info, int configure) {
  const auto& A = *(const spx::FactoryArgs<T>*)a;
  const cudaStream_t s = (cudaStream_t)stream;
  if (A.nd <= 1) return run_k1d<T, 1>(A, s, info, configure);
  if (A.nd <= 2) return run_k1d<T, 2>(A, s, info, configure);
  return run_k1d<T, 4>(A, s, info, configure);
}

extern "C" int spx_k1d_f32(const void* A, void* stream, long long* info, int configure) {
  return run_dense<float>(A, stream, info, configure);
}
extern "C" int spx_k1d_f64(const void* A, void* stream, long long* info, int configure) {
  return run_dense<double>(A, stream, info, configure);
}
#endif

#ifndef SPX_PART_SIDE
extern "C" int spx_k1_ts16_f32(const void*, void*, long long*, int);
extern "C" int spx_k1_ts16_f64(const void*, void*, long long*, int);
extern "C" int spx_k1_ts32_f32(const void*, void*, long long*, int);
extern "C" int spx_k1_ts32_f64(const void*, void*, long long*, int);
extern "C" int spx_k1d_f32(const void*, void*, long long*, int);
extern "C" int spx_k1d_f64(const void*, void*, long long*, int);

// K1 by team size (the power of two >= nd, at most 32), or K1d: its
// configuration (configure) or its launch as info says.
template <typename T, bool dense>
static int run_factory(const spx::FactoryArgs<T>& A, void* stream, long long* info,
                       int configure) {
  const cudaStream_t s = (cudaStream_t)stream;
  const bool f32 = sizeof(T) == 4;
  if (dense) return (f32 ? spx_k1d_f32 : spx_k1d_f64)(&A, stream, info, configure);
  if (A.nd <= 2) return run_k1<T, 2>(A, s, info, configure);
  if (A.nd <= 4) return run_k1<T, 4>(A, s, info, configure);
  if (A.nd <= 8) return run_k1<T, 8>(A, s, info, configure);
  if (A.nd <= 16)
    return (f32 ? spx_k1_ts16_f32 : spx_k1_ts16_f64)(&A, stream, info, configure);
  return (f32 ? spx_k1_ts32_f32 : spx_k1_ts32_f64)(&A, stream, info, configure);
}

// K1 or K1d as cfg (its configuration with the grid of this launch) says.
template <typename T, bool dense>
static int launch_factory(SPX_FACTORY_PARAMS, const long long* cfg, void* stream) {
  const auto A = spx::factory_args<T>(SPX_FACTORY_ARGS);
  return run_factory<T, dense>(A, stream, const_cast<long long*>(cfg), 0);
}

template <typename T, bool dense>
static int factory_config(int nd, int ndir, long long n, long long* info) {
  spx::FactoryArgs<T> A{};
  A.nd = nd, A.ndir = ndir, A.n = n;
  return run_factory<T, dense>(A, nullptr, info, 1);
}

template <typename T>
static int launch_order(SPX_ORDER_PARAMS, void* stream) {
  const auto A = spx::order_args<T>(g0, g1, g2, g3, dz, nd, ndir, n_double, theta, B, n);
  constexpr int threads = 256;
  if (n > 0)
    factory_order_kernel<T><<<(unsigned)((n + threads - 1) / threads), threads, 0,
                              (cudaStream_t)stream>>>(A, window, (int*)keys);
  return (int)cudaGetLastError();
}

#define SPX_CFG const long long *cfg
extern "C" int factory_order_f32(SPX_ORDER_PARAMS, void* stream) {
  return launch_order<float>(SPX_ORDER_ARGS, stream);
}
extern "C" int factory_order_f64(SPX_ORDER_PARAMS, void* stream) {
  return launch_order<double>(SPX_ORDER_ARGS, stream);
}
extern "C" int layer_factory_f32(SPX_FACTORY_PARAMS, SPX_CFG, void* stream) {
  return launch_factory<float, false>(SPX_FACTORY_ARGS, cfg, stream);
}
extern "C" int layer_factory_f64(SPX_FACTORY_PARAMS, SPX_CFG, void* stream) {
  return launch_factory<double, false>(SPX_FACTORY_ARGS, cfg, stream);
}
extern "C" int layer_factory_dense_f32(SPX_FACTORY_PARAMS, SPX_CFG, void* stream) {
  return launch_factory<float, true>(SPX_FACTORY_ARGS, cfg, stream);
}
extern "C" int layer_factory_dense_f64(SPX_FACTORY_PARAMS, SPX_CFG, void* stream) {
  return launch_factory<double, true>(SPX_FACTORY_ARGS, cfg, stream);
}
extern "C" int layer_factory_config_f32(int nd, int ndir, long long n, long long* info) {
  return factory_config<float, false>(nd, ndir, n, info);
}
extern "C" int layer_factory_config_f64(int nd, int ndir, long long n, long long* info) {
  return factory_config<double, false>(nd, ndir, n, info);
}
extern "C" int layer_factory_dense_config_f32(int nd, int ndir, long long n,
                                              long long* info) {
  return factory_config<float, true>(nd, ndir, n, info);
}
extern "C" int layer_factory_dense_config_f64(int nd, int ndir, long long n,
                                              long long* info) {
  return factory_config<double, true>(nd, ndir, n, info);
}
#endif  // SPX_PART_SIDE
#endif
