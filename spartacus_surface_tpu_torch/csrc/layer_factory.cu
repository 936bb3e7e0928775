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
// One thread per (batch element, layer).  K1, per element:
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
// A^2, A^4, A^6, U = A (b7 A^6 + b5 A^4 + b3 A^2 + b1 I) and a size-N solve;
// steps 4-5 are the same device functions.  All solves are pivot-free.
//
// Bound on the H100: the per-thread workspace (K1: 15 nd^2 + 15 nd ndir +
// 10 ndir^2 + N^2 rows, N = 2 nd + ndir; K1d: 4 N^2 + max(N^2, 3 nd ndir) +
// 4 nd^2 + 4 nd ndir + 2 ndir^2, under 500 rows for N <= 9) does not fit in
// registers, so it is a struct-of-arrays global buffer (coalesced across
// the warp, cached in L1 and L2) and the kernels are bound by that
// traffic.  The wrapper bounds the buffer by launching in chunks of
// elements.  The norm rule covers the whole [Gamma | b] row, so the
// longwave (b = O(10^2) W m^-2 per unit height) takes several more
// doubling steps per element than the shortwave.

#include "common.cuh"

namespace spx {

template <typename T>
struct FactoryArgs {
  const T *g0, *g1, *g2, *g3, *dz;  // [L, rows, B] and dz [L, B]
  T *R, *Tm, *E, *Sup, *Sdn, *idiff, *idir, *idd;  // [L, rows, B]
  T* ws;  // workspace: [rows, n]
  int nd, ndir, n_double, int_direct;  // int_direct 0: idir, idd unused
  T theta;
  long long B, j0, n;  // batch; this launch covers elements j0 .. j0+n-1
};

// Diagonal Pade [7/7] coefficients.
template <typename T>
SPX_DEV T pade(int k) {
  const double b[8] = {17297280.0, 8648640.0, 1995840.0, 277200.0,
                       25200.0,    1512.0,    56.0,      1.0};
  return T(b[k]);
}

// Thin-layer extraction from F = expm(Gamma s) (row-major N x N) plus nK
// adding-doubling steps; writes R, T, E, Sup, Sdn.  Workspace: W1 >= nd^2,
// W2 >= nd (nd + ndir), W3 >= 3 nd ndir rows; F's first nd^2 rows are a
// temporary during doubling.  RT = [R | T | Vt | tmp], SS = [Sup | Sdn |
// S_mid | SupE], EE = [E | E2].
template <typename T>
SPX_DEV void extract_double(int nd, int ndir, int nK, Col<T> F, Col<T> W1,
                            Col<T> W2, Col<T> W3, Col<T> RT, Col<T> SS,
                            Col<T> EE, Col<T> r_out, Col<T> t_out,
                            Col<T> e_out, Col<T> sup_out, Col<T> sdn_out) {
  const int N = 2 * nd + ndir, mx = nd + ndir;
  const int n2 = nd * nd, nr = nd * ndir, d2 = ndir * ndir;
  // X = F11^-1 [F12 | F13]
  for (int i = 0; i < nd; ++i) {
    for (int j = 0; j < nd; ++j) W1[i * nd + j] = F[i * N + j];
    for (int j = 0; j < mx; ++j) W2[i * mx + j] = F[i * N + nd + j];
  }
  solve_inplace(W1, nd, W2, mx, nd, mx);
  // R = -X1, Sup = -X2; T = F22 - F21 X1, Sdn = F23 - F21 X2; E = F33
  for (int i = 0; i < nd; ++i) {
    for (int j = 0; j < nd; ++j) RT[i * nd + j] = -W2[i * mx + j];
    for (int e = 0; e < ndir; ++e) SS[i * ndir + e] = -W2[i * mx + nd + e];
    for (int j = 0; j < mx; ++j) {
      T acc = F[(nd + i) * N + nd + j];
      for (int k = 0; k < nd; ++k) acc -= F[(nd + i) * N + k] * W2[k * mx + j];
      if (j < nd)
        RT[n2 + i * nd + j] = acc;
      else
        SS[nr + i * ndir + (j - nd)] = acc;
    }
  }
  for (int i = 0; i < ndir; ++i)
    for (int e = 0; e < ndir; ++e) EE[i * ndir + e] = F[(2 * nd + i) * N + 2 * nd + e];

  Col<T> R = RT, Tt = RT.at(n2), TMP = RT.at(3 * n2);
  Col<T> Sup = SS, Sdn = SS.at(nr), SMID = SS.at(2 * nr), SUPE = SS.at(3 * nr);
  Col<T> E = EE, E2 = EE.at(d2);
  for (int step = 0; step < nK; ++step) {
    // SupE = Sup E; S_mid = Sdn + R SupE
    mmc(SUPE, Sup, E, nd, ndir, ndir);
    copy(SMID, Sdn, nr);
    mmc(SMID, R, SUPE, nd, nd, ndir, true);
    // (I - R R) [Vt | Vs] = [T | S_mid]
    mmc(W1, R, R, nd, nd, nd);
    for (int i = 0; i < nd; ++i) {
      for (int j = 0; j < nd; ++j) {
        W1[i * nd + j] = T(i == j) - W1[i * nd + j];
        W2[i * mx + j] = Tt[i * nd + j];
      }
      for (int e = 0; e < ndir; ++e) W2[i * mx + nd + e] = SMID[i * ndir + e];
    }
    solve_inplace(W1, nd, W2, mx, nd, mx);
    // TMP = R Vt; W3[0:nr] = R Vs + SupE
    mm(TMP, nd, R, nd, W2, mx, nd, nd, nd);
    copy(W3, SUPE, nr);
    mm(W3, ndir, R, nd, W2.at(nd), mx, nd, nd, ndir, true);
    // R' = R + T TMP -> W1; T' = T Vt -> F[0:n2];
    // Sup' = Sup + T W3[0:nr] -> W3[nr:]; Sdn' = T Vs + Sdn E -> W3[2nr:]
    copy(W1, R, n2);
    mmc(W1, Tt, TMP, nd, nd, nd, true);
    mm(F, nd, Tt, nd, W2, mx, nd, nd, nd);
    copy(W3.at(nr), Sup, nr);
    mmc(W3.at(nr), Tt, W3, nd, nd, ndir, true);
    mm(W3.at(2 * nr), ndir, Tt, nd, W2.at(nd), mx, nd, nd, ndir);
    mmc(W3.at(2 * nr), Sdn, E, nd, ndir, ndir, true);
    mmc(E2, E, E, ndir, ndir, ndir);
    copy(R, W1, n2);
    copy(Tt, F, n2);
    copy(Sup, W3.at(nr), nr);
    copy(Sdn, W3.at(2 * nr), nr);
    copy(E, E2, d2);
  }
  copy(r_out, R, n2);
  copy(t_out, Tt, n2);
  copy(e_out, E, d2);
  copy(sup_out, Sup, nr);
  copy(sdn_out, Sdn, nr);
}

// Block-Schur Gamma^-1 integral matrices (radtool_schur.F90:45-51), with
// five nd^2 workspaces G, Fs, W1, W2, W3; the direct-beam ones (which need
// inv(g0)) only with int_direct.
template <typename T>
SPX_DEV void schur_ints(int nd, int ndir, bool int_direct, Col<T> g0,
                        Col<T> g1, Col<T> g2, Col<T> g3, Col<T> G, Col<T> Fs,
                        Col<T> W1, Col<T> W2, Col<T> W3, Col<T> idiff,
                        Col<T> idir, Col<T> idd) {
  const int n2 = nd * nd, d2 = ndir * ndir;
  copy(W1, g1, n2);  // W2 = inv(g1)
  eye(W2, nd);
  solve_inplace(W1, nd, W2, nd, nd, nd);
  mmc(G, W2, g2, nd, nd, nd);   // inv(g1) g2
  mmc(Fs, g2, W2, nd, nd, nd);  // g2 inv(g1)
  mmc(W1, g2, G, nd, nd, nd);   // Schur complement g1 - g2 inv(g1) g2
  for (int i = 0; i < n2; ++i) W1[i] = g1[i] - W1[i];
  eye(W3, nd);                  // W3 = g1i
  solve_inplace(W1, nd, W3, nd, nd, nd);
  mmc(G, W3, Fs, nd, nd, nd);   // g2i = g1i g2 inv(g1)
  for (int i = 0; i < n2; ++i) idiff[i] = G[i] - W3[i];
  if (!int_direct) return;
  copy(W1, g0, d2);             // W2 = g0i
  eye(W2, ndir);
  solve_inplace(W1, ndir, W2, ndir, ndir, ndir);
  for (int i = 0; i < d2; ++i) idir[i] = -W2[i];
  mmc(Fs, g3, W2, nd, ndir, ndir);  // g3 g0i
  for (int i = 0; i < nd; ++i)
    for (int e = 0; e < ndir; ++e) {
      T acc = T(0);
      for (int k = 0; k < nd; ++k)
        acc += (W3[i * nd + k] - G[i * nd + k]) * Fs[k * ndir + e];
      idd[i * ndir + e] = T(2) * acc;
    }
}

template <typename T>
SPX_DEV void layer_factory_thread(const FactoryArgs<T>& A, long long t) {
  const int nd = A.nd, ndir = A.ndir, N = 2 * nd + ndir;
  const int n2 = nd * nd, nr = nd * ndir, d2 = ndir * ndir;
  const long long j = A.j0 + t, l = j / A.B, b = j % A.B;
  auto op = [&](const T* p, int rows) {
    return Col<T>{const_cast<T*>(p) + l * rows * A.B + b, A.B};
  };
  const Col<T> g0 = op(A.g0, d2), g1 = op(A.g1, n2), g2 = op(A.g2, n2),
               g3 = op(A.g3, nr);
  const T s = A.dz[l * A.B + b];

  // Workspace slots (rows): AS = [Bm | Cm | b]; DSM = [D | D2 | D4 | D6 |
  // vd | ud | m | x33]; XY = [x2 y2 x3 y3 x4 y4 x5 y5 x6 y6]; BIG = nine
  // nd^2 slots shared across stages; F = N^2; RT, SS, EE for extraction.
  const Col<T> AS{A.ws + t, A.n};
  const Col<T> DSM = AS.at(2 * n2 + nr), XY = DSM.at(8 * d2),
               BIG = XY.at(10 * nr), F = BIG.at(9 * n2), RT = F.at(N * N),
               SS = RT.at(4 * n2), EE = SS.at(4 * nr);
  const Col<T> Bm = AS, Cm = AS.at(n2), bv = AS.at(2 * n2);
  const Col<T> D = DSM, D2 = DSM.at(d2), D4 = DSM.at(2 * d2),
               D6 = DSM.at(3 * d2), VD = DSM.at(4 * d2), UD = DSM.at(5 * d2),
               M = DSM.at(6 * d2), X33 = DSM.at(7 * d2);
  const Col<T> x2 = XY, y2 = XY.at(nr), x3 = XY.at(2 * nr), y3 = XY.at(3 * nr),
               x4 = XY.at(4 * nr), y4 = XY.at(5 * nr), x5 = XY.at(6 * nr),
               y5 = XY.at(7 * nr), x6 = XY.at(8 * nr), y6 = XY.at(9 * nr);
  // late-stage quantities reuse finished recurrence slots
  const Col<T> xv = x3, yv = y3, xu = x5, yu = y5, u13 = x2, u23 = y2;
  const Col<T> W = BIG, Wp = BIG.at(n2), W2 = BIG.at(2 * n2),
               Wp2 = BIG.at(3 * n2), TMP = BIG.at(4 * n2), VW = BIG.at(5 * n2),
               VWp = BIG.at(6 * n2), P12 = BIG.at(7 * n2), P21 = BIG.at(8 * n2);

  // ---- assembly in the transformed basis, scaled by dz
  for (int i = 0; i < nd; ++i) {
    for (int k = 0; k < nd; ++k) {
      const T g1r = g1[i * nd + k] * s, g2r = g2[i * nd + k] * s;
      Bm[i * nd + k] = g2r - g1r;
      Cm[i * nd + k] = -(g1r + g2r);
    }
    for (int e = 0; e < ndir; ++e) bv[i * ndir + e] = T(-2) * g3[i * ndir + e] * s;
  }
  for (int i = 0; i < d2; ++i) D[i] = g0[i] * s;

  // ---- per-element scaling from the row-sum norm of the dense Gamma dz
  T nrm = T(0);
  for (int i = 0; i < nd; ++i) {
    T r1 = T(0), r2 = T(0), r3 = T(0);
    for (int k = 0; k < nd; ++k) {
      r1 += fabs(g1[i * nd + k]);
      r2 += fabs(g2[i * nd + k]);
    }
    for (int e = 0; e < ndir; ++e) r3 += fabs(g3[i * ndir + e]);
    nrm = fmax(nrm, (r1 + r2 + r3) * s);
  }
  for (int i = 0; i < ndir; ++i) {
    T r0 = T(0);
    for (int e = 0; e < ndir; ++e) r0 += fabs(g0[i * ndir + e]);
    nrm = fmax(nrm, r0 * s);
  }
  const T kf = fmin(fmax(ceil(log2(fmax(nrm, T(1e-30)) / A.theta)), T(0)),
                    T(A.n_double));
  const int nK = int(kf);
  const T fac = ldexp(T(1), -nK);
  for (int i = 0; i < 2 * n2 + nr; ++i) AS[i] *= fac;
  for (int i = 0; i < d2; ++i) D[i] *= fac;

  // ---- half-size powers and the even/odd Pade polynomials
  mmc(W, Bm, Cm, nd, nd, nd);
  mmc(Wp, Cm, Bm, nd, nd, nd);
  mmc(W2, W, W, nd, nd, nd);
  mmc(Wp2, Wp, Wp, nd, nd, nd);
  mmc(TMP, W, W2, nd, nd, nd);  // W^3
  for (int i = 0; i < n2; ++i) {
    VW[i] = pade<T>(2) * W[i] + pade<T>(4) * W2[i] + pade<T>(6) * TMP[i];
    P12[i] = pade<T>(3) * W[i] + pade<T>(5) * W2[i] + pade<T>(7) * TMP[i];
  }
  for (int i = 0; i < nd; ++i) {
    VW[i * nd + i] += pade<T>(0);
    P12[i * nd + i] += pade<T>(1);
  }
  mmc(P21, Cm, P12, nd, nd, nd);  // P21 = Cm u(W)
  mmc(TMP, Wp, Wp2, nd, nd, nd);  // W'^3
  for (int i = 0; i < n2; ++i) {
    VWp[i] = pade<T>(2) * Wp[i] + pade<T>(4) * Wp2[i] + pade<T>(6) * TMP[i];
    TMP[i] = pade<T>(3) * Wp[i] + pade<T>(5) * Wp2[i] + pade<T>(7) * TMP[i];
  }
  for (int i = 0; i < nd; ++i) {
    VWp[i * nd + i] += pade<T>(0);
    TMP[i * nd + i] += pade<T>(1);
  }
  mmc(P12, Bm, TMP, nd, nd, nd);  // P12 = Bm u(W')

  // ---- direct block: X33 = F33 - I = (vd - D ud)^-1 2 D ud
  mmc(D2, D, D, ndir, ndir, ndir);
  mmc(D4, D2, D2, ndir, ndir, ndir);
  mmc(D6, D2, D4, ndir, ndir, ndir);
  for (int i = 0; i < d2; ++i) {
    VD[i] = pade<T>(2) * D2[i] + pade<T>(4) * D4[i] + pade<T>(6) * D6[i];
    UD[i] = pade<T>(3) * D2[i] + pade<T>(5) * D4[i] + pade<T>(7) * D6[i];
  }
  for (int i = 0; i < ndir; ++i) {
    VD[i * ndir + i] += pade<T>(0);
    UD[i * ndir + i] += pade<T>(1);
  }
  mmc(D2, D, UD, ndir, ndir, ndir);  // U33 = D ud
  for (int i = 0; i < d2; ++i) {
    M[i] = VD[i] - D2[i];
    X33[i] = T(2) * D2[i];
  }
  solve_inplace(M, ndir, X33, ndir, ndir, ndir);

  // ---- direct-coupling column recurrences
  mmc(x2, Bm, bv, nd, nd, ndir);          // x2 = Bm b
  mmc(y2, bv, D, nd, ndir, ndir);         // y2 = b D
  mmc(x3, x2, D, nd, ndir, ndir);         // x3 = x2 D
  mmc(y3, Wp, bv, nd, nd, ndir);          // y3 = W' b + y2 D
  mmc(y3, y2, D, nd, ndir, ndir, true);
  mmc(x4, W, x2, nd, nd, ndir);           // x4 = W x2 + x3 D
  mmc(x4, x3, D, nd, ndir, ndir, true);
  mmc(y4, y3, D, nd, ndir, ndir);         // y4 = y3 D
  mmc(x5, x4, D, nd, ndir, ndir);         // x5 = x4 D
  mmc(y5, Wp2, bv, nd, nd, ndir);         // y5 = W'^2 b + y4 D
  mmc(y5, y4, D, nd, ndir, ndir, true);
  mmc(x6, W2, x2, nd, nd, ndir);          // x6 = W^2 x2 + x5 D
  mmc(x6, x5, D, nd, ndir, ndir, true);
  mmc(y6, y5, D, nd, ndir, ndir);         // y6 = y5 D
  for (int i = 0; i < nr; ++i) {
    const T vx = pade<T>(2) * x2[i] + pade<T>(4) * x4[i] + pade<T>(6) * x6[i];
    const T vy = pade<T>(2) * y2[i] + pade<T>(4) * y4[i] + pade<T>(6) * y6[i];
    const T ux = pade<T>(3) * x2[i] + pade<T>(5) * x4[i] + pade<T>(7) * x6[i];
    const T uy = pade<T>(3) * y2[i] + pade<T>(5) * y4[i] + pade<T>(7) * y6[i];
    xv[i] = vx;
    yv[i] = vy;
    xu[i] = ux;
    yu[i] = uy;
  }
  mmc(u13, Bm, yu, nd, nd, ndir);         // U13 = Bm yu
  mmc(u23, Cm, xu, nd, nd, ndir);         // U23 = Cm xu + b ud
  mmc(u23, bv, UD, nd, ndir, ndir, true);

  // ---- (V - U) in BIG slots 0-3 (the powers are dead); RHS 2 U with the
  // direct column pre-corrected by X33, in F's first 2 nd rows
  const Col<T> VMU = BIG;
  const int m2 = 2 * nd;
  for (int i = 0; i < nd; ++i) {
    for (int k = 0; k < nd; ++k) {
      VMU[i * m2 + k] = VW[i * nd + k];
      VMU[i * m2 + nd + k] = -P12[i * nd + k];
      VMU[(nd + i) * m2 + k] = -P21[i * nd + k];
      VMU[(nd + i) * m2 + nd + k] = VWp[i * nd + k];
      F[i * N + k] = T(0);
      F[i * N + nd + k] = T(2) * P12[i * nd + k];
      F[(nd + i) * N + k] = T(2) * P21[i * nd + k];
      F[(nd + i) * N + nd + k] = T(0);
    }
    for (int e = 0; e < ndir; ++e) {
      T top = T(2) * u13[i * ndir + e];
      T mid = T(2) * u23[i * ndir + e];
      for (int f = 0; f < ndir; ++f) {
        top -= (xv[i * ndir + f] - u13[i * ndir + f]) * X33[f * ndir + e];
        mid -= (yv[i * ndir + f] - u23[i * ndir + f]) * X33[f * ndir + e];
      }
      F[i * N + 2 * nd + e] = top;
      F[(nd + i) * N + 2 * nd + e] = mid;
    }
  }
  solve_inplace(VMU, m2, F, N, m2, N);

  // ---- undo the similarity (butterfly) and add I, then the direct rows
  for (int i = 0; i < nd; ++i) {
    for (int k = 0; k < nd; ++k) {
      const T f11 = F[i * N + k], f12 = F[i * N + nd + k];
      const T f21 = F[(nd + i) * N + k], f22 = F[(nd + i) * N + nd + k];
      const T sa = f11 + f21, sb = f12 + f22, da = f11 - f21, db = f12 - f22;
      F[i * N + k] = T(0.5) * (sa + sb);
      F[i * N + nd + k] = T(0.5) * (sa - sb);
      F[(nd + i) * N + k] = T(0.5) * (da + db);
      F[(nd + i) * N + nd + k] = T(0.5) * (da - db);
    }
    for (int e = 0; e < ndir; ++e) {
      const T fx = F[i * N + 2 * nd + e], fy = F[(nd + i) * N + 2 * nd + e];
      F[i * N + 2 * nd + e] = T(0.5) * (fx + fy);
      F[(nd + i) * N + 2 * nd + e] = T(0.5) * (fx - fy);
    }
    F[i * N + i] += T(1);
    F[(nd + i) * N + nd + i] += T(1);
  }
  for (int i = 0; i < ndir; ++i) {
    for (int k = 0; k < 2 * nd; ++k) F[(2 * nd + i) * N + k] = T(0);
    for (int e = 0; e < ndir; ++e)
      F[(2 * nd + i) * N + 2 * nd + e] = X33[i * ndir + e] + T(i == e);
  }

  // ---- extraction + doubling (workspaces from the now-dead BIG slots),
  // then the Schur integrals (BIG slots 0-4)
  extract_double(nd, ndir, nK, F, BIG.at(4 * n2), BIG.at(5 * n2),
                 BIG.at(7 * n2), RT, SS, EE, op(A.R, n2), op(A.Tm, n2),
                 op(A.E, d2), op(A.Sup, nr), op(A.Sdn, nr));
  const Col<T> none{nullptr, A.B};
  schur_ints(nd, ndir, A.int_direct != 0, g0, g1, g2, g3, BIG, BIG.at(n2),
             BIG.at(2 * n2), BIG.at(3 * n2), BIG.at(4 * n2), op(A.idiff, n2),
             A.int_direct ? op(A.idir, d2) : none,
             A.int_direct ? op(A.idd, nr) : none);
}

// K1d: dense Pade-7 expm of the whole N x N Gamma dz (pallas_layer.py:268).
// Workspace slots (rows): G, F, W1, W2 = N^2 each; W3 = max(N^2, 3 nd ndir);
// RT = 4 nd^2, SS = 4 nd ndir, EE = 2 ndir^2 for extraction.  The Schur
// integrals reuse G, F, W1, W2, W3 as nd^2 slots.
template <typename T>
SPX_DEV void layer_factory_dense_thread(const FactoryArgs<T>& A, long long t) {
  const int nd = A.nd, ndir = A.ndir, N = 2 * nd + ndir, NN = N * N;
  const int n2 = nd * nd, nr = nd * ndir, d2 = ndir * ndir;
  const long long j = A.j0 + t, l = j / A.B, b = j % A.B;
  auto op = [&](const T* p, int rows) {
    return Col<T>{const_cast<T*>(p) + l * rows * A.B + b, A.B};
  };
  const Col<T> g0 = op(A.g0, d2), g1 = op(A.g1, n2), g2 = op(A.g2, n2),
               g3 = op(A.g3, nr);
  const T s = A.dz[l * A.B + b];
  const Col<T> G{A.ws + t, A.n};
  const Col<T> F = G.at(NN), W1 = F.at(NN), W2 = W1.at(NN), W3 = W2.at(NN),
               RT = W3.at(NN > 3 * nr ? NN : 3 * nr), SS = RT.at(4 * n2),
               EE = SS.at(4 * nr);

  // ---- assemble Gamma dz = [[-g1, -g2, -g3], [g2, g1, g3], [0, 0, g0]] dz
  for (int i = 0; i < nd; ++i) {
    for (int k = 0; k < nd; ++k) {
      const T g1r = g1[i * nd + k] * s, g2r = g2[i * nd + k] * s;
      G[i * N + k] = -g1r;
      G[i * N + nd + k] = -g2r;
      G[(nd + i) * N + k] = g2r;
      G[(nd + i) * N + nd + k] = g1r;
    }
    for (int e = 0; e < ndir; ++e) {
      const T g3r = g3[i * ndir + e] * s;
      G[i * N + 2 * nd + e] = -g3r;
      G[(nd + i) * N + 2 * nd + e] = g3r;
    }
  }
  for (int i = 0; i < ndir; ++i) {
    for (int k = 0; k < 2 * nd; ++k) G[(2 * nd + i) * N + k] = T(0);
    for (int e = 0; e < ndir; ++e)
      G[(2 * nd + i) * N + 2 * nd + e] = g0[i * ndir + e] * s;
  }

  // ---- per-element scaling from the row-sum norm of Gamma dz
  T nrm = T(0);
  for (int i = 0; i < N; ++i) {
    T r = T(0);
    for (int k = 0; k < N; ++k) r += fabs(G[i * N + k]);
    nrm = fmax(nrm, r);
  }
  const T kf = fmin(fmax(ceil(log2(fmax(nrm, T(1e-30)) / A.theta)), T(0)),
                    T(A.n_double));
  const int nK = int(kf);
  const T fac = ldexp(T(1), -nK);
  for (int i = 0; i < NN; ++i) G[i] *= fac;

  // ---- Pade-7: V = b6 A6 + b4 A4 + b2 A2 + b0 I in F,
  // U = A (b7 A6 + b5 A4 + b3 A2 + b1 I) in W2; solve (V - U) F = (V + U)
  mmc(W1, G, G, N, N, N);    // A2
  mmc(W2, W1, W1, N, N, N);  // A4
  mmc(W3, W1, W2, N, N, N);  // A6
  for (int i = 0; i < NN; ++i) {
    F[i] = pade<T>(6) * W3[i] + pade<T>(4) * W2[i] + pade<T>(2) * W1[i];
    W3[i] = pade<T>(7) * W3[i] + pade<T>(5) * W2[i] + pade<T>(3) * W1[i];
  }
  for (int i = 0; i < N; ++i) {
    F[i * N + i] += pade<T>(0);
    W3[i * N + i] += pade<T>(1);
  }
  mmc(W2, G, W3, N, N, N);  // U
  for (int i = 0; i < NN; ++i) {
    W1[i] = F[i] - W2[i];
    F[i] += W2[i];
  }
  solve_inplace(W1, N, F, N, N, N);  // F = expm(Gamma dz 2^-K)

  // ---- extraction + doubling, then the Schur integrals (G..W3 are dead)
  extract_double(nd, ndir, nK, F, W1, W2, W3, RT, SS, EE, op(A.R, n2),
                 op(A.Tm, n2), op(A.E, d2), op(A.Sup, nr), op(A.Sdn, nr));
  const Col<T> none{nullptr, A.B};
  schur_ints(nd, ndir, A.int_direct != 0, g0, g1, g2, g3, G, F, W1, W2, W3,
             op(A.idiff, n2), A.int_direct ? op(A.idir, d2) : none,
             A.int_direct ? op(A.idd, nr) : none);
}

template <typename T>
FactoryArgs<T> factory_args(void* g0, void* g1, void* g2, void* g3, void* dz,
                            void* R, void* Tm, void* E, void* Sup, void* Sdn,
                            void* idiff, void* idir, void* idd, void* ws,
                            int nd, int ndir, int n_double, int int_direct,
                            double theta, long long B, long long j0,
                            long long n) {
  return FactoryArgs<T>{(const T*)g0, (const T*)g1, (const T*)g2,
                        (const T*)g3, (const T*)dz, (T*)R, (T*)Tm, (T*)E,
                        (T*)Sup, (T*)Sdn, (T*)idiff, (T*)idir, (T*)idd,
                        (T*)ws, nd, ndir, n_double, int_direct, T(theta), B,
                        j0, n};
}

}  // namespace spx

#define SPX_FACTORY_PARAMS                                                    \
  void *g0, void *g1, void *g2, void *g3, void *dz, void *R, void *Tm,       \
      void *E, void *Sup, void *Sdn, void *idiff, void *idir, void *idd,     \
      void *ws, int nd, int ndir, int n_double, int int_direct,              \
      double theta, long long B, long long j0, long long n
#define SPX_FACTORY_ARGS                                                      \
  g0, g1, g2, g3, dz, R, Tm, E, Sup, Sdn, idiff, idir, idd, ws, nd, ndir,    \
      n_double, int_direct, theta, B, j0, n

#ifdef __CUDACC__
template <typename T>
__global__ void layer_factory_kernel(spx::FactoryArgs<T> A) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t < A.n) spx::layer_factory_thread(A, t);
}

template <typename T>
__global__ void layer_factory_dense_kernel(spx::FactoryArgs<T> A) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t < A.n) spx::layer_factory_dense_thread(A, t);
}

template <typename T, bool dense>
static int launch_factory(SPX_FACTORY_PARAMS, void* stream) {
  const auto A = spx::factory_args<T>(SPX_FACTORY_ARGS);
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  if (dense)
    layer_factory_dense_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(A);
  else
    layer_factory_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

extern "C" int layer_factory_f32(SPX_FACTORY_PARAMS, void* stream) {
  return launch_factory<float, false>(SPX_FACTORY_ARGS, stream);
}
extern "C" int layer_factory_f64(SPX_FACTORY_PARAMS, void* stream) {
  return launch_factory<double, false>(SPX_FACTORY_ARGS, stream);
}
extern "C" int layer_factory_dense_f32(SPX_FACTORY_PARAMS, void* stream) {
  return launch_factory<float, true>(SPX_FACTORY_ARGS, stream);
}
extern "C" int layer_factory_dense_f64(SPX_FACTORY_PARAMS, void* stream) {
  return launch_factory<double, true>(SPX_FACTORY_ARGS, stream);
}
#endif
