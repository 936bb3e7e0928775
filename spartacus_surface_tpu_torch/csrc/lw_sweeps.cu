// Kernels K4 and K5: the longwave adding up-sweep with emission sources and
// the fused longwave flux down-sweep (internal emission + unit incoming).
//
// Replace the TPU kernels _lw_up_kernel (spartacus_surface_tpu/ops/
// pallas_sweep.py:430, launched by lw_up_sweep :964) and _lw_down_kernel /
// _lw_down_mode (:533, :552, launched by _lw_down_call :1020 with modes
// (internal, incoming)).  Plain versions: ops/lw_sweep_kernels.py
// lw_up_sweep_plain and lw_down_sweep_plain.
//
// K4 has K2's design on the H100 (sw_sweeps.cu): a team of TS lanes per
// batch element (b = c S + s) through all L layers, its carry and solve
// workspace in a shared-memory slab (up_slab with a one-column source;
// 1,312 B at the headline, 2,496 B at the rami5 shape in float32), the
// next layer's operands copied ahead into shared memory by each warp, the
// stack rows stored from the lanes' registers.  Its step is one solve with
// 2 nd + 1 right-hand sides and the products around it; what bounds it is
// each lane's chain of dependent shared-memory loads and FMAs, not bytes.
// The ground operators depend only on the element, so K4 builds them
// instead of reading them.
//
// K5 has K3's design on the H100 (sw_sweeps.cu): teams of TS lanes, a
// block's E elements walking the layers from the top down, the carry (both
// modes' down fluxes) and each layer step's vectors in a shared-memory slab
// (lw_down_slab), both source modes side by side in each step, the next
// layer's operands (the stack and ~5 nd^2 + 3 nd rows of operators, 1,052
// rows at the rami5 shape) copied ahead block-wide in whole sectors, the
// output rows staged and stored block-wide.

#include "common.cuh"

namespace spx {

// Stack layout per layer: [a_above | source_above | inv(I - a_above R) |
// a_below | source_below] (ops/lw_sweep_kernels.py lw_stack_rows).
struct LwStackLayout {
  int aa, sa, inv, ab, sb, rows;
  SPX_HD LwStackLayout(int nd, int ns, int nreg) {
    const int nd2 = (nreg + 1) * ns;
    aa = 0;
    sa = nd * nd;
    inv = sa + nd;
    ab = inv + nd * nd;
    sb = ab + nd2 * nd2;
    rows = sb + nd2;
  }
};

template <typename T>
struct LwUpArgs {
  const T *R, *Tm, *p, *uov, *vov, *reps, *remit, *exposed, *grd, *hw;
  T *stacks, *top;
  T* ws;  // null, or one slab a resident team where a slab exceeds a block
  int nd, ns, nreg, L, S;
  long long B;
};

// K4's layer operands, in the order of its copy-ahead buffer
enum { K4_R, K4_T, K4_P, K4_U, K4_V, K4_REPS, K4_REMIT, K4_EXPOSED, K4_NOPS };

template <typename T>
SPX_HD LayerOperands<T, K4_NOPS> lw_up_operands(const LwUpArgs<T>& A) {
  const int nd = A.nd, nreg = A.nreg, nregp = nreg + 1;
  return LayerOperands<T, K4_NOPS>{
      {A.R, A.Tm, A.p, A.uov, A.vov, A.reps, A.remit, A.exposed},
      {nd * nd, nd * nd, nd, nreg * nregp, nregp * nreg, 1, 1, 1},
      {false, false, false, true, true, false, false, false}};
}

template <typename T>
SPX_HD UpSlab lw_up_slab(const LwUpArgs<T>& A) {
  return up_slab(A.nd, A.ns, A.nreg, 1, 1);
}

// K4: LW adding from the ground up (radsurf_urban_lw.F90:551-637), one
// element (rd.b; a team of TS lanes, TS = 1 on the host) with its slab.
// Stores nothing where !valid (a team past the batch's end).
template <int TS, int CAP, typename T, class Reader>
SPX_DEV void lw_up_team(const LwUpArgs<T>& A, const UpSlab& S, const Team<TS>& tm,
                        const Reader& rd, bool valid, T* slab) {
  const int nd = A.nd, ns = A.ns, nreg = A.nreg, nregp = nreg + 1;
  const int nd2 = nregp * ns, mtot = 2 * nd + 1;
  const long long B = A.B, b = rd.b;
  const LwStackLayout sl(nd, ns, nreg);
  const Sh<T> sm{slab};
  auto at = [&](int off, int ld) { return mat(sm.at(off), ld); };
  const auto AA = at(S.aa, S.ldn), SRC = at(S.da, 1), W1 = at(S.w1, S.ldn),
             RHS = at(S.rhs, S.ldr), AB = at(S.ab, S.ld2), SB = at(S.db, 1),
             NA = at(S.na, S.ldn), NS = at(S.nda, 1);
  const T geps = A.grd[b], gemit = A.grd[B + b];
  const T* hw = A.hw;

  // ground operators (radsurf_urban_lw.F90:551-565):
  // a_ground[(r,n),(r2,m)] = (1 - emissivity) hw[n] delta(r, r2),
  // source_ground[(r,n)] = emission frac0[r] hw[n]
  for (int i = tm.lane; i < nd; i += TS) {
    for (int j = 0; j < nd; ++j)
      AA(i, j) = (i / ns == j / ns) ? (T(1) - geps) * hw[i % ns] : T(0);
    SRC(i, 0) = gemit * A.grd[(2 + i / ns) * B + b] * hw[i % ns];
  }
  tm.sync();
  rd.start();

  for (int l = 0; l < A.L; ++l) {
    rd.begin(l);
    const auto R = mat(rd.view(K4_R, l), nd), Tl = mat(rd.view(K4_T, l), nd),
               P = mat(rd.view(K4_P, l), 1);
    const auto U = rd.view(K4_U, l), V = rd.view(K4_V, l);
    const T roof_refl = T(1) - rd.view(K4_REPS, l)[0],
            roof_src = rd.view(K4_REMIT, l)[0] * rd.view(K4_EXPOSED, l)[0];
    auto st = [&](int off, int ld) {
      return mat(Col<T>{A.stacks + ((long long)l * sl.rows + off) * B + b, B}, ld);
    };
    const auto sAA = st(sl.aa, nd), sSA = st(sl.sa, 1), sINV = st(sl.inv, nd),
               sAB = st(sl.ab, nd2), sSB = st(sl.sb, 1);
    // the entry carry to the stack; the source column of the RHS
    for (int i = tm.lane; i < nd; i += TS) {
      if (valid) {
        for (int j = 0; j < nd; ++j) sAA(i, j) = AA(i, j);
        sSA(i, 0) = SRC(i, 0);
      }
      RHS(i, nd) = SRC(i, 0);
    }
    // (I - a_above R) X = [a_above T | source_above + a_above p | I]
    tmm<TS, CAP, 4>(tm, W1, AA, R, nd, nd, nd);
    tmm<TS, CAP, 4>(tm, RHS, AA, Tl, nd, nd, nd);
    tmm<TS, CAP, 4>(tm, RHS.sub(0, nd), AA, P, nd, nd, 1, true);
    for (int i = tm.lane; i < nd; i += TS)
      for (int j = 0; j < nd; ++j) {
        W1(i, j) = T(i == j) - W1(i, j);
        RHS(i, nd + 1 + j) = T(i == j);
      }
    tm.sync();
    tsolve(tm, W1, RHS, nd, mtot);

    // stack: inv(denom), a_below / source_below with the exposed-roof rows
    // (Eq. 34, radsurf_urban_lw.F90:567-605), a_below over the dead carry
    // and W1
    for (int i = tm.lane; i < nd2; i += TS) {
      if (i < nd) {
        if (valid)
          for (int j = 0; j < nd; ++j) sINV(i, j) = RHS(i, nd + 1 + j);
        below_row(R, Tl, RHS, AB, i, nd);
        for (int j = nd; j < nd2; ++j) AB(i, j) = T(0);
        T acc = P(i, 0);
        for (int k = 0; k < nd; ++k) acc += Tl(i, k) * RHS(k, nd);
        SB(i, 0) = acc;
      } else {
        const int u = i - nd;
        for (int j = 0; j < nd; ++j) AB(i, j) = T(0);
        for (int v = 0; v < ns; ++v) AB(i, nd + v) = roof_refl * hw[u];
        SB(i, 0) = roof_src * hw[u];
      }
      if (valid) {
        for (int j = 0; j < nd2; ++j) sAB(i, j) = AB(i, j);
        sSB(i, 0) = SB(i, 0);
      }
    }
    tm.sync();

    // overlap to just above the interface (radsurf_urban_lw.F90:620-627):
    // (u (x) I_ns) a_below (v (x) I_ns) and (u (x) I_ns) source_below, the
    // next carry over the dead RHS
    for (int i = tm.lane; i < nd; i += TS) {
      const int t = i / ns, a = i % ns;
      T u[4], uv[16];  // nreg + 1 <= 4
      overlap_weights(U, t, nregp, u);
      for (int f = 0; f < nreg; ++f) {
        overlap_weights(u, V, f, nreg, uv);
        overlap_row(uv, AB, NA, i, a, f, ns, nregp);
      }
      T acc = T(0);
      SPX_UNROLL
      for (int q = 0; q < 4; ++q)
        if (q < nregp) acc += u[q] * SB(q * ns + a, 0);
      NS(i, 0) = acc;
    }
    tm.sync();
    rd.end();
    for (int i = tm.lane; i < nd; i += TS) {
      for (int j = 0; j < nd; ++j) AA(i, j) = NA(i, j);
      SRC(i, 0) = NS(i, 0);
    }
    tm.sync();
  }
  if (valid) {
    const auto top = mat(Col<T>{A.top + b, B}, nd);
    const auto tops = mat(Col<T>{A.top + (long long)nd * nd * B + b, B}, 1);
    for (int i = tm.lane; i < nd; i += TS) {
      for (int j = 0; j < nd; ++j) top(i, j) = AA(i, j);
      tops(i, 0) = SRC(i, 0);
    }
  }
}

template <typename T>
struct LwDownArgs {
  const T *R, *Tm, *p, *idif, *isrc, *stacks, *vov, *aux, *hw, *rmu, *rtan;
  T *outs, *fin;
  int nd, ns, nreg, L, S, do_urban, with_profiles;
  long long B;
};

// Output rows of one mode, in the order of lw_out_rows.
SPX_HD int lw_out_count(int nreg, int do_urban, int with_profiles) {
  return 3 + (nreg > 1 ? 2 : 0) + (do_urban ? 2 : 0) + (with_profiles ? 4 : 0);
}

// K5's layer operands, in the order of its copy-ahead slot (and of their
// first reads in a layer step)
enum { K5_V, K5_AB, K5_SB, K5_T, K5_SA, K5_R, K5_P, K5_INV, K5_AA, K5_IDIF, K5_ISRC, K5_X, K5_NOPS };

template <typename T>
SPX_HD LayerOperands<T, K5_NOPS> lw_down_operands(const LwDownArgs<T>& A) {
  const int nd = A.nd, nreg = A.nreg, nregp = nreg + 1, nd2 = nregp * A.ns;
  const int n_aux = nreg + (nreg > 1 ? nreg - 1 : 1) + 7;
  const LwStackLayout sl(nd, A.ns, nreg);
  const long long B = A.B;
  const T* st = A.stacks;
  const int n2 = nd * nd, sr = sl.rows;
  return LayerOperands<T, K5_NOPS>{
      {A.vov, st + sl.ab * B, st + sl.sb * B, A.Tm, st + sl.sa * B, A.R, A.p,
       st + sl.inv * B, st + sl.aa * B, A.idif, A.isrc, A.aux},
      {nregp * nreg, nd2 * nd2, nd2, n2, nd, n2, nd, n2, n2, n2, nd, n_aux},
      {true, false, false, false, false, false, false, false, false, false, false, false},
      {nreg, nd2, 1, nd, 1, nd, 1, nd, nd, nd, 1, 1},
      {0, sr, sr, 0, sr, 0, 0, sr, sr, 0, 0, 0}};
}

// K5's slab, per element: the carry (each mode's dn, nd: the rows of fin
// in order), each mode's vectors of a layer step (from `mode`, `mstride`
// apart), source_above (read again later in the step), the step's sums
// (lw_down_sums) and two layers' output rows.
struct LwDownSlab {
  int mode, mstride, dbf, upb, wrk, dnn, upa, ifl, sav, sums, out, n_out, size;
};

// The sums of a K5 layer step: per mode (from mode x per) roof_in, roof_up,
// the four profile sums, if_mu (nreg) and if_tan (nreg).
SPX_HD int lw_down_sums(int nreg, int* per) {
  *per = 6 + 2 * nreg;
  return 2 * *per;
}

SPX_HD LwDownSlab lw_down_slab(int nd, int ns, int nreg, int do_urban, int with_profiles) {
  LwDownSlab D{};
  const int nd2 = (nreg + 1) * ns;
  D.mode = 2 * nd;
  D.dbf = 0;
  D.upb = nd2;
  D.wrk = 2 * nd2;
  D.dnn = D.wrk + nd;
  D.upa = D.dnn + nd;
  D.ifl = D.upa + nd;
  D.mstride = D.ifl + nd;
  D.sav = D.mode + 2 * D.mstride;
  D.sums = D.sav + nd;
  int per;
  D.out = D.sums + lw_down_sums(nreg, &per);
  D.n_out = 2 * lw_out_count(nreg, do_urban, with_profiles);
  D.size = D.out + 2 * D.n_out;
  return D;
}

template <typename T>
SPX_HD LwDownSlab lw_down_slab(const LwDownArgs<T>& A) {
  return lw_down_slab(A.nd, A.ns, A.nreg, A.do_urban, A.with_profiles);
}

// K5: LW fluxes from the canopy top down, internal-emission and incoming
// modes (radsurf_urban_lw.F90:639-805), one element (bs.b; a team of TS
// lanes, TS = 1 on the host) with its slab, as K3's (sw_sweeps.cu
// sw_down_team): both modes side by side, the step's sums split over the
// lanes.  Stores nothing where !valid.
template <int TS, typename T, class Sweep>
SPX_DEV void lw_down_team(const LwDownArgs<T>& A, const LwDownSlab& D, const Team<TS>& tm,
                          const Sweep& bs, bool valid, T* slab) {
  const int nd = A.nd, ns = A.ns, nreg = A.nreg, nregp = nreg + 1;
  const int nd2 = nregp * ns, nod = nreg > 1 ? nreg - 1 : 1;
  // aux rows: [f_wall (nreg) | od (nod) | ab | vb | weps | sub_air |
  // sub_vegair | sub_veg | sub_wall]
  const int a_ab = nreg + nod;
  const long long B = A.B, b = bs.b;
  const Sh<T> sm{slab};
  const T *hw = A.hw, *rmu = A.rmu, *rtan = A.rtan;
  // the carry; each mode's vectors (0 internal emission, 1 incoming)
  const auto dn0 = sm.at(0), dn1 = sm.at(nd), SAV = sm.at(D.sav);
  auto vec = [&](int mode, int off) { return sm.at(D.mode + mode * D.mstride + off); };
  const auto DBF0 = vec(0, D.dbf), DBF1 = vec(1, D.dbf), UPB0 = vec(0, D.upb),
             UPB1 = vec(1, D.upb), WRK0 = vec(0, D.wrk), WRK1 = vec(1, D.wrk),
             DNN0 = vec(0, D.dnn), DNN1 = vec(1, D.dnn), UPA0 = vec(0, D.upa),
             UPA1 = vec(1, D.upa), IFL0 = vec(0, D.ifl), IFL1 = vec(1, D.ifl);

  // TOC conditions (radsurf_urban_lw.F90:639-651): mode 0 (internal
  // emission) starts from zero, mode 1 (incoming) from dn = hw in region 0
  for (int i = tm.lane; i < D.mode; i += TS)
    slab[i] = (i >= nd && i < nd + ns) ? hw[i - nd] : T(0);
  tm.sync();
  bs.start();

  for (int l = A.L - 1; l >= 0; --l) {
    // phase 1: translate across the interface at layer top (:656-660), the
    // upward flux there, the fluxes at layer base (:676-690)
    bs.begin(l);
    {
      const auto V = bs.mat(K5_V, l), AB = bs.mat(K5_AB, l), SB = bs.mat(K5_SB, l),
                 Tl = bs.mat(K5_T, l), SA = bs.mat(K5_SA, l), R = bs.mat(K5_R, l),
                 P = bs.mat(K5_P, l);
      for (int i = tm.lane; i < nd2; i += TS) {
        const int q = i / ns, a = i % ns;
        T acc0 = T(0), acc1 = T(0);
        for (int r = 0; r < nreg; ++r) {
          const T v = V(q, r);
          acc0 += v * dn0[r * ns + a], acc1 += v * dn1[r * ns + a];
        }
        DBF0[i] = acc0, DBF1[i] = acc1;
      }
      tm.sync();
      for (int i = tm.lane; i < nd2 + 2 * nd; i += TS) {
        T acc0 = T(0), acc1 = T(0);
        if (i < nd2) {
          dot_row2(AB, i, DBF0, DBF1, nd2, acc0, acc1);
          UPB0[i] = acc0 + SB(i, 0), UPB1[i] = acc1;
        } else if (i < nd2 + nd) {
          const int j = i - nd2;
          dot_row2(Tl, j, DBF0, DBF1, nd, acc0, acc1);
          WRK0[j] = dot_row(R, j, SA.v, nd, acc0) + P(j, 0), WRK1[j] = acc1;
        } else {
          SAV[i - nd2 - nd] = SA(i - nd2 - nd, 0);
        }
      }
      tm.sync();
    }
    // phase 2: the fluxes at layer base, integrated fluxes (:706-712),
    // absorption minus emission (:714-757) and walls (:759-771)
    {
      const auto INV = bs.mat(K5_INV, l), AA = bs.mat(K5_AA, l), IDIF = bs.mat(K5_IDIF, l),
                 ISRC = bs.mat(K5_ISRC, l), X = bs.mat(K5_X, l);
      for (int i = tm.lane; i < nd; i += TS) {
        T acc0 = T(0), acc1 = T(0);
        dot_row2(INV, i, WRK0, WRK1, nd, acc0, acc1);
        DNN0[i] = acc0, DNN1[i] = acc1;
      }
      tm.sync();
      for (int i = tm.lane; i < nd; i += TS) {
        T acc0 = T(0), acc1 = T(0);
        dot_row2(AA, i, DNN0, DNN1, nd, acc0, acc1);
        UPA0[i] = acc0 + SAV[i], UPA1[i] = acc1;
      }
      tm.sync();
      for (int i = tm.lane; i < nd; i += TS) {
        WRK0[i] = DBF0[i] - DNN0[i] - UPB0[i] + UPA0[i];
        WRK1[i] = DBF1[i] - DNN1[i] - UPB1[i] + UPA1[i];
      }
      tm.sync();
      for (int i = tm.lane; i < nd; i += TS) {
        T acc0 = T(0), acc1 = T(0);
        dot_row2(IDIF, i, WRK0, WRK1, nd, acc0, acc1);
        IFL0[i] = acc0 + ISRC(i, 0), IFL1[i] = acc1;
      }
      tm.sync();
      // the step's sums (lw_down_sums), split over the lanes
      const auto SUM = sm.at(D.sums);
      int per;
      const int nsums = lw_down_sums(nreg, &per);
      for (int j = tm.lane; j < nsums; j += TS) {
        T acc = T(0);
        const int mode = j / per, k = j - mode * per;
        const auto DBF = mode == 0 ? DBF0 : DBF1, UPB = mode == 0 ? UPB0 : UPB1,
                   DNN = mode == 0 ? DNN0 : DNN1, UPA = mode == 0 ? UPA0 : UPA1,
                   IFL = mode == 0 ? IFL0 : IFL1;
        if (k < 2) {  // roof_in, roof_up
          const auto v = k == 0 ? DBF : UPB;
          SPX_UNROLL4
          for (int a = 0; a < ns; ++a) acc += v[nd + a];
        } else if (k < 6) {  // the profile sums
          const auto v = k == 2 ? DBF : k == 3 ? UPB : k == 4 ? DNN : UPA;
          SPX_UNROLL4
          for (int i = 0; i < nd; ++i) acc += v[i];
        } else {  // if_mu, if_tan
          const int r = (k - 6) % nreg;
          const T* w = k - 6 < nreg ? rmu : rtan;
          SPX_UNROLL4
          for (int a = 0; a < ns; ++a) acc += IFL[r * ns + a] * w[a];
        }
        SUM[j] = acc;
      }
      tm.sync();
      // the step's output rows, in the order of lw_out_rows
      const auto out = bs.out(l);
      const T ab = X(a_ab, 0), vb = X(a_ab + 1, 0), weps = X(a_ab + 2, 0);
      int row = 0;
      SPX_UNROLL
      for (int mode = 0; mode < 2; ++mode) {
        const bool src = mode == 0;
        const auto s = SUM.at(mode * per);
        const T roof_in = s[0], roof_up = s[1], sdt = s[2], sut = s[3], sdb = s[4],
                sub = s[5];
        T if_mu[3], if_tan[3];  // nreg <= 3
        for (int r = 0; r < nreg; ++r) {
          if_mu[r] = s[6 + r];
          if_tan[r] = s[6 + nreg + r];
        }
        const bool w = tm.lane == 0;
        auto put = [&](T v) {
          if (w) out[row] = v;
          ++row;
        };
        put(roof_in);
        put(roof_in - roof_up);
        put(ab * if_mu[0] - (src ? X(a_ab + 3, 0) : T(0)));
        if (nreg > 1) {
          T va = T(0), vs = T(0);
          for (int r = 1; r < nreg; ++r) {
            va += if_mu[r];
            vs += if_mu[r] * X(nreg + r - 1, 0);
          }
          put(ab * va - (src ? X(a_ab + 4, 0) : T(0)));
          put(vb * vs - (src ? X(a_ab + 5, 0) : T(0)));
        }
        if (A.do_urban) {
          T wall_in = T(0);
          for (int r = 0; r < nreg; ++r) wall_in += X(r, 0) * if_tan[r];
          put(wall_in);
          put(wall_in * weps - (src ? X(a_ab + 6, 0) : T(0)));
        }
        if (A.with_profiles) {
          put(sdt);
          put(sut);
          put(sdb);
          put(sub);
        }
      }
      for (int i = tm.lane; i < nd; i += TS) dn0[i] = DNN0[i], dn1[i] = DNN1[i];
    }
    bs.store(l);
  }
  if (valid)
    for (int i = tm.lane; i < D.mode; i += TS) A.fin[i * B + b] = slab[i];
}

template <typename T>
LwUpArgs<T> lw_up_args(void* R, void* Tm, void* p, void* uov, void* vov,
                       void* reps, void* remit, void* exposed, void* grd,
                       void* hw, void* stacks, void* top, void* ws, int nd,
                       int ns, int nreg, int L, int S, long long B) {
  return LwUpArgs<T>{(const T*)R,     (const T*)Tm,      (const T*)p,
                     (const T*)uov,   (const T*)vov,     (const T*)reps,
                     (const T*)remit, (const T*)exposed, (const T*)grd,
                     (const T*)hw,    (T*)stacks,        (T*)top,
                     (T*)ws,          nd, ns, nreg, L, S, B};
}

template <typename T>
LwDownArgs<T> lw_down_args(void* R, void* Tm, void* p, void* idif, void* isrc,
                           void* stacks, void* vov, void* aux, void* hw,
                           void* rmu, void* rtan, void* outs, void* fin, int nd,
                           int ns, int nreg, int L, int S, int do_urban,
                           int with_profiles, long long B) {
  return LwDownArgs<T>{(const T*)R,    (const T*)Tm,   (const T*)p,
                       (const T*)idif, (const T*)isrc, (const T*)stacks,
                       (const T*)vov,  (const T*)aux,  (const T*)hw,
                       (const T*)rmu,  (const T*)rtan, (T*)outs,
                       (T*)fin,        nd, ns, nreg, L, S, do_urban,
                       with_profiles,  B};
}

}  // namespace spx

#define SPX_LW_UP_PARAMS                                                      \
  void *R, void *Tm, void *p, void *uov, void *vov, void *reps, void *remit, \
      void *exposed, void *grd, void *hw, void *stacks, void *top, void *ws, \
      int nd, int ns, int nreg, int L, int S, long long B
#define SPX_LW_UP_ARGS                                                        \
  R, Tm, p, uov, vov, reps, remit, exposed, grd, hw, stacks, top, ws, nd, ns, \
      nreg, L, S, B
#define SPX_LW_DOWN_PARAMS                                                    \
  void *R, void *Tm, void *p, void *idif, void *isrc, void *stacks,          \
      void *vov, void *aux, void *hw, void *rmu, void *rtan, void *outs,     \
      void *fin, int nd, int ns, int nreg, int L, int S, int do_urban,       \
      int with_profiles, long long B
#define SPX_LW_DOWN_ARGS                                                      \
  R, Tm, p, idif, isrc, stacks, vov, aux, hw, rmu, rtan, outs, fin, nd, ns,  \
      nreg, L, S, do_urban, with_profiles, B

#ifdef __CUDACC__
// K4: teams of TS lanes (spx::up_sweep_teams), as K2's kernel.
template <typename T, int TS, bool GLOBAL>
__global__ void lw_up_kernel(spx::LwUpArgs<T> A, spx::UpSlab S, int stride) {
  spx::up_sweep_teams<T, TS, GLOBAL>(
      spx::lw_up_operands(A), A.B, A.S, A.L, A.ws, stride,
      [&](const spx::Team<TS>& tm, const auto& rd, bool valid, T* slab) {
        spx::lw_up_team<TS, TS>(A, S, tm, rd, valid, slab);
      });
}

// K5: teams of TS lanes (spx::down_sweep_teams), as K3's kernel.
template <typename T, int TS, bool AHEAD>
__global__ void lw_down_kernel(spx::LwDownArgs<T> A, spx::LwDownSlab D, int stride, int es) {
  spx::down_sweep_teams<T, TS, AHEAD>(
      spx::lw_down_operands(A), A.B, A.S, A.L, stride, es, D.out, D.n_out, A.outs,
      [&](const spx::Team<TS>& tm, const auto& bs, bool valid, T* slab) {
        spx::lw_down_team<TS>(A, D, tm, bs, valid, slab);
      });
}

// K4 at team size TS: with `configure`, its configuration (as K2's,
// sw_sweeps.cu run_k2) written to info; else the launch info describes.
template <typename T, int TS>
static int run_k4(const spx::LwUpArgs<T>& A, cudaStream_t stream, long long* info,
                  int configure) {
  auto* ks = &lw_up_kernel<T, TS, false>;
  decltype(ks) kg = TS == 32 ? &lw_up_kernel<T, TS, TS == 32> : nullptr;
  const spx::UpSlab S = spx::lw_up_slab(A);
  if (info == nullptr) return (int)cudaErrorInvalidValue;
  if (configure)
    return (int)spx::team_config<T, TS>(ks, kg, S.size,
                                        2 * spx::lw_up_operands(A).total(), A.B, info);
  if (info[8] && A.ws == nullptr) return (int)cudaErrorInvalidValue;
  return spx::team_launch(ks, kg, info, stream, A, S, (int)(info[3] / sizeof(T)));
}

// K4 by team size (the power of two >= nd, 2 to 32)
template <typename T>
static int run_lw_up(const spx::LwUpArgs<T>& A, cudaStream_t s, long long* info,
                     int configure) {
  if (A.nd <= 2) return run_k4<T, 2>(A, s, info, configure);
  if (A.nd <= 4) return run_k4<T, 4>(A, s, info, configure);
  if (A.nd <= 8) return run_k4<T, 8>(A, s, info, configure);
  if (A.nd <= 16) return run_k4<T, 16>(A, s, info, configure);
  return run_k4<T, 32>(A, s, info, configure);
}

template <typename T>
static int lw_up_config(int nd, int ns, int nreg, long long B, long long* info) {
  spx::LwUpArgs<T> A{};
  A.nd = nd, A.ns = ns, A.nreg = nreg, A.B = B;
  return run_lw_up<T>(A, nullptr, info, 1);
}

// K5 at team size TS: with `configure`, its configuration (as K3's,
// sw_sweeps.cu run_k3) written to info; else the launch info describes.
template <typename T, int TS>
static int run_k5(const spx::LwDownArgs<T>& A, cudaStream_t stream, long long* info,
                  int configure) {
  auto* ks = &lw_down_kernel<T, TS, true>;
  decltype(ks) kd = TS == 32 ? &lw_down_kernel<T, TS, TS != 32> : nullptr;
  const spx::LwDownSlab D = spx::lw_down_slab(A);
  const int es = spx::slot_stride(spx::lw_down_operands(A), TS, (int)(sizeof(T) / 4));
  if (info == nullptr) return (int)cudaErrorInvalidValue;
  if (configure)
    return (int)spx::team_config<T, TS>(ks, kd, D.size, 2 * es, A.B, info,
                                        (int)(32 / sizeof(T)), true);
  return spx::team_launch(ks, kd, info, stream, A, D, (int)(info[3] / sizeof(T)), es);
}

// K5 by team size (the power of two >= nd, 2 to 32)
template <typename T>
static int run_lw_down(const spx::LwDownArgs<T>& A, cudaStream_t s, long long* info,
                       int configure) {
  if (A.nd <= 2) return run_k5<T, 2>(A, s, info, configure);
  if (A.nd <= 4) return run_k5<T, 4>(A, s, info, configure);
  if (A.nd <= 8) return run_k5<T, 8>(A, s, info, configure);
  if (A.nd <= 16) return run_k5<T, 16>(A, s, info, configure);
  return run_k5<T, 32>(A, s, info, configure);
}

template <typename T>
static int lw_down_config(int nd, int ns, int nreg, int do_urban, int with_profiles,
                          long long B, long long* info) {
  spx::LwDownArgs<T> A{};
  A.nd = nd, A.ns = ns, A.nreg = nreg, A.do_urban = do_urban;
  A.with_profiles = with_profiles, A.S = 1, A.B = B;
  return run_lw_down<T>(A, nullptr, info, 1);
}

extern "C" int lw_up_sweep_f32(SPX_LW_UP_PARAMS, const long long* cfg, void* stream) {
  return run_lw_up<float>(spx::lw_up_args<float>(SPX_LW_UP_ARGS), (cudaStream_t)stream,
                          const_cast<long long*>(cfg), 0);
}
extern "C" int lw_up_sweep_f64(SPX_LW_UP_PARAMS, const long long* cfg, void* stream) {
  return run_lw_up<double>(spx::lw_up_args<double>(SPX_LW_UP_ARGS), (cudaStream_t)stream,
                           const_cast<long long*>(cfg), 0);
}
extern "C" int lw_up_sweep_config_f32(int nd, int ns, int nreg, long long B,
                                      long long* info) {
  return lw_up_config<float>(nd, ns, nreg, B, info);
}
extern "C" int lw_up_sweep_config_f64(int nd, int ns, int nreg, long long B,
                                      long long* info) {
  return lw_up_config<double>(nd, ns, nreg, B, info);
}
extern "C" int lw_down_sweep_f32(SPX_LW_DOWN_PARAMS, const long long* cfg, void* stream) {
  return run_lw_down<float>(spx::lw_down_args<float>(SPX_LW_DOWN_ARGS), (cudaStream_t)stream,
                            const_cast<long long*>(cfg), 0);
}
extern "C" int lw_down_sweep_f64(SPX_LW_DOWN_PARAMS, const long long* cfg, void* stream) {
  return run_lw_down<double>(spx::lw_down_args<double>(SPX_LW_DOWN_ARGS),
                             (cudaStream_t)stream, const_cast<long long*>(cfg), 0);
}
extern "C" int lw_down_sweep_config_f32(int nd, int ns, int nreg, int do_urban,
                                        int with_profiles, long long B, long long* info) {
  return lw_down_config<float>(nd, ns, nreg, do_urban, with_profiles, B, info);
}
extern "C" int lw_down_sweep_config_f64(int nd, int ns, int nreg, int do_urban,
                                        int with_profiles, long long B, long long* info) {
  return lw_down_config<double>(nd, ns, nreg, do_urban, with_profiles, B, info);
}
#endif
