// Kernels K2 and K3: the shortwave adding up-sweep and the fused direct +
// diffuse flux down-sweep.
//
// Replace the TPU kernels _sw_up_kernel (spartacus_surface_tpu/ops/
// pallas_sweep.py:109, launched by sw_up_sweep :783) and _sw_down_kernel /
// _sw_down_mode (:233, :260, launched by _sw_down_call :842 with modes
// (direct, diffuse)).  Plain versions: ops/sweep_kernels.py
// sw_up_sweep_plain and sw_down_sweep_plain.
//
// The TPU kernels carry the recurrence in VMEM across a sequential (tile,
// layer) grid; here a loop over the layers inside the kernel takes that
// grid's place.  Per-layer operands are [L, rows, B]; per-column overlap
// matrices [L, rows, C] are read at column b / S.
//
// K2 on the H100.  One team of TS lanes of a warp per batch element (TS the
// power of two >= nd, 2 to 32, a template parameter: 8 at the headline, 16
// at the rami5 shape, 32 at nd = 24); the team holds its element through
// all L layers and splits the rows of each step's products (tmm, four
// entries of a row at once), of its pivot-free solve with 2 nd + nreg
// right-hand sides (tsolve), of a_below / d_below and of the overlap, with
// __syncwarp(team mask), never a block barrier.  The carry and the solve's
// workspace live in a shared-memory slab per element sized by the live set
// (up_slab: a_below over the dead carry and W1, the next carry over the
// dead RHS; 1,440 B at the headline, 2,752 B at the rami5 shape in
// float32).  Each warp's elements are consecutive, and the warp copies the
// next layer's operands of its elements into shared memory (cp.async,
// OperandReader) while it computes the current one.  The stack rows go out
// from each lane's registers.  Nothing else touches device memory.  What
// bounds it: not bytes (the stack and operands are under 10 % of HBM's
// rate), but each lane's chain of dependent shared-memory loads and FMAs
// through the layer step, with few elements (14,336 at the rami5 shape) and
// 128-250 registers a lane limiting the warps an SM holds.
//
// K3: one thread per batch element walks the layers top to bottom with its
// carry in a struct-of-arrays global workspace.  It reads the stack and
// ~3 nd^2 rows of operators per layer for O(nd2^2) FMAs of matvecs (bound
// by bytes), and runs both normalizations in one layer step so each layer's
// operands are read once.

#include "common.cuh"

namespace spx {

// Stack layout per layer: [a_above | d_above | inv(I - a_above R) |
// a_below | d_below] (ops/sweep_kernels.py sw_stack_rows).
struct StackLayout {
  int aa, da, inv, ab, db, rows;
  SPX_DEV StackLayout(int nd, int ns, int nreg) {
    const int nd2 = (nreg + 1) * ns;
    aa = 0;
    da = nd * nd;
    inv = da + nd * nreg;
    ab = inv + nd * nd;
    db = ab + nd2 * nd2;
    rows = db + nd2 * (nreg + 1);
  }
};

template <typename T>
struct UpArgs {
  const T *R, *Tm, *E, *Sup, *Sdn, *uov, *vov, *ralb, *ralbd, *grd, *hw;
  T *stacks, *top;
  T* ws;  // null, or one slab a resident team where a slab exceeds a block
  int nd, ns, nreg, L, S;
  long long B;
};

// K2's layer operands, in the order of its copy-ahead buffer
enum { K2_R, K2_T, K2_E, K2_SUP, K2_SDN, K2_U, K2_V, K2_RALB, K2_RALBD, K2_NOPS };

template <typename T>
SPX_HD LayerOperands<T, K2_NOPS> sw_up_operands(const UpArgs<T>& A) {
  const int nd = A.nd, nreg = A.nreg, nregp = nreg + 1;
  return LayerOperands<T, K2_NOPS>{
      {A.R, A.Tm, A.E, A.Sup, A.Sdn, A.uov, A.vov, A.ralb, A.ralbd},
      {nd * nd, nd * nd, nreg * nreg, nd * nreg, nd * nreg, nreg * nregp,
       nregp * nreg, 1, 1},
      {false, false, false, false, false, true, true, false, false}};
}

template <typename T>
SPX_HD UpSlab sw_up_slab(const UpArgs<T>& A) {
  return up_slab(A.nd, A.ns, A.nreg, A.nreg, A.nreg + 1);
}

// K2: SW adding from the ground up (radsurf_urban_sw.F90:590-674), one
// element (rd.b; a team of TS lanes, TS = 1 on the host) with its slab.
// Stores nothing where !valid (a team past the batch's end).
template <int TS, int CAP, typename T, class Reader>
SPX_DEV void sw_up_team(const UpArgs<T>& A, const UpSlab& S, const Team<TS>& tm,
                        const Reader& rd, bool valid, T* slab) {
  const int nd = A.nd, ns = A.ns, nreg = A.nreg, nregp = nreg + 1;
  const int nd2 = nregp * ns, mtot = 2 * nd + nreg;
  const long long B = A.B, b = rd.b;
  const StackLayout sl(nd, ns, nreg);
  const Sh<T> sm{slab};
  auto at = [&](int off, int ld) { return mat(sm.at(off), ld); };
  const auto AA = at(S.aa, S.ldn), DA = at(S.da, nreg), W1 = at(S.w1, S.ldn),
             RHS = at(S.rhs, S.ldr), AB = at(S.ab, S.ld2), DB = at(S.db, nregp),
             NA = at(S.na, S.ldn), ND = at(S.nda, nreg);
  const T galb = A.grd[b], galbd = A.grd[B + b], zc = A.grd[2 * B + b];
  const T* hw = A.hw;

  // ground operators (radsurf_urban_sw.F90:593-602)
  for (int i = tm.lane; i < nd; i += TS) {
    for (int j = 0; j < nd; ++j)
      AA(i, j) = (i / ns == j / ns) ? galb * hw[i % ns] : T(0);
    for (int r = 0; r < nreg; ++r)
      DA(i, r) = (i / ns == r) ? zc * galbd * hw[i % ns] : T(0);
  }
  tm.sync();
  rd.start();

  for (int l = 0; l < A.L; ++l) {
    rd.begin(l);
    const auto R = mat(rd.view(K2_R, l), nd), Tl = mat(rd.view(K2_T, l), nd),
               E = mat(rd.view(K2_E, l), nreg), Sup = mat(rd.view(K2_SUP, l), nreg),
               Sdn = mat(rd.view(K2_SDN, l), nreg);
    const auto U = rd.view(K2_U, l), V = rd.view(K2_V, l);
    const T ralb = rd.view(K2_RALB, l)[0], ralbd = rd.view(K2_RALBD, l)[0];
    auto st = [&](int off, int ld) {
      return mat(Col<T>{A.stacks + ((long long)l * sl.rows + off) * B + b, B}, ld);
    };
    const auto sAA = st(sl.aa, nd), sDA = st(sl.da, nreg), sINV = st(sl.inv, nd),
               sAB = st(sl.ab, nd2), sDB = st(sl.db, nregp);
    // the entry carry to the stack
    if (valid)
      for (int i = tm.lane; i < nd; i += TS) {
        for (int j = 0; j < nd; ++j) sAA(i, j) = AA(i, j);
        for (int r = 0; r < nreg; ++r) sDA(i, r) = DA(i, r);
      }
    // (I - a_above R) X = [a_above T | d_above E + a_above Sdn | I]
    tmm<TS, CAP, 4>(tm, W1, AA, R, nd, nd, nd);
    tmm<TS, CAP, 4>(tm, RHS, AA, Tl, nd, nd, nd);
    tmm<TS, CAP, 4>(tm, RHS.sub(0, nd), DA, E, nd, nreg, nreg);
    tmm<TS, CAP, 4>(tm, RHS.sub(0, nd), AA, Sdn, nd, nd, nreg, true);
    for (int i = tm.lane; i < nd; i += TS)
      for (int j = 0; j < nd; ++j) {
        W1(i, j) = T(i == j) - W1(i, j);
        RHS(i, nd + nreg + j) = T(i == j);
      }
    tm.sync();
    tsolve(tm, W1, RHS, nd, mtot);

    // stack: inv(denom), a_below / d_below with the exposed-roof rows
    // (radsurf_urban_sw.F90:607-643), a_below over the dead carry and W1
    for (int i = tm.lane; i < nd2; i += TS) {
      if (i < nd) {
        if (valid)
          for (int j = 0; j < nd; ++j) sINV(i, j) = RHS(i, nd + nreg + j);
        below_row(R, Tl, RHS, AB, i, nd);
        for (int j = nd; j < nd2; ++j) AB(i, j) = T(0);
        for (int r = 0; r < nreg; ++r) {
          T acc = Sup(i, r);
          for (int k = 0; k < nd; ++k) acc += Tl(i, k) * RHS(k, nd + r);
          DB(i, r) = acc;
        }
        DB(i, nreg) = T(0);
      } else {
        const int u = i - nd;
        for (int j = 0; j < nd; ++j) AB(i, j) = T(0);
        for (int v = 0; v < ns; ++v) AB(i, nd + v) = ralb * hw[u];
        for (int r = 0; r < nreg; ++r) DB(i, r) = T(0);
        DB(i, nreg) = zc * ralbd * hw[u];
      }
      if (valid) {
        for (int j = 0; j < nd2; ++j) sAB(i, j) = AB(i, j);
        for (int r = 0; r < nregp; ++r) sDB(i, r) = DB(i, r);
      }
    }
    tm.sync();

    // overlap to just above the interface (radsurf_urban_sw.F90:646-653):
    // (u (x) I_ns) a_below (v (x) I_ns) and (u (x) I_ns) d_below v, the next
    // carry over the dead RHS
    for (int i = tm.lane; i < nd; i += TS) {
      const int t = i / ns, a = i % ns;
      T u[4], uv[16];  // nreg + 1 <= 4
      overlap_weights(U, t, nregp, u);
      for (int f = 0; f < nreg; ++f) {
        overlap_weights(u, V, f, nreg, uv);
        overlap_row(uv, AB, NA, i, a, f, ns, nregp);
      }
      T dacc[4];
      SPX_UNROLL
      for (int r = 0; r < 4; ++r) {
        dacc[r] = T(0);
        SPX_UNROLL
        for (int q = 0; q < 4; ++q)
          if (q < nregp && r < nregp) dacc[r] += u[q] * DB(q * ns + a, r);
      }
      for (int f = 0; f < nreg; ++f) {
        T acc = T(0);
        SPX_UNROLL
        for (int r = 0; r < 4; ++r)
          if (r < nregp) acc += dacc[r] * V[r * nreg + f];
        ND(i, f) = acc;
      }
    }
    tm.sync();
    rd.end();
    for (int i = tm.lane; i < nd; i += TS) {
      for (int j = 0; j < nd; ++j) AA(i, j) = NA(i, j);
      for (int r = 0; r < nreg; ++r) DA(i, r) = ND(i, r);
    }
    tm.sync();
  }
  if (valid) {
    const auto top = mat(Col<T>{A.top + b, B}, nd);
    const auto topd = mat(Col<T>{A.top + (long long)nd * nd * B + b, B}, nreg);
    for (int i = tm.lane; i < nd; i += TS) {
      for (int j = 0; j < nd; ++j) top(i, j) = AA(i, j);
      for (int r = 0; r < nreg; ++r) topd(i, r) = DA(i, r);
    }
  }
}

template <typename T>
struct DownArgs {
  const T *R, *Tm, *E, *Sdn, *idir, *idif, *idd, *stacks, *vov, *aux, *zcos,
      *hw, *rmu, *rtan;
  T *outs, *fin, *ws;
  int nd, ns, nreg, L, S, do_urban, with_profiles;
  long long B;
};

// Output rows of one mode, in the order of sw_out_rows.
SPX_DEV int sw_out_count(bool wd, int nreg, int do_urban, int with_profiles) {
  return 3 + wd + (nreg > 1 ? 2 + wd : 0) + (do_urban ? 2 + wd : 0) +
         (with_profiles ? 4 + 2 * wd : 0);
}

// K3: SW fluxes from the canopy top down, both normalizations
// (radsurf_urban_sw.F90:676-1001 without the clear-sky bookkeeping).
template <typename T>
SPX_DEV void sw_down_thread(const DownArgs<T>& A, long long b) {
  const int nd = A.nd, ns = A.ns, nreg = A.nreg, nregp = nreg + 1;
  const int nd2 = nregp * ns, n2 = nd * nd, nod = nreg > 1 ? nreg - 1 : 1;
  const int n_aux = nreg + nod + 3;
  const int n_out = sw_out_count(true, nreg, A.do_urban, A.with_profiles) +
                    sw_out_count(false, nreg, A.do_urban, A.with_profiles);
  const long long B = A.B, C = B / A.S, c = b / A.S;
  const StackLayout sl(nd, ns, nreg);
  auto lay = [&](const T* p, int rows, int l) {
    return Col<T>{const_cast<T*>(p) + (long long)l * rows * B + b, B};
  };
  // workspace: DDIR (2 modes x nreg) | DDIF (2 x nd) | DBD | DBF | UPB |
  // DDN | REF | WRK | DNN | UPA | IFD | IFR
  const Col<T> DDIR{A.ws + b, B};
  const Col<T> DDIF = DDIR.at(2 * nreg), DBD = DDIF.at(2 * nd),
               DBF = DBD.at(nregp), UPB = DBF.at(nd2), DDN = UPB.at(nd2),
               REF = DDN.at(nreg), WRK = REF.at(nd), DNN = WRK.at(nd),
               UPA = DNN.at(nd), IFD = UPA.at(nd), IFR = IFD.at(nd);
  const T zc = A.zcos[b];
  const T sin0 = sqrt(fmax(T(1) - zc * zc, T(0)));
  const T *hw = A.hw, *rmu = A.rmu, *rtan = A.rtan;

  // TOC conditions (radsurf_urban_sw.F90:687-700): mode 0 direct, 1 diffuse
  fill(DDIR, 2 * nreg, T(0));
  fill(DDIF, 2 * nd, T(0));
  DDIR[0] = T(1) / zc;
  for (int a = 0; a < ns; ++a) DDIF[nd + a] = hw[a];

  for (int l = A.L - 1; l >= 0; --l) {
    const Col<T> R = lay(A.R, n2, l), Tl = lay(A.Tm, n2, l),
                 E = lay(A.E, nreg * nreg, l), Sdn = lay(A.Sdn, nd * nreg, l),
                 idir = lay(A.idir, nreg * nreg, l), idif = lay(A.idif, n2, l),
                 idd = lay(A.idd, nd * nreg, l), st = lay(A.stacks, sl.rows, l),
                 X = lay(A.aux, n_aux, l), out = lay(A.outs, n_out, l);
    const Col<T> V{const_cast<T*>(A.vov) + (long long)l * nregp * nreg * C + c, C};
    int row = 0;
    for (int mode = 0; mode < 2; ++mode) {
      const bool wd = mode == 0;
      const Col<T> ddir = DDIR.at(mode * nreg), ddif = DDIF.at(mode * nd);
      // translate across the interface at layer top (:707-714)
      for (int q = 0; q < nregp; ++q) {
        T accd = T(0);
        for (int r = 0; r < nreg; ++r) accd += V[q * nreg + r] * ddir[r];
        DBD[q] = accd;
        for (int a = 0; a < ns; ++a) {
          T accf = T(0);
          for (int r = 0; r < nreg; ++r) accf += V[q * nreg + r] * ddif[r * ns + a];
          DBF[q * ns + a] = accf;
        }
      }
      mv(UPB, st.at(sl.ab), DBF, nd2, nd2);
      if (wd) mv(UPB, st.at(sl.db), DBD, nd2, nregp, true);
      // roof fluxes (:716-721)
      const T roof_in_dir = wd ? zc * DBD[nreg] : T(0);
      T roof_in = T(0), roof_up = T(0);
      for (int a = 0; a < ns; ++a) {
        roof_in += DBF[nd + a];
        roof_up += UPB[nd + a];
      }
      if (wd) roof_in += roof_in_dir;
      // fluxes at layer base (:723-735)
      mv(WRK, Tl, DBF, nd, nd);
      if (wd) {
        mv(DDN, E, DBD, nreg, nreg);
        mv(REF, st.at(sl.da), DDN, nd, nreg);
        mv(WRK, R, REF, nd, nd, true);
        mv(WRK, Sdn, DBD, nd, nreg, true);
      }
      mv(DNN, st.at(sl.inv), WRK, nd, nd);
      mv(UPA, st.at(sl.aa), DNN, nd, nd);
      if (wd)
        for (int i = 0; i < nd; ++i) UPA[i] += REF[i];
      T sdt = T(0), sut = T(0), sdb = T(0), sub = T(0), ddt = T(0), dds = T(0);
      for (int i = 0; i < nd; ++i) {
        sdt += DBF[i];
        sut += UPB[i];
        sdb += DNN[i];
        sub += UPA[i];
      }
      if (wd)
        for (int r = 0; r < nreg; ++r) {
          ddt += DBD[r];
          dds += DDN[r];
        }
      // integrated fluxes (:753-761)
      for (int i = 0; i < nd; ++i) WRK[i] = DBF[i] - DNN[i] - UPB[i] + UPA[i];
      mv(IFD, idif, WRK, nd, nd);
      if (wd) {
        for (int r = 0; r < nreg; ++r) DBD[r] -= DDN[r];
        mv(IFR, idir, DBD, nreg, nreg);
        mv(IFD, idd, DBD, nd, nreg, true);
      } else {
        fill(IFR, nreg, T(0));
      }
      // absorption (:763-788) and walls (:790-802); aux rows
      // [f_wall (nreg) | od (nod) | air abs | veg abs | wall albedo]
      T ifd_mu[3], ifd_tan[3];  // nreg <= 3
      for (int r = 0; r < nreg; ++r) {
        ifd_mu[r] = T(0);
        ifd_tan[r] = T(0);
        for (int a = 0; a < ns; ++a) {
          ifd_mu[r] += IFD[r * ns + a] * rmu[a];
          ifd_tan[r] += IFD[r * ns + a] * rtan[a];
        }
      }
      const T ab = X[nreg + nod], vb = X[nreg + nod + 1], wa = X[nreg + nod + 2];
      out[row++] = roof_in;
      out[row++] = roof_in - roof_up;
      if (wd) out[row++] = roof_in_dir;
      out[row++] = ab * (IFR[0] + ifd_mu[0]);
      if (nreg > 1) {
        T va = T(0), vs = T(0), vd = T(0);
        for (int r = 1; r < nreg; ++r) {
          va += IFR[r] + ifd_mu[r];
          vs += (IFR[r] + ifd_mu[r]) * X[nreg + r - 1];
          vd += IFR[r] * X[nreg + r - 1];
        }
        out[row++] = ab * va;
        out[row++] = vb * vs;
        if (wd) out[row++] = vb * vd;
      }
      if (A.do_urban) {
        T wall_in = T(0), wd_sum = T(0);
        for (int r = 0; r < nreg; ++r) {
          wall_in += X[r] * ifd_tan[r];
          wd_sum += X[r] * IFR[r];
        }
        if (wd) {
          out[row++] = sin0 * wd_sum;
          wall_in += sin0 * wd_sum;
        }
        out[row++] = wall_in;
        out[row++] = wall_in * (T(1) - wa);
      }
      if (A.with_profiles) {
        if (wd) {
          out[row++] = zc * ddt;
          out[row++] = zc * dds;
          sdt += zc * ddt;
          sdb += zc * dds;
        }
        out[row++] = sdt;
        out[row++] = sut;
        out[row++] = sdb;
        out[row++] = sub;
      }
      // commit the carries
      if (wd) copy(ddir, DDN, nreg);
      copy(ddif, DNN, nd);
    }
  }
  const Col<T> fin{A.fin + b, B};
  copy(fin, DDIR, nreg);
  copy(fin.at(nreg), DDIF, nd);
  copy(fin.at(nreg + nd), DDIF.at(nd), nd);
}

template <typename T>
UpArgs<T> up_args(void* R, void* Tm, void* E, void* Sup, void* Sdn, void* uov,
                  void* vov, void* ralb, void* ralbd, void* grd, void* hw,
                  void* stacks, void* top, void* ws, int nd, int ns, int nreg,
                  int L, int S, long long B) {
  return UpArgs<T>{(const T*)R,    (const T*)Tm,   (const T*)E,
                   (const T*)Sup,  (const T*)Sdn,  (const T*)uov,
                   (const T*)vov,  (const T*)ralb, (const T*)ralbd,
                   (const T*)grd,  (const T*)hw,   (T*)stacks,
                   (T*)top,        (T*)ws,         nd, ns, nreg, L, S,
                   B};
}

template <typename T>
DownArgs<T> down_args(void* R, void* Tm, void* E, void* Sdn, void* idir,
                      void* idif, void* idd, void* stacks, void* vov,
                      void* aux, void* zcos, void* hw, void* rmu, void* rtan,
                      void* outs, void* fin, void* ws, int nd, int ns,
                      int nreg, int L, int S, int do_urban, int with_profiles,
                      long long B) {
  return DownArgs<T>{(const T*)R,    (const T*)Tm,   (const T*)E,
                     (const T*)Sdn,  (const T*)idir, (const T*)idif,
                     (const T*)idd,  (const T*)stacks, (const T*)vov,
                     (const T*)aux,  (const T*)zcos, (const T*)hw,
                     (const T*)rmu,  (const T*)rtan, (T*)outs, (T*)fin,
                     (T*)ws, nd, ns, nreg, L, S, do_urban, with_profiles, B};
}

}  // namespace spx

#define SPX_UP_PARAMS                                                         \
  void *R, void *Tm, void *E, void *Sup, void *Sdn, void *uov, void *vov,    \
      void *ralb, void *ralbd, void *grd, void *hw, void *stacks, void *top, \
      void *ws, int nd, int ns, int nreg, int L, int S, long long B
#define SPX_UP_ARGS                                                           \
  R, Tm, E, Sup, Sdn, uov, vov, ralb, ralbd, grd, hw, stacks, top, ws, nd,   \
      ns, nreg, L, S, B
#define SPX_DOWN_PARAMS                                                       \
  void *R, void *Tm, void *E, void *Sdn, void *idir, void *idif, void *idd,  \
      void *stacks, void *vov, void *aux, void *zcos, void *hw, void *rmu,   \
      void *rtan, void *outs, void *fin, void *ws, int nd, int ns, int nreg, \
      int L, int S, int do_urban, int with_profiles, long long B
#define SPX_DOWN_ARGS                                                         \
  R, Tm, E, Sdn, idir, idif, idd, stacks, vov, aux, zcos, hw, rmu, rtan,     \
      outs, fin, ws, nd, ns, nreg, L, S, do_urban, with_profiles, B

#ifdef __CUDACC__
// K2: teams of TS lanes (spx::up_sweep_teams), the slab and the copy-ahead
// in shared memory or (GLOBAL, at TS = 32 only) the slab in the wrapper's
// scratch at A.ws and the operands read from device memory.
template <typename T, int TS, bool GLOBAL>
__global__ void sw_up_kernel(spx::UpArgs<T> A, spx::UpSlab S, int stride) {
  spx::up_sweep_teams<T, TS, GLOBAL>(
      spx::sw_up_operands(A), A.B, A.S, A.L, A.ws, stride,
      [&](const spx::Team<TS>& tm, const auto& rd, bool valid, T* slab) {
        spx::sw_up_team<TS, TS>(A, S, tm, rd, valid, slab);
      });
}

template <typename T>
__global__ void sw_down_kernel(spx::DownArgs<T> A) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b < A.B) spx::sw_down_thread(A, b);
}

static unsigned n_blocks(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// K2 at team size TS: with `configure`, its configuration for A's shape
// and A.B elements (spx::team_config: the slab of up_slab and two buffers
// of one layer's operands a team, or the global-slab kernel, at TS = 32
// only) written to info; else the launch that info describes.
template <typename T, int TS>
static int run_k2(const spx::UpArgs<T>& A, cudaStream_t stream, long long* info,
                  int configure) {
  auto* ks = &sw_up_kernel<T, TS, false>;
  decltype(ks) kg = TS == 32 ? &sw_up_kernel<T, TS, TS == 32> : nullptr;
  const spx::UpSlab S = spx::sw_up_slab(A);
  if (info == nullptr) return (int)cudaErrorInvalidValue;
  if (configure)
    return (int)spx::team_config<T, TS>(ks, kg, S.size,
                                        2 * spx::sw_up_operands(A).total(), A.B, info);
  if (info[8] && A.ws == nullptr) return (int)cudaErrorInvalidValue;
  return spx::team_launch(ks, kg, info, stream, A, S, (int)(info[3] / sizeof(T)));
}

// K2 by team size (the power of two >= nd, 2 to 32)
template <typename T>
static int run_up(const spx::UpArgs<T>& A, cudaStream_t s, long long* info, int configure) {
  if (A.nd <= 2) return run_k2<T, 2>(A, s, info, configure);
  if (A.nd <= 4) return run_k2<T, 4>(A, s, info, configure);
  if (A.nd <= 8) return run_k2<T, 8>(A, s, info, configure);
  if (A.nd <= 16) return run_k2<T, 16>(A, s, info, configure);
  return run_k2<T, 32>(A, s, info, configure);
}

template <typename T>
static int up_config(int nd, int ns, int nreg, long long B, long long* info) {
  spx::UpArgs<T> A{};
  A.nd = nd, A.ns = ns, A.nreg = nreg, A.B = B;
  return run_up<T>(A, nullptr, info, 1);
}

template <typename T>
static int launch_down(SPX_DOWN_PARAMS, void* stream) {
  sw_down_kernel<T><<<n_blocks(B, 128), 128, 0, (cudaStream_t)stream>>>(
      spx::down_args<T>(SPX_DOWN_ARGS));
  return (int)cudaGetLastError();
}

extern "C" int sw_up_sweep_f32(SPX_UP_PARAMS, const long long* cfg, void* stream) {
  return run_up<float>(spx::up_args<float>(SPX_UP_ARGS), (cudaStream_t)stream,
                       const_cast<long long*>(cfg), 0);
}
extern "C" int sw_up_sweep_f64(SPX_UP_PARAMS, const long long* cfg, void* stream) {
  return run_up<double>(spx::up_args<double>(SPX_UP_ARGS), (cudaStream_t)stream,
                        const_cast<long long*>(cfg), 0);
}
extern "C" int sw_up_sweep_config_f32(int nd, int ns, int nreg, long long B,
                                      long long* info) {
  return up_config<float>(nd, ns, nreg, B, info);
}
extern "C" int sw_up_sweep_config_f64(int nd, int ns, int nreg, long long B,
                                      long long* info) {
  return up_config<double>(nd, ns, nreg, B, info);
}
extern "C" int sw_down_sweep_f32(SPX_DOWN_PARAMS, void* stream) {
  return launch_down<float>(SPX_DOWN_ARGS, stream);
}
extern "C" int sw_down_sweep_f64(SPX_DOWN_PARAMS, void* stream) {
  return launch_down<double>(SPX_DOWN_ARGS, stream);
}
#endif
