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
// K3 on the H100.  The same teams of TS lanes, E = blockDim.x / TS teams a
// block on E consecutive elements (down_sweep_teams), walking the layers
// from the top down with the carry (both modes' down fluxes) and every
// vector of a layer step in the team's shared-memory slab (sw_down_slab);
// nothing else but the results goes to device memory.  Per layer an
// element reads the stack and ~7 nd^2 rows of operators (1,186 rows at the
// rami5 shape) for ~2,400 FMAs of matrix-vector products: under one FMA a
// byte, so the kernel is bound by bytes once their latency is hidden.  The
// lanes split the rows of each product and run both normalizations side by
// side (one load of an operator entry for both); while the block computes
// one layer, all its threads copy the next layer's operands of the block's
// elements into shared memory (cp.async, BlockSweep): neighbouring threads
// take neighbouring elements of one row, so a block of 8 f32 / 4 f64
// elements reads whole 32-byte sectors, and each element's matrices land at
// odd row strides, so the lanes reading their own rows hit distinct banks.
// The output rows are staged in the slab and stored block-wide the same
// way.  Where the copy-ahead slots exceed a block's shared memory (nd from
// ~40-48 on in f64, ~56-66 in f32), a kernel with the same slabs reads its
// operands from device memory instead.

#include "common.cuh"

namespace spx {

// Stack layout per layer: [a_above | d_above | inv(I - a_above R) |
// a_below | d_below] (ops/sweep_kernels.py sw_stack_rows).
struct StackLayout {
  int aa, da, inv, ab, db, rows;
  SPX_HD StackLayout(int nd, int ns, int nreg) {
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
  T *outs, *fin;
  int nd, ns, nreg, L, S, do_urban, with_profiles;
  long long B;
};

// Output rows of one mode, in the order of sw_out_rows.
SPX_HD int sw_out_count(bool wd, int nreg, int do_urban, int with_profiles) {
  return 3 + wd + (nreg > 1 ? 2 + wd : 0) + (do_urban ? 2 + wd : 0) +
         (with_profiles ? 4 + 2 * wd : 0);
}

// K3's layer operands, in the order of its copy-ahead slot (and of their
// first reads in a layer step)
enum {
  K3_V, K3_AB, K3_DB, K3_T, K3_E, K3_DA, K3_R, K3_SDN,
  K3_INV, K3_AA, K3_IDIF, K3_IDIR, K3_IDD, K3_X, K3_NOPS
};

template <typename T>
SPX_HD LayerOperands<T, K3_NOPS> sw_down_operands(const DownArgs<T>& A) {
  const int nd = A.nd, nreg = A.nreg, nregp = nreg + 1, nd2 = nregp * A.ns;
  const int n_aux = nreg + (nreg > 1 ? nreg - 1 : 1) + 3;
  const StackLayout sl(nd, A.ns, nreg);
  const long long B = A.B;
  const T* st = A.stacks;
  const int n2 = nd * nd, dr = nd * nreg, r2 = nreg * nreg, sr = sl.rows;
  return LayerOperands<T, K3_NOPS>{
      {A.vov, st + sl.ab * B, st + sl.db * B, A.Tm, A.E, st + sl.da * B, A.R, A.Sdn,
       st + sl.inv * B, st + sl.aa * B, A.idif, A.idir, A.idd, A.aux},
      {nregp * nreg, nd2 * nd2, nd2 * nregp, n2, r2, dr, n2, dr, n2, n2, n2, r2, dr, n_aux},
      {true, false, false, false, false, false, false, false, false, false, false,
       false, false, false},
      {nreg, nd2, nregp, nd, nreg, nreg, nd, nreg, nd, nd, nd, nreg, nreg, 1},
      {0, sr, sr, 0, 0, sr, 0, 0, sr, sr, 0, 0, 0, 0}};
}

// K3's slab, per element: the carry (the direct mode's ddir, nreg; each
// mode's ddif, nd: the rows of fin in order), each mode's vectors of a
// layer step (from `mode`, `mstride` apart), the step's sums (sw_down_sums)
// and two layers' output rows.
struct SwDownSlab {
  int ddir, ddif, mode, mstride, dbd, dbf, upb, wrk, ddn, ref, dnn, upa, ifd, ifr,
      conv, sums, out, n_out, size;
};

// The sums of a K3 layer step: per mode (from mode x per) roof_in, roof_up,
// the four profile sums, ifd_mu (nreg) and ifd_tan (nreg); then the direct
// mode's ddt and dds.
SPX_HD int sw_down_sums(int nreg, int* per) {
  *per = 6 + 2 * nreg;
  return 2 * *per + 2;
}

SPX_HD SwDownSlab sw_down_slab(int nd, int ns, int nreg, int do_urban, int with_profiles) {
  SwDownSlab D{};
  const int nregp = nreg + 1, nd2 = nregp * ns;
  D.ddir = 0;
  D.ddif = nreg;
  D.mode = nreg + 2 * nd;
  D.dbd = 0;
  D.dbf = nregp;
  D.upb = D.dbf + nd2;
  D.wrk = D.upb + nd2;
  D.ddn = D.wrk + nd;
  D.ref = D.ddn + nreg;
  D.dnn = D.ref + nd;
  D.upa = D.dnn + nd;
  D.ifd = D.upa + nd;
  D.ifr = D.ifd + nd;
  D.conv = D.ifr + nreg;
  D.mstride = D.conv + nreg;
  D.sums = D.mode + 2 * D.mstride;
  int per;
  D.out = D.sums + sw_down_sums(nreg, &per);
  D.n_out = sw_out_count(true, nreg, do_urban, with_profiles) +
            sw_out_count(false, nreg, do_urban, with_profiles);
  D.size = D.out + 2 * D.n_out;
  return D;
}

template <typename T>
SPX_HD SwDownSlab sw_down_slab(const DownArgs<T>& A) {
  return sw_down_slab(A.nd, A.ns, A.nreg, A.do_urban, A.with_profiles);
}

// K3: SW fluxes from the canopy top down, both normalizations
// (radsurf_urban_sw.F90:676-1001 without the clear-sky bookkeeping), one
// element (bs.b; a team of TS lanes, TS = 1 on the host) with its slab,
// reading its operands through bs (a BlockSweep).  The lanes split the
// rows of every matrix-vector product, and each step runs both modes side
// by side (a lane loads an entry of an operator once for both sums); the
// lanes split the step's sums (each summed in order, as the plain version's
// thread did), lane 0 stages the output rows.  Stores nothing where !valid.
template <int TS, typename T, class Sweep>
SPX_DEV void sw_down_team(const DownArgs<T>& A, const SwDownSlab& D, const Team<TS>& tm,
                          const Sweep& bs, bool valid, T* slab) {
  const int nd = A.nd, ns = A.ns, nreg = A.nreg, nregp = nreg + 1;
  const int nd2 = nregp * ns, nod = nreg > 1 ? nreg - 1 : 1;
  const long long B = A.B, b = bs.b;
  const Sh<T> sm{slab};
  const T zc = A.zcos[b];
  const T sin0 = sqrt(fmax(T(1) - zc * zc, T(0)));
  const T *hw = A.hw, *rmu = A.rmu, *rtan = A.rtan;
  // the carry; each mode's vectors (0 direct, 1 diffuse; DBD, DDN, REF,
  // IFR and CONV the direct mode's only)
  const auto ddir = sm.at(D.ddir), ddif0 = sm.at(D.ddif), ddif1 = sm.at(D.ddif + nd);
  auto vec = [&](int mode, int off) { return sm.at(D.mode + mode * D.mstride + off); };
  const auto DBD = vec(0, D.dbd), DDN = vec(0, D.ddn), REF = vec(0, D.ref),
             IFR = vec(0, D.ifr), CONV = vec(0, D.conv);
  const auto DBF0 = vec(0, D.dbf), DBF1 = vec(1, D.dbf), UPB0 = vec(0, D.upb),
             UPB1 = vec(1, D.upb), WRK0 = vec(0, D.wrk), WRK1 = vec(1, D.wrk),
             DNN0 = vec(0, D.dnn), DNN1 = vec(1, D.dnn), UPA0 = vec(0, D.upa),
             UPA1 = vec(1, D.upa), IFD0 = vec(0, D.ifd), IFD1 = vec(1, D.ifd);

  // TOC conditions (radsurf_urban_sw.F90:687-700): mode 0 direct, 1 diffuse
  for (int i = tm.lane; i < D.mode; i += TS) {
    const int a = i - nreg - nd;
    slab[i] = i == 0 ? T(1) / zc : (a >= 0 && a < ns) ? hw[a] : T(0);
  }
  tm.sync();
  bs.start();

  for (int l = A.L - 1; l >= 0; --l) {
    // phase 1: translate across the interface at layer top (:707-714),
    // the upward flux there, the fluxes at layer base (:716-735)
    bs.begin(l);
    {
      const auto V = bs.mat(K3_V, l), AB = bs.mat(K3_AB, l), DB = bs.mat(K3_DB, l),
                 Tl = bs.mat(K3_T, l), El = bs.mat(K3_E, l), DA = bs.mat(K3_DA, l),
                 R = bs.mat(K3_R, l), Sdn = bs.mat(K3_SDN, l);
      for (int i = tm.lane; i < nd2 + nregp; i += TS) {
        T acc0 = T(0), acc1 = T(0);
        if (i < nd2) {
          const int q = i / ns, a = i % ns;
          for (int r = 0; r < nreg; ++r) {
            const T v = V(q, r);
            acc0 += v * ddif0[r * ns + a], acc1 += v * ddif1[r * ns + a];
          }
          DBF0[i] = acc0, DBF1[i] = acc1;
        } else {
          DBD[i - nd2] = dot_row(V, i - nd2, ddir, nreg, acc0);
        }
      }
      tm.sync();
      for (int i = tm.lane; i < nd2 + nd + nreg; i += TS) {
        T acc0 = T(0), acc1 = T(0);
        if (i < nd2) {
          dot_row2(AB, i, DBF0, DBF1, nd2, acc0, acc1);
          UPB0[i] = dot_row(DB, i, DBD, nregp, acc0), UPB1[i] = acc1;
        } else if (i < nd2 + nd) {
          dot_row2(Tl, i - nd2, DBF0, DBF1, nd, acc0, acc1);
          WRK0[i - nd2] = acc0, WRK1[i - nd2] = acc1;
        } else {
          DDN[i - nd2 - nd] = dot_row(El, i - nd2 - nd, DBD, nreg, acc0);
        }
      }
      tm.sync();
      for (int i = tm.lane; i < nd; i += TS) REF[i] = dot_row(DA, i, DDN, nreg, T(0));
      tm.sync();
      for (int i = tm.lane; i < nd; i += TS)
        WRK0[i] = dot_row(Sdn, i, DBD, nreg, dot_row(R, i, REF, nd, WRK0[i]));
      tm.sync();
    }
    // phase 2: the fluxes at layer base, integrated fluxes (:753-761),
    // absorption (:763-788) and walls (:790-802); aux rows [f_wall (nreg) |
    // od (nod) | air abs | veg abs | wall albedo]
    {
      const auto INV = bs.mat(K3_INV, l), AA = bs.mat(K3_AA, l), IDIF = bs.mat(K3_IDIF, l),
                 IDIR = bs.mat(K3_IDIR, l), IDD = bs.mat(K3_IDD, l), X = bs.mat(K3_X, l);
      for (int i = tm.lane; i < nd; i += TS) {
        T acc0 = T(0), acc1 = T(0);
        dot_row2(INV, i, WRK0, WRK1, nd, acc0, acc1);
        DNN0[i] = acc0, DNN1[i] = acc1;
      }
      tm.sync();
      for (int i = tm.lane; i < nd + nreg; i += TS) {
        if (i < nd) {
          T acc0 = T(0), acc1 = T(0);
          dot_row2(AA, i, DNN0, DNN1, nd, acc0, acc1);
          UPA0[i] = acc0 + REF[i], UPA1[i] = acc1;
        } else {
          CONV[i - nd] = DBD[i - nd] - DDN[i - nd];
        }
      }
      tm.sync();
      for (int i = tm.lane; i < nd; i += TS) {
        WRK0[i] = DBF0[i] - DNN0[i] - UPB0[i] + UPA0[i];
        WRK1[i] = DBF1[i] - DNN1[i] - UPB1[i] + UPA1[i];
      }
      tm.sync();
      for (int i = tm.lane; i < nd + nreg; i += TS) {
        T acc0 = T(0), acc1 = T(0);
        if (i < nd) {
          dot_row2(IDIF, i, WRK0, WRK1, nd, acc0, acc1);
          IFD0[i] = dot_row(IDD, i, CONV, nreg, acc0), IFD1[i] = acc1;
        } else {
          IFR[i - nd] = dot_row(IDIR, i - nd, CONV, nreg, acc0);
        }
      }
      tm.sync();
      // the step's sums (sw_down_sums), split over the lanes
      const auto SUM = sm.at(D.sums);
      int per;
      const int nsums = sw_down_sums(nreg, &per);
      for (int j = tm.lane; j < nsums; j += TS) {
        T acc = T(0);
        const int mode = j / per, k = j - mode * per;
        const auto DBF = mode == 0 ? DBF0 : DBF1, UPB = mode == 0 ? UPB0 : UPB1,
                   DNN = mode == 0 ? DNN0 : DNN1, UPA = mode == 0 ? UPA0 : UPA1,
                   IFD = mode == 0 ? IFD0 : IFD1;
        if (mode == 2) {  // ddt, dds
          const auto v = k == 0 ? DBD : DDN;
          for (int r = 0; r < nreg; ++r) acc += v[r];
        } else if (k < 2) {  // roof_in, roof_up
          const auto v = k == 0 ? DBF : UPB;
          SPX_UNROLL4
          for (int a = 0; a < ns; ++a) acc += v[nd + a];
        } else if (k < 6) {  // the profile sums
          const auto v = k == 2 ? DBF : k == 3 ? UPB : k == 4 ? DNN : UPA;
          SPX_UNROLL4
          for (int i = 0; i < nd; ++i) acc += v[i];
        } else {  // ifd_mu, ifd_tan
          const int r = (k - 6) % nreg;
          const T* w = k - 6 < nreg ? rmu : rtan;
          SPX_UNROLL4
          for (int a = 0; a < ns; ++a) acc += IFD[r * ns + a] * w[a];
        }
        SUM[j] = acc;
      }
      tm.sync();
      // the step's output rows, in the order of sw_out_rows
      const auto out = bs.out(l);
      const T ab = X(nreg + nod, 0), vb = X(nreg + nod + 1, 0), wa = X(nreg + nod + 2, 0);
      int row = 0;
      SPX_UNROLL
      for (int mode = 0; mode < 2; ++mode) {
        const bool wd = mode == 0;
        const auto s = SUM.at(mode * per);
        const T roof_in_dir = wd ? zc * DBD[nreg] : T(0);
        const T roof_in = wd ? s[0] + roof_in_dir : s[0], roof_up = s[1];
        T sdt = s[2], sdb = s[4];
        const T sut = s[3], sub = s[5];
        const T ddt = wd ? SUM[2 * per] : T(0), dds = wd ? SUM[2 * per + 1] : T(0);
        T ifd_mu[3], ifd_tan[3], ifr[3];  // nreg <= 3
        for (int r = 0; r < nreg; ++r) {
          ifd_mu[r] = s[6 + r];
          ifd_tan[r] = s[6 + nreg + r];
          ifr[r] = wd ? IFR[r] : T(0);
        }
        const bool w = tm.lane == 0;
        auto put = [&](T v) {
          if (w) out[row] = v;
          ++row;
        };
        put(roof_in);
        put(roof_in - roof_up);
        if (wd) put(roof_in_dir);
        put(ab * (ifr[0] + ifd_mu[0]));
        if (nreg > 1) {
          T va = T(0), vs = T(0), vd = T(0);
          for (int r = 1; r < nreg; ++r) {
            va += ifr[r] + ifd_mu[r];
            vs += (ifr[r] + ifd_mu[r]) * X(nreg + r - 1, 0);
            vd += ifr[r] * X(nreg + r - 1, 0);
          }
          put(ab * va);
          put(vb * vs);
          if (wd) put(vb * vd);
        }
        if (A.do_urban) {
          T wall_in = T(0), wd_sum = T(0);
          for (int r = 0; r < nreg; ++r) {
            wall_in += X(r, 0) * ifd_tan[r];
            wd_sum += X(r, 0) * ifr[r];
          }
          if (wd) {
            put(sin0 * wd_sum);
            wall_in += sin0 * wd_sum;
          }
          put(wall_in);
          put(wall_in * (T(1) - wa));
        }
        if (A.with_profiles) {
          if (wd) {
            put(zc * ddt);
            put(zc * dds);
            sdt += zc * ddt;
            sdb += zc * dds;
          }
          put(sdt);
          put(sut);
          put(sdb);
          put(sub);
        }
      }
      // commit the carries
      for (int i = tm.lane; i < nd + nreg; i += TS) {
        if (i < nd)
          ddif0[i] = DNN0[i], ddif1[i] = DNN1[i];
        else
          ddir[i - nd] = DDN[i - nd];
      }
    }
    bs.store(l);
  }
  if (valid)
    for (int i = tm.lane; i < D.mode; i += TS) A.fin[i * B + b] = slab[i];
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
                      void* outs, void* fin, int nd, int ns, int nreg, int L,
                      int S, int do_urban, int with_profiles, long long B) {
  return DownArgs<T>{(const T*)R,    (const T*)Tm,   (const T*)E,
                     (const T*)Sdn,  (const T*)idir, (const T*)idif,
                     (const T*)idd,  (const T*)stacks, (const T*)vov,
                     (const T*)aux,  (const T*)zcos, (const T*)hw,
                     (const T*)rmu,  (const T*)rtan, (T*)outs, (T*)fin,
                     nd, ns, nreg, L, S, do_urban, with_profiles, B};
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
      void *rtan, void *outs, void *fin, int nd, int ns, int nreg, int L,    \
      int S, int do_urban, int with_profiles, long long B
#define SPX_DOWN_ARGS                                                         \
  R, Tm, E, Sdn, idir, idif, idd, stacks, vov, aux, zcos, hw, rmu, rtan,     \
      outs, fin, nd, ns, nreg, L, S, do_urban, with_profiles, B

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

// K3: teams of TS lanes (spx::down_sweep_teams), the block's elements copied
// ahead into shared memory or (!AHEAD, at TS = 32 only) read from device
// memory.
template <typename T, int TS, bool AHEAD>
__global__ void sw_down_kernel(spx::DownArgs<T> A, spx::SwDownSlab D, int stride, int es) {
  spx::down_sweep_teams<T, TS, AHEAD>(
      spx::sw_down_operands(A), A.B, A.S, A.L, stride, es, D.out, D.n_out, A.outs,
      [&](const spx::Team<TS>& tm, const auto& bs, bool valid, T* slab) {
        spx::sw_down_team<TS>(A, D, tm, bs, valid, slab);
      });
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

// K3 at team size TS: with `configure`, its configuration for A's shape
// and A.B elements (spx::team_config: the slab of sw_down_slab and two
// copy-ahead slots a team, blocks of whole sectors; or, at TS = 32 only,
// the direct-read kernel with its slabs in shared memory) written to info;
// else the launch that info describes.
template <typename T, int TS>
static int run_k3(const spx::DownArgs<T>& A, cudaStream_t stream, long long* info,
                  int configure) {
  auto* ks = &sw_down_kernel<T, TS, true>;
  decltype(ks) kd = TS == 32 ? &sw_down_kernel<T, TS, TS != 32> : nullptr;
  const spx::SwDownSlab D = spx::sw_down_slab(A);
  const int es = spx::slot_stride(spx::sw_down_operands(A), TS, (int)(sizeof(T) / 4));
  if (info == nullptr) return (int)cudaErrorInvalidValue;
  if (configure)
    return (int)spx::team_config<T, TS>(ks, kd, D.size, 2 * es, A.B, info,
                                        (int)(32 / sizeof(T)), true);
  return spx::team_launch(ks, kd, info, stream, A, D, (int)(info[3] / sizeof(T)), es);
}

// K3 by team size (the power of two >= nd, 2 to 32)
template <typename T>
static int run_down(const spx::DownArgs<T>& A, cudaStream_t s, long long* info,
                    int configure) {
  if (A.nd <= 2) return run_k3<T, 2>(A, s, info, configure);
  if (A.nd <= 4) return run_k3<T, 4>(A, s, info, configure);
  if (A.nd <= 8) return run_k3<T, 8>(A, s, info, configure);
  if (A.nd <= 16) return run_k3<T, 16>(A, s, info, configure);
  return run_k3<T, 32>(A, s, info, configure);
}

template <typename T>
static int down_config(int nd, int ns, int nreg, int do_urban, int with_profiles,
                       long long B, long long* info) {
  spx::DownArgs<T> A{};
  A.nd = nd, A.ns = ns, A.nreg = nreg, A.do_urban = do_urban;
  A.with_profiles = with_profiles, A.S = 1, A.B = B;
  return run_down<T>(A, nullptr, info, 1);
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
extern "C" int sw_down_sweep_f32(SPX_DOWN_PARAMS, const long long* cfg, void* stream) {
  return run_down<float>(spx::down_args<float>(SPX_DOWN_ARGS), (cudaStream_t)stream,
                         const_cast<long long*>(cfg), 0);
}
extern "C" int sw_down_sweep_f64(SPX_DOWN_PARAMS, const long long* cfg, void* stream) {
  return run_down<double>(spx::down_args<double>(SPX_DOWN_ARGS), (cudaStream_t)stream,
                          const_cast<long long*>(cfg), 0);
}
extern "C" int sw_down_sweep_config_f32(int nd, int ns, int nreg, int do_urban,
                                        int with_profiles, long long B, long long* info) {
  return down_config<float>(nd, ns, nreg, do_urban, with_profiles, B, info);
}
extern "C" int sw_down_sweep_config_f64(int nd, int ns, int nreg, int do_urban,
                                        int with_profiles, long long B, long long* info) {
  return down_config<double>(nd, ns, nreg, do_urban, with_profiles, B, info);
}
#endif
