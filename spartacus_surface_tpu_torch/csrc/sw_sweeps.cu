// Kernels K2 and K3: the shortwave adding up-sweep and the fused direct +
// diffuse flux down-sweep.
//
// Replace the TPU kernels _sw_up_kernel (spartacus_surface_tpu/ops/
// pallas_sweep.py:109, launched by sw_up_sweep :783) and _sw_down_kernel /
// _sw_down_mode (:233, :260, launched by _sw_down_call :842 with modes
// (direct, diffuse)).  Plain versions: ops/sweep_kernels.py
// sw_up_sweep_plain and sw_down_sweep_plain.
//
// One thread per batch element (column x band); the thread walks the layers
// itself (K2 bottom to top, K3 top to bottom) with its carry in a
// struct-of-arrays global workspace, because GPU blocks share nothing from
// one launch step to the next (the TPU kernels keep the carry in VMEM across
// a sequential (tile, layer) grid).  Per-layer operands are [L, rows, B];
// per-column overlap matrices [L, rows, C] are read at column b / S.
//
// Bound on the H100: device-memory bytes.  K2 reads ~2 nd^2 + 3 nd nreg rows
// and writes the ~2 nd^2 + nd2^2 row stack per layer against O(nd^3) FMAs of
// one solve; K3 reads the stack and ~3 nd^2 rows of operators for O(nd2^2)
// FMAs of matvecs.  K3 runs both normalizations in one layer step so each
// layer's operands are read once.

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
  T *stacks, *top, *ws;
  int nd, ns, nreg, L, S;
  long long B;
};

// K2: SW adding from the ground up (radsurf_urban_sw.F90:590-674).
template <typename T>
SPX_DEV void sw_up_thread(const UpArgs<T>& A, long long b) {
  const int nd = A.nd, ns = A.ns, nreg = A.nreg, nregp = nreg + 1;
  const int nd2 = nregp * ns, n2 = nd * nd, mtot = 2 * nd + nreg;
  const long long B = A.B, C = B / A.S, c = b / A.S;
  const StackLayout sl(nd, ns, nreg);
  auto lay = [&](const T* p, int rows, int l) {
    return Col<T>{const_cast<T*>(p) + (long long)l * rows * B + b, B};
  };
  auto col = [&](const T* p, int rows, int l) {
    return Col<T>{const_cast<T*>(p) + (long long)l * rows * C + c, C};
  };
  const Col<T> AA{A.ws + b, B};
  const Col<T> DA = AA.at(n2), W1 = DA.at(nd * nreg), RHS = W1.at(n2),
               TMP = RHS.at(nd * mtot), TMPD = TMP.at(n2);
  const T galb = A.grd[b], galbd = A.grd[B + b], zc = A.grd[2 * B + b];
  const T* hw = A.hw;

  // ground operators (radsurf_urban_sw.F90:593-602)
  for (int i = 0; i < nd; ++i) {
    for (int j = 0; j < nd; ++j)
      AA[i * nd + j] = (i / ns == j / ns) ? galb * hw[i % ns] : T(0);
    for (int r = 0; r < nreg; ++r)
      DA[i * nreg + r] = (i / ns == r) ? zc * galbd * hw[i % ns] : T(0);
  }

  for (int l = 0; l < A.L; ++l) {
    const Col<T> R = lay(A.R, n2, l), Tl = lay(A.Tm, n2, l),
                 E = lay(A.E, nreg * nreg, l), Sup = lay(A.Sup, nd * nreg, l),
                 Sdn = lay(A.Sdn, nd * nreg, l), st = lay(A.stacks, sl.rows, l);
    // (I - a_above R) X = [a_above T | d_above E + a_above Sdn | I]
    mmc(W1, AA, R, nd, nd, nd);
    for (int i = 0; i < n2; ++i) W1[i] = T(i / nd == i % nd) - W1[i];
    mm(RHS, mtot, AA, nd, Tl, nd, nd, nd, nd);
    mm(RHS.at(nd), mtot, DA, nreg, E, nreg, nd, nreg, nreg);
    mm(RHS.at(nd), mtot, AA, nd, Sdn, nreg, nd, nd, nreg, true);
    for (int i = 0; i < nd; ++i)
      for (int j = 0; j < nd; ++j) RHS[i * mtot + nd + nreg + j] = T(i == j);
    solve_inplace(W1, nd, RHS, mtot, nd, mtot);

    // stack: entry carry, inv(denom), a_below / d_below with exposed-roof
    // rows (radsurf_urban_sw.F90:607-643)
    copy(st.at(sl.aa), AA, n2);
    copy(st.at(sl.da), DA, nd * nreg);
    for (int i = 0; i < nd; ++i)
      for (int j = 0; j < nd; ++j)
        st[sl.inv + i * nd + j] = RHS[i * mtot + nd + nreg + j];
    fill(st.at(sl.ab), nd2 * nd2, T(0));
    fill(st.at(sl.db), nd2 * nregp, T(0));
    for (int i = 0; i < nd; ++i) {
      for (int j = 0; j < nd; ++j) {
        T acc = R[i * nd + j];
        for (int k = 0; k < nd; ++k) acc += Tl[i * nd + k] * RHS[k * mtot + j];
        st[sl.ab + i * nd2 + j] = acc;
      }
      for (int r = 0; r < nreg; ++r) {
        T acc = Sup[i * nreg + r];
        for (int k = 0; k < nd; ++k) acc += Tl[i * nd + k] * RHS[k * mtot + nd + r];
        st[sl.db + i * nregp + r] = acc;
      }
    }
    const T ralb = A.ralb[(long long)l * B + b], ralbd = A.ralbd[(long long)l * B + b];
    for (int u = 0; u < ns; ++u) {
      for (int v = 0; v < ns; ++v) st[sl.ab + (nd + u) * nd2 + nd + v] = ralb * hw[u];
      st[sl.db + (nd + u) * nregp + nreg] = zc * ralbd * hw[u];
    }

    // overlap to just above the interface (radsurf_urban_sw.F90:646-653):
    // (u (x) I_ns) a_below (v (x) I_ns) and (u (x) I_ns) d_below v
    const Col<T> U = col(A.uov, nreg * nregp, l), V = col(A.vov, nregp * nreg, l);
    for (int t = 0; t < nreg; ++t)
      for (int a = 0; a < ns; ++a) {
        for (int f = 0; f < nreg; ++f)
          for (int v = 0; v < ns; ++v) {
            T acc = T(0);
            for (int q = 0; q < nregp; ++q)
              for (int r = 0; r < nregp; ++r)
                acc += U[t * nregp + q] * V[r * nreg + f] *
                       st[sl.ab + (q * ns + a) * nd2 + r * ns + v];
            TMP[(t * ns + a) * nd + f * ns + v] = acc;
          }
        T dacc[4];  // nreg + 1 <= 4
        for (int r = 0; r < nregp; ++r) {
          dacc[r] = T(0);
          for (int q = 0; q < nregp; ++q)
            dacc[r] += U[t * nregp + q] * st[sl.db + (q * ns + a) * nregp + r];
        }
        for (int f = 0; f < nreg; ++f) {
          T acc = T(0);
          for (int r = 0; r < nregp; ++r) acc += dacc[r] * V[r * nreg + f];
          TMPD[(t * ns + a) * nreg + f] = acc;
        }
      }
    copy(AA, TMP, n2);
    copy(DA, TMPD, nd * nreg);
  }
  const Col<T> top{A.top + b, B};
  copy(top, AA, n2);
  copy(top.at(n2), DA, nd * nreg);
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
                   (T*)top,        (T*)ws,         nd, ns, nreg, L, S, B};
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
template <typename T>
__global__ void sw_up_kernel(spx::UpArgs<T> A) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b < A.B) spx::sw_up_thread(A, b);
}

template <typename T>
__global__ void sw_down_kernel(spx::DownArgs<T> A) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b < A.B) spx::sw_down_thread(A, b);
}

static unsigned n_blocks(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

template <typename T>
static int launch_up(SPX_UP_PARAMS, void* stream) {
  sw_up_kernel<T><<<n_blocks(B, 128), 128, 0, (cudaStream_t)stream>>>(
      spx::up_args<T>(SPX_UP_ARGS));
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_down(SPX_DOWN_PARAMS, void* stream) {
  sw_down_kernel<T><<<n_blocks(B, 128), 128, 0, (cudaStream_t)stream>>>(
      spx::down_args<T>(SPX_DOWN_ARGS));
  return (int)cudaGetLastError();
}

extern "C" int sw_up_sweep_f32(SPX_UP_PARAMS, void* stream) {
  return launch_up<float>(SPX_UP_ARGS, stream);
}
extern "C" int sw_up_sweep_f64(SPX_UP_PARAMS, void* stream) {
  return launch_up<double>(SPX_UP_ARGS, stream);
}
extern "C" int sw_down_sweep_f32(SPX_DOWN_PARAMS, void* stream) {
  return launch_down<float>(SPX_DOWN_ARGS, stream);
}
extern "C" int sw_down_sweep_f64(SPX_DOWN_PARAMS, void* stream) {
  return launch_down<double>(SPX_DOWN_ARGS, stream);
}
#endif
