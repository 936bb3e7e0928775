// Kernels K4 and K5: the longwave adding up-sweep with emission sources and
// the fused longwave flux down-sweep (internal emission + unit incoming).
//
// Replace the TPU kernels _lw_up_kernel (spartacus_surface_tpu/ops/
// pallas_sweep.py:430, launched by lw_up_sweep :964) and _lw_down_kernel /
// _lw_down_mode (:533, :552, launched by _lw_down_call :1020 with modes
// (internal, incoming)).  Plain versions: ops/lw_sweep_kernels.py
// lw_up_sweep_plain and lw_down_sweep_plain.
//
// One thread per batch element (column x band, b = c S + s); the thread
// walks the layers itself (K4 bottom to top, K5 top to bottom) with its
// carry in a struct-of-arrays global workspace, as K2 and K3 do: GPU blocks
// share nothing from one launch step to the next, where the TPU kernels
// keep the carry in VMEM across a sequential (tile, layer) grid.  Per-layer
// operands are [L, rows, B]; per-column overlap matrices [L, rows, C] are
// read at column b / S.  The ground operators depend only on the element, so
// K4 builds them in the thread instead of reading them.
//
// Bound on the H100: device-memory bytes.  K4 reads ~2 nd^2 + nd rows of
// layer operators and writes the 2 nd^2 + nd + nd2^2 + nd2 row stack per
// layer against the O(nd^3) FMAs of one solve with 2 nd + 1 right-hand
// sides; K5 reads the stack and ~3 nd^2 + 2 nd rows of operators for the
// O(nd2^2) FMAs of its matvecs.  K5 runs both source modes in one layer step
// so each layer's operands and stack are read once.

#include "common.cuh"

namespace spx {

// Stack layout per layer: [a_above | source_above | inv(I - a_above R) |
// a_below | source_below] (ops/lw_sweep_kernels.py lw_stack_rows).
struct LwStackLayout {
  int aa, sa, inv, ab, sb, rows;
  SPX_DEV LwStackLayout(int nd, int ns, int nreg) {
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
  T *stacks, *top, *ws;
  int nd, ns, nreg, L, S;
  long long B;
};

// K4: LW adding from the ground up (radsurf_urban_lw.F90:551-637).
template <typename T>
SPX_DEV void lw_up_thread(const LwUpArgs<T>& A, long long b) {
  const int nd = A.nd, ns = A.ns, nreg = A.nreg, nregp = nreg + 1;
  const int nd2 = nregp * ns, n2 = nd * nd, mtot = 2 * nd + 1;
  const long long B = A.B, C = B / A.S, c = b / A.S;
  const LwStackLayout sl(nd, ns, nreg);
  auto lay = [&](const T* ptr, int rows, int l) {
    return Col<T>{const_cast<T*>(ptr) + (long long)l * rows * B + b, B};
  };
  auto col = [&](const T* ptr, int rows, int l) {
    return Col<T>{const_cast<T*>(ptr) + (long long)l * rows * C + c, C};
  };
  // workspace: AA | SRC | W1 | RHS | TMP | TMPS
  const Col<T> AA{A.ws + b, B};
  const Col<T> SRC = AA.at(n2), W1 = SRC.at(nd), RHS = W1.at(n2),
               TMP = RHS.at(nd * mtot), TMPS = TMP.at(n2);
  const T geps = A.grd[b], gemit = A.grd[B + b];
  const T* hw = A.hw;

  // ground operators (radsurf_urban_lw.F90:551-565):
  // a_ground[(r,n),(r2,m)] = (1 - emissivity) hw[n] delta(r, r2),
  // source_ground[(r,n)] = emission frac0[r] hw[n]
  for (int i = 0; i < nd; ++i) {
    for (int j = 0; j < nd; ++j)
      AA[i * nd + j] = (i / ns == j / ns) ? (T(1) - geps) * hw[i % ns] : T(0);
    SRC[i] = gemit * A.grd[(2 + i / ns) * B + b] * hw[i % ns];
  }

  for (int l = 0; l < A.L; ++l) {
    const Col<T> R = lay(A.R, n2, l), Tl = lay(A.Tm, n2, l),
                 P = lay(A.p, nd, l), st = lay(A.stacks, sl.rows, l);
    // (I - a_above R) X = [a_above T | source_above + a_above p | I]
    mmc(W1, AA, R, nd, nd, nd);
    for (int i = 0; i < n2; ++i) W1[i] = T(i / nd == i % nd) - W1[i];
    mm(RHS, mtot, AA, nd, Tl, nd, nd, nd, nd);
    for (int i = 0; i < nd; ++i) {
      T acc = SRC[i];
      for (int k = 0; k < nd; ++k) acc += AA[i * nd + k] * P[k];
      RHS[i * mtot + nd] = acc;
      for (int j = 0; j < nd; ++j) RHS[i * mtot + nd + 1 + j] = T(i == j);
    }
    solve_inplace(W1, nd, RHS, mtot, nd, mtot);

    // stack: entry carry, inv(denom), a_below / source_below with the
    // exposed-roof rows (Eq. 34, radsurf_urban_lw.F90:567-605)
    copy(st.at(sl.aa), AA, n2);
    copy(st.at(sl.sa), SRC, nd);
    for (int i = 0; i < nd; ++i)
      for (int j = 0; j < nd; ++j)
        st[sl.inv + i * nd + j] = RHS[i * mtot + nd + 1 + j];
    fill(st.at(sl.ab), nd2 * nd2, T(0));
    for (int i = 0; i < nd; ++i) {
      for (int j = 0; j < nd; ++j) {
        T acc = R[i * nd + j];
        for (int k = 0; k < nd; ++k) acc += Tl[i * nd + k] * RHS[k * mtot + j];
        st[sl.ab + i * nd2 + j] = acc;
      }
      T acc = P[i];
      for (int k = 0; k < nd; ++k) acc += Tl[i * nd + k] * RHS[k * mtot + nd];
      st[sl.sb + i] = acc;
    }
    const long long lb = (long long)l * B + b;
    const T roof_refl = T(1) - A.reps[lb], roof_src = A.remit[lb] * A.exposed[lb];
    for (int u = 0; u < ns; ++u) {
      for (int v = 0; v < ns; ++v) st[sl.ab + (nd + u) * nd2 + nd + v] = roof_refl * hw[u];
      st[sl.sb + nd + u] = roof_src * hw[u];
    }

    // overlap to just above the interface (radsurf_urban_lw.F90:620-627):
    // (u (x) I_ns) a_below (v (x) I_ns) and (u (x) I_ns) source_below
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
        T acc = T(0);
        for (int q = 0; q < nregp; ++q) acc += U[t * nregp + q] * st[sl.sb + q * ns + a];
        TMPS[t * ns + a] = acc;
      }
    copy(AA, TMP, n2);
    copy(SRC, TMPS, nd);
  }
  const Col<T> top{A.top + b, B};
  copy(top, AA, n2);
  copy(top.at(n2), SRC, nd);
}

template <typename T>
struct LwDownArgs {
  const T *R, *Tm, *p, *idif, *isrc, *stacks, *vov, *aux, *hw, *rmu, *rtan;
  T *outs, *fin, *ws;
  int nd, ns, nreg, L, S, do_urban, with_profiles;
  long long B;
};

// Output rows of one mode, in the order of lw_out_rows.
SPX_DEV int lw_out_count(int nreg, int do_urban, int with_profiles) {
  return 3 + (nreg > 1 ? 2 : 0) + (do_urban ? 2 : 0) + (with_profiles ? 4 : 0);
}

// K5: LW fluxes from the canopy top down, internal-emission and incoming
// modes (radsurf_urban_lw.F90:639-805).
template <typename T>
SPX_DEV void lw_down_thread(const LwDownArgs<T>& A, long long b) {
  const int nd = A.nd, ns = A.ns, nreg = A.nreg, nregp = nreg + 1;
  const int nd2 = nregp * ns, n2 = nd * nd, nod = nreg > 1 ? nreg - 1 : 1;
  // aux rows: [f_wall (nreg) | od (nod) | ab | vb | weps | sub_air |
  // sub_vegair | sub_veg | sub_wall]
  const int a_ab = nreg + nod, n_aux = nreg + nod + 7;
  const int n_rows = lw_out_count(nreg, A.do_urban, A.with_profiles);
  const long long B = A.B, C = B / A.S, c = b / A.S;
  const LwStackLayout sl(nd, ns, nreg);
  auto lay = [&](const T* ptr, int rows, int l) {
    return Col<T>{const_cast<T*>(ptr) + (long long)l * rows * B + b, B};
  };
  // workspace: DN (2 modes x nd) | DBF | UPB | WRK | DNN | UPA | IFL
  const Col<T> DN{A.ws + b, B};
  const Col<T> DBF = DN.at(2 * nd), UPB = DBF.at(nd2), WRK = UPB.at(nd2),
               DNN = WRK.at(nd), UPA = DNN.at(nd), IFL = UPA.at(nd);
  const T *hw = A.hw, *rmu = A.rmu, *rtan = A.rtan;

  // TOC conditions (radsurf_urban_lw.F90:639-651): mode 0 (internal
  // emission) starts from zero, mode 1 (incoming) from dn = hw in region 0
  fill(DN, 2 * nd, T(0));
  for (int a = 0; a < ns; ++a) DN[nd + a] = hw[a];

  for (int l = A.L - 1; l >= 0; --l) {
    const Col<T> R = lay(A.R, n2, l), Tl = lay(A.Tm, n2, l),
                 P = lay(A.p, nd, l), idif = lay(A.idif, n2, l),
                 isrc = lay(A.isrc, nd, l), st = lay(A.stacks, sl.rows, l),
                 X = lay(A.aux, n_aux, l), out = lay(A.outs, 2 * n_rows, l);
    const Col<T> V{const_cast<T*>(A.vov) + (long long)l * nregp * nreg * C + c, C};
    int row = 0;
    for (int mode = 0; mode < 2; ++mode) {
      const bool src = mode == 0;
      const Col<T> dn = DN.at(mode * nd);
      // translate across the interface at layer top (:656-660)
      for (int q = 0; q < nregp; ++q)
        for (int a = 0; a < ns; ++a) {
          T acc = T(0);
          for (int r = 0; r < nreg; ++r) acc += V[q * nreg + r] * dn[r * ns + a];
          DBF[q * ns + a] = acc;
        }
      mv(UPB, st.at(sl.ab), DBF, nd2, nd2);
      if (src)
        for (int i = 0; i < nd2; ++i) UPB[i] += st[sl.sb + i];
      T roof_in = T(0), roof_up = T(0);
      for (int a = 0; a < ns; ++a) {
        roof_in += DBF[nd + a];
        roof_up += UPB[nd + a];
      }
      // fluxes at layer base (:676-690)
      mv(WRK, Tl, DBF, nd, nd);
      if (src) {
        mv(WRK, R, st.at(sl.sa), nd, nd, true);
        for (int i = 0; i < nd; ++i) WRK[i] += P[i];
      }
      mv(DNN, st.at(sl.inv), WRK, nd, nd);
      mv(UPA, st.at(sl.aa), DNN, nd, nd);
      if (src)
        for (int i = 0; i < nd; ++i) UPA[i] += st[sl.sa + i];
      T sdt = T(0), sut = T(0), sdb = T(0), sub = T(0);
      for (int i = 0; i < nd; ++i) {
        sdt += DBF[i];
        sut += UPB[i];
        sdb += DNN[i];
        sub += UPA[i];
      }
      // integrated fluxes (:706-712)
      for (int i = 0; i < nd; ++i) WRK[i] = DBF[i] - DNN[i] - UPB[i] + UPA[i];
      mv(IFL, idif, WRK, nd, nd);
      if (src)
        for (int i = 0; i < nd; ++i) IFL[i] += isrc[i];
      T if_mu[3], if_tan[3];  // nreg <= 3
      for (int r = 0; r < nreg; ++r) {
        if_mu[r] = T(0);
        if_tan[r] = T(0);
        for (int a = 0; a < ns; ++a) {
          if_mu[r] += IFL[r * ns + a] * rmu[a];
          if_tan[r] += IFL[r * ns + a] * rtan[a];
        }
      }
      // absorption minus emission (:714-757) and walls (:759-771)
      const T ab = X[a_ab], vb = X[a_ab + 1], weps = X[a_ab + 2];
      out[row++] = roof_in;
      out[row++] = roof_in - roof_up;
      out[row++] = ab * if_mu[0] - (src ? X[a_ab + 3] : T(0));
      if (nreg > 1) {
        T va = T(0), vs = T(0);
        for (int r = 1; r < nreg; ++r) {
          va += if_mu[r];
          vs += if_mu[r] * X[nreg + r - 1];
        }
        out[row++] = ab * va - (src ? X[a_ab + 4] : T(0));
        out[row++] = vb * vs - (src ? X[a_ab + 5] : T(0));
      }
      if (A.do_urban) {
        T wall_in = T(0);
        for (int r = 0; r < nreg; ++r) wall_in += X[r] * if_tan[r];
        out[row++] = wall_in;
        out[row++] = wall_in * weps - (src ? X[a_ab + 6] : T(0));
      }
      if (A.with_profiles) {
        out[row++] = sdt;
        out[row++] = sut;
        out[row++] = sdb;
        out[row++] = sub;
      }
      copy(dn, DNN, nd);
    }
  }
  const Col<T> fin{A.fin + b, B};
  copy(fin, DN, 2 * nd);
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
                           void* rmu, void* rtan, void* outs, void* fin,
                           void* ws, int nd, int ns, int nreg, int L, int S,
                           int do_urban, int with_profiles, long long B) {
  return LwDownArgs<T>{(const T*)R,    (const T*)Tm,   (const T*)p,
                       (const T*)idif, (const T*)isrc, (const T*)stacks,
                       (const T*)vov,  (const T*)aux,  (const T*)hw,
                       (const T*)rmu,  (const T*)rtan, (T*)outs,
                       (T*)fin,        (T*)ws,         nd, ns, nreg, L, S,
                       do_urban,       with_profiles,  B};
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
      void *fin, void *ws, int nd, int ns, int nreg, int L, int S,           \
      int do_urban, int with_profiles, long long B
#define SPX_LW_DOWN_ARGS                                                      \
  R, Tm, p, idif, isrc, stacks, vov, aux, hw, rmu, rtan, outs, fin, ws, nd,  \
      ns, nreg, L, S, do_urban, with_profiles, B

#ifdef __CUDACC__
template <typename T>
__global__ void lw_up_kernel(spx::LwUpArgs<T> A) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b < A.B) spx::lw_up_thread(A, b);
}

template <typename T>
__global__ void lw_down_kernel(spx::LwDownArgs<T> A) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b < A.B) spx::lw_down_thread(A, b);
}

static unsigned n_blocks(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

template <typename T>
static int launch_lw_up(SPX_LW_UP_PARAMS, void* stream) {
  lw_up_kernel<T><<<n_blocks(B, 128), 128, 0, (cudaStream_t)stream>>>(
      spx::lw_up_args<T>(SPX_LW_UP_ARGS));
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_lw_down(SPX_LW_DOWN_PARAMS, void* stream) {
  lw_down_kernel<T><<<n_blocks(B, 128), 128, 0, (cudaStream_t)stream>>>(
      spx::lw_down_args<T>(SPX_LW_DOWN_ARGS));
  return (int)cudaGetLastError();
}

extern "C" int lw_up_sweep_f32(SPX_LW_UP_PARAMS, void* stream) {
  return launch_lw_up<float>(SPX_LW_UP_ARGS, stream);
}
extern "C" int lw_up_sweep_f64(SPX_LW_UP_PARAMS, void* stream) {
  return launch_lw_up<double>(SPX_LW_UP_ARGS, stream);
}
extern "C" int lw_down_sweep_f32(SPX_LW_DOWN_PARAMS, void* stream) {
  return launch_lw_down<float>(SPX_LW_DOWN_ARGS, stream);
}
extern "C" int lw_down_sweep_f64(SPX_LW_DOWN_PARAMS, void* stream) {
  return launch_lw_down<double>(SPX_LW_DOWN_ARGS, stream);
}
#endif
