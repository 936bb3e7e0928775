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
// K5: one thread per element walks the layers top to bottom with its carry
// in a struct-of-arrays global workspace, as K3 does; it reads the stack
// and ~3 nd^2 + 2 nd rows of operators per layer for the O(nd2^2) FMAs of
// its matvecs (bound by bytes), and runs both source modes in one layer
// step so each layer's operands and stack are read once.

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
// K4: teams of TS lanes (spx::up_sweep_teams), as K2's kernel.
template <typename T, int TS, bool GLOBAL>
__global__ void lw_up_kernel(spx::LwUpArgs<T> A, spx::UpSlab S, int stride) {
  spx::up_sweep_teams<T, TS, GLOBAL>(
      spx::lw_up_operands(A), A.B, A.S, A.L, A.ws, stride,
      [&](const spx::Team<TS>& tm, const auto& rd, bool valid, T* slab) {
        spx::lw_up_team<TS, TS>(A, S, tm, rd, valid, slab);
      });
}

template <typename T>
__global__ void lw_down_kernel(spx::LwDownArgs<T> A) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b < A.B) spx::lw_down_thread(A, b);
}

static unsigned n_blocks(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
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

template <typename T>
static int launch_lw_down(SPX_LW_DOWN_PARAMS, void* stream) {
  lw_down_kernel<T><<<n_blocks(B, 128), 128, 0, (cudaStream_t)stream>>>(
      spx::lw_down_args<T>(SPX_LW_DOWN_ARGS));
  return (int)cudaGetLastError();
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
extern "C" int lw_down_sweep_f32(SPX_LW_DOWN_PARAMS, void* stream) {
  return launch_lw_down<float>(SPX_LW_DOWN_ARGS, stream);
}
extern "C" int lw_down_sweep_f64(SPX_LW_DOWN_PARAMS, void* stream) {
  return launch_lw_down<double>(SPX_LW_DOWN_ARGS, stream);
}
#endif
