// Shared helpers of the hand-written SPARTACUS kernels.
//
// Operands and results are struct-of-arrays: an element's matrix of n x m
// rows lives at p[i * s] (row-major entry i, stride s = the batch), so
// neighbouring elements' copies of one entry are neighbours in memory.  The
// layer factory (K1, and K1d, its dense branch) and the sweeps (K2-K5)
// give each element a team of TS lanes of one warp and a contiguous slab
// of shared memory; the team forms below (Team, Mat, tmm,
// tsolve, dot_row) split a matrix's rows over the lanes, and a team of one
// lane (TS = 1) runs them as plain loops.  The up-sweeps' warps
// (OperandReader) and the down-sweeps' blocks (BlockSweep) copy each
// layer's operands ahead into shared memory.  team_config / team_launch
// (CUDA only) choose and launch the six team kernels' block shapes.
//
// The bodies are plain C++ on scalars.  Built with nvcc they are device
// functions; built by a host C++ compiler (see host_check.cpp) the same
// arithmetic runs on the CPU, one "thread" (or a team of one) at a time,
// which lets the CPU tests check the kernels' indexing and algebra without
// a GPU.

#pragma once

#include <type_traits>
#include <utility>

#ifdef __CUDACC__
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#define SPX_DEV __device__ __forceinline__
#define SPX_HD __host__ __device__ inline
#define SPX_UNROLL _Pragma("unroll")
#define SPX_UNROLL4 _Pragma("unroll 4")
#else
#include <cmath>
#define SPX_DEV inline
#define SPX_HD inline
#define SPX_UNROLL
#define SPX_UNROLL4
namespace spx {
using std::ceil;
using std::fabs;
using std::fma;
using std::fmax;
using std::fmin;
using std::ldexp;
using std::log2;
using std::sqrt;
}  // namespace spx
#endif

namespace spx {

// One thread's strided view of a struct-of-arrays buffer.
template <typename T>
struct Col {
  using value_type = T;
  using index_type = long long;
  T* p;
  long long s;
  SPX_DEV T& operator[](long long i) const { return p[i * s]; }
  SPX_DEV Col at(long long k) const { return Col{p + k * s, s}; }
};

// A contiguous view: a team's slab of shared memory (or a host buffer).
template <typename T>
struct Sh {
  using value_type = T;
  using index_type = int;  // a slab is far below 2^31 entries
  T* p;
  SPX_DEV T& operator[](int i) const { return p[i]; }
  SPX_DEV Sh at(int k) const { return Sh{p + k}; }
};

// A strided view of shared memory: an element's copy of its operands in
// its warp's copy-ahead buffer (32-bit indexing).
template <typename T>
struct ShS {
  using value_type = T;
  using index_type = int;
  T* p;
  int s;
  SPX_DEV T& operator[](int i) const { return p[i * s]; }
  SPX_DEV ShS at(int k) const { return ShS{p + k * s, s}; }
};

// A row-major matrix on a view V (Col, Sh or ShS) with row stride ld.
template <class V>
struct Mat {
  using T = typename V::value_type;
  using I = typename V::index_type;
  V v;
  int ld;
  SPX_DEV T& operator()(int i, int j) const { return v[(I)i * ld + j]; }
  SPX_DEV Mat sub(int i, int j) const { return Mat{v.at((I)i * ld + j), ld}; }
};

template <class V>
SPX_DEV Mat<V> mat(V v, int ld) {
  return Mat<V>{v, ld};
}

template <class M>
using elem_t = std::remove_reference_t<decltype(std::declval<M>()(0, 0))>;

// A team of TS lanes of one warp that works on one element: lane `lane`
// owns rows lane, lane + TS, ... of every matrix it writes; sync() orders
// the team's shared-memory accesses (nothing for a team of one).
template <int TS>
struct Team {
  int lane;
  unsigned mask;  // the team's lanes within the warp
  SPX_DEV void sync() const {
#ifdef __CUDACC__
    if (TS > 1) __syncwarp(mask);
#endif
  }
};

// Team product: out (n x m) (+)= a (n x p) @ b (p x m), each lane its own
// rows; b is read whole by every lane (a broadcast).  Where p <= CAP a
// lane keeps its row of a in registers and, with JU > 1, computes JU
// entries of its row at once (JU independent sums).  Each entry sums its
// products over k = 0, ..., p - 1 in order (after `out` where it
// accumulates).  `out` must not alias `a` or `b`.  Ends with a team
// sync.
template <int TS, int CAP, int JU = 1, class MO, class MA, class MB>
SPX_DEV void tmm(const Team<TS>& tm, MO out, MA a, MB b, int n, int p, int m,
                 bool accumulate = false) {
  using T = elem_t<MO>;
  constexpr int C = CAP > 0 ? CAP : 1;
  for (int i = tm.lane; i < n; i += TS) {
    if (CAP > 0 && p <= CAP) {
      T ar[C];
      SPX_UNROLL
      for (int k = 0; k < C; ++k)
        if (k < p) ar[k] = a(i, k);
      int j = 0;
      for (; JU > 1 && j + JU <= m; j += JU) {
        T acc[JU];
        SPX_UNROLL
        for (int u = 0; u < JU; ++u) acc[u] = accumulate ? out(i, j + u) : T(0);
        SPX_UNROLL
        for (int k = 0; k < C; ++k)
          if (k < p)
            SPX_UNROLL
            for (int u = 0; u < JU; ++u) acc[u] += ar[k] * b(k, j + u);
        SPX_UNROLL
        for (int u = 0; u < JU; ++u) out(i, j + u) = acc[u];
      }
      for (; j < m; ++j) {
        T acc = accumulate ? out(i, j) : T(0);
        SPX_UNROLL
        for (int k = 0; k < C; ++k)
          if (k < p) acc += ar[k] * b(k, j);
        out(i, j) = acc;
      }
    } else {
      for (int j = 0; j < m; ++j) {
        T acc = accumulate ? out(i, j) : T(0);
        for (int k = 0; k < p; ++k) acc += a(i, k) * b(k, j);
        out(i, j) = acc;
      }
    }
  }
  tm.sync();
}

// acc + sum_k a(i, k) x[k], k = 0, ..., p - 1 in order (four terms' loads
// at once, so a lane waits once for four shared-memory loads)
template <typename T, class MA, class VX>
SPX_DEV T dot_row(const MA& a, int i, const VX& x, int p, T acc) {
  int k = 0;
  for (; k + 4 <= p; k += 4) {
    T av[4], xv[4];
    SPX_UNROLL
    for (int u = 0; u < 4; ++u) av[u] = a(i, k + u), xv[u] = x[k + u];
    SPX_UNROLL
    for (int u = 0; u < 4; ++u) acc += av[u] * xv[u];
  }
  for (; k < p; ++k) acc += a(i, k) * x[k];
  return acc;
}

// dot_row on two vectors at once: acc0 + a(i, :) x0 and acc1 + a(i, :) x1,
// each in order, each entry of a loaded once
template <typename T, class MA, class VX>
SPX_DEV void dot_row2(const MA& a, int i, const VX& x0, const VX& x1, int p, T& acc0,
                      T& acc1) {
  int k = 0;
  for (; k + 4 <= p; k += 4) {
    T av[4], y0[4], y1[4];
    SPX_UNROLL
    for (int u = 0; u < 4; ++u) av[u] = a(i, k + u), y0[u] = x0[k + u], y1[u] = x1[k + u];
    SPX_UNROLL
    for (int u = 0; u < 4; ++u) acc0 += av[u] * y0[u], acc1 += av[u] * y1[u];
  }
  for (; k < p; ++k) {
    const T av = a(i, k);
    acc0 += av * x0[k], acc1 += av * x1[k];
  }
}

// Team pivot-free solve a X = rhs (a n x n, destroyed; rhs n x m,
// overwritten by X).  The SPARTACUS matrices are diagonally dominant by
// construction, as in the reference's unpivoted LU
// (radtool_matrix.F90:982-1055).  The elimination splits the rows over the
// lanes, one broadcast pivot row per step; the back substitution splits the
// columns.  Ends with a team sync.
template <int TS, class MA, class MB>
SPX_DEV void tsolve(const Team<TS>& tm, MA a, MB rhs, int n, int m) {
  using T = elem_t<MA>;
  for (int k = 0; k < n - 1; ++k) {
    const T piv = T(1) / a(k, k);
    for (int i = tm.lane; i < n; i += TS) {
      if (i <= k) continue;
      const T f = a(i, k) * piv;
      for (int j = k + 1; j < n; ++j) a(i, j) -= f * a(k, j);
      for (int j = 0; j < m; ++j) rhs(i, j) -= f * rhs(k, j);
    }
    tm.sync();
  }
  for (int i = n - 1; i >= 0; --i) {
    const T rd = T(1) / a(i, i);
    for (int j = tm.lane; j < m; j += TS) {
      T acc = rhs(i, j);
      for (int k = i + 1; k < n; ++k) acc -= a(i, k) * rhs(k, j);
      rhs(i, j) = acc * rd;
    }
  }
  tm.sync();
}

// Team copy dst (n x m) = src, each lane its own rows; ends with a sync.
template <int TS, class MD, class MS>
SPX_DEV void tcopy(const Team<TS>& tm, MD dst, MS src, int n, int m) {
  for (int i = tm.lane; i < n; i += TS)
    for (int j = 0; j < m; ++j) dst(i, j) = src(i, j);
  tm.sync();
}

// Team identity dst (n x n) = I; ends with a sync.
template <int TS, class MD>
SPX_DEV void teye(const Team<TS>& tm, MD dst, int n) {
  using T = elem_t<MD>;
  for (int i = tm.lane; i < n; i += TS)
    for (int j = 0; j < n; ++j) dst(i, j) = T(i == j);
  tm.sync();
}

// An up-sweep's slab (K2, K4), per element: the carry [AA | D] (nd x nd
// and nd x nq: nq = nreg for K2's d_above, 1 for K4's source_above) and W1,
// the solve's nd x nd matrix, which a_below and its second block (nd2 x
// nd2, nd2 x nqb) overlay once the solve is done; then RHS (nd x (2 nd +
// nq)), which the next carry (NA, ND) overlays once a_below is built.  Odd
// row strides for the nd-, nd2- and RHS-wide rows, so a team's lanes
// reading their own rows hit distinct banks.
struct UpSlab {
  int ldn, ld2, ldr, aa, da, w1, ab, db, rhs, na, nda, size;
};

SPX_HD UpSlab up_slab(int nd, int ns, int nreg, int nq, int nqb) {
  UpSlab S{};
  const int nd2 = (nreg + 1) * ns;
  S.ldn = nd | 1;
  S.ld2 = nd2 | 1;
  S.ldr = (2 * nd + nq) | 1;
  S.aa = 0;
  S.da = nd * S.ldn;
  S.w1 = S.da + nd * nq;
  S.ab = 0;
  S.db = nd2 * S.ld2;
  const int end_a = S.w1 + nd * S.ldn, end_b = S.db + nd2 * nqb;
  S.rhs = end_a > end_b ? end_a : end_b;
  S.na = S.rhs;
  S.nda = S.rhs + nd * S.ldn;
  S.size = S.rhs + nd * S.ldr;
  return S;
}

// The up-sweeps' overlap to just above an interface, (u (x) I_ns) a_below
// (v (x) I_ns): u holds row t of the nreg x nregp matrix U; uv[q * 4 + r]
// = u[q] V[r, f] for one column f of the nregp x nreg matrix V; an entry of
// the next carry sums uv[q, r] a_below[(q, a), (r, v)] over q, then r
// (radsurf_urban_sw.F90:646-653, radsurf_urban_lw.F90:620-627).  a_below's
// first nd rows are R + T X (below_row).
// (The loops run to 4 with guards, so that on the card u and uv are
// registers.)
template <typename T, class VU>
SPX_DEV void overlap_weights(const VU& U, int t, int nregp, T* u) {
  SPX_UNROLL
  for (int q = 0; q < 4; ++q)
    if (q < nregp) u[q] = U[t * nregp + q];
}

template <typename T, class VV>
SPX_DEV void overlap_weights(const T* u, const VV& V, int f, int nreg, T* uv) {
  SPX_UNROLL
  for (int q = 0; q < 4; ++q)
    SPX_UNROLL
    for (int r = 0; r < 4; ++r)
      if (q <= nreg && r <= nreg) uv[q * 4 + r] = u[q] * V[r * nreg + f];
}

// NA(i, f * ns + v) for every v: four entries at once.
template <typename T, class M, class MN>
SPX_DEV void overlap_row(const T* uv, const M& AB, const MN& NA, int i, int a,
                         int f, int ns, int nregp) {
  for (int v0 = 0; v0 < ns; v0 += 4) {
    T acc[4] = {T(0), T(0), T(0), T(0)};
    SPX_UNROLL
    for (int q = 0; q < 4; ++q)
      SPX_UNROLL
      for (int r = 0; r < 4; ++r)
        if (q < nregp && r < nregp)
          SPX_UNROLL
          for (int u = 0; u < 4; ++u)
            if (v0 + u < ns) acc[u] += uv[q * 4 + r] * AB(q * ns + a, r * ns + v0 + u);
    SPX_UNROLL
    for (int u = 0; u < 4; ++u)
      if (v0 + u < ns) NA(i, f * ns + v0 + u) = acc[u];
  }
}

// Row i of R + T X over the first nd columns of X: four entries at once,
// each summing R(i, j) then T(i, k) X(k, j) over k in order.
template <class MR, class MT, class MX, class MO>
SPX_DEV void below_row(const MR& R, const MT& Tl, const MX& X, const MO& out, int i,
                       int nd) {
  using T = elem_t<MO>;
  for (int j0 = 0; j0 < nd; j0 += 4) {
    T acc[4];
    SPX_UNROLL
    for (int u = 0; u < 4; ++u) acc[u] = j0 + u < nd ? R(i, j0 + u) : T(0);
    for (int k = 0; k < nd; ++k) {
      const T t = Tl(i, k);
      SPX_UNROLL
      for (int u = 0; u < 4; ++u)
        if (j0 + u < nd) acc[u] += t * X(k, j0 + u);
    }
    SPX_UNROLL
    for (int u = 0; u < 4; ++u)
      if (j0 + u < nd) out(i, j0 + u) = acc[u];
  }
}

// The N per-layer operands of a sweep, each [L, rows, W]: W the batch B
// (one copy per element) or, with per_col, the column count C (element b
// reads column b / S).  The down-sweeps also give each operand's columns
// (a row-major matrix of rows / cols x cols; 0: one) and its layer pitch in
// rows (0: rows; a part of the stack has the stack's).
template <typename T, int N>
struct LayerOperands {
  const T* p[N];
  int rows[N];
  bool per_col[N];
  int cols[N];
  int pitch[N];
  SPX_HD int total() const {
    int t = 0;
    for (int s = 0; s < N; ++s) t += rows[s];
    return t;
  }
  SPX_HD int ncols(int s) const { return cols[s] > 0 ? cols[s] : 1; }
  // the row stride of operand s in a down-sweep's copy-ahead buffer: odd,
  // so a team's lanes reading their own rows hit distinct banks
  SPX_HD int ld(int s) const { return ncols(s) == 1 ? 1 : (ncols(s) | 1); }
  SPX_HD int padded(int s) const { return rows[s] / ncols(s) * ld(s); }
};

// n rounded up so that teams of TS lanes whose regions are n entries of
// `words` 4-byte words apart start TS banks apart (a team of one: n).
SPX_HD int bank_stride(int n, int TS, int words) {
  if (TS < 2) return n;
  while ((n * words) % 32 != TS % 32) ++n;
  return n;
}

// A down-sweep's copy-ahead slot per element (K3, K5): its operands'
// padded entries, rounded by bank_stride.
template <typename T, int N>
SPX_HD int slot_stride(const LayerOperands<T, N>& ops, int TS, int words) {
  int n = 0;
  for (int s = 0; s < N; ++s) n += ops.padded(s);
  return bank_stride(n, TS, words);
}

// Where a team of an up-sweep reads its element's layer operands: straight
// from device memory (AHEAD false: views of stride B or C; the host build,
// and the card's kernel whose slabs are global, see up_sweep_teams), or
// from its warp's two copy-ahead buffers in shared memory (AHEAD),
// each one layer's operands of the warp's ew consecutive elements
// ([row][ew], views of stride ew).  With AHEAD the warp copies layer l + 1
// (cp.async, each row of its elements' neighbouring entries by neighbouring
// lanes) while it computes layer l; begin(l) waits for layer l, end() frees
// its buffer.  Both are warp-wide: every lane of the warp calls them, in
// step.  The element is clamped to the batch, so a team past its end reads
// valid memory (and stores nothing).
template <typename T, int N, bool AHEAD>
struct OperandReader {
  LayerOperands<T, N> ops;
  long long B, C, b, b0;  // batch, columns, the element, the warp's first
  int S, L, ew, e, total;  // bands, layers, elements a warp, e = b - b0, rows
  T* buf;                  // AHEAD: the warp's two buffers
  int off[N];

  SPX_DEV OperandReader(const LayerOperands<T, N>& o, long long B_, int S_,
                        int L_, long long b_, long long b0_, int ew_, T* buf_)
      : ops(o), B(B_), C(B_ / S_), b(b_ < B_ ? b_ : B_ - 1), b0(b0_), S(S_),
        L(L_), ew(ew_), e((int)(b_ - b0_)), total(0), buf(buf_) {
    for (int s = 0; s < N; ++s) {
      off[s] = total;
      total += ops.rows[s];
    }
  }
  // operand s of layer l for this element
  SPX_DEV auto view(int s, int l) const {
    if constexpr (AHEAD) {
      return ShS<T>{buf + ((l & 1) * total + off[s]) * ew + e, ew};
    } else {
      const long long W = ops.per_col[s] ? C : B, x = ops.per_col[s] ? b / S : b;
      return Col<T>{const_cast<T*>(ops.p[s]) + (long long)l * ops.rows[s] * W + x, W};
    }
  }
#ifdef __CUDACC__
  SPX_DEV void copy(int l) const {
    T* dst = buf + (l & 1) * total * ew;
    const int lane = threadIdx.x & 31;
    for (int s = 0; s < N; ++s) {
      const long long W = ops.per_col[s] ? C : B;
      const T* src = ops.p[s] + (long long)l * ops.rows[s] * W;
      for (int i = lane; i < ops.rows[s] * ew; i += 32) {
        const int r = i / ew, k = i % ew;
        long long x = b0 + k < B ? b0 + k : B - 1;
        if (ops.per_col[s]) x /= S;
        __pipeline_memcpy_async(dst + (off[s] + r) * ew + k, src + r * W + x, sizeof(T));
      }
    }
    __pipeline_commit();
  }
#endif
  SPX_DEV void start() const {
#ifdef __CUDACC__
    if constexpr (AHEAD) copy(0);
#endif
  }
  SPX_DEV void begin(int l) const {
#ifdef __CUDACC__
    if constexpr (AHEAD) {
      if (l + 1 < L)
        copy(l + 1);
      else
        __pipeline_commit();  // an empty group keeps the count
      __pipeline_wait_prior(1);
      __syncwarp();
    }
#endif
  }
  SPX_DEV void end() const {
#ifdef __CUDACC__
    if constexpr (AHEAD) __syncwarp();
#endif
  }
};

// A down-sweep's block (K3, K5): its E teams on the E consecutive elements
// b0, ..., b0 + E - 1 walk the layers from the top down, together.  Where
// a team reads its element's layer operands: with AHEAD, from the block's
// two copy-ahead slots in shared memory, each one layer's operands of the
// block's elements (per element es entries: each matrix at its odd row
// stride ld, so a team's lanes reading their own rows hit distinct banks;
// elements es apart, so the teams of a warp start TS banks apart).  While
// the block computes layer l, layer l - 1 is in flight: every thread of the
// block copies (cp.async), neighbouring threads taking neighbouring elements
// of one row, so each row of E elements is E x sizeof(T) contiguous bytes of
// device memory (whole 32-byte sectors from 8 f32 / 4 f64 elements on).
// begin(l) waits for layer l (a block barrier) and starts the copy of l - 1
// into the slot of l + 1, which store(l + 1)'s barrier freed.  Without AHEAD
// (the host build, and the card's kernel whose slots exceed a block's shared
// memory) a team reads its operands straight from device memory.  Each team
// stages its output rows of layer l in its slab (out(l); two layers' rows,
// by parity), and store(l) (a block barrier) writes the block's rows to
// `outs`, again neighbouring threads on neighbouring elements.  Every thread
// of the block calls start, begin and store, in step; a team past the
// batch's end runs on the last element and stores nothing.
template <typename T, int N, bool AHEAD>
struct BlockSweep {
  LayerOperands<T, N> ops;
  long long B, C, b, b0;
  int S, L, E, e, es, stride, out_off, n_out;
  T *smem, *outs;  // the block's slabs (E of `stride` entries), then its slots
  int off[N];      // each operand's offset in an element's slot

  SPX_DEV BlockSweep(const LayerOperands<T, N>& o, long long B_, int S_, int L_,
                     long long b0_, int E_, int e_, int es_, T* smem_, int stride_,
                     int out_off_, int n_out_, T* outs_)
      : ops(o), B(B_), C(B_ / S_), b(b0_ + e_ < B_ ? b0_ + e_ : B_ - 1), b0(b0_),
        S(S_), L(L_), E(E_), e(e_), es(es_), stride(stride_), out_off(out_off_),
        n_out(n_out_), smem(smem_), outs(outs_) {
    int run = 0;
    for (int s = 0; s < N; ++s) {
      off[s] = run;
      run += ops.padded(s);
    }
  }
  // operand s of layer l for this element, a matrix of its columns
  SPX_DEV auto mat(int s, int l) const {
    if constexpr (AHEAD) {
      T* slots = smem + E * stride;
      return Mat<Sh<T>>{Sh<T>{slots + ((l & 1) * E + e) * es + off[s]}, ops.ld(s)};
    } else {
      const long long W = ops.per_col[s] ? C : B, x = ops.per_col[s] ? b / S : b;
      const int pitch = ops.pitch[s] > 0 ? ops.pitch[s] : ops.rows[s];
      return Mat<Col<T>>{
          Col<T>{const_cast<T*>(ops.p[s]) + (long long)l * pitch * W + x, W},
          ops.ncols(s)};
    }
  }
  // this team's output rows of layer l
  SPX_DEV Sh<T> out(int l) const {
    return Sh<T>{smem + e * stride + out_off + (l & 1) * n_out};
  }
  SPX_DEV void store(int l) const {
#ifdef __CUDACC__
    __syncthreads();
    const int t0 = threadIdx.x, nt = blockDim.x;
#else
    const int t0 = 0, nt = 1;
#endif
    for (int i = t0; i < n_out * E; i += nt) {
      const int r = i / E, k = i - r * E;
      if (b0 + k < B)
        outs[((long long)l * n_out + r) * B + b0 + k] =
            smem[k * stride + out_off + (l & 1) * n_out + r];
    }
  }
#ifdef __CUDACC__
  // Layer l into slot l & 1: thread t copies entries t / E, + blockDim.x /
  // E, ... of each operand's rows for element t % E.
  SPX_DEV void copy(int l) const {
    T* dst0 = smem + E * stride + (l & 1) * E * es;
    const int el = threadIdx.x % E, j0 = threadIdx.x / E, q = blockDim.x / E;
    const long long xb = b0 + el < B ? b0 + el : B - 1;
    SPX_UNROLL
    for (int s = 0; s < N; ++s) {
      const long long W = ops.per_col[s] ? C : B;
      const int pitch = ops.pitch[s] > 0 ? ops.pitch[s] : ops.rows[s];
      const T* src = ops.p[s] + (long long)l * pitch * W + (ops.per_col[s] ? xb / S : xb);
      const int m = ops.ncols(s), ld = ops.ld(s), qi = q / m, qc = q - qi * m;
      T* dst = dst0 + el * es + off[s];
      int i = j0 / m, c = j0 - i * m;
      src += (long long)j0 * W;
      for (int idx = j0; idx < ops.rows[s]; idx += q, src += q * W) {
        __pipeline_memcpy_async(dst + i * ld + c, src, sizeof(T));
        i += qi, c += qc;
        if (c >= m) c -= m, ++i;
      }
    }
    __pipeline_commit();
  }
#endif
  SPX_DEV void start() const {
#ifdef __CUDACC__
    if constexpr (AHEAD) copy(L - 1);
#endif
  }
  SPX_DEV void begin(int l) const {
#ifdef __CUDACC__
    if constexpr (AHEAD) {
      if (l > 0)
        copy(l - 1);
      else
        __pipeline_commit();  // an empty group keeps the count
      __pipeline_wait_prior(1);
      __syncthreads();
    }
#endif
  }
};

// A team kernel's launch configuration (team_config writes it, the
// wrappers keep it per kernel, dtype and shape, and set the grid per call;
// team_launch reads it): team size, teams a block, threads a block, slab
// bytes (one team's slab, its stride), shared bytes a block, resident
// blocks an SM, registers a thread, SMs, global slab (0 / 1), grid,
// fallback (0 / 1: the kernel for what a block's shared memory cannot hold).
#define SPX_TEAM_INFO 11

#ifdef __CUDACC__

// The configuration of a team kernel at team size TS over n elements:
// each team a slab of slab_elems entries in shared memory (stride rounded
// up so the teams of a warp start TS banks apart) plus `extra` entries of
// shared memory (a sweep's copy-ahead buffers); blocks of at least
// min_per_block teams (a down-sweep's whole sectors; fewer only where no
// such block fits) and of two or four warps, whichever keeps more teams
// resident on an SM (the CUDA occupancy calculator: shared memory,
// registers), or one or else eight warps where none of those fits (blocks
// of one warp ran K1 at the rami5 shape in f32 1.8x slower than blocks of
// two at the same resident teams, on the H100).
// Where one team's slab and extra exceed the shared memory a block may
// take, and k_fallback is given, k_fallback runs instead, with nothing of
// extra: its slabs in shared memory where fallback_shared_slab (a
// down-sweep's direct-read kernel), else in a global scratch of one slab a
// resident team (the grid no larger than the resident blocks) and nothing
// in shared memory (an up-sweep's global kernel reads its operands from
// device memory).  Both kernels may take up to the card's shared memory per
// block.
template <typename T, int TS, class K>
static cudaError_t team_config(K* k_shared, K* k_fallback, int slab_elems,
                               int extra, long long n, long long* info,
                               int min_per_block = 1, bool fallback_shared_slab = false) {
  const int stride = bank_stride(slab_elems, TS, (int)(sizeof(T) / 4));
  int device = 0, optin = 0, sms = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long slab = (long long)stride * sizeof(T);
  const long long own = slab + extra * (long long)sizeof(T);
  const bool fallback = k_fallback != nullptr && own > optin;
  const bool global = fallback && !fallback_shared_slab;
  K* k = fallback ? k_fallback : k_shared;
  cudaError_t err = cudaFuncSetAttribute(
      k_shared, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess && k_fallback != nullptr)
    err = cudaFuncSetAttribute(k_fallback, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  const long long per_team = global ? 0 : fallback ? slab : own;
  int per_block = 1, blocks_sm = 0;
  for (int least = min_per_block; err == cudaSuccess && blocks_sm == 0 && least > 0;
       least = least > 1 ? 1 : 0)  // then blocks of fewer teams, where none fits
    for (const int warps : {2, 4, 1, 8}) {
      if (err != cudaSuccess || ((warps == 1 || warps == 8) && blocks_sm > 0)) break;
      const int pb = warps * 32 / TS;
      if (pb < least || pb * per_team > optin) continue;
      int b = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, k, pb * TS,
                                                          (size_t)(pb * per_team));
      if (b * pb > blocks_sm * per_block) per_block = pb, blocks_sm = b;
    }
  cudaFuncAttributes fa{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, k);
  if (err == cudaSuccess && blocks_sm == 0) err = cudaErrorInvalidConfiguration;
  long long grid = (n + per_block - 1) / per_block;
  if (grid < 1) grid = 1;
  if (global && grid > (long long)blocks_sm * sms) grid = (long long)blocks_sm * sms;
  const long long vals[SPX_TEAM_INFO] = {
      TS, per_block, per_block * TS, slab, per_block * per_team, blocks_sm,
      fa.numRegs, sms, global, grid, fallback};
  for (int i = 0; i < SPX_TEAM_INFO; ++i) info[i] = vals[i];
  return err;
}

// The body of an up-sweep's team kernel (K2, K4): teams of TS lanes,
// blockDim.x / TS of them a block, the ew = 32 / TS teams of a warp on
// consecutive elements, each team looping over the elements j = its index,
// + the grid's teams, ...; its slab in dynamic shared memory, after it each
// warp's two copy-ahead buffers; or, GLOBAL (a slab and its buffers larger
// than a block's shared memory; team_config), the slab in ws and the
// operands read from device memory.  Every lane of a warp takes each round
// (the copy-ahead is warp-wide): a team past the batch runs on the last
// element and stores nothing.  body(tm, rd, valid, slab) runs one element.
template <typename T, int TS, bool GLOBAL, int N, class F>
__device__ void up_sweep_teams(const LayerOperands<T, N>& ops, long long B,
                               int S, int L, T* ws, int stride, F body) {
  constexpr bool AHEAD = !GLOBAL;
  extern __shared__ __align__(16) unsigned char spx_team_smem[];
  T* smem = reinterpret_cast<T*>(spx_team_smem);
  const int per_block = blockDim.x / TS, team = threadIdx.x / TS, ew = 32 / TS;
  const unsigned ones = (unsigned)((1ull << TS) - 1ull);
  const Team<TS> tm{(int)(threadIdx.x % TS), ones << ((threadIdx.x % 32) / TS * TS)};
  const long long first = (long long)blockIdx.x * per_block + team;
  const long long step = (long long)gridDim.x * per_block;
  T* slab = GLOBAL ? ws + first * stride : smem + team * stride;
  T* buf = AHEAD ? smem + per_block * stride + (threadIdx.x / 32) * 2 * ops.total() * ew
                 : nullptr;
  for (long long j = first;; j += step) {
    if (__ballot_sync(0xffffffffu, j < B) == 0) break;
    const OperandReader<T, N, AHEAD> rd(ops, B, S, L, j, j - team % ew, ew, buf);
    body(tm, rd, j < B, slab);
  }
}

// The body of a down-sweep's team kernel (K3, K5): teams of TS lanes,
// E = blockDim.x / TS of them a block on E consecutive elements, the block
// taking the elements b0 = its index x E, + the grid's elements, ...; each
// team's slab (stride entries) in dynamic shared memory, after the slabs
// (AHEAD) the block's two copy-ahead slots of es entries an element
// (BlockSweep).  body(tm, bs, valid, slab) runs one element.
template <typename T, int TS, bool AHEAD, int N, class F>
__device__ void down_sweep_teams(const LayerOperands<T, N>& ops, long long B, int S, int L,
                                 int stride, int es, int out_off, int n_out, T* outs,
                                 F body) {
  extern __shared__ __align__(16) unsigned char spx_team_smem[];
  T* smem = reinterpret_cast<T*>(spx_team_smem);
  const int E = blockDim.x / TS, team = threadIdx.x / TS;
  const unsigned ones = (unsigned)((1ull << TS) - 1ull);
  const Team<TS> tm{(int)(threadIdx.x % TS), ones << ((threadIdx.x % 32) / TS * TS)};
  for (long long b0 = (long long)blockIdx.x * E; b0 < B; b0 += (long long)gridDim.x * E) {
    const BlockSweep<T, N, AHEAD> bs(ops, B, S, L, b0, E, team, es, smem, stride, out_off,
                                     n_out, outs);
    body(tm, bs, b0 + team < B, smem + team * stride);
  }
}

// Launch a team kernel as `info` (team_config's, grid set by the caller)
// says: the fallback kernel where info names it.
template <class K, class... Args>
static int team_launch(K* k_shared, K* k_global, const long long* info,
                       cudaStream_t stream, Args... args) {
  if (info == nullptr) return (int)cudaErrorInvalidValue;
  K* k = info[10] ? k_global : k_shared;
  if (k == nullptr || info[9] < 1) return (int)cudaErrorInvalidConfiguration;
  k<<<(unsigned)info[9], (unsigned)info[2], (size_t)info[4], stream>>>(args...);
  return (int)cudaGetLastError();
}
#endif

}  // namespace spx
