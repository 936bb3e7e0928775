// Shared helpers of the hand-written SPARTACUS kernels.
//
// The sweeps (K2-K5) and the dense factory (K1d) keep one batch element per
// thread in a struct-of-arrays layout: a thread's matrix of n x m rows lives
// at p[i * s] (row-major entry i, stride s = the number of threads of the
// launch or the batch), so a warp's accesses to the same entry are
// consecutive in memory.  The structured factory (K1) gives each element a
// team of TS lanes of one warp and a contiguous slab of shared memory; the
// team forms below (Team, Mat, tmm, tsolve) split a matrix's rows over the
// lanes, and a team of one lane (TS = 1) runs them as plain loops.
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
#include <cuda_runtime.h>
#define SPX_DEV __device__ __forceinline__
#define SPX_UNROLL _Pragma("unroll")
#else
#include <cmath>
#define SPX_DEV inline
#define SPX_UNROLL
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

// A row-major matrix on a view V (Col or Sh) with row stride ld.
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
// lane keeps its row of a in registers.  Each entry sums in the order of
// mm below.  `out` must not alias `a` or `b`.  Ends with a team sync.
template <int TS, int CAP, class MO, class MA, class MB>
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
      for (int j = 0; j < m; ++j) {
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

// Team pivot-free solve a X = rhs (a n x n, destroyed; rhs n x m,
// overwritten by X), the arithmetic of solve_inplace below: the
// elimination splits the rows over the lanes, one broadcast pivot row per
// step; the back substitution splits the columns.  Ends with a team sync.
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

// out[i*os + j] (+)= sum_k a[i*as + k] * b[k*bs + j] for the (n x m) result
// of (n x p) @ (p x m).  `out` must not alias `a` or `b`.
template <typename T>
SPX_DEV void mm(Col<T> out, int os, Col<T> a, int as, Col<T> b, int bs,
                int n, int p, int m, bool accumulate = false) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < m; ++j) {
      T acc = accumulate ? out[i * os + j] : T(0);
      for (int k = 0; k < p; ++k) acc += a[i * as + k] * b[k * bs + j];
      out[i * os + j] = acc;
    }
}

// Contiguous-stride form: out (n x m) (+)= a (n x p) @ b (p x m).
template <typename T>
SPX_DEV void mmc(Col<T> out, Col<T> a, Col<T> b, int n, int p, int m,
                 bool accumulate = false) {
  mm(out, m, a, p, b, m, n, p, m, accumulate);
}

// out[i] (+)= sum_k a[i*p + k] * x[k]  (matrix-vector, contiguous rows).
template <typename T>
SPX_DEV void mv(Col<T> out, Col<T> a, Col<T> x, int n, int p,
                bool accumulate = false) {
  for (int i = 0; i < n; ++i) {
    T acc = accumulate ? out[i] : T(0);
    for (int k = 0; k < p; ++k) acc += a[i * p + k] * x[k];
    out[i] = acc;
  }
}

// Pivot-free in-place solve a X = rhs: a is (n x n) with row stride as and
// is destroyed; rhs is (n x m) with row stride rs and is overwritten by X.
// The SPARTACUS matrices are diagonally dominant by construction, as in the
// reference's unpivoted LU (radtool_matrix.F90:982-1055).
template <typename T>
SPX_DEV void solve_inplace(Col<T> a, int as, Col<T> rhs, int rs, int n, int m) {
  for (int k = 0; k < n - 1; ++k) {
    const T piv = T(1) / a[k * as + k];
    for (int i = k + 1; i < n; ++i) {
      const T f = a[i * as + k] * piv;
      for (int j = k + 1; j < n; ++j) a[i * as + j] -= f * a[k * as + j];
      for (int j = 0; j < m; ++j) rhs[i * rs + j] -= f * rhs[k * rs + j];
    }
  }
  for (int i = n - 1; i >= 0; --i) {
    const T rd = T(1) / a[i * as + i];
    for (int j = 0; j < m; ++j) {
      T acc = rhs[i * rs + j];
      for (int k = i + 1; k < n; ++k) acc -= a[i * as + k] * rhs[k * rs + j];
      rhs[i * rs + j] = acc * rd;
    }
  }
}

template <typename T>
SPX_DEV void copy(Col<T> dst, Col<T> src, int rows) {
  for (int i = 0; i < rows; ++i) dst[i] = src[i];
}

template <typename T>
SPX_DEV void fill(Col<T> dst, int rows, T value) {
  for (int i = 0; i < rows; ++i) dst[i] = value;
}

}  // namespace spx
