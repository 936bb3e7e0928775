// Shared helpers of the hand-written SPARTACUS kernels.
//
// Every kernel keeps one batch element per thread in a struct-of-arrays
// layout: a thread's matrix of n x m rows lives at p[i * s] (row-major
// entry i, stride s = the number of threads of the launch or the batch),
// so a warp's accesses to the same entry are consecutive in memory.
//
// The bodies are plain C++ on scalars.  Built with nvcc they are device
// functions; built by a host C++ compiler (see host_check.cpp) the same
// arithmetic runs on the CPU, one "thread" at a time, which lets the CPU
// tests check the kernels' indexing and algebra without a GPU.

#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SPX_DEV __device__ __forceinline__
#else
#include <cmath>
#define SPX_DEV inline
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
  T* p;
  long long s;
  SPX_DEV T& operator[](long long i) const { return p[i * s]; }
  SPX_DEV Col at(long long k) const { return Col{p + k * s, s}; }
};

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

// dst (n x n) = identity.
template <typename T>
SPX_DEV void eye(Col<T> dst, int n) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) dst[i * n + j] = T(i == j);
}

}  // namespace spx
