// Counting host build of the kernels' per-thread bodies (K1, K1d, K2-K5),
// for the CPU tests of the roofline work model (tests/test_torch_roofline.py):
// the bodies run with T = spx::Counted<double>, a double that adds one to a
// counter for every add, subtract, multiply and divide it performs (an fma
// counts two); negation, fabs, fmax, fmin, ceil, log2, ldexp and sqrt count
// nothing.  Each "launch" runs the thread function for every thread index in
// turn (K1, K1d and K2-K5: their team bodies as a team of one lane per
// element, so an element's work counts once, not once per lane) and
// records that thread's count.  Counted<double> has the size and layout of a
// double, so the buffers are float64 tensors and the exported
// functions have the C interface of the float64 CUDA launchers.  Built with
// a host C++ compiler; nvcc never sees this file.

#include <cmath>
#include <vector>

#include "common.cuh"

namespace spx {

inline long long flops = 0;

template <typename V>
struct Counted {
  V v;
  Counted() = default;
  explicit Counted(V x) : v(x) {}
  explicit operator int() const { return int(v); }

  friend Counted operator+(Counted a, Counted b) { ++flops; return Counted(a.v + b.v); }
  friend Counted operator-(Counted a, Counted b) { ++flops; return Counted(a.v - b.v); }
  friend Counted operator*(Counted a, Counted b) { ++flops; return Counted(a.v * b.v); }
  friend Counted operator/(Counted a, Counted b) { ++flops; return Counted(a.v / b.v); }
  friend Counted operator-(Counted a) { return Counted(-a.v); }
  Counted& operator+=(Counted b) { return *this = *this + b; }
  Counted& operator-=(Counted b) { return *this = *this - b; }
  Counted& operator*=(Counted b) { return *this = *this * b; }
  Counted& operator/=(Counted b) { return *this = *this / b; }

  friend Counted fabs(Counted a) { return Counted(std::fabs(a.v)); }
  friend Counted fmax(Counted a, Counted b) { return Counted(std::fmax(a.v, b.v)); }
  friend Counted fmin(Counted a, Counted b) { return Counted(std::fmin(a.v, b.v)); }
  friend Counted ceil(Counted a) { return Counted(std::ceil(a.v)); }
  friend Counted log2(Counted a) { return Counted(std::log2(a.v)); }
  friend Counted ldexp(Counted a, int e) { return Counted(std::ldexp(a.v, e)); }
  friend Counted sqrt(Counted a) { return Counted(std::sqrt(a.v)); }
  friend Counted fma(Counted a, Counted b, Counted c) {
    flops += 2;
    return Counted(std::fma(a.v, b.v, c.v));
  }
};

static_assert(sizeof(Counted<double>) == sizeof(double), "layout of a double");

}  // namespace spx

#include "layer_factory.cu"
#include "lw_sweeps.cu"
#include "sw_sweeps.cu"

using CT = spx::Counted<double>;

static std::vector<long long> thread_flops;  // one entry per thread run

// a team kernel's configuration (SPX_TEAM_INFO): a team of one lane per
// element
static int config_host(long long n, long long* info) {
  const long long vals[SPX_TEAM_INFO] = {1, 1, 1, 0, 0, 1, 0, 1, 0, n, 0};
  for (int i = 0; i < SPX_TEAM_INFO; ++i) info[i] = vals[i];
  return 0;
}

template <typename F>
static void each_thread(long long n, F body) {
  for (long long t = 0; t < n; ++t) {
    const long long before = spx::flops;
    body(t);
    thread_flops.push_back(spx::flops - before);
  }
}

extern "C" {
void count_reset() { thread_flops.clear(); }
long long count_threads() { return (long long)thread_flops.size(); }
// the per-thread FLOP totals of every thread run since count_reset
void count_per_thread(long long* out) {
  for (size_t i = 0; i < thread_flops.size(); ++i) out[i] = thread_flops[i];
}

int layer_factory_f64(SPX_FACTORY_PARAMS, const long long*, void*) {
  const auto A = spx::factory_args<CT>(SPX_FACTORY_ARGS);
  const spx::Slab S = spx::slab_layout(nd, ndir);
  std::vector<CT> slab(S.size);
  each_thread(n, [&](long long t) {
    spx::layer_factory_team<1, 32>(A, S, spx::Team<1>{0, 0u}, A.order[t], slab.data(),
                                   0u);
  });
  return 0;
}
int layer_factory_config_f64(int nd, int ndir, long long n, long long* info) {
  return config_host(n, info);
}
// the order pass (its operations are not the factory's: recorded for no
// thread)
int factory_order_f64(SPX_ORDER_PARAMS, void*) {
  order_host<CT>(SPX_ORDER_ARGS);
  return 0;
}
int layer_factory_dense_f64(SPX_FACTORY_PARAMS, const long long*, void*) {
  const auto A = spx::factory_args<CT>(SPX_FACTORY_ARGS);
  const spx::DenseSlab S = spx::dense_slab_layout(nd, ndir);
  std::vector<CT> slab(S.size);
  each_thread(n, [&](long long t) {
    spx::layer_factory_dense_team<1, SPX_DENSE_CAP>(A, S, spx::Team<1>{0, 0u},
                                                    A.order[t], slab.data(), 0u);
  });
  return 0;
}
int layer_factory_dense_config_f64(int nd, int ndir, long long n, long long* info) {
  return config_host(n, info);
}
int sw_up_sweep_f64(SPX_UP_PARAMS, const long long*, void*) {
  const auto A = spx::up_args<CT>(SPX_UP_ARGS);
  std::vector<CT> slab(spx::sw_up_slab(A).size);
  each_thread(B, [&](long long b) {
    const spx::OperandReader<CT, spx::K2_NOPS, false> rd(spx::sw_up_operands(A), B, S, L,
                                                  b, b, 1, nullptr);
    spx::sw_up_team<1, 32>(A, spx::sw_up_slab(A), spx::Team<1>{0, 0u}, rd, true,
                           slab.data());
  });
  return 0;
}
int sw_up_sweep_config_f64(int, int, int, long long B, long long* info) {
  return config_host(B, info);
}
int sw_down_sweep_f64(SPX_DOWN_PARAMS, const long long*, void*) {
  const auto A = spx::down_args<CT>(SPX_DOWN_ARGS);
  const spx::SwDownSlab D = spx::sw_down_slab(A);
  std::vector<CT> slab(D.size);
  each_thread(B, [&](long long b) {
    const spx::BlockSweep<CT, spx::K3_NOPS, false> bs(
        spx::sw_down_operands(A), B, S, L, b, 1, 0, 0, slab.data(), D.size, D.out,
        D.n_out, A.outs);
    spx::sw_down_team<1>(A, D, spx::Team<1>{0, 0u}, bs, true, slab.data());
  });
  return 0;
}
int sw_down_sweep_config_f64(int, int, int, int, int, long long B, long long* info) {
  return config_host(B, info);
}
int lw_up_sweep_f64(SPX_LW_UP_PARAMS, const long long*, void*) {
  const auto A = spx::lw_up_args<CT>(SPX_LW_UP_ARGS);
  std::vector<CT> slab(spx::lw_up_slab(A).size);
  each_thread(B, [&](long long b) {
    const spx::OperandReader<CT, spx::K4_NOPS, false> rd(spx::lw_up_operands(A), B, S, L,
                                                  b, b, 1, nullptr);
    spx::lw_up_team<1, 32>(A, spx::lw_up_slab(A), spx::Team<1>{0, 0u}, rd, true,
                           slab.data());
  });
  return 0;
}
int lw_up_sweep_config_f64(int, int, int, long long B, long long* info) {
  return config_host(B, info);
}
int lw_down_sweep_f64(SPX_LW_DOWN_PARAMS, const long long*, void*) {
  const auto A = spx::lw_down_args<CT>(SPX_LW_DOWN_ARGS);
  const spx::LwDownSlab D = spx::lw_down_slab(A);
  std::vector<CT> slab(D.size);
  each_thread(B, [&](long long b) {
    const spx::BlockSweep<CT, spx::K5_NOPS, false> bs(
        spx::lw_down_operands(A), B, S, L, b, 1, 0, 0, slab.data(), D.size, D.out,
        D.n_out, A.outs);
    spx::lw_down_team<1>(A, D, spx::Team<1>{0, 0u}, bs, true, slab.data());
  });
  return 0;
}
int lw_down_sweep_config_f64(int, int, int, int, int, long long B, long long* info) {
  return config_host(B, info);
}
}
