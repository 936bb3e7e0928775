// Host build of the CUDA kernels' per-thread bodies, for the CPU tests
// (tests/test_torch_kernels.py; tests/test_torch_roofline.py for the probes
// K6 and K7): each "launch" runs the thread function for
// every thread index in turn, on host memory, with the same arguments as the
// CUDA launchers (a launch configuration is taken and ignored).  The team
// bodies (K1-K5) run as a team of one lane (TS = 1) per element on a
// host slab laid out as on the card, which is filled with NaN before each
// element, so a read of a slot the body has not written shows in the
// results; K1 and K1d take their elements in the launch's order, as the
// card's teams do.  Built with a host C++ compiler; nvcc never sees this file.

#include <limits>
#include <vector>

#include "layer_factory.cu"
#include "lw_sweeps.cu"
#include "roofline_probes.cu"
#include "sw_sweeps.cu"

template <typename T>
static void factory_host(SPX_FACTORY_PARAMS) {
  const auto A = spx::factory_args<T>(SPX_FACTORY_ARGS);
  const spx::Slab S = spx::slab_layout(nd, ndir);
  std::vector<T> slab(S.size);
  for (long long t = 0; t < n; ++t) {
    slab.assign(S.size, std::numeric_limits<T>::quiet_NaN());
    spx::layer_factory_team<1, 32>(A, S, spx::Team<1>{0, 0u}, A.order[t], slab.data(),
                                   0u);
  }
}

// A team kernel's launch configuration on the host (SPX_TEAM_INFO): a team
// of one lane per element, one element a "block", the slab in host memory
// (no scratch).
static int team_config_host(long long slab_bytes, long long n, long long* info) {
  const long long vals[SPX_TEAM_INFO] = {1, 1, 1, slab_bytes, 0, 1, 0, 1, 0, n, 0};
  for (int i = 0; i < SPX_TEAM_INFO; ++i) info[i] = vals[i];
  return 0;
}

template <typename T>
static void dense_factory_host(SPX_FACTORY_PARAMS) {
  const auto A = spx::factory_args<T>(SPX_FACTORY_ARGS);
  const spx::DenseSlab S = spx::dense_slab_layout(nd, ndir);
  std::vector<T> slab(S.size);
  for (long long t = 0; t < n; ++t) {
    slab.assign(S.size, std::numeric_limits<T>::quiet_NaN());
    spx::layer_factory_dense_team<1, SPX_DENSE_CAP>(A, S, spx::Team<1>{0, 0u},
                                                    A.order[t], slab.data(), 0u);
  }
}

// K2 and K4: each element's team body as a team of one lane, reading its
// operands from host memory, on a slab filled with NaN first.
template <typename T>
static void up_host(SPX_UP_PARAMS) {
  const auto A = spx::up_args<T>(SPX_UP_ARGS);
  const spx::UpSlab SL = spx::sw_up_slab(A);
  std::vector<T> slab;
  for (long long b = 0; b < B; ++b) {
    slab.assign(SL.size, std::numeric_limits<T>::quiet_NaN());
    const spx::OperandReader<T, spx::K2_NOPS, false> rd(spx::sw_up_operands(A), B, S, L,
                                                 b, b, 1, nullptr);
    spx::sw_up_team<1, 32>(A, SL, spx::Team<1>{0, 0u}, rd, true, slab.data());
  }
}

// K3 and K5: each element's team body as a team of one lane, reading its
// operands from host memory, on a slab filled with NaN first, its output
// rows staged there and stored as on the card.
template <typename T>
static void down_host(SPX_DOWN_PARAMS) {
  const auto A = spx::down_args<T>(SPX_DOWN_ARGS);
  const spx::SwDownSlab D = spx::sw_down_slab(A);
  std::vector<T> slab;
  for (long long b = 0; b < B; ++b) {
    slab.assign(D.size, std::numeric_limits<T>::quiet_NaN());
    const spx::BlockSweep<T, spx::K3_NOPS, false> bs(
        spx::sw_down_operands(A), B, S, L, b, 1, 0, 0, slab.data(), D.size, D.out,
        D.n_out, A.outs);
    spx::sw_down_team<1>(A, D, spx::Team<1>{0, 0u}, bs, true, slab.data());
  }
}

template <typename T>
static void lw_up_host(SPX_LW_UP_PARAMS) {
  const auto A = spx::lw_up_args<T>(SPX_LW_UP_ARGS);
  const spx::UpSlab SL = spx::lw_up_slab(A);
  std::vector<T> slab;
  for (long long b = 0; b < B; ++b) {
    slab.assign(SL.size, std::numeric_limits<T>::quiet_NaN());
    const spx::OperandReader<T, spx::K4_NOPS, false> rd(spx::lw_up_operands(A), B, S, L,
                                                 b, b, 1, nullptr);
    spx::lw_up_team<1, 32>(A, SL, spx::Team<1>{0, 0u}, rd, true, slab.data());
  }
}

template <typename T>
static void lw_down_host(SPX_LW_DOWN_PARAMS) {
  const auto A = spx::lw_down_args<T>(SPX_LW_DOWN_ARGS);
  const spx::LwDownSlab D = spx::lw_down_slab(A);
  std::vector<T> slab;
  for (long long b = 0; b < B; ++b) {
    slab.assign(D.size, std::numeric_limits<T>::quiet_NaN());
    const spx::BlockSweep<T, spx::K5_NOPS, false> bs(
        spx::lw_down_operands(A), B, S, L, b, 1, 0, 0, slab.data(), D.size, D.out,
        D.n_out, A.outs);
    spx::lw_down_team<1>(A, D, spx::Team<1>{0, 0u}, bs, true, slab.data());
  }
}

template <typename T>
static void fma_host(SPX_FMA_PARAMS) {
  for (long long t = 0; t < n; ++t)
    spx::fma_chain_thread((const T*)x, (T*)out, T(b), T(c), n, t);
}

// Same C interface as the CUDA launchers; the stream is ignored and the
// return value (cudaGetLastError there) is 0.
extern "C" {
int layer_factory_f32(SPX_FACTORY_PARAMS, const long long*, void*) {
  factory_host<float>(SPX_FACTORY_ARGS);
  return 0;
}
int layer_factory_f64(SPX_FACTORY_PARAMS, const long long*, void*) {
  factory_host<double>(SPX_FACTORY_ARGS);
  return 0;
}
int factory_order_f32(SPX_ORDER_PARAMS, void*) {
  order_host<float>(SPX_ORDER_ARGS);
  return 0;
}
int factory_order_f64(SPX_ORDER_PARAMS, void*) {
  order_host<double>(SPX_ORDER_ARGS);
  return 0;
}
int layer_factory_config_f32(int nd, int ndir, long long n, long long* info) {
  return team_config_host(spx::slab_layout(nd, ndir).size * sizeof(float), n, info);
}
int layer_factory_config_f64(int nd, int ndir, long long n, long long* info) {
  return team_config_host(spx::slab_layout(nd, ndir).size * sizeof(double), n, info);
}
int layer_factory_dense_f32(SPX_FACTORY_PARAMS, const long long*, void*) {
  dense_factory_host<float>(SPX_FACTORY_ARGS);
  return 0;
}
int layer_factory_dense_f64(SPX_FACTORY_PARAMS, const long long*, void*) {
  dense_factory_host<double>(SPX_FACTORY_ARGS);
  return 0;
}
int layer_factory_dense_config_f32(int nd, int ndir, long long n, long long* info) {
  return team_config_host(spx::dense_slab_layout(nd, ndir).size * sizeof(float), n, info);
}
int layer_factory_dense_config_f64(int nd, int ndir, long long n, long long* info) {
  return team_config_host(spx::dense_slab_layout(nd, ndir).size * sizeof(double), n, info);
}
int sw_up_sweep_f32(SPX_UP_PARAMS, const long long*, void*) {
  up_host<float>(SPX_UP_ARGS);
  return 0;
}
int sw_up_sweep_config_f32(int nd, int ns, int nreg, long long B, long long* info) {
  return team_config_host(
      spx::up_slab(nd, ns, nreg, nreg, nreg + 1).size * sizeof(float), B, info);
}
int sw_up_sweep_f64(SPX_UP_PARAMS, const long long*, void*) {
  up_host<double>(SPX_UP_ARGS);
  return 0;
}
int sw_up_sweep_config_f64(int nd, int ns, int nreg, long long B, long long* info) {
  return team_config_host(
      spx::up_slab(nd, ns, nreg, nreg, nreg + 1).size * sizeof(double), B, info);
}
int sw_down_sweep_f32(SPX_DOWN_PARAMS, const long long*, void*) {
  down_host<float>(SPX_DOWN_ARGS);
  return 0;
}
int sw_down_sweep_f64(SPX_DOWN_PARAMS, const long long*, void*) {
  down_host<double>(SPX_DOWN_ARGS);
  return 0;
}
int sw_down_sweep_config_f32(int nd, int ns, int nreg, int do_urban, int with_profiles,
                             long long B, long long* info) {
  return team_config_host(
      spx::sw_down_slab(nd, ns, nreg, do_urban, with_profiles).size * sizeof(float), B, info);
}
int sw_down_sweep_config_f64(int nd, int ns, int nreg, int do_urban, int with_profiles,
                             long long B, long long* info) {
  return team_config_host(
      spx::sw_down_slab(nd, ns, nreg, do_urban, with_profiles).size * sizeof(double), B, info);
}
int lw_up_sweep_f32(SPX_LW_UP_PARAMS, const long long*, void*) {
  lw_up_host<float>(SPX_LW_UP_ARGS);
  return 0;
}
int lw_up_sweep_config_f32(int nd, int ns, int nreg, long long B, long long* info) {
  return team_config_host(
      spx::up_slab(nd, ns, nreg, 1, 1).size * sizeof(float), B, info);
}
int lw_up_sweep_f64(SPX_LW_UP_PARAMS, const long long*, void*) {
  lw_up_host<double>(SPX_LW_UP_ARGS);
  return 0;
}
int lw_up_sweep_config_f64(int nd, int ns, int nreg, long long B, long long* info) {
  return team_config_host(
      spx::up_slab(nd, ns, nreg, 1, 1).size * sizeof(double), B, info);
}
int lw_down_sweep_f32(SPX_LW_DOWN_PARAMS, const long long*, void*) {
  lw_down_host<float>(SPX_LW_DOWN_ARGS);
  return 0;
}
int lw_down_sweep_f64(SPX_LW_DOWN_PARAMS, const long long*, void*) {
  lw_down_host<double>(SPX_LW_DOWN_ARGS);
  return 0;
}
int lw_down_sweep_config_f32(int nd, int ns, int nreg, int do_urban, int with_profiles,
                             long long B, long long* info) {
  return team_config_host(
      spx::lw_down_slab(nd, ns, nreg, do_urban, with_profiles).size * sizeof(float), B, info);
}
int lw_down_sweep_config_f64(int nd, int ns, int nreg, int do_urban, int with_profiles,
                             long long B, long long* info) {
  return team_config_host(
      spx::lw_down_slab(nd, ns, nreg, do_urban, with_profiles).size * sizeof(double), B, info);
}
int fma_chain_f32(SPX_FMA_PARAMS, void*) {
  fma_host<float>(SPX_FMA_ARGS);
  return 0;
}
int fma_chain_f64(SPX_FMA_PARAMS, void*) {
  fma_host<double>(SPX_FMA_ARGS);
  return 0;
}
int copy_add_f32(SPX_COPY_PARAMS, void*) {
  // every thread of every block of the card's grid, in turn
  for (long long blk = 0; blk < spx::copy_add_blocks(n); ++blk)
    for (int t = 0; t < SPX_COPY_THREADS; ++t)
      spx::copy_add_thread((const float*)x, (float*)o, n, blk, t);
  return 0;
}
}
