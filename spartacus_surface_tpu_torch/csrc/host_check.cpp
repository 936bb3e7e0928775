// Host build of the CUDA kernels' per-thread bodies, for the CPU tests
// (tests/test_torch_kernels.py): each "launch" runs the thread function for
// every thread index in turn, on host memory, with the same arguments as the
// CUDA launchers.  Built with a host C++ compiler; nvcc never sees this file.

#include "layer_factory.cu"
#include "lw_sweeps.cu"
#include "sw_sweeps.cu"

template <typename T>
static void factory_host(SPX_FACTORY_PARAMS) {
  const auto A = spx::factory_args<T>(SPX_FACTORY_ARGS);
  for (long long t = 0; t < n; ++t) spx::layer_factory_thread(A, t);
}

template <typename T>
static void dense_factory_host(SPX_FACTORY_PARAMS) {
  const auto A = spx::factory_args<T>(SPX_FACTORY_ARGS);
  for (long long t = 0; t < n; ++t) spx::layer_factory_dense_thread(A, t);
}

template <typename T>
static void up_host(SPX_UP_PARAMS) {
  const auto A = spx::up_args<T>(SPX_UP_ARGS);
  for (long long b = 0; b < B; ++b) spx::sw_up_thread(A, b);
}

template <typename T>
static void down_host(SPX_DOWN_PARAMS) {
  const auto A = spx::down_args<T>(SPX_DOWN_ARGS);
  for (long long b = 0; b < B; ++b) spx::sw_down_thread(A, b);
}

template <typename T>
static void lw_up_host(SPX_LW_UP_PARAMS) {
  const auto A = spx::lw_up_args<T>(SPX_LW_UP_ARGS);
  for (long long b = 0; b < B; ++b) spx::lw_up_thread(A, b);
}

template <typename T>
static void lw_down_host(SPX_LW_DOWN_PARAMS) {
  const auto A = spx::lw_down_args<T>(SPX_LW_DOWN_ARGS);
  for (long long b = 0; b < B; ++b) spx::lw_down_thread(A, b);
}

// Same C interface as the CUDA launchers; the stream is ignored and the
// return value (cudaGetLastError there) is 0.
extern "C" {
int layer_factory_f32(SPX_FACTORY_PARAMS, void*) {
  factory_host<float>(SPX_FACTORY_ARGS);
  return 0;
}
int layer_factory_f64(SPX_FACTORY_PARAMS, void*) {
  factory_host<double>(SPX_FACTORY_ARGS);
  return 0;
}
int layer_factory_dense_f32(SPX_FACTORY_PARAMS, void*) {
  dense_factory_host<float>(SPX_FACTORY_ARGS);
  return 0;
}
int layer_factory_dense_f64(SPX_FACTORY_PARAMS, void*) {
  dense_factory_host<double>(SPX_FACTORY_ARGS);
  return 0;
}
int sw_up_sweep_f32(SPX_UP_PARAMS, void*) {
  up_host<float>(SPX_UP_ARGS);
  return 0;
}
int sw_up_sweep_f64(SPX_UP_PARAMS, void*) {
  up_host<double>(SPX_UP_ARGS);
  return 0;
}
int sw_down_sweep_f32(SPX_DOWN_PARAMS, void*) {
  down_host<float>(SPX_DOWN_ARGS);
  return 0;
}
int sw_down_sweep_f64(SPX_DOWN_PARAMS, void*) {
  down_host<double>(SPX_DOWN_ARGS);
  return 0;
}
int lw_up_sweep_f32(SPX_LW_UP_PARAMS, void*) {
  lw_up_host<float>(SPX_LW_UP_ARGS);
  return 0;
}
int lw_up_sweep_f64(SPX_LW_UP_PARAMS, void*) {
  lw_up_host<double>(SPX_LW_UP_ARGS);
  return 0;
}
int lw_down_sweep_f32(SPX_LW_DOWN_PARAMS, void*) {
  lw_down_host<float>(SPX_LW_DOWN_ARGS);
  return 0;
}
int lw_down_sweep_f64(SPX_LW_DOWN_PARAMS, void*) {
  lw_down_host<double>(SPX_LW_DOWN_ARGS);
  return 0;
}
}
