// Probe kernels K6 and K7: the card's arithmetic and memory ceilings, which
// the roofline tool (tools/roofline.py of the port) holds every other kernel
// against.
//
// Replace the TPU probes of tools/roofline.py:
//   K6 (fma_chain_kernel): measure_vpu_peak_flops :39 (kernel :52), chained
//       dependent FMAs acc = acc * c + b on f32 vector registers;
//   K7 (copy_add_kernel): measure_hbm_bw :83 (kernel :95), o = x + 1 streamed
//       over a 512 MB array.
// Plain versions: ops/probe_kernels.py fma_chain_plain and copy_add_plain.
//
// Bound on the H100: K6 by operations (FMA issue: 128 f32 or 64 f64 lanes
// per SM, one FMA a lane a cycle), K7 by device-memory bytes.  K6 keeps
// FMA_ACC independent chains per thread, so each scheduler always has an
// FMA whose operands are ready although each one waits for the last of its
// own chain; the chains start from an input array and b, c are arguments,
// so nothing folds, and each step is exactly the fma() that the FLOP count
// (2 per FMA) assumes.  K7 moves 16 bytes per thread and access (float4)
// in a grid-stride loop; its array is ten times the 50 MB L2.

#include "common.cuh"

#define SPX_FMA_ACC 8
#define SPX_FMA_INNER 512

namespace spx {

// K6, one thread: chains k = 0 .. FMA_ACC-1 start at x[k n + t] (coalesced
// across the warp) and take FMA_INNER steps acc = fma(acc, c, b).
template <typename T>
SPX_DEV void fma_chain_thread(const T* x, T* out, T b, T c, long long n,
                              long long t) {
  T acc[SPX_FMA_ACC];
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int k = 0; k < SPX_FMA_ACC; ++k) acc[k] = x[k * n + t];
#ifdef __CUDACC__
#pragma unroll 8
#endif
  for (int i = 0; i < SPX_FMA_INNER; ++i) {
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int k = 0; k < SPX_FMA_ACC; ++k) acc[k] = fma(acc[k], c, b);
  }
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int k = 0; k < SPX_FMA_ACC; ++k) out[k * n + t] = acc[k];
}

// K7's unit of access: four floats, one 16-byte load or store on the card
// (the wrapper checks the alignment).
#ifdef __CUDACC__
using Float4 = float4;
#else
struct Float4 {
  float x, y, z, w;
};
#endif

SPX_DEV Float4 add_one(Float4 v) {
  v.x += 1.0f;
  v.y += 1.0f;
  v.z += 1.0f;
  v.w += 1.0f;
  return v;
}

// K7, one thread of `stride`: groups t, t + stride, ... of four floats, then
// the element 4 (n / 4) + t of the ragged tail.
SPX_DEV void copy_add_thread(const float* x, float* o, long long n,
                             long long t, long long stride) {
  const Float4* xv = reinterpret_cast<const Float4*>(x);
  Float4* ov = reinterpret_cast<Float4*>(o);
  const long long n4 = n / 4;
  for (long long i = t; i < n4; i += stride) ov[i] = add_one(xv[i]);
  if (t < n - 4 * n4) o[4 * n4 + t] = x[4 * n4 + t] + 1.0f;
}

}  // namespace spx

#define SPX_FMA_PARAMS void *x, void *out, double b, double c, long long n
#define SPX_FMA_ARGS x, out, b, c, n
#define SPX_COPY_PARAMS void *x, void *o, long long n
#define SPX_COPY_ARGS x, o, n

#ifdef __CUDACC__
template <typename T>
__global__ void fma_chain_kernel(const T* x, T* out, T b, T c, long long n) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t < n) spx::fma_chain_thread(x, out, b, c, n, t);
}

__global__ void copy_add_kernel(const float* x, float* o, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  spx::copy_add_thread(x, o, n, blockIdx.x * (long long)blockDim.x + threadIdx.x,
                       stride);
}

// K6: one thread per chain set, 256 to a block (ragged last block masked).
template <typename T>
static int launch_fma(SPX_FMA_PARAMS, void* stream) {
  const unsigned blocks = (unsigned)((n + 255) / 256);
  fma_chain_kernel<T><<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const T*)x, (T*)out, T(b), T(c), n);
  return (int)cudaGetLastError();
}

extern "C" int fma_chain_f32(SPX_FMA_PARAMS, void* stream) {
  return launch_fma<float>(SPX_FMA_ARGS, stream);
}
extern "C" int fma_chain_f64(SPX_FMA_PARAMS, void* stream) {
  return launch_fma<double>(SPX_FMA_ARGS, stream);
}

// K7: eight blocks of 256 threads per SM (a full SM's 2,048 threads), or
// fewer for a short array.
extern "C" int copy_add_f32(SPX_COPY_PARAMS, void* stream) {
  int device = 0, sms = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long groups = (n / 4 + 255) / 256;
  const long long blocks = groups < 8LL * sms ? (groups > 0 ? groups : 1) : 8LL * sms;
  copy_add_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)o, n);
  return (int)cudaGetLastError();
}
#endif
