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
// (2 per FMA) assumes.  K7 is a one-shot grid, as PyTorch's elementwise
// kernels launch: no grid-stride loop, each
// thread moves one float4 (16 bytes an access) with streaming cache hints
// (__ldcs / __stcs: the data is touched once); block 0 also does the
// ragged tail of n % 4.  Its array is ten times the 50 MB L2.

#include "common.cuh"

#define SPX_FMA_ACC 8
#define SPX_FMA_INNER 512
// K7's threads a block: of 128, 256 or 512 threads a block and 1, 2, 4 or 8
// float4 a thread, one float4 and 512 threads was the fastest on the H100
// (against torch.add on the same 512 MB, in turns)
#define SPX_COPY_THREADS 512

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

SPX_DEV Float4 load_stream(const Float4* p) {
#ifdef __CUDACC__
  return __ldcs(p);
#else
  return *p;
#endif
}

SPX_DEV void store_stream(Float4* p, Float4 v) {
#ifdef __CUDACC__
  __stcs(p, v);
#else
  *p = v;
#endif
}

// K7, thread t of block blk: the float4 group blk * THREADS + t, then in
// block 0 the element 4 (n / 4) + t of the ragged tail.
SPX_DEV void copy_add_thread(const float* x, float* o, long long n,
                             long long blk, int t) {
  const Float4* xv = reinterpret_cast<const Float4*>(x);
  Float4* ov = reinterpret_cast<Float4*>(o);
  const long long n4 = n / 4, i = blk * SPX_COPY_THREADS + t;
  if (i < n4) store_stream(ov + i, add_one(load_stream(xv + i)));
  if (blk == 0 && t < n - 4 * n4) o[4 * n4 + t] = x[4 * n4 + t] + 1.0f;
}

// K7's blocks for n floats (at least one, for the tail).
inline long long copy_add_blocks(long long n) {
  const long long b = (n / 4 + SPX_COPY_THREADS - 1) / SPX_COPY_THREADS;
  return b > 0 ? b : 1;
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

__global__ void __launch_bounds__(SPX_COPY_THREADS)
    copy_add_kernel(const float* x, float* o, long long n) {
  spx::copy_add_thread(x, o, n, blockIdx.x, threadIdx.x);
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

// K7: one block per THREADS float4 groups.
extern "C" int copy_add_f32(SPX_COPY_PARAMS, void* stream) {
  copy_add_kernel<<<(unsigned)spx::copy_add_blocks(n), SPX_COPY_THREADS, 0,
                    (cudaStream_t)stream>>>((const float*)x, (float*)o, n);
  return (int)cudaGetLastError();
}
#endif
