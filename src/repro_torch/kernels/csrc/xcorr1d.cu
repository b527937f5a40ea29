// 1-D valid cross-correlation f'_i = sum_j g_j f^_{i+j} (paper Eq. 3,
// Sec. 4.1, Figs. 7-9) for Hopper (sm_90a), in the paper's three tuning
// strategies.
//
// Replaces the TPU kernel repro/kernels/stencil1d.py:xcorr1d_pallas
// (line 73; pl.pallas_call at line 121) with its bodies _kernel_baseline
// (line 52), _kernel_elementwise (line 56) and _mac_loop (line 35). It
// computes what that kernel computes; what the TPU version owes to the
// TPU (the pl.Element windows, the taps zero-padded to a multiple of the
// unroll factor, the wrapper's copy of f to a block multiple) is not
// carried over.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32 and 34 f64 outside the
// tensor cores): bytes at small r, operations at large r. The least time
// is max((n + 2r + n) x itemsize / 3.35 TB/s, 2 (2r + 1) n / rate): at
// n = 2^24 f32, 0.040 ms at r = 1 (bytes) and 1.03 ms at r = 1024
// (operations); f64 at r = 1024, 2.02 ms.
//
// Design, in the paper's GPU terms. One block computes `block_size`
// consecutive outputs. It stages its window of block_size + 2r inputs in
// shared memory once, coalesced, with cp.async (4- and 8-byte elements),
// so each input is read from device memory about once (a block's 2r halo
// twice): the byte bound's traffic. The taps g sit in shared memory
// beside the window. Every thread of a warp reads the same tap at once,
// which shared memory broadcasts, as the constant bank would; shared
// memory was chosen because it needs no per-call copy into a module-wide
// __constant__ symbol (which two calls with different g in flight would
// share) and it holds any radius the window does. The strategies keep
// the reference's meaning:
// - baseline: one output per thread per pass, the tap loop rolled
//   (#pragma unroll 1);
// - pointwise: the tap loop unrolled by U, the last n_taps mod U taps done
//   one by one (no zero-padded taps, no read past the window);
// - elementwise: U outputs per thread, one in each of U adjacent
//   sub-blocks of block_size / U outputs, advanced together from one
//   load of each coefficient.
// Threads per block: min(block_size / U_e, 1024), U_e = U on elementwise
// and 1 otherwise; a thread loops (passes) over its outputs when the
// block has more. The last block of a ragged n masks its outputs and
// stages only the inputs that exist (the rest of its window is zeroed),
// so the wrapper never copies f to a block multiple. Every strategy sums
// the taps in the reference's order, one FMA each. At large r the kernel
// is held back by shared-memory loads, not FMAs: two loads (window, tap)
// per FMA on baseline and pointwise, U + 1 per U FMAs on elementwise.
// Holding the window in registers across taps (register tiling) and
// wider loads are later work.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int MODE_BASELINE = 0;
constexpr int MODE_POINTWISE = 1;
constexpr int MODE_ELEMENTWISE = 2;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_UNROLL = 16;  // U instantiated: 1..16
constexpr int DTYPE_F32 = 0;    // emit.py:DTYPE_CODES
constexpr int DTYPE_F64 = 1;
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB a block can use

__host__ __device__ inline size_t round_up16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Shared memory of one block: the window of block_size + n_taps - 1
// elements, padded to 16 B, then the n_taps taps.
inline size_t smem_bytes(int n_taps, int block_size, size_t item) {
  return round_up16(size_t(block_size + n_taps - 1) * item) +
         size_t(n_taps) * item;
}

inline int launch_threads(int block_size, int mode, int unroll) {
  const int lanes =
      mode == MODE_ELEMENTWISE ? block_size / unroll : block_size;
  return lanes < MAX_THREADS ? lanes : MAX_THREADS;
}

template <typename T, int MODE, int U>
__global__ void __launch_bounds__(MAX_THREADS)
    xcorr1d_kernel(const T* __restrict__ f, const T* __restrict__ g,
                   T* __restrict__ out, long long n, int n_taps,
                   int block_size) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int win = block_size + n_taps - 1;
  T* w = reinterpret_cast<T*>(smem_raw);
  T* taps =
      reinterpret_cast<T*>(smem_raw + round_up16(size_t(win) * sizeof(T)));
  const long long base = (long long)blockIdx.x * block_size;
  const long long left = n - base;
  const int nout = left < block_size ? int(left) : block_size;
  const int avail = nout + n_taps - 1;  // the inputs this block's outputs read
  const int tid = threadIdx.x, nthr = blockDim.x;

  for (int i = tid; i < avail; i += nthr)
    __pipeline_memcpy_async(w + i, f + base + i, sizeof(T));
  for (int i = tid; i < n_taps; i += nthr)
    __pipeline_memcpy_async(taps + i, g + i, sizeof(T));
  __pipeline_commit();
  for (int i = avail + tid; i < win; i += nthr) w[i] = T(0);
  __pipeline_wait_prior(0);
  __syncthreads();

  if constexpr (MODE == MODE_BASELINE) {
    for (int i = tid; i < nout; i += nthr) {
      T acc = T(0);
#pragma unroll 1
      for (int k = 0; k < n_taps; ++k) acc += taps[k] * w[i + k];
      out[base + i] = acc;
    }
  } else if constexpr (MODE == MODE_POINTWISE) {
    for (int i = tid; i < nout; i += nthr) {
      const T* wi = w + i;
      T acc = T(0);
      int k = 0;
#pragma unroll 1
      for (; k + U <= n_taps; k += U) {
#pragma unroll
        for (int u = 0; u < U; ++u) acc += taps[k + u] * wi[k + u];
      }
#pragma unroll 1
      for (; k < n_taps; ++k) acc += taps[k] * wi[k];
      out[base + i] = acc;
    }
  } else {
    const int sub = block_size / U;
    for (int i = tid; i < sub && i < nout; i += nthr) {
      T acc[U];
#pragma unroll
      for (int e = 0; e < U; ++e) acc[e] = T(0);
#pragma unroll 1
      for (int k = 0; k < n_taps; ++k) {
        const T c = taps[k];
#pragma unroll
        for (int e = 0; e < U; ++e) acc[e] += c * w[i + e * sub + k];
      }
#pragma unroll
      for (int e = 0; e < U; ++e)
        if (i + e * sub < nout) out[base + i + e * sub] = acc[e];
    }
  }
}

template <typename T, int MODE, int U>
cudaError_t launch(const void* f, const void* g, void* out, long long n,
                   int n_taps, int block_size, cudaStream_t stream) {
  const size_t smem = smem_bytes(n_taps, block_size, sizeof(T));
  auto kernel = xcorr1d_kernel<T, MODE, U>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (n + block_size - 1) / block_size;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<unsigned(blocks), launch_threads(block_size, MODE, U), smem,
           stream>>>(static_cast<const T*>(f), static_cast<const T*>(g),
                     static_cast<T*>(out), n, n_taps, block_size);
  return cudaGetLastError();
}

// The launch of the instantiated U equal to `unroll` (1..MAX_UNROLL).
template <typename T, int MODE, int U = 1>
cudaError_t launch_unroll(int unroll, const void* f, const void* g,
                          void* out, long long n, int n_taps, int block_size,
                          cudaStream_t stream) {
  if constexpr (U > MAX_UNROLL) {
    return cudaErrorInvalidValue;
  } else {
    if (unroll == U)
      return launch<T, MODE, U>(f, g, out, n, n_taps, block_size, stream);
    return launch_unroll<T, MODE, U + 1>(unroll, f, g, out, n, n_taps,
                                         block_size, stream);
  }
}

template <typename T>
cudaError_t launch_mode(int mode, int unroll, const void* f, const void* g,
                        void* out, long long n, int n_taps, int block_size,
                        cudaStream_t stream) {
  switch (mode) {
    case MODE_BASELINE:
      return launch<T, MODE_BASELINE, 1>(f, g, out, n, n_taps, block_size,
                                         stream);
    case MODE_POINTWISE:
      return launch_unroll<T, MODE_POINTWISE>(unroll, f, g, out, n, n_taps,
                                              block_size, stream);
    case MODE_ELEMENTWISE:
      return launch_unroll<T, MODE_ELEMENTWISE>(unroll, f, g, out, n, n_taps,
                                                block_size, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch the cross-correlation on `stream`: out[i] = sum_k g[k] f[i + k]
// for i < n, f holding n + n_taps - 1 elements. `f`, `g` and `out` are
// device memory of the element type `dtype` (DTYPE_F32 or DTYPE_F64);
// `mode` is 0 baseline, 1 pointwise, 2 elementwise, with `unroll` in
// 1..16 (1 on baseline; dividing block_size on elementwise). Returns the
// cudaError_t of the launch (0 on success).
int repro_xcorr1d(const void* f, const void* g, void* out, long long n,
                  int n_taps, int block_size, int mode, int unroll, int dtype,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (n < 1 || n_taps < 1 || block_size < 1 || unroll < 1 ||
      unroll > MAX_UNROLL || (mode == MODE_BASELINE && unroll != 1) ||
      (mode == MODE_ELEMENTWISE && block_size % unroll != 0))
    return int(cudaErrorInvalidValue);
  const size_t item = dtype == DTYPE_F64 ? 8 : 4;
  if (smem_bytes(n_taps, block_size, item) > SMEM_LIMIT)
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DTYPE_F32:
      return int(launch_mode<float>(mode, unroll, f, g, out, n, n_taps,
                                    block_size, st));
    case DTYPE_F64:
      return int(launch_mode<double>(mode, unroll, f, g, out, n, n_taps,
                                     block_size, st));
    default:  // bf16 and f16 wait for ROADMAP B6b
      return int(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory of one block (xcorr1d.py:smem_bytes must equal it).
long long repro_xcorr1d_smem_bytes(int n_taps, int block_size, int dtype) {
  return (long long)smem_bytes(n_taps, block_size,
                               dtype == DTYPE_F64 ? 8 : 4);
}

// Threads of one block (xcorr1d.py:launch_threads must equal it).
int repro_xcorr1d_threads(int block_size, int mode, int unroll) {
  return launch_threads(block_size, mode, unroll);
}

}  // extern "C"
