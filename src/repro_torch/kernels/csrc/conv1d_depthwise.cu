// Depthwise causal 1-D convolution (mamba2's conv frontend) for Hopper
// (sm_90a): y[b,t,c] = sum_{j<k} w[j,c] x[b, t-(k-1)+j, c], zeros left of
// each sequence, optionally y * sigmoid(y) (SiLU).
//
// Replaces the TPU kernel repro/kernels/conv1d_depthwise.py:
// conv1d_depthwise_pallas (line 36; pl.pallas_call at line 58) with its
// body _kernel (line 26). It computes what that kernel computes; what the
// TPU version owes to the TPU (the (seq x 128-lane) tiles with their
// pl.Element halo, the padded copy of x left of each sequence, the pad of
// seq to a multiple of block_seq) is not carried over.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. Each output reads k inputs and
// k taps and does 2k FLOPs, so at k = 4 the work is 0.87 GFLOP against
// 436 MB at mamba2's prefill launch (4, 8192, 3328) in bf16: 0.130 ms of
// memory, 0.013 ms of f32 arithmetic.
//
// Design. Channels lie across the threads of a warp, so every load and
// store is one coalesced row segment: f32 one channel per thread, bf16
// two per thread as __nv_bfloat162 (4-byte accesses) when the channels
// and strides allow it, else one. Each thread walks a run of block_seq
// positions of its channel(s) (grid y: runs along the sequence; grid z:
// the batch; grid x: channel blocks). The last k-1 inputs stay in
// registers as a sliding window, so each input is read once, plus k-1
// halo values at the start of a run; the k taps sit in registers. U
// positions are loaded before any of them is used, so a thread keeps U
// loads in flight. The causal zeros come from the index (t < 0 reads 0)
// and the ragged last run is masked: x is read in place, through its
// batch and row strides, so mamba2's xBC (a column slice of the
// in-projection, rows 2 d_inner + 2 g n + h apart) needs no copy.
//
// Rounding. The sum is taken as the TPU kernel's body takes it, in the
// input type, term by term in tap order (term = w_j x_j; acc = acc +
// term): each product and each partial sum is rounded to T (in f32 with
// __fmul_rn/__fadd_rn, so no FMA contraction), and SiLU as y * sigmoid(y)
// with sigmoid(y) rounded to T. So the kernel equals its plain version
// (ref.conv1d_depthwise) bit for bit. A kernel that summed in f32 and
// rounded once would be closer to exact, but random-init mamba2 in bf16
// amplifies any change of rounding: on a 48-layer, 256-wide model it
// moved the last logits by 57% of their largest value (CPU,
// tools/mamba2_drift.py rounding), where the card's prefill check allows
// 2e-2. Wider vectors and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int DTYPE_F32 = 0;   // emit.py:DTYPE_CODES
constexpr int DTYPE_BF16 = 2;
constexpr int ACT_NONE = 0;
constexpr int ACT_SILU = 1;
constexpr int MAX_K = 8;       // taps instantiated: 1..8
constexpr int MAX_THREADS = 128;
constexpr int U = 8;           // positions loaded ahead by each thread
constexpr int MAX_GRID_YZ = 65535;

// Threads of one block: one lane per VEC channels, whole warps, at most
// MAX_THREADS (conv1d_depthwise.py:launch_layout must equal it).
inline int launch_threads(int c, int vec) {
  const int lanes = (c + vec - 1) / vec;
  const int warps = (lanes + 31) / 32;
  return warps * 32 < MAX_THREADS ? warps * 32 : MAX_THREADS;
}

// v rounded to T and back (what a T-typed op of the plain version keeps).
template <typename T>
__device__ inline float round_to(float v);
template <>
__device__ inline float round_to<float>(float v) { return v; }
template <>
__device__ inline float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, int VEC>
struct Io;

template <>
struct Io<float, 1> {
  __device__ static void load(const float* p, float (&v)[1]) { v[0] = *p; }
  __device__ static void store(float* p, const float (&v)[1]) { *p = v[0]; }
};

template <>
struct Io<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float (&v)[1]) {
    v[0] = __bfloat162float(*p);
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[1]) {
    *p = __float2bfloat16_rn(v[0]);
  }
};

template <>
struct Io<__nv_bfloat16, 2> {
  __device__ static void load(const __nv_bfloat16* p, float (&v)[2]) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = f.x;
    v[1] = f.y;
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[2]) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  }
};

template <typename T, int VEC, int K, int ACT>
__global__ void __launch_bounds__(MAX_THREADS)
    conv1d_depthwise_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            T* __restrict__ y, int s, int c,
                            long long x_stride_b, long long x_stride_s,
                            int block_seq) {
  using IO = Io<T, VEC>;
  const int ch = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (ch >= c) return;
  const int t0 = blockIdx.y * block_seq;
  const int t1 = min(t0 + block_seq, s);
  const T* xb = x + (long long)blockIdx.z * x_stride_b + ch;
  T* yb = y + ((long long)blockIdx.z * s) * c + ch;

  float taps[K][VEC];
#pragma unroll
  for (int j = 0; j < K; ++j) IO::load(w + (long long)j * c + ch, taps[j]);

  // win[0..K-2]: the inputs t-(K-1) .. t-1; win[K-1]: input t.
  float win[K][VEC];
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const int t = t0 - (K - 1) + j;
    if (t >= 0) {
      IO::load(xb + t * x_stride_s, win[j]);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) win[j][v] = 0.f;
    }
  }

  for (int t = t0; t < t1; t += U) {
    float nx[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t + u < t1) {
        IO::load(xb + (t + u) * x_stride_s, nx[u]);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) nx[u][v] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float acc[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        win[K - 1][v] = nx[u][v];
        acc[v] = round_to<T>(__fmul_rn(taps[0][v], win[0][v]));
#pragma unroll
        for (int j = 1; j < K; ++j)
          acc[v] = round_to<T>(__fadd_rn(
              acc[v], round_to<T>(__fmul_rn(taps[j][v], win[j][v]))));
        if constexpr (ACT == ACT_SILU) {
          const float sig = round_to<T>(1.f / (1.f + expf(-acc[v])));
          acc[v] = __fmul_rn(acc[v], sig);
        }
      }
      if (t + u < t1) IO::store(yb + (long long)(t + u) * c, acc);
#pragma unroll
      for (int j = 0; j < K - 1; ++j) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) win[j][v] = win[j + 1][v];
      }
    }
  }
}

struct Args {
  const void* x;
  const void* w;
  void* y;
  int b, s, c, k;
  long long x_stride_b, x_stride_s;
  int block_seq;
  cudaStream_t stream;
};

template <typename T, int VEC, int K, int ACT>
cudaError_t launch(const Args& a) {
  const int threads = launch_threads(a.c, VEC);
  const int lanes = (a.c + VEC - 1) / VEC;
  const dim3 grid((lanes + threads - 1) / threads,
                  (a.s + a.block_seq - 1) / a.block_seq, a.b);
  conv1d_depthwise_kernel<T, VEC, K, ACT><<<grid, threads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w),
      static_cast<T*>(a.y), a.s, a.c, a.x_stride_b, a.x_stride_s,
      a.block_seq);
  return cudaGetLastError();
}

// The launch of the instantiated K equal to a.k (1..MAX_K).
template <typename T, int VEC, int ACT, int K = 1>
cudaError_t launch_k(const Args& a) {
  if constexpr (K > MAX_K) {
    return cudaErrorInvalidValue;
  } else {
    if (a.k == K) return launch<T, VEC, K, ACT>(a);
    return launch_k<T, VEC, ACT, K + 1>(a);
  }
}

template <typename T, int VEC>
cudaError_t launch_act(int activation, const Args& a) {
  switch (activation) {
    case ACT_NONE:
      return launch_k<T, VEC, ACT_NONE>(a);
    case ACT_SILU:
      return launch_k<T, VEC, ACT_SILU>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch the depthwise causal conv on `stream`. `x` is (b, s, c) with
// element strides (x_stride_b, x_stride_s, 1); `w` is (k, c) and `y`
// (b, s, c), both contiguous; all of element type `dtype` (DTYPE_F32 or
// DTYPE_BF16). `vec` is the channels per thread: 1, or 2 in bf16 (then c
// and both strides are even, x and w 4-byte aligned). `activation` is 0
// (none) or 1 (SiLU). Returns the cudaError_t of the launch (0 on
// success).
int repro_conv1d_depthwise(const void* x, const void* w, void* y, int b,
                           int s, int c, int k, long long x_stride_b,
                           long long x_stride_s, int block_seq,
                           int activation, int dtype, int vec, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (b < 1 || s < 1 || c < 1 || k < 1 || k > MAX_K || block_seq < 1 ||
      b > MAX_GRID_YZ || (s + block_seq - 1) / block_seq > MAX_GRID_YZ)
    return int(cudaErrorInvalidValue);
  const Args a{x, w, y, b, s, c, k, x_stride_b, x_stride_s, block_seq,
               static_cast<cudaStream_t>(stream)};
  if (dtype == DTYPE_F32 && vec == 1)
    return int(launch_act<float, 1>(activation, a));
  if (dtype == DTYPE_BF16 && vec == 1)
    return int(launch_act<__nv_bfloat16, 1>(activation, a));
  if (dtype == DTYPE_BF16 && vec == 2) {
    if (c % 2 || x_stride_b % 2 || x_stride_s % 2 ||
        reinterpret_cast<unsigned long long>(x) % 4 ||
        reinterpret_cast<unsigned long long>(w) % 4)
      return int(cudaErrorInvalidValue);
    return int(launch_act<__nv_bfloat16, 2>(activation, a));
  }
  return int(cudaErrorInvalidValue);  // other types wait for ROADMAP B7b
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Threads of one block (conv1d_depthwise.py:launch_layout must equal it).
int repro_conv1d_depthwise_threads(int c, int vec) {
  return launch_threads(c, vec);
}

}  // extern "C"
