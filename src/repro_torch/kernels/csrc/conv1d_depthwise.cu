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
// 436 MB at mamba2's prefill launch (4, 8192, 3328) in bf16 or f16: 0.130
// ms of memory, 0.013 ms of f32 arithmetic; in f64 0.521 ms of memory.
//
// Design. Channels lie across the lanes of a warp, VEC channels a lane:
// 16-byte accesses (8 bf16/f16, 4 f32 or 2 f64 channels) when the channel
// count, both outer strides of x and the pointers allow it (mamba2's xBC:
// c = 3328, rows 6448 apart, offset 3072), else 2-byte pairs
// (__nv_bfloat162, __half2) or single channels. So every load and store of a warp is one coalesced
// row segment of 32 lanes. A warp column is 32 lanes of channels; the
// work is the (column, batch, position) space, positions fastest, and a
// persistent grid (the kernel's resident blocks per SM times the SMs)
// splits it into one contiguous range of positions per warp, equal to
// within one position, so every SM gets the same share in one wave. A
// warp walks its range along the sequence (a new column or batch member
// restarts the walk). The k taps sit in registers; the last k-1 inputs
// stay in registers as a sliding window, so each input is read once,
// plus k-1 halo values at the start of a range. Loads are in flight while
// earlier positions are computed: U positions (4 at 16 bytes, else 8) are
// computed from registers while the next U are loading (a register double
// buffer). The causal zeros come from the index (t < 0 reads 0), and x is
// read in place through its batch and row strides, so mamba2's xBC (a
// column slice of the in-projection) needs no copy. No shared memory.
// K is templated up to MAX_K = 8 taps (a register window of k - 1 inputs
// and k taps a lane; f64 at 16-byte lanes doubles both). More taps run one
// body with k at run time (K = 0): 8 positions a pass, tap by tap, the
// tap's row and the 8 inputs it meets read each time (the earlier ones
// again, through L1), so the window costs no registers at any k.
//
// Rounding. The sum is taken as the TPU kernel's body takes it, in the
// input type, term by term in tap order (term = w_j x_j; acc = acc +
// term): each product and each partial sum is rounded to T, and SiLU as y
// * sigmoid(y) with sigmoid(y) rounded to T. f32 and f64 use
// __f*_rn/__d*_rn (no FMA contraction). bf16 and f16 use the packed
// mul.rn and add.rn (bf16x2 of sm_90, f16x2), two channels an
// instruction: the product of two p-bit values is exact in f32 and f32
// has 24 >= 2p + 2 significand bits (p = 8 bf16, 11 f16), so rounding
// once to the type gives the bits of rounding to f32 and then to it, as
// the plain version does (the explicit .rn also keeps the compiler from
// fusing them). So the kernel equals its plain version
// (ref.conv1d_depthwise) bit for bit; the SiLU runs in f32 with the
// 2-byte type's roundings, as the plain version's, and in f64 by exp. A
// kernel that summed in f32 and rounded once would be closer to exact,
// but random-init mamba2 in bf16
// amplifies any change of rounding: on a 48-layer, 256-wide model it
// moved the last logits by 57% of their largest value (CPU,
// tools/mamba2_drift.py rounding), where the card's prefill check allows
// 2e-2. TMA for the rows is not used: a warp's 512-byte row segments
// already coalesce, and the registers hold the window.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>

#include "persistent.cuh"

namespace {

constexpr int DTYPE_F32 = 0;   // emit.py:DTYPE_CODES
constexpr int DTYPE_F64 = 1;
constexpr int DTYPE_BF16 = 2;
constexpr int DTYPE_F16 = 3;
constexpr int ACT_NONE = 0;
constexpr int ACT_SILU = 1;
constexpr int MAX_K = 8;       // taps instantiated: 1..8; more: K = 0
constexpr int THREADS = 256;   // conv1d_depthwise.py:THREADS
constexpr int WARPS = THREADS / 32;
// The grid gives each warp at least this many positions
// (conv1d_depthwise.py:MIN_WARP_POSITIONS).
constexpr int MIN_WARP_POSITIONS = 32;

// Positions of the (warp column, batch, position) space: 32 lanes of vec
// channels a column (conv1d_depthwise.py:positions).
__host__ __device__ inline long long positions(int b, int s, int c, int vec) {
  const long long lanes = (c + vec - 1) / vec;
  return (lanes + 31) / 32 * b * (long long)s;
}

inline int itemsize(int dtype) {
  return dtype == DTYPE_F64 ? 8 : dtype == DTYPE_F32 ? 4 : 2;
}

// The packed arithmetic of a 2-byte type: two channels a register, each
// half rounded once; SiLU's conversions to and from f32.
template <typename T>
struct Pair;

template <>
struct Pair<__nv_bfloat16> {
  __device__ static unsigned mul(unsigned a, unsigned b) {
    unsigned d;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  __device__ static unsigned add(unsigned a, unsigned b) {
    unsigned d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  __device__ static float2 to_float2(unsigned h) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h));
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ static unsigned from_floats(float lo, float hi) {
    const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&r);
  }
};

template <>
struct Pair<__half> {
  __device__ static unsigned mul(unsigned a, unsigned b) {
    unsigned d;
    asm("mul.rn.f16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  __device__ static unsigned add(unsigned a, unsigned b) {
    unsigned d;
    asm("add.rn.f16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  __device__ static float2 to_float2(unsigned h) {
    return __half22float2(*reinterpret_cast<const __half2*>(&h));
  }
  __device__ static float round(float x) {
    return __half2float(__float2half_rn(x));
  }
  __device__ static unsigned from_floats(float lo, float hi) {
    const __half2 r = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&r);
  }
};

// VEC channels of one lane in registers, with the plain version's
// arithmetic in T.
template <typename T, int VEC>
struct Lanes;

template <int VEC>
struct Lanes<float, VEC> {
  static_assert(VEC == 1 || VEC == 4, "f32: 1 or 4 channels a lane");
  float v[VEC];
  __device__ void load(const float* p) {
    if constexpr (VEC == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
      v[0] = *p;
    }
  }
  __device__ void store(float* p) const {
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      *p = v[0];
    }
  }
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = 0.f;
  }
  __device__ static Lanes mul(const Lanes& a, const Lanes& b) {
    Lanes r;
#pragma unroll
    for (int i = 0; i < VEC; ++i) r.v[i] = __fmul_rn(a.v[i], b.v[i]);
    return r;
  }
  __device__ static Lanes add(const Lanes& a, const Lanes& b) {
    Lanes r;
#pragma unroll
    for (int i = 0; i < VEC; ++i) r.v[i] = __fadd_rn(a.v[i], b.v[i]);
    return r;
  }
  __device__ void silu() {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      v[i] = __fmul_rn(v[i], 1.f / (1.f + expf(-v[i])));
  }
};

template <int VEC>
struct Lanes<double, VEC> {
  static_assert(VEC == 1 || VEC == 2, "f64: 1 or 2 channels a lane");
  double v[VEC];
  __device__ void load(const double* p) {
    if constexpr (VEC == 2) {
      const double2 q = *reinterpret_cast<const double2*>(p);
      v[0] = q.x, v[1] = q.y;
    } else {
      v[0] = *p;
    }
  }
  __device__ void store(double* p) const {
    if constexpr (VEC == 2) {
      *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
    } else {
      *p = v[0];
    }
  }
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = 0.0;
  }
  __device__ static Lanes mul(const Lanes& a, const Lanes& b) {
    Lanes r;
#pragma unroll
    for (int i = 0; i < VEC; ++i) r.v[i] = __dmul_rn(a.v[i], b.v[i]);
    return r;
  }
  __device__ static Lanes add(const Lanes& a, const Lanes& b) {
    Lanes r;
#pragma unroll
    for (int i = 0; i < VEC; ++i) r.v[i] = __dadd_rn(a.v[i], b.v[i]);
    return r;
  }
  __device__ void silu() {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      v[i] = __dmul_rn(v[i], 1.0 / (1.0 + exp(-v[i])));
  }
};

// 2-byte types as packed pairs; one channel a lane keeps it in the low
// half (the high half stays 0).
template <typename T, int VEC>
struct Lanes2 {
  static_assert(VEC == 1 || VEC == 2 || VEC == 8,
                "bf16/f16: 1, 2 or 8 channels a lane");
  using Ops = Pair<T>;
  static constexpr int P = VEC > 1 ? VEC / 2 : 1;
  unsigned h[P];
  __device__ void load(const T* p) {
    if constexpr (VEC == 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      h[0] = q.x, h[1] = q.y, h[2] = q.z, h[3] = q.w;
    } else if constexpr (VEC == 2) {
      h[0] = *reinterpret_cast<const unsigned*>(p);
    } else {
      h[0] = *reinterpret_cast<const unsigned short*>(p);
    }
  }
  __device__ void store(T* p) const {
    if constexpr (VEC == 8) {
      *reinterpret_cast<uint4*>(p) = make_uint4(h[0], h[1], h[2], h[3]);
    } else if constexpr (VEC == 2) {
      *reinterpret_cast<unsigned*>(p) = h[0];
    } else {
      *reinterpret_cast<unsigned short*>(p) = (unsigned short)(h[0] & 0xffffu);
    }
  }
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < P; ++i) h[i] = 0u;
  }
  __device__ static Lanes2 mul(const Lanes2& a, const Lanes2& b) {
    Lanes2 r;
#pragma unroll
    for (int i = 0; i < P; ++i) r.h[i] = Ops::mul(a.h[i], b.h[i]);
    return r;
  }
  __device__ static Lanes2 add(const Lanes2& a, const Lanes2& b) {
    Lanes2 r;
#pragma unroll
    for (int i = 0; i < P; ++i) r.h[i] = Ops::add(a.h[i], b.h[i]);
    return r;
  }
  // y * sigmoid(y) in f32, sigmoid(y) rounded to T, the product rounded
  // to T (the plain version's roundings).
  __device__ void silu() {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float2 f = Ops::to_float2(h[i]);
      const float s0 = Ops::round(1.f / (1.f + expf(-f.x)));
      const float s1 = Ops::round(1.f / (1.f + expf(-f.y)));
      h[i] = Ops::from_floats(__fmul_rn(f.x, s0), __fmul_rn(f.y, s1));
    }
  }
};

// The lanes of T: Lanes, or Lanes2 for the 2-byte types.
template <typename T, int VEC>
struct LanesOf {
  using type = Lanes<T, VEC>;
};
template <int VEC>
struct LanesOf<__nv_bfloat16, VEC> {
  using type = Lanes2<__nv_bfloat16, VEC>;
};
template <int VEC>
struct LanesOf<__half, VEC> {
  using type = Lanes2<__half, VEC>;
};

// One warp's run of positions [t0, t1) of one sequence, this lane's
// channels: xb and yb point at the lane's first channel of position 0.
// K taps in registers, the last K - 1 inputs a register window.
template <typename T, int VEC, int K, int ACT>
__device__ __forceinline__ void run(const T* __restrict__ xb,
                                    const T* __restrict__ wc,
                                    T* __restrict__ yb, int c,
                                    long long x_stride_s, int t0, int t1) {
  using L = typename LanesOf<T, VEC>::type;
  constexpr int U = VEC * int(sizeof(T)) == 16 ? 4 : 8;
  L taps[K];
#pragma unroll
  for (int j = 0; j < K; ++j) taps[j].load(wc + (long long)j * c);
  // xs[0..K-2]: inputs t-(K-1) .. t-1; xs[K-1+u]: input t+u.
  L xs[K - 1 + U];
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const int t = t0 - (K - 1) + j;
    if (t >= 0)
      xs[j].load(xb + t * x_stride_s);
    else
      xs[j].zero();
  }
  L nx[U];  // the next U inputs, in flight while the current U compute
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (t0 + u < t1)
      nx[u].load(xb + (t0 + u) * x_stride_s);
    else
      nx[u].zero();
  }
  for (int t = t0; t < t1; t += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) xs[K - 1 + u] = nx[u];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int tn = t + U + u;
      if (tn < t1)
        nx[u].load(xb + tn * x_stride_s);
      else
        nx[u].zero();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      L acc = L::mul(taps[0], xs[u]);
#pragma unroll
      for (int j = 1; j < K; ++j) acc = L::add(acc, L::mul(taps[j], xs[u + j]));
      if constexpr (ACT == ACT_SILU) acc.silu();
      if (t + u < t1) acc.store(yb + (long long)(t + u) * c);
    }
#pragma unroll
    for (int j = 0; j < K - 1; ++j) xs[j] = xs[U + j];
  }
}

// As run, for k > MAX_K taps known at run time: U positions a pass, tap
// by tap in order, the tap's row and the U inputs it meets loaded each
// time (the earlier inputs again, through L1).
template <typename T, int VEC, int ACT>
__device__ __forceinline__ void run_any_k(const T* __restrict__ xb,
                                          const T* __restrict__ wc,
                                          T* __restrict__ yb, int c,
                                          long long x_stride_s, int t0,
                                          int t1, int k) {
  using L = typename LanesOf<T, VEC>::type;
  constexpr int U = 8;
  for (int t = t0; t < t1; t += U) {
    L acc[U];
#pragma unroll 1
    for (int j = 0; j < k; ++j) {
      L wj;
      wj.load(wc + (long long)j * c);
      L xv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int ti = t + u - (k - 1) + j;  // < t1 for every stored u
        if (ti >= 0 && ti < t1)
          xv[u].load(xb + ti * x_stride_s);
        else
          xv[u].zero();
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        acc[u] = j ? L::add(acc[u], L::mul(wj, xv[u])) : L::mul(wj, xv[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if constexpr (ACT == ACT_SILU) acc[u].silu();
      if (t + u < t1) acc[u].store(yb + (long long)(t + u) * c);
    }
  }
}

// Warp w of W takes positions [w P / W, (w + 1) P / W) of the (column,
// batch, position) space (conv1d_depthwise.py:warp_runs mirrors it). Up to
// 4 taps, at least 3 blocks an SM in f32 (80 registers) and 2 in other
// types (a cap of 80 spilled bf16 and ran slower); more taps, and the
// run-time k (K = 0), take what they need.
template <typename T, int VEC, int K, int ACT>
__global__ void __launch_bounds__(THREADS,
                                  K > 4 || K == 0
                                      ? 1
                                      : (sizeof(T) == 4 ? 3 : 2))
    conv1d_depthwise_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            T* __restrict__ y, int b, int s, int c, int k,
                            long long x_stride_b, long long x_stride_s) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long n_warps = (long long)gridDim.x * WARPS;
  const long long seq = (long long)b * s;
  const long long total = positions(b, s, c, VEC);
  long long p = warp * total / n_warps;
  const long long p_end = (warp + 1) * total / n_warps;
  while (p < p_end) {
    const long long col = p / seq;
    const long long rem = p - col * seq;
    const int bi = int(rem / s);
    const int t0 = int(rem - (long long)bi * s);
    const long long left = p_end - p;
    const int t1 = left < s - t0 ? t0 + int(left) : s;
    const int ch = (int(col) * 32 + lane) * VEC;
    if (ch < c) {
      if constexpr (K == 0) {
        run_any_k<T, VEC, ACT>(x + bi * x_stride_b + ch, w + ch,
                               y + (long long)bi * s * c + ch, c, x_stride_s,
                               t0, t1, k);
      } else {
        run<T, VEC, K, ACT>(x + bi * x_stride_b + ch, w + ch,
                            y + (long long)bi * s * c + ch, c, x_stride_s, t0,
                            t1);
      }
    }
    p += t1 - t0;
  }
}

struct Args {
  const void* x;
  const void* w;
  void* y;
  int b, s, c, k;
  long long x_stride_b, x_stride_s;
  long long items;  // blocks the work could use (at least 1)
  int device;
  bool launch;      // false: only the grid
  cudaStream_t stream;
};

template <typename T, int VEC, int K, int ACT>
cudaError_t launch(const Args& a, long long& grid) {
  constexpr auto kernel = conv1d_depthwise_kernel<T, VEC, K, ACT>;
  cudaError_t err =
      stencil::persistent_grid<kernel>(THREADS, 0, a.device, a.items, grid);
  if (err != cudaSuccess || !a.launch) return err;
  kernel<<<unsigned(grid), THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w),
      static_cast<T*>(a.y), a.b, a.s, a.c, a.k, a.x_stride_b, a.x_stride_s);
  return cudaGetLastError();
}

// The launch of the instantiated K equal to a.k (1..MAX_K), or the body
// with k at run time (K = 0) above MAX_K.
template <typename T, int VEC, int ACT, int K = 1>
cudaError_t launch_k(const Args& a, long long& grid) {
  if constexpr (K > MAX_K) {
    return launch<T, VEC, 0, ACT>(a, grid);
  } else {
    if (a.k == K) return launch<T, VEC, K, ACT>(a, grid);
    return launch_k<T, VEC, ACT, K + 1>(a, grid);
  }
}

template <typename T, int VEC>
cudaError_t launch_act(int activation, const Args& a, long long& grid) {
  switch (activation) {
    case ACT_NONE:
      return launch_k<T, VEC, ACT_NONE>(a, grid);
    case ACT_SILU:
      return launch_k<T, VEC, ACT_SILU>(a, grid);
    default:
      return cudaErrorInvalidValue;
  }
}

// 16-byte lanes of any type; 2-byte pairs; single channels.
template <typename T, int WIDE>
cudaError_t launch_vec(int activation, int vec, const Args& a,
                       long long& grid) {
  if (vec == 1) return launch_act<T, 1>(activation, a, grid);
  if (vec == WIDE) return launch_act<T, WIDE>(activation, a, grid);
  if constexpr (sizeof(T) == 2) {
    if (vec == 2) return launch_act<T, 2>(activation, a, grid);
  }
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(int activation, int dtype, int vec, const Args& a,
                     long long& grid) {
  if (a.k < 1) return cudaErrorInvalidValue;
  switch (dtype) {
    case DTYPE_F32:
      return launch_vec<float, 4>(activation, vec, a, grid);
    case DTYPE_F64:
      return launch_vec<double, 2>(activation, vec, a, grid);
    case DTYPE_BF16:
      return launch_vec<__nv_bfloat16, 8>(activation, vec, a, grid);
    case DTYPE_F16:
      return launch_vec<__half, 8>(activation, vec, a, grid);
    default:
      return cudaErrorInvalidValue;
  }
}

// Blocks the work of (b, s, c) could use: one warp per
// MIN_WARP_POSITIONS positions (conv1d_depthwise.py:launch_layout).
inline long long work_blocks(int b, int s, int c, int vec) {
  const long long per_block = (long long)WARPS * MIN_WARP_POSITIONS;
  const long long n = (positions(b, s, c, vec) + per_block - 1) / per_block;
  return n > 0 ? n : 1;
}

}  // namespace

extern "C" {

// Launch the depthwise causal conv on `stream`. `x` is (b, s, c) with
// element strides (x_stride_b, x_stride_s, 1); `w` is (k, c) and `y`
// (b, s, c), both contiguous; all of element type `dtype` (DTYPE_F32,
// DTYPE_F64, DTYPE_BF16 or DTYPE_F16); k >= 1. `vec` is the channels per
// lane: 16 bytes (4 f32, 2 f64, 8 bf16/f16), 2 for 2-byte pairs, or 1;
// with vec > 1, c and both strides are multiples of vec and x, w and y
// are aligned to vec elements. `activation` is 0 (none) or 1 (SiLU).
// Returns the cudaError_t of the launch (0 on success).
int repro_conv1d_depthwise(const void* x, const void* w, void* y, int b,
                           int s, int c, int k, long long x_stride_b,
                           long long x_stride_s, int activation, int dtype,
                           int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (b < 1 || s < 1 || c < 1 || vec < 1) return int(cudaErrorInvalidValue);
  if (vec > 1) {
    const unsigned long long align =
        (unsigned long long)vec * itemsize(dtype);
    if (c % vec || x_stride_b % vec || x_stride_s % vec ||
        reinterpret_cast<unsigned long long>(x) % align ||
        reinterpret_cast<unsigned long long>(w) % align ||
        reinterpret_cast<unsigned long long>(y) % align)
      return int(cudaErrorInvalidValue);
  }
  const Args a{x, w, y, b, s, c, k, x_stride_b, x_stride_s,
               work_blocks(b, s, c, vec), device, true,
               static_cast<cudaStream_t>(stream)};
  long long grid = 0;
  return int(dispatch(activation, dtype, vec, a, grid));
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Threads of one block (conv1d_depthwise.py:THREADS must equal it).
int repro_conv1d_depthwise_threads() { return THREADS; }

// Blocks a launch of (b, s, c) runs: the kernel's resident blocks per SM
// times the SMs, at most the work's blocks (conv1d_depthwise.py:
// launch_layout must equal it); with b = 0 the resident blocks alone.
// Negative: a CUDA error.
long long repro_conv1d_depthwise_grid(int b, int s, int c, int k,
                                      int activation, int dtype, int vec,
                                      int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(long long)err;
  const long long items = b > 0 ? work_blocks(b, s, c, vec) : LLONG_MAX;
  const Args a{nullptr, nullptr, nullptr, b, s, c, k, 0, 0, items, device,
               false, nullptr};
  long long grid = 0;
  err = dispatch(activation, dtype, vec, a, grid);
  return err == cudaSuccess ? grid : -(long long)err;
}

// The layout of a launch of (b, s, c) with k taps at `vec` channels a
// lane (body code 9, analysis/bodies.py:conv1d_depthwise mirrors it):
// out[0] 9, then the threads, vec, the positions, the work's blocks, the
// shared bytes (none) and the tap body (the taps templated: the k taps
// a lane's registers hold, 1..MAX_K; 0: k at run time). Returns the count
// written. Host only: no launch.
int repro_conv1d_depthwise_layout(int b, int s, int c, int k, int vec,
                                  long long* out) {
  const long long v[] = {9, THREADS, vec, positions(b, s, c, vec),
                         work_blocks(b, s, c, vec), 0,
                         k <= MAX_K ? k : 0};
  return stencil::put_fields(v, out);
}

}  // extern "C"
