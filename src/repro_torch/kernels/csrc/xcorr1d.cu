// 1-D valid cross-correlation f'_i = sum_j g_j f^_{i+j} (paper Eq. 3,
// Sec. 4.1, Figs. 7-9) for Hopper (sm_90a), in the paper's three tuning
// strategies.
//
// Replaces the TPU kernel repro/kernels/stencil1d.py:xcorr1d_pallas
// (line 73; pl.pallas_call at line 121) with its bodies _kernel_baseline
// (line 52), _kernel_elementwise (line 56) and _mac_loop (line 35). It
// computes what that kernel computes; what the TPU version owes to the
// TPU (the pl.Element windows, the taps zero-padded to a multiple of the
// unroll factor, the wrapper's copy of f to a block multiple, the
// elementwise sub-blocks that lay a thread's outputs across lanes) is not
// carried over.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32 and 34 f64 outside the
// tensor cores, 134 bf16/f16 in packed pairs): bytes at small r,
// operations at large r. The least time is max((n + 2r + n) x itemsize /
// 3.35 TB/s, 2 (2r + 1) n / rate): at n = 2^24 f32, 0.040 ms at r = 1
// (bytes) and 1.03 ms at r = 1024 (operations); f64 at r = 1024, 2.02 ms;
// bf16/f16 at r = 1024, 0.51 ms, of which a multiply and an add rounded
// apart (not an FMA) reach half.
//
// Design, in the paper's GPU terms. A tile is `block_size` consecutive
// outputs; its window is block_size + n_taps - 1 inputs. Two launches
// (ring_route; xcorr1d.py:ring_route mirrors it):
// - the one-tile launch: one block a tile, its window staged element by
//   element (cp.async) before any compute, the reference's loop shapes:
//   baseline one output per thread per pass, the tap loop rolled
//   (#pragma unroll 1); pointwise the tap loop unrolled by U, the last
//   n_taps mod U taps one by one (no zero-padded taps, no read past the
//   window); elementwise U outputs per thread from one load of each
//   coefficient, thread i taking outputs i + e block_size / U, e < U (the
//   reference's sub-blocks). Baseline and pointwise run it at every
//   n_taps, elementwise at U = 1 or below RING_MIN_TAPS taps. Resident
//   blocks overlap one's staging with another's compute. Baseline and
//   pointwise are held back by shared-memory loads at every radius past
//   a few (two per FMA: window and tap), which a ring does not cut; run
//   on the ring, they and elementwise at r <= 4 took up to 25% longer on
//   an H100 at some radii and dtypes (PERF.md).
// - the persistent ring, elementwise from RING_MIN_TAPS taps at U > 1:
//   persistent blocks (the kernel's resident blocks per SM times the SMs)
//   walk the tiles b, b + grid, ... with a ring of window buffers in
//   shared memory (2 where they fit, else 1; ring_stages): the next
//   tile's window is in flight (cp.async) while the block computes the
//   current one. A window is staged with 16-byte cp.async when f and
//   block_size x itemsize are 16-byte aligned (the last chunk of a ragged
//   tile reads only the bytes that exist and zero-fills the rest), else
//   element by element; each input is read from device memory about once
//   (a tile's halo twice). The outputs are register-tiled: a thread's U
//   outputs are consecutive, so one window of U + V inputs slides through
//   registers (a ring of U / V + 1 vectors of V = gcd(U, 16 B / itemsize)
//   elements: float4 or double2 when V divides U). Per V taps a thread
//   loads one new window vector and one tap vector (a broadcast) for U V
//   FMAs, so the FMA rate bounds it once U >= 8 (U = 4: 5 wavefronts per
//   16 FMAs of a warp in f32). A thread's vectors lie U x itemsize bytes
//   from its neighbour's; where that is an even number of 16-byte slots,
//   the window leaves one slot empty after every thread's U / V vectors,
//   so 8 threads of a quarter warp hit 8 distinct slots (conflict-free).
//   The last n_taps mod V taps are done one by one; a window vector past
//   the tile's inputs is not loaded, and the window past the inputs of a
//   ragged tile is zeroed. Where a thread's outputs are more than one
//   vector, each warp's 32 U outputs pass through a scratch of its own in
//   shared memory and are stored 16 bytes a lane, contiguous across the
//   warp (stored straight from the registers, U x itemsize bytes apart,
//   each 32-byte sector would be written in pieces).
// The taps g sit in shared memory beside the window(s), staged once a
// block; every thread of a warp reads the same tap at once, which shared
// memory broadcasts (no per-call copy into a module-wide __constant__
// symbol, which two calls with different g in flight would share).
// Threads per block: min(block_size / U_e, 1024), U_e = U on elementwise
// and 1 otherwise (512 at most on the ring past U_r = 8, for its
// registers); a thread loops (passes) over its outputs when the tile has
// more. The last tile of a ragged n masks its outputs and stages only the
// inputs that exist, so the wrapper never copies f to a tile multiple.
// Both launches sum each output's taps in the reference's order, so the
// outputs do not depend on the launch or the loop shape: f32 and f64 one
// FMA a tap; bf16 and f16 (the plain version's arithmetic) a multiply
// rounded to the type, then an add rounded to it (mul.rn/add.rn, never an
// FMA): a product of two p-bit values is exact in f32, and f32's 24 >=
// 2p + 2 bits (p = 8 bf16, 11 f16) make one rounding equal PyTorch's f32
// operation rounded to the type, so the kernel equals its plain version
// bit for bit. The ring computes 2-byte outputs in packed pairs (o, o + 1)
// (bf16x2/f16x2, U even): at tap offset j their inputs (o + j, o + j + 1)
// are one register of the window vector for an even o + j, and for an odd
// one a byte permute (prmt) of two neighbouring registers, computed where
// it is read (the compiler can keep one per distinct odd offset of a group:
// (U + V) / 2 permutes beside the group's U V packed instructions), where a
// second copy of the window shifted by one element would double the
// ring's registers and its shared-memory loads. 2-byte windows are staged
// by the whole block, 16 bytes a copy where f and the tiles are on 16
// bytes, else element by element (cp.async has no 2-byte copy).
//
// Unroll factors: the kernel instantiates register widths 1..MAX_UNROLL
// and runs U as its largest divisor U_r <= 16 (register_unroll), in U /
// U_r passes: pointwise unrolls each U taps as U / U_r runs of U_r;
// elementwise on the one-tile launch takes a thread's U sub-block outputs
// U_r at a time; on the ring a thread's U outputs are U / U_r lanes of U_r
// (threads min(block_size / U, cap), thread t taking the lanes t, t +
// threads, ...). repro_xcorr1d_layout reports U_r and the passes.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>

#include "persistent.cuh"

namespace {

constexpr int MODE_BASELINE = 0;
constexpr int MODE_POINTWISE = 1;
constexpr int MODE_ELEMENTWISE = 2;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_UNROLL = 16;     // register widths instantiated: 1..16
// Fewer taps: the one-tile launch. Every dtype: bf16 and f16 cross over
// between 11 and 21 taps as f32 and f64 do (tools/xcorr_times.py).
constexpr int RING_MIN_TAPS = 21;
constexpr int DTYPE_F32 = 0;       // emit.py:DTYPE_CODES
constexpr int DTYPE_F64 = 1;
constexpr int DTYPE_BF16 = 2;
constexpr int DTYPE_F16 = 3;
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB a block can use

// The launch a build forces: 0 the rule below, 1 the one-tile launch, 2
// the ring wherever it can run. Only tools/xcorr_times.py's own builds
// (-DXCORR_FORCE_ROUTE=1 or 2) force one, to time both launches at the
// same taps; the library the port loads keeps the rule.
#ifdef XCORR_FORCE_ROUTE
constexpr int FORCED_ROUTE = XCORR_FORCE_ROUTE;
#else
constexpr int FORCED_ROUTE = 0;
#endif

__host__ __device__ inline size_t round_up16(size_t n) {
  return (n + 15) / 16 * 16;
}

__host__ __device__ constexpr int gcd(int a, int b) {
  return b ? gcd(b, a % b) : a;
}

inline int itemsize(int dtype) {
  return dtype == DTYPE_F64 ? 8 : dtype == DTYPE_F32 ? 4 : 2;
}

// The register width the kernel runs U at (xcorr1d.py:register_unroll):
// U's largest divisor of at most MAX_UNROLL, in U / U_r passes.
__host__ __device__ constexpr int register_unroll(int unroll) {
  int u = unroll < MAX_UNROLL ? unroll : MAX_UNROLL;
  while (unroll % u) --u;
  return u;
}

// Which launch (xcorr1d.py:ring_route): the persistent ring on
// elementwise at U_r > 1 from RING_MIN_TAPS taps, else the one-tile launch.
inline bool ring_route(int mode, int unroll, int n_taps) {
  const bool can = mode == MODE_ELEMENTWISE && register_unroll(unroll) > 1;
  if (FORCED_ROUTE) return can && FORCED_ROUTE == 2;
  return can && n_taps >= RING_MIN_TAPS;
}

// The empty-slot period of a ring window (xcorr1d.py:window_pad): on
// elementwise, when a thread's U_r outputs are an even number U_r / V of
// 16-byte vectors, one 16-byte slot stays empty after every U_r / V
// vectors; else 0 (the window in order). Callers pass U_r.
__host__ __device__ constexpr int window_pad(int mode, int unroll,
                                             int item) {
  const int vmax = 16 / item;
  const int v = gcd(unroll, vmax);
  return mode == MODE_ELEMENTWISE && v == vmax && (unroll / v) % 2 == 0
             ? unroll / v
             : 0;
}

// Bytes of one window buffer: block_size + n_taps - 1 elements padded to
// 16 B, and the empty slots (xcorr1d.py:window_bytes).
inline size_t window_bytes(int n_taps, int block_size, size_t item,
                           int pad) {
  const size_t q = round_up16(size_t(block_size + n_taps - 1) * item) / 16;
  return 16 * (pad ? q + (q - 1) / pad : q);
}

// Bytes of one warp's output scratch on the ring
// (xcorr1d.py:warp_scratch_bytes): on elementwise, where a thread's U_r
// outputs are more than one vector, they pass through shared memory to be
// stored contiguous across the warp (in the window's layout: an empty
// slot after each thread's vectors where the window has them); else 0.
// Callers pass U_r.
__host__ __device__ constexpr int warp_scratch_bytes(int mode, int unroll,
                                                     int item) {
  const int v = gcd(unroll, 16 / item);
  if (mode != MODE_ELEMENTWISE || unroll == v) return 0;
  return window_pad(mode, unroll, item) ? 32 * (unroll / v + 1) * 16
                                        : 32 * unroll * item;
}

// Most threads of a ring block: 1024, and 512 on elementwise past U_r =
// 8, whose accumulators and ring take up to 128 registers.
__host__ __device__ constexpr int ring_max_threads(int mode, int unroll) {
  return mode == MODE_ELEMENTWISE && unroll > 8 ? MAX_THREADS / 2
                                                : MAX_THREADS;
}

inline int launch_threads(int block_size, int mode, int unroll,
                          int n_taps) {
  const int lanes =
      mode == MODE_ELEMENTWISE ? block_size / unroll : block_size;
  const int most = ring_route(mode, unroll, n_taps)
                       ? ring_max_threads(mode, register_unroll(unroll))
                       : MAX_THREADS;
  return lanes < most ? lanes : most;
}

// Shared memory of a ring block with `stages` window buffers: the
// buffers, each warp's output scratch, then the n_taps taps.
inline size_t ring_smem_bytes(int n_taps, int block_size, int item,
                              int mode, int unroll, int stages) {
  const int threads = launch_threads(block_size, mode, unroll, n_taps);
  const int ur = register_unroll(unroll);
  return size_t(stages) * window_bytes(n_taps, block_size, item,
                                       window_pad(mode, ur, item)) +
         size_t((threads + 31) / 32) * warp_scratch_bytes(mode, ur, item) +
         size_t(n_taps) * item;
}

// Window buffers of a ring block (xcorr1d.py:ring_stages): 2 (one tile
// computing while the next lands) where two fit 227 KB beside the scratch
// and taps, else 1.
inline int ring_stages(int n_taps, int block_size, int item, int mode,
                       int unroll) {
  return ring_smem_bytes(n_taps, block_size, item, mode, unroll, 2) <=
                 SMEM_LIMIT
             ? 2
             : 1;
}

// Shared memory of one block (xcorr1d.py:smem_bytes): on the ring its
// buffers, scratch and taps; on the one-tile launch the window padded to
// 16 B, then the taps.
inline size_t smem_bytes(int n_taps, int block_size, int item, int mode,
                         int unroll) {
  if (!ring_route(mode, unroll, n_taps))
    return round_up16(size_t(block_size + n_taps - 1) * item) +
           size_t(n_taps) * item;
  return ring_smem_bytes(n_taps, block_size, item, mode, unroll,
                         ring_stages(n_taps, block_size, item, mode, unroll));
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// --- arithmetic: the plain version's, in the field's type ----------------

template <typename T>
__device__ __forceinline__ T zero() {
  return T(0);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero() {
  return __ushort_as_bfloat16(0);
}
template <>
__device__ __forceinline__ __half zero() {
  return __ushort_as_half(0);
}

// acc + c v: f32 and f64 one FMA; bf16 and f16 mul.rn then add.rn (in
// PTX, so that no compiler contracts the pair into one FMA).
__device__ __forceinline__ float mac(float c, float v, float acc) {
  return __fmaf_rn(c, v, acc);
}
__device__ __forceinline__ double mac(double c, double v, double acc) {
  return __fma_rn(c, v, acc);
}
__device__ __forceinline__ __nv_bfloat16 mac(__nv_bfloat16 c,
                                             __nv_bfloat16 v,
                                             __nv_bfloat16 acc) {
  unsigned short p, s;
  asm("mul.rn.bf16 %0, %1, %2;"
      : "=h"(p)
      : "h"(__bfloat16_as_ushort(c)), "h"(__bfloat16_as_ushort(v)));
  asm("add.rn.bf16 %0, %1, %2;"
      : "=h"(s)
      : "h"(__bfloat16_as_ushort(acc)), "h"(p));
  return __ushort_as_bfloat16(s);
}
__device__ __forceinline__ __half mac(__half c, __half v, __half acc) {
  unsigned short p, s;
  asm("mul.rn.f16 %0, %1, %2;"
      : "=h"(p)
      : "h"(__half_as_ushort(c)), "h"(__half_as_ushort(v)));
  asm("add.rn.f16 %0, %1, %2;" : "=h"(s) : "h"(__half_as_ushort(acc)), "h"(p));
  return __ushort_as_half(s);
}

// Two 2-byte values a register, element o in the low half: acc + c v per
// half, each rounded once.
template <typename T>
__device__ __forceinline__ unsigned mac2(unsigned c, unsigned v,
                                         unsigned acc);
template <>
__device__ __forceinline__ unsigned mac2<__nv_bfloat16>(unsigned c,
                                                        unsigned v,
                                                        unsigned acc) {
  unsigned p, s;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(p) : "r"(c), "r"(v));
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(s) : "r"(acc), "r"(p));
  return s;
}
template <>
__device__ __forceinline__ unsigned mac2<__half>(unsigned c, unsigned v,
                                                 unsigned acc) {
  unsigned p, s;
  asm("mul.rn.f16x2 %0, %1, %2;" : "=r"(p) : "r"(c), "r"(v));
  asm("add.rn.f16x2 %0, %1, %2;" : "=r"(s) : "r"(acc), "r"(p));
  return s;
}

template <typename T>
__device__ __forceinline__ T half_of(unsigned pair, int hi);
template <>
__device__ __forceinline__ __nv_bfloat16 half_of(unsigned pair, int hi) {
  return __ushort_as_bfloat16((unsigned short)(hi ? pair >> 16 : pair));
}
template <>
__device__ __forceinline__ __half half_of(unsigned pair, int hi) {
  return __ushort_as_half((unsigned short)(hi ? pair >> 16 : pair));
}

// --- staging ---------------------------------------------------------------

// One element global -> shared: cp.async for 4 or 8 bytes; 2-byte values
// through a register (cp.async has no 2-byte copy).
template <typename T>
__device__ __forceinline__ void copy_elem(T* dst, const T* src) {
  if constexpr (sizeof(T) >= 4) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(int(sizeof(T))));
  } else {
    *dst = *src;
  }
}
// The shared-memory slot (16 bytes) of window vector q of 16 bytes.
template <int PAD>
__device__ __forceinline__ int slot(int q) {
  if constexpr (PAD > 0) {
    return q + q / PAD;
  } else {
    return q;
  }
}

// Stage the window of one tile (its `avail` inputs from f + base) into
// `buf` with the whole block, and zero the window past them.
template <typename T, int PAD>
__device__ __forceinline__ void stage(const T* __restrict__ f, T* buf,
                                      long long base, int avail, int win,
                                      bool wide) {
  constexpr int VMAX = 16 / int(sizeof(T));
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int units = (win + VMAX - 1) / VMAX;
  if (wide) {
    const int bytes = avail * int(sizeof(T));
    const int chunks = (bytes + 15) / 16;
    const char* src = reinterpret_cast<const char*>(f + base);
    for (int q = tid; q < chunks; q += nthr) {
      const int left = bytes - 16 * q;
      stencil::cp_async16(buf + slot<PAD>(q) * VMAX, src + 16 * q,
                          left < 16 ? left : 16);
    }
    for (int q = chunks + tid; q < units; q += nthr)
      *reinterpret_cast<uint4*>(buf + slot<PAD>(q) * VMAX) =
          make_uint4(0u, 0u, 0u, 0u);
  } else {
    for (int i = tid; i < avail; i += nthr)
      copy_elem(buf + slot<PAD>(i / VMAX) * VMAX + i % VMAX, f + base + i);
    for (int i = avail + tid; i < units * VMAX; i += nthr)
      buf[slot<PAD>(i / VMAX) * VMAX + i % VMAX] = zero<T>();
  }
}

// --- the one-tile launch (baseline, pointwise; elementwise at few taps) --

// U is the register width U_r; `unroll` the U it runs (a multiple).
template <typename T, int MODE, int U>
__global__ void __launch_bounds__(MAX_THREADS)
    tile_kernel(const T* __restrict__ f, const T* __restrict__ g,
                T* __restrict__ out, long long n, int n_taps,
                int block_size, int unroll, int wide) {
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

  if constexpr (sizeof(T) >= 4) {
    for (int i = tid; i < avail; i += nthr)
      __pipeline_memcpy_async(w + i, f + base + i, sizeof(T));
    for (int i = tid; i < n_taps; i += nthr)
      __pipeline_memcpy_async(taps + i, g + i, sizeof(T));
    __pipeline_commit();
    for (int i = avail + tid; i < win; i += nthr) w[i] = T(0);
    __pipeline_wait_prior(0);
  } else {
    stage<T, 0>(f, w, base, avail, win, wide != 0);
    for (int i = tid; i < n_taps; i += nthr) taps[i] = g[i];
    stencil::cp_async_commit();
    stencil::cp_async_wait<0>();
  }
  __syncthreads();

  if constexpr (MODE == MODE_BASELINE) {
    for (int i = tid; i < nout; i += nthr) {
      T acc = zero<T>();
#pragma unroll 1
      for (int k = 0; k < n_taps; ++k) acc = mac(taps[k], w[i + k], acc);
      out[base + i] = acc;
    }
  } else if constexpr (MODE == MODE_POINTWISE) {
    for (int i = tid; i < nout; i += nthr) {
      const T* wi = w + i;
      T acc = zero<T>();
      int k = 0;
      if (unroll == U) {
#pragma unroll 1
        for (; k + U <= n_taps; k += U) {
#pragma unroll
          for (int u = 0; u < U; ++u) acc = mac(taps[k + u], wi[k + u], acc);
        }
      } else {  // U = unroll / passes: each U taps as passes runs of U_r
#pragma unroll 1
        for (; k + unroll <= n_taps; k += unroll) {
#pragma unroll 1
          for (int p = k; p < k + unroll; p += U) {
#pragma unroll
            for (int u = 0; u < U; ++u)
              acc = mac(taps[p + u], wi[p + u], acc);
          }
        }
      }
#pragma unroll 1
      for (; k < n_taps; ++k) acc = mac(taps[k], wi[k], acc);
      out[base + i] = acc;
    }
  } else if (unroll == U) {  // one pass, its sub-block stride U-constant
    const int sub = block_size / U;
    for (int i = tid; i < sub && i < nout; i += nthr) {
      T acc[U];
#pragma unroll
      for (int e = 0; e < U; ++e) acc[e] = zero<T>();
#pragma unroll 1
      for (int k = 0; k < n_taps; ++k) {
        const T c = taps[k];
#pragma unroll
        for (int e = 0; e < U; ++e) acc[e] = mac(c, w[i + e * sub + k], acc[e]);
      }
#pragma unroll
      for (int e = 0; e < U; ++e)
        if (i + e * sub < nout) out[base + i + e * sub] = acc[e];
    }
  } else {
    const int sub = block_size / unroll;
    for (int i = tid; i < sub && i < nout; i += nthr) {
#pragma unroll 1
      for (int e0 = 0; e0 < unroll; e0 += U) {  // sub-blocks e0 .. e0 + U - 1
        const T* wi = w + i + e0 * sub;
        T acc[U];
#pragma unroll
        for (int e = 0; e < U; ++e) acc[e] = zero<T>();
#pragma unroll 1
        for (int k = 0; k < n_taps; ++k) {
          const T c = taps[k];
#pragma unroll
          for (int e = 0; e < U; ++e) acc[e] = mac(c, wi[e * sub + k], acc[e]);
        }
#pragma unroll
        for (int e = 0; e < U; ++e)
          if (i + (e0 + e) * sub < nout)
            out[base + i + (e0 + e) * sub] = acc[e];
      }
    }
  }
}

// --- the persistent ring (elementwise from RING_MIN_TAPS taps) ---------

// The register tiling of a thread's U outputs (U = U_r): V elements a
// window vector, NV vectors of outputs, a ring of R = NV + 1 vectors.
template <typename T, int U>
struct Tiling {
  static constexpr int VMAX = 16 / int(sizeof(T));
  static constexpr int V = gcd(U, VMAX);
  static constexpr int NV = U / V;
  static constexpr int R = NV + 1;
  static constexpr int PAD = window_pad(MODE_ELEMENTWISE, U, int(sizeof(T)));
  // 2-byte outputs in packed pairs (o, o + 1) where U is even.
  static constexpr bool PAIRS = sizeof(T) == 2 && U % 2 == 0;
};

// Lane l's U outputs l U .. l U + U - 1 element by element: the window
// slides through a ring of R vectors. Group c + r (taps (c + r) V ..)
// reads ring[(r + i) % R] as window vector q0 + c + r + i, i = 0..NV; it
// loads i = NV.
template <typename T, int U>
__device__ __forceinline__ void tile_elements(const T* __restrict__ w,
                                              const T* __restrict__ taps,
                                              int l, int n_taps, int q_end,
                                              T (&acc)[U]) {
  using Tl = Tiling<T, U>;
  constexpr int V = Tl::V, NV = Tl::NV, R = Tl::R, PAD = Tl::PAD;
  using Vt = Vec<T, V>;
  const Vt* gv = reinterpret_cast<const Vt*>(taps);
  const int q0 = l * NV;
  // Vector q0 + c of the window; with PAD (= NV), q0 is a multiple of
  // PAD, so its slot is l (PAD + 1) + c + c / PAD.
  const Vt* lw = reinterpret_cast<const Vt*>(w) + (PAD ? l * (PAD + 1) : q0);
  auto at = [&](int c) -> Vt { return lw[slot<PAD>(c)]; };
  Vt ring[R];
#pragma unroll
  for (int i = 0; i < NV; ++i) ring[i] = at(i);
  int c = 0;
  for (; (c + R) * V <= n_taps; c += R) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ring[(r + NV) % R] = at(c + r + NV);
      const Vt gk = gv[c + r];
#pragma unroll
      for (int j = 0; j < V; ++j) {
#pragma unroll
        for (int e = 0; e < U; ++e)
          acc[e] = mac(gk.v[j], ring[(r + (e + j) / V) % R].v[(e + j) % V],
                       acc[e]);
      }
    }
  }
  // The last full groups (fewer than R) and the partial one.
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k0 = (c + r) * V;
    if (k0 < n_taps) {
      if (q0 + c + r + NV < q_end) ring[(r + NV) % R] = at(c + r + NV);
      const int left = n_taps - k0;
      Vt gk;
      if (left >= V) {
        gk = gv[c + r];
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) gk.v[j] = j < left ? taps[k0 + j] : zero<T>();
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (j < left) {
#pragma unroll
          for (int e = 0; e < U; ++e)
            acc[e] = mac(gk.v[j], ring[(r + (e + j) / V) % R].v[(e + j) % V],
                         acc[e]);
        }
      }
    }
  }
}

// As tile_elements, for 2-byte T at even U in packed pairs: acc[i] holds
// outputs (2i, 2i + 1); the ring's vectors are V / 2 registers of two
// elements. At tap offset j (of a group), the pair reads window elements
// (2i + j, 2i + j + 1): a register for an even j, a byte permute of two
// neighbouring ones (their high and low halves) for an odd j.
template <typename T, int U>
__device__ __forceinline__ void tile_pairs(const T* __restrict__ w,
                                           const T* __restrict__ taps, int l,
                                           int n_taps, int q_end,
                                           unsigned (&acc)[U / 2]) {
  using Tl = Tiling<T, U>;
  constexpr int V = Tl::V, NV = Tl::NV, R = Tl::R, PAD = Tl::PAD;
  using Vp = Vec<unsigned, V / 2>;
  using Vg = Vec<unsigned short, V>;
  const Vg* gv = reinterpret_cast<const Vg*>(taps);
  const unsigned short* gs = reinterpret_cast<const unsigned short*>(taps);
  const int q0 = l * NV;
  const Vp* lw = reinterpret_cast<const Vp*>(w) + (PAD ? l * (PAD + 1) : q0);
  auto at = [&](int c) -> Vp { return lw[slot<PAD>(c)]; };
  Vp ring[R];
#pragma unroll
  for (int i = 0; i < NV; ++i) ring[i] = at(i);
  // Elements (p, p + 1) of group r's window, p < U + V - 1.
  auto pair = [&](int r, int p) -> unsigned {
    const unsigned lo = ring[(r + p / V) % R].v[(p % V) / 2];
    if (p % 2 == 0) return lo;
    const unsigned hi = ring[(r + (p + 1) / V) % R].v[((p + 1) % V) / 2];
    return __byte_perm(lo, hi, 0x5432);
  };
  auto group = [&](int r, const Vg& gk, int live) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (j < live) {
        const unsigned g2 = unsigned(gk.v[j]) * 0x10001u;
#pragma unroll
        for (int i = 0; i < U / 2; ++i)
          acc[i] = mac2<T>(g2, pair(r, 2 * i + j), acc[i]);
      }
    }
  };
  int c = 0;
  for (; (c + R) * V <= n_taps; c += R) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ring[(r + NV) % R] = at(c + r + NV);
      group(r, gv[c + r], V);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k0 = (c + r) * V;
    if (k0 < n_taps) {
      if (q0 + c + r + NV < q_end) ring[(r + NV) % R] = at(c + r + NV);
      const int left = n_taps - k0;
      Vg gk;
      if (left >= V) {
        gk = gv[c + r];
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) gk.v[j] = j < left ? gs[k0 + j] : 0;
      }
      group(r, gk, left);
    }
  }
}

// Elementwise by register tiling (see the design note): lane l of the tile
// computes outputs l U .. l U + U - 1 (U = U_r; a thread takes the lanes
// threadIdx.x, + blockDim.x, ...). Where those are more than one vector,
// the warp's 32 U outputs go through its `scratch` and are stored 16
// bytes a lane, contiguous across the warp (a lane's own U outputs are U
// x itemsize bytes from its neighbour's, and stores that far apart write
// each 32-byte sector in pieces).
template <typename T, int U>
__device__ __forceinline__ void elementwise(const T* __restrict__ w,
                                            const T* __restrict__ taps,
                                            T* scratch, T* __restrict__ out,
                                            int nout, int n_taps,
                                            int block_size, int win) {
  using Tl = Tiling<T, U>;
  constexpr int VMAX = Tl::VMAX, V = Tl::V, NV = Tl::NV, PAD = Tl::PAD;
  using Vt = Vec<T, V>;
  using V16 = Vec<T, VMAX>;
  const int q_end = (win + V - 1) / V;  // window vectors the tile holds
  const int lanes = block_size / U;
  const int lane = threadIdx.x & 31;
  const int warp0 = threadIdx.x & ~31;
  const int warp_lanes = min(32, int(blockDim.x) - warp0);
  const unsigned mask =
      warp_lanes == 32 ? 0xffffffffu : (1u << warp_lanes) - 1u;
  for (int l0 = 0; l0 < lanes; l0 += blockDim.x) {
    const int l = l0 + threadIdx.x;
    const int o0 = l * U;
    const bool live = l < lanes && o0 < nout;
    T acc[U];
    if constexpr (Tl::PAIRS) {
      unsigned acc2[U / 2];
#pragma unroll
      for (int i = 0; i < U / 2; ++i) acc2[i] = 0u;
      if (live) tile_pairs<T, U>(w, taps, l, n_taps, q_end, acc2);
#pragma unroll
      for (int e = 0; e < U; ++e) acc[e] = half_of<T>(acc2[e / 2], e % 2);
    } else {
#pragma unroll
      for (int e = 0; e < U; ++e) acc[e] = zero<T>();
      if (live) tile_elements<T, U>(w, taps, l, n_taps, q_end, acc);
    }
    if constexpr (NV == 1) {  // one vector a lane: contiguous already
      if (live) {
        if (o0 + U <= nout) {
          Vt v;
#pragma unroll
          for (int j = 0; j < V; ++j) v.v[j] = acc[j];
          *reinterpret_cast<Vt*>(out + o0) = v;
        } else {
#pragma unroll
          for (int e = 0; e < U; ++e)
            if (o0 + e < nout) out[o0 + e] = acc[e];
        }
      }
    } else {
      Vt* sv = reinterpret_cast<Vt*>(scratch) + (PAD ? lane * (PAD + 1)
                                                     : lane * NV);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        Vt v;
#pragma unroll
        for (int j = 0; j < V; ++j) v.v[j] = acc[i * V + j];
        sv[i] = v;
      }
      __syncwarp(mask);
      // The warp's outputs w0 .. end - 1, element e of them at scratch
      // element slot(e / VMAX) VMAX + e % VMAX, stored by its warp_lanes
      // lanes (fewer than 32 in a block's last, part warp).
      const int w0 = (l0 + warp0) * U;
      const int end = min(nout, w0 + warp_lanes * U);
      T* ow = out + w0;
      if (reinterpret_cast<unsigned long long>(ow) % 16 == 0) {
        const V16* s16 = reinterpret_cast<const V16*>(scratch);
        for (int q = lane; w0 + q * VMAX < end; q += warp_lanes) {
          const V16 v = s16[slot<PAD>(q)];
          if (w0 + (q + 1) * VMAX <= end) {
            reinterpret_cast<V16*>(ow)[q] = v;
          } else {
#pragma unroll
            for (int j = 0; j < VMAX; ++j)
              if (w0 + q * VMAX + j < end) ow[q * VMAX + j] = v.v[j];
          }
        }
      } else {
        for (int e = lane; w0 + e < end; e += warp_lanes)
          ow[e] = scratch[slot<PAD>(e / VMAX) * VMAX + e % VMAX];
      }
      __syncwarp(mask);  // before the next pass writes the scratch
    }
  }
}

template <typename T, int U>
__global__ void __launch_bounds__(ring_max_threads(MODE_ELEMENTWISE, U))
    ring_kernel(const T* __restrict__ f, const T* __restrict__ g,
                T* __restrict__ out, long long n, int n_taps, int block_size,
                int stages, int wide, long long tiles, int buf_units) {
  constexpr int PAD = window_pad(MODE_ELEMENTWISE, U, int(sizeof(T)));
  constexpr int SCRATCH =
      warp_scratch_bytes(MODE_ELEMENTWISE, U, int(sizeof(T)));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // The ring's buffers of buf_units 16-byte units, each warp's scratch,
  // the taps: all on 16 bytes.
  const int buf_elems = buf_units * (16 / int(sizeof(T)));
  T* ring = reinterpret_cast<T*>(smem_raw);
  unsigned char* scratch_raw =
      smem_raw + size_t(stages) * buf_units * 16;
  T* scratch = reinterpret_cast<T*>(scratch_raw +
                                    (threadIdx.x >> 5) * SCRATCH);
  T* taps = reinterpret_cast<T*>(
      scratch_raw + ((blockDim.x + 31) >> 5) * SCRATCH);
  const int win = block_size + n_taps - 1;
  const int tid = threadIdx.x, nthr = blockDim.x;
  auto stage_tile = [&](long long tile, int buf) {
    const long long base = tile * block_size;
    const long long left = n - base;
    const int nout = left < block_size ? int(left) : block_size;
    stage<T, PAD>(f, ring + buf * buf_elems, base, nout + n_taps - 1, win,
                  wide != 0);
  };

  for (int i = tid; i < n_taps; i += nthr) copy_elem(taps + i, g + i);
  if (stages == 2) {
    if (blockIdx.x < tiles) stage_tile(blockIdx.x, 0);
    stencil::cp_async_commit();
  }
  int cur = 0;  // the buffer computed now; with 2 stages the other lands
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long next = tile + (long long)(stages - 1) * gridDim.x;
    if (next < tiles) stage_tile(next, stages - 1 - cur);
    stencil::cp_async_commit();
    if (stages == 2)
      stencil::cp_async_wait<1>();
    else
      stencil::cp_async_wait<0>();
    __syncthreads();

    const T* w = ring + cur * buf_elems;
    const long long base = tile * block_size;
    const long long left = n - base;
    const int nout = left < block_size ? int(left) : block_size;
    elementwise<T, U>(w, taps, scratch, out + base, nout, n_taps, block_size,
                      win);
    cur = stages - 1 - cur;
    __syncthreads();  // before the ring stages into buffer `cur` again
  }
}

struct Args {
  const void* f;
  const void* g;
  void* out;
  long long n;
  int n_taps, block_size, unroll, device;
  bool launch;  // false: only the grid
  cudaStream_t stream;
};

// 16-byte staging where f and every tile start on 16 bytes.
inline bool wide_staging(const Args& a, int item) {
  return reinterpret_cast<unsigned long long>(a.f) % 16 == 0 &&
         (a.block_size * item) % 16 == 0;
}

// The one-tile launch: a block a tile, ceil(n / block_size) blocks.
template <typename T, int MODE, int U>
cudaError_t launch_tile(const Args& a, long long& grid) {
  constexpr auto kernel = tile_kernel<T, MODE, U>;
  constexpr int item = int(sizeof(T));
  const size_t smem = smem_bytes(a.n_taps, a.block_size, item, MODE,
                                 a.unroll);
  grid = (a.n + a.block_size - 1) / a.block_size;
  if (grid > INT_MAX) return cudaErrorInvalidValue;
  if (!a.launch) return cudaSuccess;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<unsigned(grid),
           launch_threads(a.block_size, MODE, a.unroll, a.n_taps), smem,
           a.stream>>>(static_cast<const T*>(a.f),
                       static_cast<const T*>(a.g), static_cast<T*>(a.out),
                       a.n, a.n_taps, a.block_size, a.unroll,
                       wide_staging(a, item));
  return cudaGetLastError();
}

// The ring (elementwise): the kernel's resident blocks, at most the tiles
// (with n = 0 the resident blocks alone).
template <typename T, int U>
cudaError_t launch_ring(const Args& a, long long& grid) {
  constexpr auto kernel = ring_kernel<T, U>;
  constexpr int item = int(sizeof(T));
  constexpr int mode = MODE_ELEMENTWISE;
  const int stages = ring_stages(a.n_taps, a.block_size, item, mode,
                                 a.unroll);
  const size_t buf = window_bytes(a.n_taps, a.block_size, item,
                                  window_pad(mode, U, item));
  const int threads = launch_threads(a.block_size, mode, a.unroll, a.n_taps);
  const size_t smem =
      ring_smem_bytes(a.n_taps, a.block_size, item, mode, a.unroll, stages);
  const long long tiles = (a.n + a.block_size - 1) / a.block_size;
  cudaError_t err = stencil::persistent_grid<kernel>(
      threads, smem, a.device, a.n > 0 ? tiles : LLONG_MAX, grid);
  if (err != cudaSuccess || !a.launch) return err;
  kernel<<<unsigned(grid), threads, smem, a.stream>>>(
      static_cast<const T*>(a.f), static_cast<const T*>(a.g),
      static_cast<T*>(a.out), a.n, a.n_taps, a.block_size, stages,
      wide_staging(a, item), tiles, int(buf / 16));
  return cudaGetLastError();
}

template <typename T, int MODE, int U>
cudaError_t launch(const Args& a, long long& grid) {
  if constexpr (MODE == MODE_ELEMENTWISE && U > 1) {
    if (ring_route(MODE, a.unroll, a.n_taps))
      return launch_ring<T, U>(a, grid);
  }
  return launch_tile<T, MODE, U>(a, grid);
}

// The launch of the instantiated register width U = register_unroll of
// a.unroll (1..MAX_UNROLL).
template <typename T, int MODE, int U = 1>
cudaError_t launch_unroll(const Args& a, long long& grid) {
  if constexpr (U > MAX_UNROLL) {
    return cudaErrorInvalidValue;
  } else {
    if (register_unroll(a.unroll) == U) return launch<T, MODE, U>(a, grid);
    return launch_unroll<T, MODE, U + 1>(a, grid);
  }
}

template <typename T>
cudaError_t launch_mode(int mode, const Args& a, long long& grid) {
  switch (mode) {
    case MODE_BASELINE:
      return launch<T, MODE_BASELINE, 1>(a, grid);
    case MODE_POINTWISE:
      return launch_unroll<T, MODE_POINTWISE>(a, grid);
    case MODE_ELEMENTWISE:
      return launch_unroll<T, MODE_ELEMENTWISE>(a, grid);
    default:
      return cudaErrorInvalidValue;
  }
}

// The reference's rules and what the kernel takes.
bool valid(int n_taps, int block_size, int mode, int unroll, int dtype) {
  if (n_taps < 1 || block_size < 1 || unroll < 1 ||
      (mode == MODE_BASELINE && unroll != 1) ||
      (mode == MODE_ELEMENTWISE && block_size % unroll != 0) || dtype < 0 ||
      dtype > DTYPE_F16)
    return false;
  return smem_bytes(n_taps, block_size, itemsize(dtype), mode, unroll) <=
         SMEM_LIMIT;
}

cudaError_t dispatch(int mode, int dtype, const Args& a, long long& grid) {
  switch (dtype) {
    case DTYPE_F32:
      return launch_mode<float>(mode, a, grid);
    case DTYPE_F64:
      return launch_mode<double>(mode, a, grid);
    case DTYPE_BF16:
      return launch_mode<__nv_bfloat16>(mode, a, grid);
    case DTYPE_F16:
      return launch_mode<__half>(mode, a, grid);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch the cross-correlation on `stream`: out[i] = sum_k g[k] f[i + k]
// for i < n, f holding n + n_taps - 1 elements. `f`, `g` and `out` are
// device memory of the element type `dtype` (DTYPE_F32, DTYPE_F64,
// DTYPE_BF16 or DTYPE_F16), `out` 16-byte aligned; `mode` is 0 baseline,
// 1 pointwise, 2 elementwise, with `unroll` >= 1 (1 on baseline; dividing
// block_size on elementwise). Returns the cudaError_t of the launch (0 on
// success).
int repro_xcorr1d(const void* f, const void* g, void* out, long long n,
                  int n_taps, int block_size, int mode, int unroll, int dtype,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (n < 1 || !valid(n_taps, block_size, mode, unroll, dtype) ||
      reinterpret_cast<unsigned long long>(out) % 16)
    return int(cudaErrorInvalidValue);
  const Args a{f, g, out, n, n_taps, block_size, unroll, device, true,
               static_cast<cudaStream_t>(stream)};
  long long grid = 0;
  return int(dispatch(mode, dtype, a, grid));
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory of one block (xcorr1d.py:smem_bytes must equal it).
long long repro_xcorr1d_smem_bytes(int n_taps, int block_size, int mode,
                                   int unroll, int dtype) {
  return (long long)smem_bytes(n_taps, block_size, itemsize(dtype), mode,
                               unroll);
}

// Threads of one block (xcorr1d.py:launch_threads must equal it).
int repro_xcorr1d_threads(int n_taps, int block_size, int mode,
                          int unroll) {
  return launch_threads(block_size, mode, unroll, n_taps);
}

// Blocks a launch of n outputs runs (xcorr1d.py:launch_grid must equal
// it): the tiles on the one-tile launch; on the ring the kernel's
// resident blocks per SM times the SMs, at most the tiles, and with n = 0
// the resident blocks alone. Negative: a CUDA error.
long long repro_xcorr1d_grid(long long n, int n_taps, int block_size,
                             int mode, int unroll, int dtype, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(long long)err;
  if (n < 0 || !valid(n_taps, block_size, mode, unroll, dtype))
    return -(long long)cudaErrorInvalidValue;
  const Args a{nullptr, nullptr, nullptr, n, n_taps, block_size, unroll,
               device, false, nullptr};
  long long grid = 0;
  err = dispatch(mode, dtype, a, grid);
  return err == cudaSuccess ? grid : -(long long)err;
}

// The layout of a launch (body code 8, analysis/bodies.py:xcorr1d mirrors
// it): out[0] 8, then the route (1 the ring), threads, the window's
// empty-slot period, one window's bytes, a warp's scratch bytes, the
// ring's stages (0 on the one-tile launch), the shared bytes, the register
// width U_r the kernel runs and the passes U / U_r. Returns the count
// written, or -1. Host only: no launch.
int repro_xcorr1d_layout(int n_taps, int block_size, int mode, int unroll,
                         int dtype, long long* out) {
  if (dtype < 0 || dtype > DTYPE_F16) return -1;
  const int item = itemsize(dtype);
  const int ur = register_unroll(unroll);
  const bool ring = ring_route(mode, unroll, n_taps);
  const int pad = ring ? window_pad(mode, ur, item) : 0;
  const long long v[] = {
      8, ring ? 1 : 0, launch_threads(block_size, mode, unroll, n_taps), pad,
      ring ? (long long)window_bytes(n_taps, block_size, item, pad)
           : (long long)round_up16(size_t(block_size + n_taps - 1) * item),
      ring ? warp_scratch_bytes(mode, ur, item) : 0,
      ring ? ring_stages(n_taps, block_size, item, mode, unroll) : 0,
      (long long)smem_bytes(n_taps, block_size, item, mode, unroll), ur,
      unroll / ur};
  return stencil::put_fields(v, out);
}

}  // extern "C"
