// What the fused-stencil kernels share: fused_stencil.cu (depth 1),
// fused_stencil_temporal.cu (depth > 1) and fused_stencil_stream.cu
// (swc_stream, its depth-1 body in stream_body.cuh). The geometry the
// wrapper (repro_torch/kernels/emit.py) hands over, its host-side reading,
// the tap table kept in shared memory, and one operator evaluated at one
// point.
#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace stencil {

constexpr int KIND_SELECT = 0;
constexpr int KIND_MHD_RHS = 1;
constexpr int KIND_MHD_SUBSTEP = 2;
constexpr int MAX_SLOTS = 16;
constexpr int MAX_PARAMS = 16;

// Element types the wrappers hand over (emit.py:dtype_code).
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_F64 = 1;
constexpr int DTYPE_BF16 = 2;

// Host-side int layout of the geometry array (emit.py:geometry builds it).
enum GeomIndex {
  G_NF, G_NOUT, G_NAUX,
  G_N0, G_N1, G_N2,  // interior extents (z, y, x)
  G_P0, G_P1, G_P2,  // padded extents
  G_R0, G_R1, G_R2,  // radii
  G_T0, G_T1, G_T2,  // tile
  G_UNROLL, G_NOPS, G_NTAPS, G_NSLOTS,
  G_FUSE,  // sweeps per launch
  G_NBUF,  // staged window buffers (depth > 1: 1 or 2); depth-1 rings:
           // windows (swc, tc: 2 or 3) or chunks (swc_stream: 1-4)
  G_NTHR,  // threads per block
  G_NSEG,  // swc_stream: segments the stream axis is cut into
  G_NB,    // ensemble members (the outer part of blockIdx.z)
  G_CLEN,  // tc: doubles per band-coefficient row (2 r_max + 1); else 0
  G_SLOT0,  // MAX_SLOTS operator indices follow
  G_TPS = G_SLOT0 + MAX_SLOTS,  // depth 1 (swc, tc): tiles per step; else 0
  G_TABW,   // tc depth 1: words of its table (group rows, fragments)
  G_UOUT,   // depth 1, swc and swc_stream's ring body: outputs per
            // thread; else 0
  G_LEN
};

struct Geometry {
  int n_f, n_out, n_aux;
  int n[3];  // interior (z, y, x)
  int p[3];  // padded (z, y, x)
  int r[3];  // radii
  int t[3];  // tile (z, y, x)
  int unroll;
  int n_ops, n_taps, n_slots;
  int fuse_steps;
  int n_buf;
  int n_thr;
  int n_seg;
  int n_b;
  int coef_len;  // tc: doubles per band-coefficient row
  int tps;         // depth 1 (swc, tc): tiles per step along x
  int table_words;  // tc depth 1: 32-bit words of its table
  int u_out;        // depth 1 (swc, swc_stream's ring): outputs per thread
  int per_member;  // blocks along z per member (set by fold_members)
  unsigned long long member_mul;  // ceil(2^32 / per_member)
  int slot[MAX_SLOTS];  // operator index read by each phi slot
  int n_params;         // doubles per parameter row
  // phi parameters in device memory, fuse_steps rows of n_params, one per
  // sweep: a buffer the wrapper passes, so no depth is fixed here.
  const double* prm;
};

// Fill `g` from the wrapper's int array and its device buffer of
// fuse_steps x n_params parameter rows; false when a count exceeds the
// kernel's arrays.
inline bool read_geometry(const int* geom, const double* params,
                          int n_params, Geometry& g) {
  if (n_params < 0 || n_params > MAX_PARAMS || geom[G_NSLOTS] > MAX_SLOTS ||
      geom[G_FUSE] < 1)
    return false;
  g = Geometry{};
  g.n_f = geom[G_NF];
  g.n_out = geom[G_NOUT];
  g.n_aux = geom[G_NAUX];
  for (int a = 0; a < 3; ++a) {
    g.n[a] = geom[G_N0 + a];
    g.p[a] = geom[G_P0 + a];
    g.r[a] = geom[G_R0 + a];
    g.t[a] = geom[G_T0 + a];
  }
  g.unroll = geom[G_UNROLL];
  g.n_ops = geom[G_NOPS];
  g.n_taps = geom[G_NTAPS];
  g.n_slots = geom[G_NSLOTS];
  g.fuse_steps = geom[G_FUSE];
  g.n_buf = geom[G_NBUF];
  g.n_thr = geom[G_NTHR];
  g.n_seg = geom[G_NSEG];
  g.n_b = geom[G_NB];
  g.coef_len = geom[G_CLEN];
  g.tps = geom[G_TPS];
  g.table_words = geom[G_TABW];
  g.u_out = geom[G_UOUT];
  for (int s = 0; s < g.n_slots; ++s) g.slot[s] = geom[G_SLOT0 + s];
  g.n_params = n_params;
  g.prm = params;
  return true;
}

// Sweep s's row of phi parameters (device memory).
__device__ __forceinline__ const double* prm_row(const Geometry& g, int s) {
  return g.prm + s * g.n_params;
}

// Ensemble members: every kernel folds the member into blockIdx.z as
// member * per_member + z, per_member being its z tiles (or, streaming,
// its segments), so one block serves one member and runs the unbatched
// body on that member's field, aux and output.
struct MemberZ {
  int member;  // the ensemble member this block serves
  int z;       // the block's z index within that member
};

// Host: set the grid's z extent (members x per_member, within CUDA's
// 65,535) and the multiplier that splits blockIdx.z back on the card.
inline bool fold_members(Geometry& g, int per_member, unsigned& grid_z) {
  const long long n = (long long)g.n_b * per_member;
  if (g.n_b < 1 || per_member < 1 || n > 65535) return false;
  g.per_member = per_member;
  g.member_mul = ((1ull << 32) + per_member - 1) / per_member;
  grid_z = unsigned(n);
  return true;
}

// blockIdx.z / per_member without an integer division (some twenty
// instructions at the start of every block, short blocks included):
// with z, per_member < 2^16, z * per_member < 2^32, so
// floor(z * ceil(2^32 / per_member) / 2^32) is the quotient exactly.
__device__ __forceinline__ MemberZ member_z(const Geometry& g) {
  const unsigned z = blockIdx.z;
  const int m = int((z * g.member_mul) >> 32);
  return {m, int(z) - m * g.per_member};
}

// A tap coefficient (double on the host) in the field type, cast before
// the multiply as the reference does; bf16 goes through float, as
// PyTorch's own conversion of a Python float does.
template <typename T>
__device__ inline T cast_coef(double c) {
  return static_cast<T>(c);
}
template <>
__device__ inline __nv_bfloat16 cast_coef<__nv_bfloat16>(double c) {
  return __float2bfloat16(static_cast<float>(c));
}

// One tap in shared memory: coefficient (in the field type) and its
// linear offset in the staged buffer, read together in one load.
template <typename T>
struct __align__(2 * sizeof(T)) Tap {
  T coef;
  int offset;
};

__host__ __device__ inline size_t round_up16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Wait until the oldest staged window has landed for the whole block;
// with `next_in_flight` one younger copy may stay outstanding.
__device__ __forceinline__ void wait_staged(bool next_in_flight) {
  if (next_in_flight) {
    __pipeline_wait_prior(1);
  } else {
    __pipeline_wait_prior(0);
  }
  __syncthreads();
}

// One operator at one point: taps [b, e) of the table, in order.
template <typename T>
__device__ __forceinline__ T apply_op(const T* __restrict__ win,
                                      const Tap<T>* __restrict__ taps, int b,
                                      int e, int center) {
  T acc = T(0);
#pragma unroll 4
  for (int t = b; t < e; ++t) {
    const Tap<T> tap = taps[t];
    acc += tap.coef * win[center + tap.offset];
  }
  return acc;
}

// bf16 products and sums as PyTorch's and XLA's elementwise bf16
// arithmetic rounds them: the operation in f32 (exact for a product of
// two bf16 values), then one rounding to bf16. __fmul_rn/__fadd_rn are
// never contracted into an FMA, which a bf16 mul/add pair may be.
__device__ __forceinline__ __nv_bfloat16 bf16_mul(__nv_bfloat16 a,
                                                  __nv_bfloat16 b) {
  return __float2bfloat16_rn(
      __fmul_rn(__bfloat162float(a), __bfloat162float(b)));
}
__device__ __forceinline__ __nv_bfloat16 bf16_add(__nv_bfloat16 a,
                                                  __nv_bfloat16 b) {
  return __float2bfloat16_rn(
      __fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}

// bf16: every product and every sum rounded to bf16, in table order.
template <>
__device__ __forceinline__ __nv_bfloat16 apply_op(
    const __nv_bfloat16* __restrict__ win,
    const Tap<__nv_bfloat16>* __restrict__ taps, int b, int e, int center) {
  __nv_bfloat16 acc = __float2bfloat16(0.0f);
#pragma unroll 4
  for (int t = b; t < e; ++t) {
    const Tap<__nv_bfloat16> tap = taps[t];
    acc = bf16_add(acc, bf16_mul(tap.coef, win[center + tap.offset]));
  }
  return acc;
}

// Start an asynchronous copy of one element into shared memory:
// cp.async for 4- and 8-byte types; cp.async takes no 2-byte copy, so
// bf16 elements are copied through a register (the wait before their
// first read synchronises the block all the same).
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  if constexpr (sizeof(T) >= 4) {
    __pipeline_memcpy_async(dst, src, sizeof(T));
  } else {
    *dst = *src;
  }
}

}  // namespace stencil
