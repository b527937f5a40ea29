// Fused stencil phi(A.B), software-managed cache ("swc"), depth 1, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/emit.py:_kernel_pipelined
// (line 207) with _block_derivs (line 73), launched by
// fused_stencil_pallas (line 473 -> pl.pallas_call at line 565): every
// operator of a tap table applied to every field of a halo-padded stack,
// then a point-wise map phi (with an optional halo-free aux operand),
// computing `unroll` adjacent x sub-tiles per block from one staged
// window.
//
// Design. One thread block per output tile, one thread per point of a
// sub-tile, x fastest so neighbouring threads touch neighbouring
// addresses. The TPU staged the whole (n_f, tile + 2r) window in VMEM;
// for MHD in f64 that does not fit the 227 KB a Hopper block can use at
// any useful tile, so the block stages ONE field's halo window in shared
// memory at a time, double-buffered with cp.async: while every thread
// evaluates the operators phi reads on field k at its point into
// registers, field k+1's window is in flight. phi runs once all
// n_slots x n_f values are in registers (10 x 8 = 80 for MHD). The tap
// table (flattened (op, tap) -> (dz, dy, dx, coeff), coefficients in
// double) is copied into shared memory at block start: each coefficient
// is cast to the field type BEFORE the multiply and each operator
// accumulates its taps in table order, as the reference does (ref.py:55,
// emit.py:92). Ranks 1 and 2 run as rank 3 with unit leading extents and
// zero radii.
//
// Ensemble batch (B5: the TPU's _fused_batched, emit.py:345, with
// _member_phi, line 318). The reference flattens B members onto the
// field axis so all B x n_f fields share one staged window; here the
// member is an outer grid index instead (blockIdx.z = member x z tiles
// + z tile), so shared memory per block stays one member's. A block
// adds member x n_f, n_aux and n_out fields to its field, aux and
// output offsets (64-bit) and runs the unbatched body, so member m of a
// batched launch is the unbatched launch on member m, bit for bit, and
// B members cost one launch.
//
// bf16 (the select kind only; B1b). The reference's VPU path casts each
// coefficient to bf16 and rounds every product and every sum to bf16;
// apply_op's bf16 form does the same (bf16_mul/bf16_add: the operation
// in f32, then one rounding, never contracted into an FMA). cp.async
// takes no 2-byte copy, so a bf16 window is staged through registers
// (copy_async).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 / 34 TFLOP/s f64
// outside the tensor cores): diffusion (one field, 19 taps at order 6)
// moves 8 B per point in f32 and is bound by bytes; the MHD RHS (2,368
// stencil FLOP plus ~250 for phi per point against 64 B) is bound by
// operations. What this simple kernel does about it: it never writes an
// intermediate derivative to device memory and reads each window once
// (halo re-reads hit L2). Each tap still costs two shared-memory loads
// (its coefficient/offset pair and the window value) beside one FMA, so
// MHD is limited by the rate of shared-memory loads, not of FMAs, and
// diffusion, one load-compute-store per block, by memory latency
// (PERF.md). Streaming the slowest axis through a cp.async/TMA pipeline
// is the swc_stream kernel's job (ROADMAP B3).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "phi_mhd.cuh"
#include "stencil_common.cuh"

namespace {

using namespace stencil;

__host__ __device__ inline int window_x(const Geometry& g) {
  return g.t[2] * g.unroll + 2 * g.r[2];
}

// Shared-memory layout: two window buffers (each padded to 16 bytes) |
// taps | op starts. repro_torch/kernels/plan.py:StencilPlan.smem_bytes
// mirrors it.
template <typename T>
__host__ __device__ inline size_t window_bytes(const Geometry& g) {
  const size_t window = size_t(g.t[0] + 2 * g.r[0]) *
                        size_t(g.t[1] + 2 * g.r[1]) * size_t(window_x(g));
  return round_up16(window * sizeof(T));
}

template <typename T>
__host__ __device__ inline size_t taps_offset(const Geometry& g) {
  return 2 * window_bytes<T>(g);
}

template <typename T>
size_t smem_bytes(const Geometry& g) {
  return taps_offset<T>(g) + size_t(g.n_taps) * sizeof(Tap<T>) +
         size_t(g.n_ops + 1) * sizeof(int);
}

// Start copying one field's halo window (wz, wy, wx) into shared memory
// with cp.async: every element's copy is in flight at once and none
// passes through a register. The window's (z, y) rows are spread over
// the block's (y, z) threads and each row's x over the x threads, so
// consecutive threads read consecutive addresses.
template <typename T>
__device__ __forceinline__ void stage_async(const T* __restrict__ src,
                                            T* __restrict__ win, int wz,
                                            int wy, int wx, long long psz,
                                            long long psy) {
  const int rows = wz * wy;
  const int row_step = blockDim.y * blockDim.z;
  for (int row = threadIdx.y + blockDim.y * threadIdx.z; row < rows;
       row += row_step) {
    const int z = row / wy;
    const int y = row - z * wy;
    const T* s = src + z * psz + y * psy;
    T* w = win + row * wx;
    for (int x = threadIdx.x; x < wx; x += blockDim.x)
      copy_async(w + x, s + x);
  }
  __pipeline_commit();
}

template <typename T, int KIND>
__global__ void __launch_bounds__(KIND == KIND_SELECT ? 1024 : 256)
    fused_stencil_kernel(const T* __restrict__ f, const T* __restrict__ aux,
                         T* __restrict__ out, const int* __restrict__ tap_off,
                         const double* __restrict__ tap_coef,
                         const int* __restrict__ op_start,
                         const __grid_constant__ Geometry g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wz = g.t[0] + 2 * g.r[0];
  const int wy = g.t[1] + 2 * g.r[1];
  const int wx = window_x(g);
  const size_t wbytes = window_bytes<T>(g);
  auto buf = [&](int k) {  // window buffer of field k (two, alternating)
    return reinterpret_cast<T*>(smem_raw + (k & 1) * wbytes);
  };
  Tap<T>* taps = reinterpret_cast<Tap<T>*>(smem_raw + taps_offset<T>(g));
  int* start = reinterpret_cast<int*>(taps + g.n_taps);

  const int tid =
      threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
  const int nthr = blockDim.x * blockDim.y * blockDim.z;
  for (int i = tid; i < g.n_taps; i += nthr) {
    taps[i].coef = cast_coef<T>(tap_coef[i]);  // cast before the multiply
    taps[i].offset = (tap_off[3 * i] * wy + tap_off[3 * i + 1]) * wx +
                     tap_off[3 * i + 2];
  }
  for (int i = tid; i <= g.n_ops; i += nthr) start[i] = op_start[i];

  // Padded (input) and interior (output, aux) strides.
  const long long psy = g.p[2];
  const long long psz = psy * g.p[1];
  const long long pfield = psz * g.p[0];
  const long long osy = g.n[2];
  const long long osz = osy * g.n[1];
  const long long ofield = osz * g.n[0];
  // The member this block serves (blockIdx.z = member x z tiles + z):
  // its field, aux and output start member x n_f, n_aux and n_out
  // fields in. The offsets join the origins below: moving the
  // __restrict__ pointers themselves instead made the diffusion kernel
  // measurably slower on the card (PERF.md, section 6).
  const MemberZ mz = member_z(g);
  const long long member = mz.member;
  // The tile's origin in the interior is its window's origin in the
  // padded field (the window reaches r further on every side).
  const long long z0 = (long long)mz.z * g.t[0];
  const long long y0 = (long long)blockIdx.y * g.t[1];
  const long long x0 = (long long)blockIdx.x * g.t[2] * g.unroll;
  const long long porigin =
      member * g.n_f * pfield + z0 * psz + y0 * psy + x0;
  const long long point = (z0 + threadIdx.z) * osz +
                          (y0 + threadIdx.y) * osy + x0 + threadIdx.x;
  const long long opoint = member * g.n_out * ofield + point;
  const long long apoint = member * g.n_aux * ofield + point;
  const int center = ((threadIdx.z + g.r[0]) * wy + threadIdx.y + g.r[1]) * wx +
                     threadIdx.x + g.r[2];

  // Fields are double-buffered: field k+1's window is in flight while
  // field k is evaluated.
  if constexpr (KIND == KIND_SELECT) {
    // out[k] = op_slot0(f[k]): one value per field, written at once, so
    // every sub-tile is computed from the one staged window.
    const int op = g.slot[0];
    stage_async(f + porigin, buf(0), wz, wy, wx, psz, psy);
    for (int k = 0; k < g.n_f; ++k) {
      const bool more = k + 1 < g.n_f;
      if (more)
        stage_async(f + (k + 1) * pfield + porigin, buf(k + 1), wz, wy,
                    wx, psz, psy);
      wait_staged(more);
      for (int u = 0; u < g.unroll; ++u) {
        const int du = u * g.t[2];
        out[k * ofield + opoint + du] =
            apply_op(buf(k), taps, start[op], start[op + 1], center + du);
      }
      __syncthreads();  // buf(k) read before field k + 2 lands there
    }
  } else {
    // MHD: 80 derivative values per point live in registers, so sub-tiles
    // run one after another (restaging the fields) rather than holding
    // unroll x 80 values.
    const mhd::Consts<T> c(prm_row(g, 0));
    for (int u = 0; u < g.unroll; ++u) {
      const int du = u * g.t[2];
      T d[mhd::N_SLOTS][mhd::N_FIELDS];
      stage_async(f + porigin, buf(0), wz, wy, wx, psz, psy);
#pragma unroll
      for (int k = 0; k < mhd::N_FIELDS; ++k) {
        const bool more = k + 1 < mhd::N_FIELDS;
        if (more)
          stage_async(f + (k + 1) * pfield + porigin, buf(k + 1), wz,
                      wy, wx, psz, psy);
        wait_staged(more);
#pragma unroll
        for (int s = 0; s < mhd::N_SLOTS; ++s) {
          const int op = g.slot[s];
          d[s][k] = apply_op(buf(k), taps, start[op], start[op + 1],
                             center + du);
        }
        __syncthreads();
      }
      T rhs[mhd::N_FIELDS];
      mhd::rhs<T>(d, c, rhs);
      const long long pt = opoint + du;
      if constexpr (KIND == KIND_MHD_RHS) {
#pragma unroll
        for (int k = 0; k < mhd::N_FIELDS; ++k) out[k * ofield + pt] = rhs[k];
      } else {
        // Fused RK axpy (repro/physics/mhd.py:284-290), aux = w.
        const T alpha = T(prm_row(g, 0)[mhd::P_ALPHA]);
        const T beta = T(prm_row(g, 0)[mhd::P_BETA]);
        const T dt = T(prm_row(g, 0)[mhd::P_DT]);
#pragma unroll
        for (int k = 0; k < mhd::N_FIELDS; ++k) {
          const T w = alpha * aux[k * ofield + apoint + du] + dt * rhs[k];
          out[k * ofield + pt] = d[mhd::VAL][k] + beta * w;
          out[(mhd::N_FIELDS + k) * ofield + pt] = w;
        }
      }
    }
  }
}

template <typename T, int KIND>
cudaError_t launch(const void* f, const void* aux, void* out,
                   const void* tap_off, const void* tap_coef,
                   const void* op_start, Geometry g,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(g);
  auto kernel = fused_stencil_kernel<T, KIND>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  unsigned gz;
  if (!fold_members(g, g.n[0] / g.t[0], gz)) return cudaErrorInvalidValue;
  const dim3 block(g.t[2], g.t[1], g.t[0]);
  const dim3 grid(g.n[2] / (g.t[2] * g.unroll), g.n[1] / g.t[1], gz);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(f), static_cast<const T*>(aux),
      static_cast<T*>(out), static_cast<const int*>(tap_off),
      static_cast<const double*>(tap_coef), static_cast<const int*>(op_start),
      g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the fused stencil on `stream`. `geom` (G_LEN ints) is a host
// array; every other pointer, `params` (one row of n_params doubles)
// included, is device memory. Returns the cudaError_t of the launch (0
// on success).
int repro_fused_stencil(const void* f, const void* aux, void* out,
                        const void* tap_off, const void* tap_coef,
                        const void* op_start, const int* geom,
                        const double* params, int n_params, int kind,
                        int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  Geometry g;
  if (!read_geometry(geom, params, n_params, g) || g.fuse_steps != 1)
    return int(cudaErrorInvalidValue);

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind * 3 + dtype) {
    case KIND_SELECT * 3 + DTYPE_F32:
      return int(launch<float, KIND_SELECT>(f, aux, out, tap_off, tap_coef,
                                            op_start, g, st));
    case KIND_SELECT * 3 + DTYPE_F64:
      return int(launch<double, KIND_SELECT>(f, aux, out, tap_off, tap_coef,
                                             op_start, g, st));
    case KIND_SELECT * 3 + DTYPE_BF16:  // B1b: the select kind in bf16
      return int(launch<__nv_bfloat16, KIND_SELECT>(
          f, aux, out, tap_off, tap_coef, op_start, g, st));
    case KIND_MHD_RHS * 3 + DTYPE_F32:
      return int(launch<float, KIND_MHD_RHS>(f, aux, out, tap_off, tap_coef,
                                             op_start, g, st));
    case KIND_MHD_RHS * 3 + DTYPE_F64:
      return int(launch<double, KIND_MHD_RHS>(f, aux, out, tap_off, tap_coef,
                                              op_start, g, st));
    case KIND_MHD_SUBSTEP * 3 + DTYPE_F32:
      return int(launch<float, KIND_MHD_SUBSTEP>(f, aux, out, tap_off,
                                                 tap_coef, op_start, g, st));
    case KIND_MHD_SUBSTEP * 3 + DTYPE_F64:
      return int(launch<double, KIND_MHD_SUBSTEP>(f, aux, out, tap_off,
                                                  tap_coef, op_start, g, st));
    default:
      return int(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory one block of this kernel uses for `geom` (the plan's
// StencilPlan.smem_bytes must equal it).
long long repro_fused_stencil_smem_bytes(const int* geom, int dtype) {
  Geometry g;
  if (!read_geometry(geom, nullptr, 0, g)) return -1;
  switch (dtype) {
    case DTYPE_F32: return (long long)smem_bytes<float>(g);
    case DTYPE_F64: return (long long)smem_bytes<double>(g);
    case DTYPE_BF16: return (long long)smem_bytes<__nv_bfloat16>(g);
    default: return -1;
  }
}

int repro_fused_stencil_geometry_len(void) { return G_LEN; }

}  // extern "C"
