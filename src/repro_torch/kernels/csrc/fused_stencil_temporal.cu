// Fused stencil phi(A.B) with temporal fusion ("swc" at depth
// S = fuse_steps > 1), for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/emit.py:_kernel_temporal
// (line 271) with _temporal_sweeps (line 242), launched by
// fused_stencil_pallas at line 565: one tile staged with a halo of r*S,
// S sweeps on it, sweep s evaluating every operator over the tile
// widened by r*(S-1-s) and applying phi_s. Rows [0, n_f) of an
// intermediate sweep are the next sweep's fields, rows [n_f, n_f+n_aux)
// its aux carry, cut by r on every side (emit.py:297-315); only the last
// sweep's n_out rows reach device memory.
//
// Design. One block per output tile, a 1-D block of the phi kind's
// thread count (at most sweep 0's points, StencilPlan.threads) whatever
// the tile: the threads loop over the points of each sweep's region, so
// a tile shrunk to fit shared memory keeps a full block. The sweeps,
// the staging and the carry are temporal_body.cuh's, shared with the tc
// kernel; here the derivatives come from the tap table (ScalarEval in
// stencil_sweep.cuh), which sits in shared memory as in the depth-1
// kernel, each sweep rewriting the taps' offsets for the extents of the
// buffer it reads. Coefficients are cast to the field type before the
// multiply and taps are summed in table order, as the plain version
// does.
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
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 / 34 TFLOP/s f64
// outside the tensor cores): diffusion is bound by bytes, and S sweeps
// per launch divide its device-memory traffic per step by about S; what
// it pays is the redundant sweeps over the widened regions
// (core/trafficmodel.py). The MHD pair is bound by operations: every
// sweep evaluates the RHS (2,368 stencil FLOP plus ~286 for phi per
// point), and sweep 0 does so over the widened region, 14.5x the tile's
// points at tile (1, 8, 32). Fusing saves one round trip of the 16-row
// state through device memory, which does not bind MHD, so the pair
// does more work than two depth-1 launches; the design keeps that extra
// work to the one widened sweep and never writes an intermediate to
// device memory.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "phi_mhd.cuh"
#include "stencil_common.cuh"
#include "stencil_sweep.cuh"
#include "temporal_body.cuh"

namespace {

using namespace stencil;

// One block per SM is what the shared memory allows at the planner's
// tiles, so the MHD kinds may use up to 255 registers a thread.
template <typename T, int KIND>
__global__ void __launch_bounds__(KIND == KIND_SELECT ? 1024 : 256, 1)
    temporal_kernel(const T* __restrict__ f, const T* __restrict__ aux,
                    T* __restrict__ out, const int* __restrict__ tap_off,
                    const double* __restrict__ tap_coef,
                    const int* __restrict__ op_start,
                    const __grid_constant__ Geometry g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  temporal_body<T, KIND, ScalarEval<T, KIND == KIND_SELECT>>(
      f, aux, out, tap_off, tap_coef, op_start, g, smem_raw);
}

template <typename T, int KIND>
cudaError_t launch(const void* f, const void* aux, void* out,
                   const void* tap_off, const void* tap_coef,
                   const void* op_start, Geometry g,
                   cudaStream_t stream) {
  const size_t smem =
      temporal_layout<T, ScalarEval<T, KIND == KIND_SELECT>>(g).total;
  auto kernel = temporal_kernel<T, KIND>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  unsigned gz;
  if (!fold_members(g, g.n[0] / g.t[0], gz)) return cudaErrorInvalidValue;
  const dim3 block(g.n_thr);
  const dim3 grid(g.n[2] / g.t[2], g.n[1] / g.t[1], gz);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(f), static_cast<const T*>(aux),
      static_cast<T*>(out), static_cast<const int*>(tap_off),
      static_cast<const double*>(tap_coef), static_cast<const int*>(op_start),
      g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the temporal kernel on `stream`. `geom` (G_LEN ints) is a host
// array; every other pointer, `params` (fuse_steps rows of n_params
// doubles, one per sweep) included, is device memory. Returns the cudaError_t
// of the launch (0 on success).
int repro_fused_stencil_temporal(const void* f, const void* aux, void* out,
                                 const void* tap_off, const void* tap_coef,
                                 const void* op_start, const int* geom,
                                 const double* params, int n_params, int kind,
                                 int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  Geometry g;
  if (!read_geometry(geom, params, n_params, g) || g.fuse_steps < 2 ||
      g.unroll != 1 || g.n_buf < 1 || g.n_buf > 2 || g.n_thr < 1 ||
      g.n_thr > (kind == KIND_SELECT ? 1024 : 256) ||
      (dtype != DTYPE_F32 && dtype != DTYPE_F64))
    return int(cudaErrorInvalidValue);
  const bool is_double = dtype == DTYPE_F64;

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind * 2 + (is_double ? 1 : 0)) {
    case KIND_SELECT * 2:
      return int(launch<float, KIND_SELECT>(f, aux, out, tap_off, tap_coef,
                                            op_start, g, st));
    case KIND_SELECT * 2 + 1:
      return int(launch<double, KIND_SELECT>(f, aux, out, tap_off, tap_coef,
                                             op_start, g, st));
    case KIND_MHD_RHS * 2:
      return int(launch<float, KIND_MHD_RHS>(f, aux, out, tap_off, tap_coef,
                                             op_start, g, st));
    case KIND_MHD_RHS * 2 + 1:
      return int(launch<double, KIND_MHD_RHS>(f, aux, out, tap_off, tap_coef,
                                              op_start, g, st));
    case KIND_MHD_SUBSTEP * 2:
      return int(launch<float, KIND_MHD_SUBSTEP>(f, aux, out, tap_off,
                                                 tap_coef, op_start, g, st));
    case KIND_MHD_SUBSTEP * 2 + 1:
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
long long repro_fused_stencil_temporal_smem_bytes(const int* geom,
                                                  int dtype) {
  Geometry g;
  if (!read_geometry(geom, nullptr, 0, g)) return -1;
  switch (dtype) {
    case DTYPE_F32:
      return (long long)temporal_layout<float, ScalarEval<float, true>>(g)
          .total;
    case DTYPE_F64:
      return (long long)temporal_layout<double, ScalarEval<double, true>>(g)
          .total;
    default:
      return -1;
  }
}

int repro_fused_stencil_temporal_geometry_len(void) { return G_LEN; }

}  // extern "C"
