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
// Two bodies. The select kind at ranks 2 and 3 and the MHD kinds in f32
// and bf16 (the geometry's outputs per thread G_UOUT > 0) run
// temporal_walk_body.cuh,
// whose header says how and why: persistent blocks walk tile columns along
// the slowest axis, a ring of input planes filled by 16-byte cp.async and a
// ring of planes per intermediate sweep, read where they land, several
// outputs per thread, phi's MHD inputs in shared memory. The MHD kinds in
// f64 (eight fields' rings fit no tile beside phi's inputs) and rank 1
// (tiles of 1024 points with a 2rS halo, 1.01-1.02 evaluations per
// output-step already) run temporal_kernel below on temporal_body.cuh.
//
// temporal_kernel. One block per output tile, a 1-D block of the phi kind's
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
// bf16 (B2c, and B4b on the walk's pair). As at depth 1 (fused_stencil.cu):
// every product and sum of the tap loop rounded once to bf16 in table
// order (the walk's swc::mac, the one-tile body's apply_op), phi's every
// operation rounded once (phi_mhd.cuh's Bf16), and each intermediate
// sweep's rows stored in bf16, as the reference carries cur = val[:n_f]
// from sweep to sweep. The walk stages bf16 with 16-byte cp.async into
// rows congruent modulo 16 bytes (8 values); the one-tile body (rank 1)
// copies 2-byte values through a register (cp.async takes none).
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
#include "temporal_walk_body.cuh"

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

// The walk body (temporal_walk_body.cuh): at most 128 registers a thread
// (select 256 threads x 2 blocks an SM or 512 x 1, MHD 512 x 1).
template <typename T, int KIND>
__global__ void __launch_bounds__(walk::MAX_THREADS, 1)
    walk_kernel(const T* __restrict__ f, const T* __restrict__ aux,
                T* __restrict__ out, const int* __restrict__ tap_off,
                const double* __restrict__ tap_coef,
                const int* __restrict__ op_start,
                const __grid_constant__ Geometry g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  walk::walk_body<T, KIND, walk::outputs<KIND>()>(
      f, aux, out, tap_off, tap_coef, op_start, g, smem_raw);
}

// Whether a launch runs the walk body: outputs per thread in the geometry
// (emit.geometry sets them for the plans that take it).
inline bool walk_launch(const Geometry& g) { return g.u_out > 0; }

// One walk launch, or (grid != nullptr) the grid a launch would take:
// persistent.cuh's persistent_grid over the launch's columns.
template <typename T, int KIND>
cudaError_t walk_run(const void* f, const void* aux, void* out,
                     const void* tap_off, const void* tap_coef,
                     const void* op_start, const Geometry& g, int device,
                     cudaStream_t stream, long long* grid) {
  const size_t smem = walk::walk_layout<T>(g).total;
  const long long items = (long long)(g.n[2] / g.t[2]) * (g.n[1] / g.t[1]) *
                          g.n_seg * g.n_b;
  long long blocks = 0;
  const cudaError_t err = persistent_grid<walk_kernel<T, KIND>>(
      g.n_thr, smem, device, items, blocks);
  if (err != cudaSuccess || grid) {
    if (grid) *grid = blocks;
    return err;
  }
  walk_kernel<T, KIND><<<unsigned(blocks), g.n_thr, smem, stream>>>(
      static_cast<const T*>(f), static_cast<const T*>(aux),
      static_cast<T*>(out), static_cast<const int*>(tap_off),
      static_cast<const double*>(tap_coef), static_cast<const int*>(op_start),
      g);
  return cudaGetLastError();
}

// The walk's instantiations: select in f32, f64 and bf16; the MHD kinds
// in f32 and bf16 (in f64 the eight fields' rings fit no tile beside phi's
// inputs: they keep the one-tile body).
cudaError_t walk_dispatch(int kind, int dtype, const void* f, const void* aux,
                          void* out, const void* tap_off,
                          const void* tap_coef, const void* op_start,
                          const Geometry& g, int device, cudaStream_t st,
                          long long* grid) {
  using bf16 = __nv_bfloat16;
  switch (kind * 3 + dtype) {
    case KIND_SELECT * 3 + DTYPE_F32:
      return walk_run<float, KIND_SELECT>(f, aux, out, tap_off, tap_coef,
                                          op_start, g, device, st, grid);
    case KIND_SELECT * 3 + DTYPE_F64:
      return walk_run<double, KIND_SELECT>(f, aux, out, tap_off, tap_coef,
                                           op_start, g, device, st, grid);
    case KIND_SELECT * 3 + DTYPE_BF16:  // B2c
      return walk_run<bf16, KIND_SELECT>(f, aux, out, tap_off, tap_coef,
                                         op_start, g, device, st, grid);
    case KIND_MHD_RHS * 3 + DTYPE_F32:
      return walk_run<float, KIND_MHD_RHS>(f, aux, out, tap_off, tap_coef,
                                           op_start, g, device, st, grid);
    case KIND_MHD_SUBSTEP * 3 + DTYPE_F32:
      return walk_run<float, KIND_MHD_SUBSTEP>(f, aux, out, tap_off,
                                               tap_coef, op_start, g, device,
                                               st, grid);
    case KIND_MHD_RHS * 3 + DTYPE_BF16:  // B4b
      return walk_run<bf16, KIND_MHD_RHS>(f, aux, out, tap_off, tap_coef,
                                          op_start, g, device, st, grid);
    case KIND_MHD_SUBSTEP * 3 + DTYPE_BF16:
      return walk_run<bf16, KIND_MHD_SUBSTEP>(f, aux, out, tap_off, tap_coef,
                                              op_start, g, device, st, grid);
    default:
      return cudaErrorInvalidValue;
  }
}

// The walk's Shape and Layout fields (body code 4,
// analysis/bodies.py:walk_body mirrors them).
template <typename T>
int walk_fields(const Geometry& g, long long* out) {
  const walk::Shape s = walk::walk_shape<T>(g);
  const walk::Layout L = walk::walk_layout<T>(g);
  const long long v[] = {4, s.tau, s.ty, s.tx, s.wy, s.wx, s.lead, s.pitch,
                         s.plane, s.period, s.fstride, s.q, s.cq, s.seg,
                         (long long)L.mid, (long long)L.carry,
                         (long long)L.div, (long long)L.taps,
                         (long long)L.sums, (long long)L.total};
  return put_fields(v, out);
}

// The one-tile body's Layout fields (body code 7,
// analysis/bodies.py:temporal_body mirrors them).
template <typename T, class Eval>
int tile_fields(const Geometry& g, long long* out) {
  const Layout L = temporal_layout<T, Eval>(g);
  const long long v[] = {7, (long long)L.win, (long long)L.mid[0],
                         (long long)L.mid[1], (long long)L.carry[0],
                         (long long)L.carry[1], (long long)L.eval,
                         (long long)L.total};
  return put_fields(v, out);
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
      g.unroll != 1 || dtype < DTYPE_F32 || dtype > DTYPE_BF16)
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (walk_launch(g)) {
    if (!walk::valid(g, kind) || (aux != nullptr) != (g.n_aux > 0))
      return int(cudaErrorInvalidValue);
    return int(walk_dispatch(kind, dtype, f, aux, out, tap_off, tap_coef,
                             op_start, g, device, st, nullptr));
  }
  if (g.n_buf < 1 || g.n_buf > 2 || g.n_thr < 1 ||
      g.n_thr > (kind == KIND_SELECT ? 1024 : 256))
    return int(cudaErrorInvalidValue);
  // The one-tile body: select at rank 1 and the MHD kinds in f64 (the
  // planner sends every other swc plan to the walk).
  switch (kind * 3 + dtype) {
    case KIND_SELECT * 3 + DTYPE_F32:
      return int(launch<float, KIND_SELECT>(f, aux, out, tap_off, tap_coef,
                                            op_start, g, st));
    case KIND_SELECT * 3 + DTYPE_F64:
      return int(launch<double, KIND_SELECT>(f, aux, out, tap_off, tap_coef,
                                             op_start, g, st));
    case KIND_SELECT * 3 + DTYPE_BF16:  // B2c at rank 1
      return int(launch<__nv_bfloat16, KIND_SELECT>(
          f, aux, out, tap_off, tap_coef, op_start, g, st));
    case KIND_MHD_RHS * 3 + DTYPE_F64:
      return int(launch<double, KIND_MHD_RHS>(f, aux, out, tap_off, tap_coef,
                                              op_start, g, st));
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

// The blocks a walk launch of `geom` takes (the persistent grid), or a
// negative cudaError_t (the one-tile body has no persistent grid).
long long repro_fused_stencil_temporal_grid(const int* geom, int kind,
                                            int dtype, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(long long)err;
  Geometry g;
  if (!read_geometry(geom, nullptr, 0, g) || !walk_launch(g) ||
      !walk::valid(g, kind))
    return -(long long)cudaErrorInvalidValue;
  long long grid = 0;
  err = walk_dispatch(kind, dtype, nullptr, nullptr, nullptr, nullptr,
                      nullptr, nullptr, g, device, nullptr, &grid);
  return err == cudaSuccess ? grid : -(long long)err;
}

// Shared memory one block of this kernel uses for `geom` (the plan's
// StencilPlan.smem_bytes must equal it).
long long repro_fused_stencil_temporal_smem_bytes(const int* geom,
                                                  int dtype) {
  Geometry g;
  if (!read_geometry(geom, nullptr, 0, g)) return -1;
  using bf16 = __nv_bfloat16;
  if (walk_launch(g)) {
    switch (dtype) {
      case DTYPE_F32: return (long long)walk::walk_layout<float>(g).total;
      case DTYPE_F64: return (long long)walk::walk_layout<double>(g).total;
      case DTYPE_BF16: return (long long)walk::walk_layout<bf16>(g).total;
      default: return -1;
    }
  }
  switch (dtype) {
    case DTYPE_F32:
      return (long long)temporal_layout<float, ScalarEval<float, true>>(g)
          .total;
    case DTYPE_F64:
      return (long long)temporal_layout<double, ScalarEval<double, true>>(g)
          .total;
    case DTYPE_BF16:
      return (long long)temporal_layout<bf16, ScalarEval<bf16, true>>(g)
          .total;
    default:
      return -1;
  }
}

int repro_fused_stencil_temporal_geometry_len(void) { return G_LEN; }

// The body's layout for `geom`: out[0] its code (4 the walk, 7 the
// one-tile body), then its fields (emit.py:layout_fields names them).
// Returns the count written, or -1. Host only: no launch.
int repro_fused_stencil_temporal_layout(const int* geom, int dtype,
                                        long long* out) {
  Geometry g;
  if (!read_geometry(geom, nullptr, 0, g)) return -1;
  const bool w = walk_launch(g);
  switch (dtype) {
    case DTYPE_F32:
      return w ? walk_fields<float>(g, out)
               : tile_fields<float, ScalarEval<float, true>>(g, out);
    case DTYPE_F64:
      return w ? walk_fields<double>(g, out)
               : tile_fields<double, ScalarEval<double, true>>(g, out);
    case DTYPE_BF16:
      return w ? walk_fields<__nv_bfloat16>(g, out)
               : tile_fields<__nv_bfloat16,
                             ScalarEval<__nv_bfloat16, true>>(g, out);
    default:
      return -1;
  }
}

}  // extern "C"
