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
// Design (swc_body.cuh, whose header says how and why): persistent
// blocks walk the output tiles with a ring of windows in flight through
// 16-byte cp.async into buffers congruent to the global rows modulo 16
// bytes, each thread computes several outputs from a tap table built once
// per block (coefficient cast to the field type before any multiply,
// linear offset), and the MHD phi reads its 80 inputs from shared memory.
// Each operator accumulates its taps in table order, as the reference does
// (ref.py:55, emit.py:92). Ranks 1 and 2 run as rank 3 with unit leading
// extents and zero radii.
//
// Ensemble batch (B5: the TPU's _fused_batched, emit.py:345, with
// _member_phi, line 318). The reference flattens B members onto the
// field axis so all B x n_f fields share one staged window; here the
// member is the outermost index of the walk, so shared memory per block
// stays one member's, member m of a batched launch is the unbatched
// launch on member m, bit for bit, and B members cost one launch.
//
// bf16 (the select kind, B1b; the MHD kinds, B4b). The reference's VPU
// path casts each coefficient to bf16 and rounds every product and every
// sum to bf16; the body does the same (mac: the operation in f32, then
// one rounding, never contracted into an FMA), and phi rounds each of its
// operations once (phi_mhd.cuh's Bf16). phi's inputs sit in shared memory
// as bf16: the tap loop has rounded them already, so that is lossless.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 / 34 TFLOP/s f64
// outside the tensor cores): diffusion (one field, 19 taps at order 6)
// moves 8 B per point in f32 and is bound by bytes; the MHD RHS (2,368
// stencil FLOP plus ~250 for phi per point against 64 B) is bound by
// operations. The kernel never writes an intermediate derivative to
// device memory and reads each window once (halo re-reads hit L2).
#include <cuda_runtime.h>

#include "stencil_common.cuh"
#include "swc_body.cuh"

namespace {

using namespace stencil;

template <typename T, int KIND>
__global__ void __launch_bounds__(swc::max_threads<T, KIND>(), 1)
    fused_stencil_kernel(const T* __restrict__ f, const T* __restrict__ aux,
                         T* __restrict__ out, const int* __restrict__ tap_off,
                         const double* __restrict__ tap_coef,
                         const int* __restrict__ op_start,
                         const __grid_constant__ Geometry g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  swc::swc_body<T, KIND>(f, aux, out, tap_off, tap_coef, op_start, g,
                         smem_raw);
}

// The persistent grid (persistent.cuh's persistent_grid) over the launch's
// steps.
template <typename T, int KIND>
cudaError_t grid_of(const Geometry& g, int device, long long& grid) {
  const swc::Shape s = swc::swc_shape<T>(g);
  const long long items = (long long)(g.n[2] / s.tx) * (g.n[1] / s.ty) *
                          (g.n[0] / s.tz) * g.n_b;
  return persistent_grid<fused_stencil_kernel<T, KIND>>(
      g.n_thr, swc::swc_layout<T>(g).total, device, items, grid);
}

// One launch, or (grid != nullptr) the grid a launch would take. The
// geometry's threads and outputs per thread must be the kernel's
// (swc::outputs, plan.py:SWC_OUTPUTS).
template <typename T, int KIND>
cudaError_t run(const void* f, const void* aux, void* out,
                const void* tap_off, const void* tap_coef,
                const void* op_start, const Geometry& g, int device,
                cudaStream_t stream, long long* grid) {
  if (g.n_thr > swc::max_threads<T, KIND>() ||
      g.u_out != swc::outputs<KIND>())
    return cudaErrorInvalidValue;
  long long blocks = 0;
  const cudaError_t err = grid_of<T, KIND>(g, device, blocks);
  if (err != cudaSuccess || grid) {
    if (grid) *grid = blocks;
    return err;
  }
  fused_stencil_kernel<T, KIND>
      <<<unsigned(blocks), g.n_thr, swc::swc_layout<T>(g).total, stream>>>(
          static_cast<const T*>(f), static_cast<const T*>(aux),
          static_cast<T*>(out), static_cast<const int*>(tap_off),
          static_cast<const double*>(tap_coef),
          static_cast<const int*>(op_start), g);
  return cudaGetLastError();
}

bool valid(const Geometry& g, int kind) {
  if (g.fuse_steps != 1 || g.n_buf < 2 || g.n_buf > 3 || g.tps < 1 ||
      g.unroll < 1 || g.n_thr < 32 || g.n_thr % 32 || g.n_b < 1)
    return false;
  for (int a = 0; a < 3; ++a)
    if (g.t[a] < 1 || g.n[a] % g.t[a]) return false;
  if (g.n[2] % (g.t[2] * g.unroll * g.tps)) return false;
  if (kind == KIND_SELECT) return g.n_slots == 1;
  return g.n_f == mhd::N_FIELDS && g.n_slots == mhd::N_SLOTS;
}

cudaError_t dispatch(int kind, int dtype, const void* f, const void* aux,
                     void* out, const void* tap_off, const void* tap_coef,
                     const void* op_start, const Geometry& g, int device,
                     cudaStream_t st, long long* grid) {
  switch (kind * 3 + dtype) {
    case KIND_SELECT * 3 + DTYPE_F32:
      return run<float, KIND_SELECT>(f, aux, out, tap_off, tap_coef,
                                     op_start, g, device, st, grid);
    case KIND_SELECT * 3 + DTYPE_F64:
      return run<double, KIND_SELECT>(f, aux, out, tap_off, tap_coef,
                                      op_start, g, device, st, grid);
    case KIND_SELECT * 3 + DTYPE_BF16:  // B1b: the select kind in bf16
      return run<__nv_bfloat16, KIND_SELECT>(f, aux, out, tap_off, tap_coef,
                                             op_start, g, device, st, grid);
    case KIND_MHD_RHS * 3 + DTYPE_F32:
      return run<float, KIND_MHD_RHS>(f, aux, out, tap_off, tap_coef,
                                      op_start, g, device, st, grid);
    case KIND_MHD_RHS * 3 + DTYPE_F64:
      return run<double, KIND_MHD_RHS>(f, aux, out, tap_off, tap_coef,
                                       op_start, g, device, st, grid);
    case KIND_MHD_SUBSTEP * 3 + DTYPE_F32:
      return run<float, KIND_MHD_SUBSTEP>(f, aux, out, tap_off, tap_coef,
                                          op_start, g, device, st, grid);
    case KIND_MHD_SUBSTEP * 3 + DTYPE_F64:
      return run<double, KIND_MHD_SUBSTEP>(f, aux, out, tap_off, tap_coef,
                                           op_start, g, device, st, grid);
    case KIND_MHD_RHS * 3 + DTYPE_BF16:  // B4b: the MHD phi in bf16
      return run<__nv_bfloat16, KIND_MHD_RHS>(f, aux, out, tap_off, tap_coef,
                                              op_start, g, device, st, grid);
    case KIND_MHD_SUBSTEP * 3 + DTYPE_BF16:
      return run<__nv_bfloat16, KIND_MHD_SUBSTEP>(f, aux, out, tap_off,
                                                  tap_coef, op_start, g,
                                                  device, st, grid);
    default:
      return cudaErrorInvalidValue;
  }
}

// The depth-1 body's Shape and Layout fields (body code 1,
// analysis/bodies.py:swc_body mirrors them).
template <typename T>
int layout_fields(const Geometry& g, long long* out) {
  const swc::Shape s = swc::swc_shape<T>(g);
  const swc::Layout L = swc::swc_layout<T>(g);
  const long long v[] = {1, s.tz, s.ty, s.tx, s.wz, s.wy, s.wx, s.pitch,
                         s.plane, s.points, (long long)s.buf,
                         (long long)L.taps, (long long)L.starts,
                         (long long)L.sums, (long long)L.total};
  return put_fields(v, out);
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
  if (!read_geometry(geom, params, n_params, g) || !valid(g, kind))
    return int(cudaErrorInvalidValue);
  return int(dispatch(kind, dtype, f, aux, out, tap_off, tap_coef, op_start,
                      g, device, static_cast<cudaStream_t>(stream),
                      nullptr));
}

// The blocks a launch of `geom` takes (the persistent grid), or a
// negative cudaError_t.
long long repro_fused_stencil_grid(const int* geom, int kind, int dtype,
                                   int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(long long)err;
  Geometry g;
  if (!read_geometry(geom, nullptr, 0, g) || !valid(g, kind))
    return -(long long)cudaErrorInvalidValue;
  long long grid = 0;
  err = dispatch(kind, dtype, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, g, device, nullptr, &grid);
  return err == cudaSuccess ? grid : -(long long)err;
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
    case DTYPE_F32: return (long long)swc::swc_layout<float>(g).total;
    case DTYPE_F64: return (long long)swc::swc_layout<double>(g).total;
    case DTYPE_BF16:
      return (long long)swc::swc_layout<__nv_bfloat16>(g).total;
    default: return -1;
  }
}

int repro_fused_stencil_geometry_len(void) { return G_LEN; }

// The body's layout for `geom`: out[0] its code, then the fields of its
// Shape and Layout (emit.py:layout_fields names them). Returns the count
// written (at most 32), or -1. Host only: no launch.
int repro_fused_stencil_layout(const int* geom, int dtype,
                               long long* out) {
  Geometry g;
  if (!read_geometry(geom, nullptr, 0, g)) return -1;
  switch (dtype) {
    case DTYPE_F32: return layout_fields<float>(g, out);
    case DTYPE_F64: return layout_fields<double>(g, out);
    case DTYPE_BF16: return layout_fields<__nv_bfloat16>(g, out);
    default: return -1;
  }
}

}  // extern "C"
