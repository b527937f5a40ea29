// Fused stencil phi(A.B) streaming the slowest axis ("swc_stream", paper
// Fig. 5b), any temporal depth S, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/emit.py:_kernel_stream (line 585),
// launched by _fused_stream (line 687 -> pl.pallas_call at line 699): a
// grid step owns one cross-stream tile and walks every chunk of tau0
// planes of axis 0 (z at rank 3, y at rank 2) through on-chip memory. Its
// working set is all n_f fields of (tau0 + 2h0) planes of the cross
// window (tile + 2h, h = r * S); the leading 2h0 planes are carried from
// chunk to chunk, the next chunk's tau0 fresh planes are copied in while
// this chunk computes, and each chunk runs the S sweeps of
// _temporal_sweeps (line 242) on its working set: sweep s evaluates every
// operator over the tile widened by r * (S - 1 - s) on every axis,
// including the stream axis, and applies phi_s.
//
// Three bodies, chosen by the geometry's outputs per thread G_UOUT > 0
// and the depth. Depth 1 (select in f32, f64 and bf16, the MHD RHS in f32
// and bf16) runs
// stream_body.cuh, whose header says how and why: a ring of planes per
// field filled chunks ahead by 16-byte cp.async and read where they land,
// a tap table with one row per ring slot, several outputs per thread, and
// the MHD phi's inputs in shared memory. Depth S > 1 (select in f32, f64
// and bf16, ranks 2 and 3) runs the temporal kernel's walk body
// (temporal_walk_body.cuh) under this kernel's name: the chunk is the
// walk's step tau, the cross tile its cross tile, the segments
// (StencilPlan.segments) its column segments and the member the outermost
// index of the columns its persistent blocks walk. Each sweep keeps its
// planes in a ring of its own, so no chunk recomputes its widened z
// margin. The one launch left to stream_kernel below is the MHD RHS in f64
// at depth 1 (its eight fields' ring and phi's inputs fit no tile with a
// thread per point); the planner refuses the MHD kinds at depth S > 1,
// which fit no tile here (use swc).
//
// stream_kernel (depth 1, the f64 MHD RHS). One block per cross-stream
// tile and stream segment, a 1-D block of the phi kind's thread count (at
// most the points of one chunk, StencilPlan.threads) looping over the
// chunk's points. Shared memory holds:
//   work  n_f x (tau0 + 2r0) planes of the cross window, contiguous, so
//         the tap table's linear offsets hold as in the other kernels;
//   pf    n_f x tau0 planes, where cp.async lands the next chunk's fresh
//         planes while this chunk is computed;
//   the tap table and operator starts.
// Per chunk: wait for pf, copy it behind the carried halo in work, start
// the next chunk's copy into pf, run the sweep (it writes the chunk's
// output to device memory), then copy the last 2r0 planes of work to its
// front (tau0 planes at a time, since source and destination overlap when
// tau0 < 2r0). The reference copies the carried planes the same way
// (emit.py:680). The copies cost one shared-memory load and store per
// element and (tau0 + 2r0) / tau0 per fresh plane.
// Where the port departs from the reference's single walk: the stream
// axis may be cut into segments (blockIdx.z, StencilPlan.segments), each
// staging its own leading 2h0 planes, so that a grid of few cross tiles
// (MHD 256^3 at (8, 32), rank-2 8192^2) still has blocks for every SM.
// The function computed is the same; the planner counts the extra halo
// reads (core/trafficmodel.py).
// The shared sweep machinery (regions, staging, tap offsets, one sweep
// from shared memory, the MHD phi) is stencil_sweep.cuh, as in the
// temporal kernel. Coefficients are cast to the field type before the
// multiply and taps are summed in table order, as the plain version
// does. Rank 2 runs as rank 3 with the stream axis first and a unit y
// extent (the wrapper lifts (Y, X) to (Y, 1, X)); with y of extent 1 a
// tap's (0, dy, dx) lands on the same linear offset as (dy, 0, dx).
//
// Ensemble batch (B5: the TPU's _fused_batched, emit.py:345, with
// _member_phi, line 318). The reference flattens B members onto the
// field axis so all B x n_f fields share one staged window; here the
// member is an outer grid index instead (blockIdx.z = member x segments
// + segment), so shared memory per block stays one member's. A block
// adds member x n_f and n_out fields to its field and output offsets
// (64-bit) and runs the unbatched walk, so member m of a batched launch
// is the unbatched launch on member m, bit for bit, and B members cost
// one launch.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 / 34 TFLOP/s f64
// outside the tensor cores): diffusion is bound by bytes; streaming
// reads each plane of a column once (plus the cross-axis halo), where
// the depth-1 kernel fetches the stream-axis halo again for every tile,
// and the block overlaps the next chunks' copies with this chunk's
// arithmetic. The MHD RHS is bound by operations (2,368 stencil FLOP
// plus ~246 for phi per point); all 8 fields stay resident, so no
// window is staged twice.
//
// bf16 (B3c; B4b for the MHD RHS on the ring). The tap loop rounds every
// product and sum once to bf16 in table order (swc::mac), phi each of its
// operations (phi_mhd.cuh's Bf16), as the depth-1 swc kernel does. The
// ring and the walk stage bf16 with the same 16-byte cp.async into rows
// and plane slots congruent modulo 16 bytes (8 values), so the next
// chunks' copies stay asynchronous; only the one-buffer body (the f64
// MHD RHS) copies element by element.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "persistent.cuh"
#include "phi_mhd.cuh"
#include "stencil_common.cuh"
#include "stencil_sweep.cuh"
#include "stream_body.cuh"
#include "temporal_walk_body.cuh"

namespace {

using namespace stencil;

// The tau0 fresh planes of one chunk (the cross window, one field).
__host__ __device__ inline Box fresh_box(const Geometry& g) {
  const Box w = region(g, -1);
  return {g.t[0], w.y, w.x};
}

// Byte offsets of stream_kernel's shared-memory layout: work | pf | taps |
// op starts; every buffer but the last padded to 16 bytes.
// repro_torch/kernels/plan.py:stream_smem_bytes mirrors it.
struct Layout {
  size_t work, pf, taps, starts, total;
};

template <typename T>
__host__ __device__ inline Layout layout(const Geometry& g) {
  Layout L;
  size_t off = 0;
  L.work = off;
  off += round_up16(size_t(g.n_f) * region(g, -1).size() * sizeof(T));
  L.pf = off;
  off += round_up16(size_t(g.n_f) * fresh_box(g).size() * sizeof(T));
  L.taps = off;
  off += size_t(g.n_taps) * sizeof(Tap<T>);
  L.starts = off;
  off += size_t(g.n_ops + 1) * sizeof(int);
  L.total = off;
  return L;
}

// Depth 1, the MHD RHS (in f64: the one launch the planner gives it).
// Shared memory allows one block per SM at the planner's MHD tiles, so it
// may use up to 255 registers a thread.
template <typename T>
__global__ void __launch_bounds__(256, 1)
    stream_kernel(const T* __restrict__ f, T* __restrict__ out,
                  const int* __restrict__ tap_off,
                  const double* __restrict__ tap_coef,
                  const int* __restrict__ op_start,
                  const __grid_constant__ Geometry g) {
  constexpr int KIND = KIND_MHD_RHS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout L = layout<T>(g);
  const Box wbox = region(g, -1);
  const Box rb = region(g, 0);
  const Box fbox = fresh_box(g);
  const int plane = wbox.y * wbox.x;
  const int carried = 2 * g.r[0];  // planes carried chunk to chunk
  T* work = reinterpret_cast<T*>(smem_raw + L.work);
  T* pf = reinterpret_cast<T*>(smem_raw + L.pf);
  Tap<T>* taps = reinterpret_cast<Tap<T>*>(smem_raw + L.taps);
  int* start = reinterpret_cast<int*>(smem_raw + L.starts);

  using Eval = ScalarEval<T, false>;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  for (int i = tid; i < g.n_taps; i += nthr)
    taps[i].coef = static_cast<T>(tap_coef[i]);  // cast before the multiply
  for (int i = tid; i <= g.n_ops; i += nthr) start[i] = op_start[i];

  // Padded input and interior output strides.
  const long long psy = g.p[2];
  const long long psz = psy * g.p[1];
  const long long pfield = psz * g.p[0];
  const long long osy = g.n[2];
  const long long osz = osy * g.n[1];
  const long long ofield = osz * g.n[0];
  // The member this block serves (blockIdx.z = member x segments +
  // segment): its field and output start member x n_f and n_out fields
  // in (the offsets join the origins, the pointers stay as passed: see
  // fused_stencil.cu).
  const MemberZ mz = member_z(g);
  const long long member = mz.member;
  const long long obase = member * g.n_out * ofield;
  // The tile's cross origin in the interior is its window's origin in the
  // padded field; chunk c's window starts at padded plane c * tau0.
  const long long y0 = (long long)blockIdx.y * g.t[1];
  const long long x0 = (long long)blockIdx.x * g.t[2];
  const T* column = f + member * g.n_f * pfield + y0 * psy + x0;
  const int chunks = g.n[0] / (g.t[0] * g.n_seg);
  const int first = mz.z * chunks;
  const int last = first + chunks;

  // Copy planes [z0, z0 + b.z) of every field's column into dst.
  auto stage = [&](long long z0, T* dst, const Box& b, int dst_field) {
    for (int k = 0; k < g.n_f; ++k)
      stage_window(column + k * pfield + z0 * psz, dst + k * dst_field, b,
                   psz, psy, tid, nthr);
  };
  // Prologue: the segment's leading halo straight into work, its first
  // chunk's fresh planes into pf.
  stage((long long)first * g.t[0], work, Box{carried, wbox.y, wbox.x},
        wbox.size());
  stage((long long)first * g.t[0] + carried, pf, fbox, fbox.size());
  set_tap_offsets(taps, tap_off, g.n_taps, wbox, tid, nthr);

  for (int c = first; c < last; ++c) {
    // Land this chunk's fresh planes behind the carried halo; the
    // barrier also ends the previous chunk's carry.
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int i = tid; i < g.n_f * fbox.size(); i += nthr) {
      const int k = i / fbox.size();
      work[k * wbox.size() + carried * plane + (i - k * fbox.size())] = pf[i];
    }
    __syncthreads();
    // The next chunk's copy runs while this one is computed.
    if (c + 1 < last)
      stage((long long)(c + 1) * g.t[0] + carried, pf, fbox, fbox.size());

    const long long zc = (long long)c * g.t[0];
    sweep<T, KIND>(
        g, work, wbox, rb, Eval(g, taps, start), prm_row(g, 0), nullptr,
        [&](int j, const Point& q, int, T v) {
          out[obase + j * ofield + (zc + q.z) * osz + (y0 + q.y) * osy + x0 +
              q.x] = v;
        },
        tid, nthr);

    // Carry: the last 2r0 planes of work become the next chunk's leading
    // halo, tau0 planes at a time so no copy reads a plane already
    // overwritten (the last batch ends at the next chunk's barrier).
    __syncthreads();  // the sweep has read work
    for (int b0 = 0; b0 < carried; b0 += g.t[0]) {
      const int n = min(g.t[0], carried - b0) * plane;
      for (int i = tid; i < g.n_f * n; i += nthr) {
        const int k = i / n;
        T* w = work + k * wbox.size() + b0 * plane + (i - k * n);
        w[0] = w[g.t[0] * plane];
      }
      if (b0 + g.t[0] < carried) __syncthreads();
    }
  }
}

// The depth-1 body (stream_body.cuh), U outputs a thread: at most 128
// registers a thread (select 256 threads x 2 blocks an SM, MHD 512 x 1).
template <typename T, int KIND, int U>
__global__ void __launch_bounds__(stream::max_threads<KIND>(),
                                  stream::min_blocks<KIND>())
    stream_d1_kernel(const T* __restrict__ f, T* __restrict__ out,
                     const int* __restrict__ tap_off,
                     const double* __restrict__ tap_coef,
                     const int* __restrict__ op_start,
                     const __grid_constant__ Geometry g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  stream::stream_body<T, KIND, U>(f, out, tap_off, tap_coef, op_start, g,
                                  smem_raw);
}

// Whether a launch runs the depth-1 body: depth 1 with outputs per thread
// in the geometry (emit.geometry sets them for the kinds the body takes).
inline bool ring_body(const Geometry& g) {
  return g.fuse_steps == 1 && g.u_out > 0;
}

// Whether a launch runs the walk body: depth > 1 with outputs per thread
// in the geometry (emit.geometry sets them for the stream walk).
inline bool walk_launch(const Geometry& g) {
  return g.fuse_steps > 1 && g.u_out > 0;
}

template <typename T>
size_t smem_bytes(const Geometry& g) {
  if (walk_launch(g)) return walk::walk_layout<T>(g).total;
  return ring_body(g) ? stream::ring_layout<T>(g).total
                      : layout<T>(g).total;
}

// The walk body at depth > 1, select only: at most 128 registers a thread
// (512 threads x 1 block an SM in f32, 256 x 2 in f64).
template <typename T>
__global__ void __launch_bounds__(walk::MAX_THREADS, 1)
    stream_walk_kernel(const T* __restrict__ f, T* __restrict__ out,
                       const int* __restrict__ tap_off,
                       const double* __restrict__ tap_coef,
                       const int* __restrict__ op_start,
                       const __grid_constant__ Geometry g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  walk::walk_body<T, KIND_SELECT, walk::outputs<KIND_SELECT>()>(
      f, nullptr, out, tap_off, tap_coef, op_start, g, smem_raw);
}

// One walk launch, or (grid != nullptr) the grid a launch would take:
// persistent.cuh's persistent_grid over the launch's columns.
template <typename T>
cudaError_t walk_run(const void* f, void* out, const void* tap_off,
                     const void* tap_coef, const void* op_start,
                     const Geometry& g, int device, cudaStream_t stream,
                     long long* grid) {
  const size_t smem = walk::walk_layout<T>(g).total;
  const long long items = (long long)(g.n[2] / g.t[2]) * (g.n[1] / g.t[1]) *
                          g.n_seg * g.n_b;
  long long blocks = 0;
  const cudaError_t err = persistent_grid<stream_walk_kernel<T>>(
      g.n_thr, smem, device, items, blocks);
  if (err != cudaSuccess || grid) {
    if (grid) *grid = blocks;
    return err;
  }
  stream_walk_kernel<T><<<unsigned(blocks), g.n_thr, smem, stream>>>(
      static_cast<const T*>(f), static_cast<T*>(out),
      static_cast<const int*>(tap_off), static_cast<const double*>(tap_coef),
      static_cast<const int*>(op_start), g);
  return cudaGetLastError();
}

// The walk's launch or grid query: the select kind in f32, f64 or bf16.
cudaError_t walk_dispatch(int kind, int dtype, const void* f, void* out,
                          const void* tap_off, const void* tap_coef,
                          const void* op_start, const Geometry& g,
                          int device, cudaStream_t st, long long* grid) {
  if (kind != KIND_SELECT || !walk::valid(g, KIND_SELECT))
    return cudaErrorInvalidValue;
  switch (dtype) {
    case DTYPE_F32:
      return walk_run<float>(f, out, tap_off, tap_coef, op_start, g, device,
                             st, grid);
    case DTYPE_F64:
      return walk_run<double>(f, out, tap_off, tap_coef, op_start, g, device,
                              st, grid);
    case DTYPE_BF16:  // B3c
      return walk_run<__nv_bfloat16>(f, out, tap_off, tap_coef, op_start, g,
                                     device, st, grid);
    default:
      return cudaErrorInvalidValue;
  }
}

// One launch of `kernel` on a grid of (x tiles, y tiles, members x
// segments) blocks of g.n_thr threads and `smem` bytes of shared memory.
template <typename T, typename Kernel>
cudaError_t grid_launch(Kernel kernel, const void* f, void* out,
                        const void* tap_off, const void* tap_coef,
                        const void* op_start, Geometry g, size_t smem,
                        cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  unsigned gz;
  if (!fold_members(g, g.n_seg, gz)) return cudaErrorInvalidValue;
  const dim3 block(g.n_thr);
  const dim3 grid(g.n[2] / g.t[2], g.n[1] / g.t[1], gz);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(f), static_cast<T*>(out),
      static_cast<const int*>(tap_off), static_cast<const double*>(tap_coef),
      static_cast<const int*>(op_start), g);
  return cudaGetLastError();
}

// One launch of the depth-1 ring body (select, or the MHD RHS in f32 or
// bf16).
template <typename T, int KIND>
cudaError_t ring_launch(const void* f, void* out, const void* tap_off,
                        const void* tap_coef, const void* op_start,
                        const Geometry& g, cudaStream_t stream) {
  // The body's threads, outputs per thread and ring (select reads a chunk
  // while 1-2 are in flight; MHD fetches during phi).
  const int min_buf = KIND == KIND_SELECT ? 2 : 1;
  if (!stream::built_for<KIND>(g.u_out) || g.n_thr % 32 ||
      g.n_thr > stream::max_threads<KIND>() || g.n_buf < min_buf ||
      g.n_buf > min_buf + 2 ||
      (g.u_out > 1 && g.t[1] * g.t[2] % (32 * g.u_out) != 0))
    return cudaErrorInvalidValue;
  auto kernel = stream_d1_kernel<T, KIND, 1>;
  if constexpr (KIND == KIND_SELECT)
    kernel = g.u_out == 4   ? stream_d1_kernel<T, KIND, 4>
             : g.u_out == 2 ? stream_d1_kernel<T, KIND, 2>
                            : stream_d1_kernel<T, KIND, 1>;
  return grid_launch<T>(kernel, f, out, tap_off, tap_coef, op_start, g,
                        stream::ring_layout<T>(g).total, stream);
}

// One launch of stream_kernel: depth 1, the MHD RHS in f64.
cudaError_t buffer_launch(const void* f, void* out, const void* tap_off,
                          const void* tap_coef, const void* op_start,
                          const Geometry& g, cudaStream_t stream) {
  if (g.fuse_steps != 1 || g.n_thr > 256 || g.n_f != mhd::N_FIELDS ||
      g.n_slots != mhd::N_SLOTS)
    return cudaErrorInvalidValue;
  return grid_launch<double>(stream_kernel<double>, f, out, tap_off,
                             tap_coef, op_start, g, layout<double>(g).total,
                             stream);
}

// The fields of the body a launch of `g` runs: the walk (body code 4,
// analysis/bodies.py:walk_body), the depth-1 ring (2, stream_body) or the
// one-buffer body (3, stream_buffer).
template <typename T>
int layout_fields(const Geometry& g, long long* out) {
  if (walk_launch(g)) {
    const walk::Shape s = walk::walk_shape<T>(g);
    const walk::Layout L = walk::walk_layout<T>(g);
    const long long v[] = {4, s.tau, s.ty, s.tx, s.wy, s.wx, s.lead,
                           s.pitch, s.plane, s.period, s.fstride, s.q, s.cq,
                           s.seg, (long long)L.mid, (long long)L.carry,
                           (long long)L.div, (long long)L.taps,
                           (long long)L.sums, (long long)L.total};
    return put_fields(v, out);
  }
  if (ring_body(g)) {
    const stream::Ring s = stream::ring_shape<T>(g);
    const stream::Layout L = stream::ring_layout<T>(g);
    const long long v[] = {2, s.tz, s.ty, s.tx, s.wy, s.wx, s.lead, s.pitch,
                           s.plane, s.period, s.fstride, (long long)L.taps,
                           (long long)L.starts, (long long)L.sums,
                           (long long)L.total};
    return put_fields(v, out);
  }
  const Layout L = layout<T>(g);
  const long long v[] = {3, (long long)L.work, (long long)L.pf,
                         (long long)L.taps, (long long)L.starts,
                         (long long)L.total};
  return put_fields(v, out);
}

}  // namespace

extern "C" {

// Launch the stream kernel on `stream`. `geom` (G_LEN ints) is a host
// array; every other pointer, `params` (fuse_steps rows of n_params
// doubles, one per sweep) included, is device memory (`aux` must be
// null: swc_stream takes no aux). Returns the cudaError_t of the launch
// (0 on success).
int repro_fused_stencil_stream(const void* f, const void* aux, void* out,
                               const void* tap_off, const void* tap_coef,
                               const void* op_start, const int* geom,
                               const double* params, int n_params, int kind,
                               int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  Geometry g;
  if (!read_geometry(geom, params, n_params, g) || aux != nullptr ||
      g.n_aux != 0 || g.unroll != 1 || g.n_thr < 1 || g.n_seg < 1 ||
      g.t[0] < 1 || g.n[0] % (g.t[0] * g.n_seg) != 0 ||
      g.n[1] % g.t[1] != 0 || g.n[2] % g.t[2] != 0)
    return int(cudaErrorInvalidValue);

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype < DTYPE_F32 || dtype > DTYPE_BF16)
    return int(cudaErrorInvalidValue);
  if (walk_launch(g))
    return int(walk_dispatch(kind, dtype, f, out, tap_off, tap_coef,
                             op_start, g, device, st, nullptr));
  if (!ring_body(g)) {
    if (kind != KIND_MHD_RHS || dtype != DTYPE_F64)
      return int(cudaErrorInvalidValue);
    return int(buffer_launch(f, out, tap_off, tap_coef, op_start, g, st));
  }
  using bf16 = __nv_bfloat16;
  switch (kind * 3 + dtype) {
    case KIND_SELECT * 3 + DTYPE_F32:
      return int(ring_launch<float, KIND_SELECT>(f, out, tap_off, tap_coef,
                                                 op_start, g, st));
    case KIND_SELECT * 3 + DTYPE_F64:
      return int(ring_launch<double, KIND_SELECT>(f, out, tap_off, tap_coef,
                                                  op_start, g, st));
    case KIND_SELECT * 3 + DTYPE_BF16:  // B3c
      return int(ring_launch<bf16, KIND_SELECT>(f, out, tap_off, tap_coef,
                                                op_start, g, st));
    case KIND_MHD_RHS * 3 + DTYPE_F32:
      return int(ring_launch<float, KIND_MHD_RHS>(f, out, tap_off, tap_coef,
                                                  op_start, g, st));
    case KIND_MHD_RHS * 3 + DTYPE_BF16:  // B4b
      return int(ring_launch<bf16, KIND_MHD_RHS>(f, out, tap_off, tap_coef,
                                                 op_start, g, st));
    default:  // mhd_substep needs aux, which swc_stream refuses; the f64
              // MHD RHS takes the one-buffer body
      return int(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The blocks a walk launch of `geom` takes (the persistent grid), or a
// negative cudaError_t (the other bodies have no persistent grid).
long long repro_fused_stencil_stream_grid(const int* geom, int kind,
                                          int dtype, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(long long)err;
  Geometry g;
  if (!read_geometry(geom, nullptr, 0, g) || !walk_launch(g))
    return -(long long)cudaErrorInvalidValue;
  long long grid = 0;
  err = walk_dispatch(kind, dtype, nullptr, nullptr, nullptr, nullptr,
                      nullptr, g, device, nullptr, &grid);
  return err == cudaSuccess ? grid : -(long long)err;
}

// Shared memory one block of this kernel uses for `geom` (the plan's
// StencilPlan.smem_bytes must equal it).
long long repro_fused_stencil_stream_smem_bytes(const int* geom,
                                                int dtype) {
  Geometry g;
  if (!read_geometry(geom, nullptr, 0, g)) return -1;
  switch (dtype) {
    case DTYPE_F32: return (long long)smem_bytes<float>(g);
    case DTYPE_F64: return (long long)smem_bytes<double>(g);
    case DTYPE_BF16: return (long long)smem_bytes<__nv_bfloat16>(g);
    default: return -1;
  }
}

int repro_fused_stencil_stream_geometry_len(void) { return G_LEN; }

// The body's layout for `geom`: out[0] its code, then its fields
// (emit.py:layout_fields names them). Returns the count written, or -1.
// Host only: no launch.
int repro_fused_stencil_stream_layout(const int* geom, int dtype,
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
