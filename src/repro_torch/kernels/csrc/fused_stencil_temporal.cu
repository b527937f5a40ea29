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
// a tile shrunk to fit shared memory keeps a full block.
// Sweep 0 stages ONE field's window (tile + 2rS) at a time in shared
// memory with cp.async, as the depth-1 kernel does, double-buffered when
// two windows fit (the planner decides, StencilPlan.stage_buffers).
// Every later sweep reads its fields from shared memory: each sweep
// writes all n_f fields of its region, in the field type (the plain
// version stores its intermediates in that type too), into one of two
// buffers used in turn, and its carry, cut by r, beside them.
// - select: each output row reads one field, so sweep 0 runs the fields
//   one after another, one window each.
// - MHD: phi reads 10 operators x 8 fields per point, kept in registers
//   as in the depth-1 kernel, so sweep 0 covers its region in batches of
//   one point per thread and stages the 8 windows again for each batch,
//   each only as deep in z as the batch's points reach.
// The tap table sits in shared memory as in the depth-1 kernel; each
// sweep rewrites the taps' offsets for the extents of the buffer it
// reads. Coefficients are cast to the field type before the multiply and
// taps are summed in table order, as the plain version does.
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

namespace {

using namespace stencil;

// Byte offsets of the shared-memory layout: n_buf staged windows |
// mid[0], mid[1] (all n_f fields of the sweeps s = 0, 2, ... and
// s = 1, 3, ... before the last; sized for s = 0 and s = 1) |
// carry[0], carry[1] (the n_aux carry rows of those sweeps, cut by r)
// | taps | op starts; every buffer padded to 16 bytes.
// repro_torch/kernels/plan.py:temporal_smem_bytes mirrors it.
struct Layout {
  size_t win, mid[2], carry[2], taps, starts, total;
};

template <typename T>
__host__ __device__ inline Layout layout(const Geometry& g) {
  Layout L;
  size_t off = 0;
  L.win = off;
  off += g.n_buf * round_up16(size_t(region(g, -1).size()) * sizeof(T));
  for (int i = 0; i < 2; ++i) {
    L.mid[i] = off;
    if (i < g.fuse_steps - 1)
      off += round_up16(size_t(g.n_f) * region(g, i).size() * sizeof(T));
  }
  for (int i = 0; i < 2; ++i) {
    L.carry[i] = off;
    if (g.n_aux && i < g.fuse_steps - 1)
      off += round_up16(size_t(g.n_aux) * region(g, i + 1).size() * sizeof(T));
  }
  L.taps = off;
  off += size_t(g.n_taps) * sizeof(Tap<T>);
  L.starts = off;
  off += size_t(g.n_ops + 1) * sizeof(int);
  L.total = off;
  return L;
}

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
  const Layout L = layout<T>(g);
  const int S = g.fuse_steps;
  const Box wbox = region(g, -1);
  const size_t wbytes = round_up16(size_t(wbox.size()) * sizeof(T));
  auto buf = [&](int k) {  // staged window of field k
    return reinterpret_cast<T*>(smem_raw + L.win + (k % g.n_buf) * wbytes);
  };
  // Buffers by parity of the sweep, chosen without indexing L at run
  // time (which would put L in local memory).
  auto mid = [&](int s) {  // fields written by sweep s
    return reinterpret_cast<T*>(smem_raw + ((s & 1) ? L.mid[1] : L.mid[0]));
  };
  auto carry = [&](int s) {  // carry written by sweep s
    return reinterpret_cast<T*>(smem_raw +
                                ((s & 1) ? L.carry[1] : L.carry[0]));
  };
  Tap<T>* taps = reinterpret_cast<Tap<T>*>(smem_raw + L.taps);
  int* start = reinterpret_cast<int*>(smem_raw + L.starts);

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  for (int i = tid; i < g.n_taps; i += nthr)
    taps[i].coef = static_cast<T>(tap_coef[i]);  // cast before the multiply
  for (int i = tid; i <= g.n_ops; i += nthr) start[i] = op_start[i];

  // Padded input, interior output and padded aux (r(S-1) per side).
  const long long psy = g.p[2];
  const long long psz = psy * g.p[1];
  const long long pfield = psz * g.p[0];
  const long long osy = g.n[2];
  const long long osz = osy * g.n[1];
  const long long ofield = osz * g.n[0];
  const long long asy = g.n[2] + 2 * g.r[2] * (S - 1);
  const long long asz = asy * (g.n[1] + 2 * g.r[1] * (S - 1));
  const long long afield = asz * (g.n[0] + 2 * g.r[0] * (S - 1));
  // The member this block serves (blockIdx.z = member x z tiles + z):
  // its field, aux and output start member x n_f, n_aux and n_out
  // fields in (the offsets join the origins, the pointers stay as
  // passed: see fused_stencil.cu).
  const MemberZ mz = member_z(g);
  const long long member = mz.member;
  const long long obase = member * g.n_out * ofield;
  const long long abase = member * g.n_aux * afield;
  // The tile's origin in the interior is the origin of its window in the
  // padded field and of its sweep-0 region in the padded aux.
  const long long z0 = (long long)mz.z * g.t[0];
  const long long y0 = (long long)blockIdx.y * g.t[1];
  const long long x0 = (long long)blockIdx.x * g.t[2];
  const long long porigin =
      member * g.n_f * pfield + z0 * psz + y0 * psy + x0;

  // Row j of sweep s's phi at point q (index p of region s): the output
  // after the last sweep, else the next sweep's fields or, cut by r,
  // its carry.
  auto store = [&](int s, int j, const Point& q, int p, T v) {
    if (s == S - 1) {
      out[obase + j * ofield + (z0 + q.z) * osz + (y0 + q.y) * osy + x0 +
          q.x] = v;
    } else if (j < g.n_f) {
      mid(s)[j * region(g, s).size() + p] = v;
    } else {
      const Box nb = region(g, s + 1);
      const Point c = {q.z - g.r[0], q.y - g.r[1], q.x - g.r[2]};
      if (c.z >= 0 && c.z < nb.z && c.y >= 0 && c.y < nb.y && c.x >= 0 &&
          c.x < nb.x)
        carry(s)[(j - g.n_f) * nb.size() + index_in(c, 0, 0, 0, nb)] = v;
    }
  };

  // Sweep 0 reads the staged windows, field by field.
  set_tap_offsets(taps, tap_off, g.n_taps, wbox, tid, nthr);
  const Box r0 = region(g, 0);
  if constexpr (KIND == KIND_SELECT) {
    const int b = start[g.slot[0]], e = start[g.slot[0] + 1];
    auto stage = [&](int k) {
      stage_window(f + k * pfield + porigin, buf(k), wbox, psz, psy, tid,
                   nthr);
    };
    if (g.n_buf == 2) stage(0);
    for (int k = 0; k < g.n_f; ++k) {
      const bool more = g.n_buf == 2 && k + 1 < g.n_f;
      if (g.n_buf == 1) {
        stage(k);
      } else if (more) {
        stage(k + 1);
      }
      wait_staged(more);
      for (int p = tid; p < r0.size(); p += nthr) {
        const Point q = unflatten(p, r0);
        store(0, k, q, p,
              apply_op(buf(k), taps, b, e,
                       index_in(q, g.r[0], g.r[1], g.r[2], wbox)));
      }
      __syncthreads();  // buf(k) read before another window lands there
    }
  } else {
    const SweepPhi<T> ph(g.prm[0]);
    const int plane = r0.y * r0.x;
    for (int p0 = 0; p0 < r0.size(); p0 += nthr) {
      const int p = p0 + tid;
      const bool live = p < r0.size();
      const Point q = unflatten(live ? p : p0, r0);
      // The batch's points lie in planes [zlo, zhi] of region 0 and read
      // planes [zlo, zhi + 2r] of the window: only those are staged.
      const int zlo = p0 / plane;
      const int zhi = (min(p0 + nthr, r0.size()) - 1) / plane;
      const Box sub = {zhi - zlo + 1 + 2 * g.r[0], wbox.y, wbox.x};
      auto stage_batch = [&](int k) {
        stage_window(f + k * pfield + porigin + zlo * psz, buf(k), sub, psz,
                     psy, tid, nthr);
      };
      const int center = index_in(q, g.r[0] - zlo, g.r[1], g.r[2], wbox);
      T d[mhd::N_SLOTS][mhd::N_FIELDS];
      if (g.n_buf == 2) stage_batch(0);
#pragma unroll
      for (int k = 0; k < mhd::N_FIELDS; ++k) {
        const bool more = g.n_buf == 2 && k + 1 < mhd::N_FIELDS;
        if (g.n_buf == 1) {
          stage_batch(k);
        } else if (more) {
          stage_batch(k + 1);
        }
        wait_staged(more);
#pragma unroll
        for (int sl = 0; sl < mhd::N_SLOTS; ++sl) {
          const int op = g.slot[sl];
          d[sl][k] = apply_op(buf(k), taps, start[op], start[op + 1], center);
        }
        __syncthreads();
      }
      if (live) {
        const T* a = KIND == KIND_MHD_SUBSTEP
                         ? aux + abase + (z0 + q.z) * asz + (y0 + q.y) * asy +
                               x0 + q.x
                         : nullptr;
        mhd_phi<T, KIND>(d, ph, a, afield,
                         [&](int j, T v) { store(0, j, q, p, v); });
      }
    }
  }

  // Sweeps 1 .. S-1 read the previous sweep's fields and carry from
  // shared memory.
  for (int s = 1; s < S; ++s) {
    const Box src = region(g, s - 1);
    set_tap_offsets(taps, tap_off, g.n_taps, src, tid, nthr);
    sweep<T, KIND>(
        g, mid(s - 1), src, region(g, s), taps, start, g.prm[s], carry(s - 1),
        [&](int j, const Point& q, int p, T v) { store(s, j, q, p, v); }, tid,
        nthr);
  }
}

template <typename T, int KIND>
cudaError_t launch(const void* f, const void* aux, void* out,
                   const void* tap_off, const void* tap_coef,
                   const void* op_start, Geometry g,
                   cudaStream_t stream) {
  const size_t smem = layout<T>(g).total;
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

// Launch the temporal kernel on `stream`. `geom` (G_LEN ints) and
// `params` (fuse_steps rows of n_params doubles, one per sweep) are host
// arrays; every other pointer is device memory. Returns the cudaError_t
// of the launch (0 on success).
int repro_fused_stencil_temporal(const void* f, const void* aux, void* out,
                                 const void* tap_off, const void* tap_coef,
                                 const void* op_start, const int* geom,
                                 const double* params, int n_params, int kind,
                                 int is_double, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  Geometry g;
  if (!read_geometry(geom, params, n_params, g) || g.fuse_steps < 2 ||
      g.unroll != 1 || g.n_buf < 1 || g.n_buf > 2 || g.n_thr < 1 ||
      g.n_thr > (kind == KIND_SELECT ? 1024 : 256))
    return int(cudaErrorInvalidValue);

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
                                                  int is_double) {
  Geometry g;
  if (!read_geometry(geom, nullptr, 0, g)) return -1;
  return is_double ? (long long)layout<double>(g).total
                   : (long long)layout<float>(g).total;
}

int repro_fused_stencil_temporal_geometry_len(void) { return G_LEN; }

}  // extern "C"
