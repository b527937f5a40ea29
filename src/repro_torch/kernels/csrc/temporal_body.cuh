// The body of a launch of S >= 1 fused sweeps on one staged tile, shared
// by fused_stencil_temporal.cu (swc at depth > 1, the tap-table
// evaluator) and fused_stencil_tc.cu (tc at every depth, the
// tensor-core evaluator): one source of truth for the sweep arithmetic
// (the shrinking regions, the staging of sweep 0, the intermediate
// fields and the aux carry) whatever evaluates the derivatives.
//
// Sweep s evaluates every operator over the tile widened by r*(S-1-s)
// and applies phi_s. Rows [0, n_f) of an intermediate sweep are the next
// sweep's fields, rows [n_f, n_f+n_aux) its aux carry, cut by r on every
// side (repro/kernels/emit.py:297-315); only the last sweep's n_out rows
// reach device memory.
//
// One block per output tile, a 1-D block of g.n_thr threads looping over
// the points of each sweep's region. Sweep 0 stages ONE field's window
// (tile + 2rS) at a time in shared memory, double-buffered when two
// windows fit (StencilPlan.stage_buffers). Every later sweep reads its
// fields from shared memory: each sweep writes all n_f fields of its
// region, in the field type (the plain version stores its intermediates
// in that type too), into one of two buffers used in turn, and its carry,
// cut by r, beside them.
// - select: each output row reads one field, so sweep 0 runs the fields
//   one after another, one window each.
// - MHD: phi reads 10 operators x 8 fields per point, kept in registers,
//   so sweep 0 covers its region in batches of one point per thread and
//   stages the 8 windows again for each batch, each only as deep in z as
//   the batch's points reach.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "phi_mhd.cuh"
#include "stencil_common.cuh"
#include "stencil_sweep.cuh"

namespace stencil {

// Byte offsets of the shared-memory layout: n_buf staged windows |
// mid[0], mid[1] (all n_f fields of the sweeps s = 0, 2, ... and
// s = 1, 3, ... before the last; sized for s = 0 and s = 1) |
// carry[0], carry[1] (the n_aux carry rows of those sweeps, cut by r)
// | the evaluator's own (Eval::smem_bytes); every buffer but the last
// padded to 16 bytes. repro_torch/kernels/plan.py:temporal_smem_bytes
// mirrors it.
struct Layout {
  size_t win, mid[2], carry[2], eval, total;
};

template <typename T, class Eval>
__host__ __device__ inline Layout temporal_layout(const Geometry& g) {
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
  L.eval = off;
  off += Eval::smem_bytes(g);
  L.total = off;
  return L;
}

template <typename T, int KIND, class Eval>
__device__ __forceinline__ void temporal_body(
    const T* __restrict__ f, const T* __restrict__ aux, T* __restrict__ out,
    const int* __restrict__ tap_off, const double* __restrict__ tap_coef,
    const int* __restrict__ op_start, const Geometry& g,
    unsigned char* smem_raw) {
  const Layout L = temporal_layout<T, Eval>(g);
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

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const Eval ev(g, smem_raw + L.eval, tap_off, tap_coef, op_start, tid, nthr);

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
  ev.set_source(wbox, tid, nthr);
  const Box r0 = region(g, 0);
  if constexpr (KIND == KIND_SELECT) {
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
      ev.prepare(g, buf(k), wbox, r0, 0, r0.z - 1, 0, tid, nthr);
      for (int p = tid; p < r0.size(); p += nthr) {
        const Point q = unflatten(p, r0);
        store(0, k, q, p,
              ev.value(g, 0, buf(k),
                       index_in(q, g.r[0], g.r[1], g.r[2], wbox), p));
      }
      __syncthreads();  // buf(k) read before another window lands there
    }
  } else {
    const SweepPhi<T> ph(prm_row(g, 0));
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
      const int local = (live ? p : p0) - zlo * plane;
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
        ev.prepare(g, buf(k), sub, r0, zlo, zhi, zlo, tid, nthr);
#pragma unroll
        for (int sl = 0; sl < mhd::N_SLOTS; ++sl)
          d[sl][k] = ev.value(g, sl, buf(k), center, local);
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
    ev.set_source(src, tid, nthr);
    sweep<T, KIND>(
        g, mid(s - 1), src, region(g, s), ev, prm_row(g, s), carry(s - 1),
        [&](int j, const Point& q, int p, T v) { store(s, j, q, p, v); }, tid,
        nthr);
  }
}

}  // namespace stencil
