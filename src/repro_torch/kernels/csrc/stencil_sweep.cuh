// The sweep machinery the kernels with a 1-D block share:
// fused_stencil_temporal.cu (depth > 1), fused_stencil_stream.cu
// (swc_stream, any depth) and fused_stencil_tc.cu (tc, any depth). Boxes
// of points and the regions of the fused sweeps, cp.async staging of a
// box of rows, tap offsets for the buffer a sweep reads, the tap-table
// derivative evaluator, and one sweep (every operator on every field of
// a buffer in shared memory, then phi) over a region, its threads
// looping over the region's points, templated on the evaluator.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "phi_mhd.cuh"
#include "stencil_common.cuh"

namespace stencil {

// Extents (z, y, x) of a box of points.
struct Box {
  int z, y, x;
  __host__ __device__ int size() const { return z * y * x; }
};

struct Point {
  int z, y, x;
};

// Sweep s's region, tile + 2r(S-1-s); s = -1 is the staged window.
__host__ __device__ inline Box region(const Geometry& g, int s) {
  const int m = g.fuse_steps - 1 - s;
  return {g.t[0] + 2 * g.r[0] * m, g.t[1] + 2 * g.r[1] * m,
          g.t[2] + 2 * g.r[2] * m};
}

__device__ __forceinline__ Point unflatten(int p, const Box& b) {
  const int plane = b.y * b.x;
  const int z = p / plane;
  const int rest = p - z * plane;
  const int y = rest / b.x;
  return {z, y, rest - y * b.x};
}

// Index of point q shifted by (dz, dy, dx) in a buffer of extents b.
__device__ __forceinline__ int index_in(const Point& q, int dz, int dy,
                                        int dx, const Box& b) {
  return ((q.z + dz) * b.y + q.y + dy) * b.x + q.x + dx;
}

// Start copying one field's box w of rows into shared memory with
// cp.async: rows go to groups of up to 32 threads, each row's x to the
// threads of its group, so neighbouring threads read neighbouring
// addresses and no element passes through a register.
template <typename T>
__device__ __forceinline__ void stage_window(const T* __restrict__ src,
                                             T* __restrict__ win,
                                             const Box& w, long long psz,
                                             long long psy, int tid,
                                             int nthr) {
  const int lanes = nthr < 32 ? nthr : 32;
  const int groups = nthr / lanes;
  const int grp = tid / lanes;
  const int lane = tid - grp * lanes;
  if (grp < groups) {
    for (int row = grp; row < w.z * w.y; row += groups) {
      const int z = row / w.y;
      const int y = row - z * w.y;
      const T* s = src + z * psz + y * psy;
      T* d = win + row * w.x;
      for (int x = lane; x < w.x; x += lanes)
        copy_async(d + x, s + x);
    }
  }
  __pipeline_commit();
}

// Point every tap at its neighbour in a buffer of extents b.
template <typename T>
__device__ __forceinline__ void set_tap_offsets(Tap<T>* taps,
                                                const int* __restrict__ off,
                                                int n_taps, const Box& b,
                                                int tid, int nthr) {
  __syncthreads();  // no thread reads the previous offsets any more
  for (int i = tid; i < n_taps; i += nthr)
    taps[i].offset = (off[3 * i] * b.y + off[3 * i + 1]) * b.x + off[3 * i + 2];
  __syncthreads();
}

// One sweep's MHD phi constants.
template <typename T>
struct SweepPhi {
  mhd::Consts<T> c;
  T alpha, beta, dt;
  __device__ explicit SweepPhi(const double* p)
      : c(p),
        alpha(T(p[mhd::P_ALPHA])),
        beta(T(p[mhd::P_BETA])),
        dt(T(p[mhd::P_DT])) {}
};

// phi of the MHD kinds at one point, row by row into store(j, value):
// the RHS (mhd_rhs), or f' = f + beta w' and w' = alpha w + dt rhs with
// w = aux[k * aux_stride] (mhd_substep, repro/physics/mhd.py:284-290).
template <typename T, int KIND, typename Store>
__device__ __forceinline__ void mhd_phi(
    const T (&d)[mhd::N_SLOTS][mhd::N_FIELDS], const SweepPhi<T>& ph,
    const T* aux, long long aux_stride, Store store) {
  T rhs[mhd::N_FIELDS];
  mhd::rhs<T>(d, ph.c, rhs);
#pragma unroll
  for (int k = 0; k < mhd::N_FIELDS; ++k) {
    if constexpr (KIND == KIND_MHD_RHS) {
      store(k, rhs[k]);
    } else {
      const T w = ph.alpha * aux[k * aux_stride] + ph.dt * rhs[k];
      store(k, d[mhd::VAL][k] + ph.beta * w);
      store(mhd::N_FIELDS + k, w);
    }
  }
}

// A derivative evaluator: how a sweep gets the value of operator slot
// `sl` of one field at one point. Two exist: ScalarEval (below: the
// tap table, point by point, for swc) and TcEval (fused_stencil_tc.cu:
// banded contractions on the tensor cores, for tc). An evaluator with
// kCooperative set first computes a box of points with the whole block
// (prepare), then hands out values by the point's index in that box
// (value), and wants the block to have read them before the next
// prepare (done); set_source runs before a sweep that reads a buffer of
// new extents.
// kSelect (the select kind, which reads slot 0 only) holds slot 0's tap
// range in registers; the MHD kinds look each slot's range up in shared
// memory, which keeps two registers free in their register-bound loops.
template <typename T, bool kSelect>
struct ScalarEval {
  static constexpr bool kCooperative = false;
  Tap<T>* taps;
  const int* start;
  const int* tap_off;
  int n_taps;
  int b0 = 0, e0 = 0;  // slot 0's taps (kSelect)

  // Its shared memory: the tap table and the int32 operator starts.
  __host__ __device__ static size_t smem_bytes(const Geometry& g) {
    return size_t(g.n_taps) * sizeof(Tap<T>) +
           size_t(g.n_ops + 1) * sizeof(int);
  }

  // Copy the tap table (coefficients cast to T before any multiply) and
  // the operator starts into `smem`.
  __device__ ScalarEval(const Geometry& g, unsigned char* smem,
                        const int* off, const double* coef,
                        const int* op_start, int tid, int nthr)
      : taps(reinterpret_cast<Tap<T>*>(smem)),
        start(reinterpret_cast<int*>(smem +
                                     size_t(g.n_taps) * sizeof(Tap<T>))),
        tap_off(off),
        n_taps(g.n_taps) {
    if constexpr (kSelect) {
      b0 = op_start[g.slot[0]];
      e0 = op_start[g.slot[0] + 1];
    }
    for (int i = tid; i < g.n_taps; i += nthr)
      taps[i].coef = cast_coef<T>(coef[i]);  // cast before the multiply
    int* st = reinterpret_cast<int*>(smem + size_t(g.n_taps) * sizeof(Tap<T>));
    for (int i = tid; i <= g.n_ops; i += nthr) st[i] = op_start[i];
  }
  // Over a tap table and operator starts already in shared memory.
  __device__ ScalarEval(const Geometry& g, Tap<T>* t, const int* s)
      : taps(t), start(s), tap_off(nullptr), n_taps(0) {
    if constexpr (kSelect) {
      b0 = s[g.slot[0]];
      e0 = s[g.slot[0] + 1];
    }
  }

  __device__ void set_source(const Box& src, int tid, int nthr) const {
    set_tap_offsets(taps, tap_off, n_taps, src, tid, nthr);
  }
  __device__ void prepare(const Geometry&, const T*, const Box&, const Box&,
                          int, int, int, int, int) const {}
  __device__ void done() const {}
  __device__ T value(const Geometry& g, int sl, const T* fld, int center,
                     int) const {
    if constexpr (kSelect) {
      return apply_op(fld, taps, b0, e0, center);
    } else {
      const int op = g.slot[sl];
      return apply_op(fld, taps, start[op], start[op + 1], center);
    }
  }
};

// One sweep from shared memory: every operator phi reads, on each of the
// n_f fields of `fin` (field k at fin + k * src.size(), extents src, one
// radius wider than rb on every side), at every point of region rb, then
// phi with the parameter row `prm`; row j of phi at point q (index p of
// rb) goes to store(j, q, p, value). `cin` is the mhd_substep carry, one
// row of rb.size() per field. The evaluator must have been pointed at a
// buffer of extents src (set_source).
// - select: each output row reads one field, so the threads loop over
//   (field, point) pairs (a cooperative evaluator: field by field).
// - MHD: phi reads 10 operators x 8 fields per point, kept in registers;
//   the threads loop over points (a cooperative evaluator: in batches of
//   one point per thread, each batch's planes evaluated field by field).
template <typename T, int KIND, class Eval, typename Store>
__device__ __forceinline__ void sweep(const Geometry& g,
                                      const T* __restrict__ fin,
                                      const Box& src, const Box& rb,
                                      const Eval& ev, const double* prm,
                                      const T* cin, Store store, int tid,
                                      int nthr) {
  if constexpr (KIND == KIND_SELECT && !Eval::kCooperative) {
    for (int i = tid; i < g.n_f * rb.size(); i += nthr) {
      const int k = i / rb.size();
      const int p = i - k * rb.size();
      const Point q = unflatten(p, rb);
      store(k, q, p,
            ev.value(g, 0, fin + k * src.size(),
                     index_in(q, g.r[0], g.r[1], g.r[2], src), p));
    }
  } else if constexpr (KIND == KIND_SELECT) {
    for (int k = 0; k < g.n_f; ++k) {
      const T* fk = fin + k * src.size();
      ev.prepare(g, fk, src, rb, 0, rb.z - 1, 0, tid, nthr);
      for (int p = tid; p < rb.size(); p += nthr) {
        const Point q = unflatten(p, rb);
        store(k, q, p,
              ev.value(g, 0, fk, index_in(q, g.r[0], g.r[1], g.r[2], src),
                       p));
      }
      ev.done();
    }
  } else if constexpr (!Eval::kCooperative) {
    const SweepPhi<T> ph(prm);
    for (int p = tid; p < rb.size(); p += nthr) {
      const Point q = unflatten(p, rb);
      const int center = index_in(q, g.r[0], g.r[1], g.r[2], src);
      T d[mhd::N_SLOTS][mhd::N_FIELDS];
#pragma unroll
      for (int k = 0; k < mhd::N_FIELDS; ++k) {
#pragma unroll
        for (int sl = 0; sl < mhd::N_SLOTS; ++sl)
          d[sl][k] = ev.value(g, sl, fin + k * src.size(), center, p);
      }
      const T* a = KIND == KIND_MHD_SUBSTEP ? cin + p : nullptr;
      mhd_phi<T, KIND>(d, ph, a, rb.size(),
                       [&](int j, T v) { store(j, q, p, v); });
    }
  } else {
    const SweepPhi<T> ph(prm);
    const int plane = rb.y * rb.x;
    for (int p0 = 0; p0 < rb.size(); p0 += nthr) {
      const int p = p0 + tid;
      const bool live = p < rb.size();
      const Point q = unflatten(live ? p : p0, rb);
      const int zlo = p0 / plane;
      const int zhi = (min(p0 + nthr, rb.size()) - 1) / plane;
      const int center = index_in(q, g.r[0], g.r[1], g.r[2], src);
      const int local = (live ? p : p0) - zlo * plane;
      T d[mhd::N_SLOTS][mhd::N_FIELDS];
#pragma unroll
      for (int k = 0; k < mhd::N_FIELDS; ++k) {
        const T* fk = fin + k * src.size();
        ev.prepare(g, fk, src, rb, zlo, zhi, 0, tid, nthr);
#pragma unroll
        for (int sl = 0; sl < mhd::N_SLOTS; ++sl)
          d[sl][k] = ev.value(g, sl, fk, center, local);
        ev.done();
      }
      if (live) {
        const T* a = KIND == KIND_MHD_SUBSTEP ? cin + p : nullptr;
        mhd_phi<T, KIND>(d, ph, a, rb.size(),
                         [&](int j, T v) { store(j, q, p, v); });
      }
    }
  }
}

}  // namespace stencil
