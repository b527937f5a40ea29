// The body of the depth-1 swc kernel (fused_stencil.cu): a persistent tile
// walk with windows in flight, several outputs per thread from a tap table
// built once per block, and the MHD phi's inputs in shared memory.
//
// Design, on an H100 (132 SMs, 228 KB of shared memory each; 3.35 TB/s).
// Diffusion is bound by bytes, the MHD RHS by operations; what bound the
// one-tile-per-block kernel before it was latency (one window round trip
// per block, nothing in flight across tiles) and, for MHD, shared-memory
// loads (PERF.md section 5). The parts below cut those.
// - Persistent blocks. The grid is the kernel's resident blocks per SM
//   times the SMs; block b takes steps b, b + grid, ... of the launch:
//   member x z x y x x tiles, x fastest (B5's order), advanced in mixed
//   radix without a division (persistent.cuh). A step is one tile (x
//   extent tile x unroll), at rank 1 several consecutive ones. A unit is
//   one field of one step: its window, step + 2r, is copied into one of
//   g.n_buf ring buffers with 16-byte cp.async, issued n_buf - 1 units
//   ahead, so the next windows are in flight while this one is read; one
//   barrier per unit.
// - Congruent buffers. Padded rows have a pitch that is no multiple of 16
//   bytes (2072 B at 512^3 f32), so a buffer row cannot start on a 16-byte
//   boundary and keep its elements' alignment both. Instead the buffer's
//   row pitch and plane pitch are congruent to the global ones modulo 16
//   bytes, and the window starts at the global start's offset within its
//   16 bytes: every global 16 bytes land on 16 shared bytes (bf16 too, no
//   staging through registers), and a tap (dz, dy, dx) sits at the same
//   linear offset dz plane + dy pitch + dx from every point of the window.
//   The chunks a row's copies cover never meet the next row's (pitch >=
//   window row + V - 1), and the bytes they bring beyond the row are never
//   read.
// - The tap table. A block builds it once: each coefficient cast to T
//   (before any multiply, as the reference casts it) beside its linear
//   offset, read as one shared load.
// - Several outputs per thread. Each thread takes U points of a step, tid
//   + i nthr for i < U (consecutive threads on consecutive x), and reads
//   each tap once for U multiply-adds with U independent sums.
// - Order of arithmetic: each operator sums its taps in table order from
//   zero, one FMA per tap (bf16: bf16_mul then bf16_add, each rounded),
//   exactly as the one-tile body's apply_op did, so the outputs are that
//   body's bit for bit, and a member of a batched launch is its unbatched
//   launch bit for bit.
// - MHD. The slots phi reads on this field (mhd::fields_read: 62 of the
//   80 (slot, field) pairs for the RHS, 65 for the fused substep) are
//   evaluated one at a time and each sum goes to a shared tile of n_slots
//   x n_f values per point, so the tap loop holds U sums, not 80 x U
//   values; after the 8th field one thread per point reads its values and
//   runs phi. No field is staged twice.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "persistent.cuh"
#include "phi_mhd.cuh"
#include "stencil_common.cuh"
#include "stencil_sweep.cuh"

namespace stencil {
namespace swc {

// Most threads a block of each phi kind takes (__launch_bounds__, so at
// most 65536 / max_threads() registers a thread): 512 for select and the
// f32 MHD kinds (phi takes ~120 registers), 256 for f64 MHD (~210).
template <typename T, int KIND>
__host__ __device__ constexpr int max_threads() {
  return KIND != KIND_SELECT && sizeof(T) == 8 ? 256 : 512;
}

// Outputs a thread computes per round of a step (plan.py:SWC_OUTPUTS):
// select 4, each tap read once for four multiply-adds; the MHD kinds 1
// (two each on half the threads measured slower, PERF.md section 6).
template <int KIND>
__host__ __device__ constexpr int outputs() {
  return KIND == KIND_SELECT ? 4 : 1;
}

// Smallest n' >= n with n' = m (mod v).
__host__ __device__ inline int congruent_up(int n, int m, int v) {
  return n + ((m - n) % v + v) % v;
}

// One step of the walk and its window buffer (plan.py:swc_step mirrors
// it). Element index of window point (z, y, x) in a buffer: s0 + z plane +
// y pitch + x, s0 the global start's offset within its 16 bytes.
struct Shape {
  int tz, ty, tx;      // outputs of a step
  int wz, wy, wx;      // the window
  int pitch, plane;    // buffer elements per row and per plane
  int points;          // outputs of a step
  size_t buf;          // bytes of one ring buffer
};

template <typename T>
__host__ __device__ inline Shape swc_shape(const Geometry& g) {
  constexpr int V = 16 / sizeof(T);
  Shape s;
  s.tz = g.t[0];
  s.ty = g.t[1];
  s.tx = g.t[2] * g.unroll * g.tps;
  s.wz = s.tz + 2 * g.r[0];
  s.wy = s.ty + 2 * g.r[1];
  s.wx = s.tx + 2 * g.r[2];
  s.pitch = congruent_up(s.wx + V - 1, g.p[2] % V, V);
  s.plane = congruent_up(s.wy * s.pitch,
                         int((long long)g.p[1] * g.p[2] % V), V);
  s.points = s.tz * s.ty * s.tx;
  s.buf = size_t(cdiv(V - 1 + (s.wz - 1) * s.plane + (s.wy - 1) * s.pitch +
                          s.wx,
                      V)) *
          16;
  return s;
}

// Byte offsets of the shared memory: the ring of g.n_buf windows | the tap
// table | the operator starts | (MHD, from a 16-byte boundary) phi's
// inputs, n_slots x n_f values of T per point of a step.
// plan.py:swc_smem_bytes mirrors it.
struct Layout {
  size_t taps, starts, sums, total;
};

template <typename T>
__host__ __device__ inline Layout swc_layout(const Geometry& g) {
  const Shape s = swc_shape<T>(g);
  Layout L;
  L.taps = size_t(g.n_buf) * s.buf;
  L.starts = L.taps + size_t(g.n_taps) * sizeof(Tap<T>);
  L.total = L.starts + size_t(g.n_ops + 1) * sizeof(int);
  L.sums = L.total;
  if (g.n_slots > 1) {
    L.sums = round_up16(L.total);
    L.total = L.sums + size_t(g.n_slots) * g.n_f * s.points * sizeof(T);
  }
  return L;
}

// acc + c v as the one-tile body summed it: one FMA (f32, f64); bf16 the
// product and the sum each rounded.
__device__ __forceinline__ float mac(float c, float v, float acc) {
  return fmaf(c, v, acc);
}
__device__ __forceinline__ double mac(double c, double v, double acc) {
  return fma(c, v, acc);
}
// bf16: the native mul.rn and add.rn, each correctly rounded, which is
// what bf16_mul/bf16_add give (the operation in f32, then a rounding to
// bf16: with 24 >= 2 x 8 + 2 bits, rounding twice equals rounding once).
// (In PTX, so that no compiler contracts the pair into one fma.)
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

template <typename T, int KIND>
__device__ __forceinline__ void swc_body(
    const T* __restrict__ f, const T* __restrict__ aux, T* __restrict__ out,
    const int* __restrict__ tap_off, const double* __restrict__ tap_coef,
    const int* __restrict__ op_start, const Geometry& g,
    unsigned char* smem) {
  constexpr int V = 16 / sizeof(T), U = outputs<KIND>();
  const Shape sh = swc_shape<T>(g);
  const Layout L = swc_layout<T>(g);
  Tap<T>* taps = reinterpret_cast<Tap<T>*>(smem + L.taps);
  int* start = reinterpret_cast<int*>(smem + L.starts);
  T* sums = reinterpret_cast<T*>(smem + L.sums);
  const int tid = threadIdx.x, nthr = blockDim.x;

  // The tap table, once per block: coefficient in T, linear offset.
  for (int i = tid; i < g.n_taps; i += nthr) {
    taps[i].coef = cast_coef<T>(tap_coef[i]);  // cast before the multiply
    taps[i].offset = tap_off[3 * i] * sh.plane +
                     tap_off[3 * i + 1] * sh.pitch + tap_off[3 * i + 2];
  }
  for (int i = tid; i <= g.n_ops; i += nthr) start[i] = op_start[i];

  const long long psy = g.p[2], psz = psy * g.p[1], pfield = psz * g.p[0];
  const long long osy = g.n[2], osz = osy * g.n[1], ofield = osz * g.n[0];
  const unsigned usz = unsigned(psz), usy = unsigned(psy);
  Walker wk;
  wk.nx = g.n[2] / sh.tx;
  wk.ny = g.n[1] / sh.ty;
  wk.nz = g.n[0] / sh.tz;
  wk.nf = g.n_f;
  {
    const Walk s = wk.at(gridDim.x);
    wk.sx = s.ix;
    wk.sy = s.iy;
    wk.sz = s.iz;
    wk.sm = s.m;
  }
  const long long items = (long long)wk.nx * wk.ny * wk.nz * g.n_b;
  const long long mine =
      items > blockIdx.x ? (items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int nf = g.n_f, NS = g.n_buf;
  const int units = int(mine) * nf;

  auto buffer = [&](int slot) {
    return reinterpret_cast<T*>(smem + size_t(slot) * sh.buf);
  };
  // Field k's window of a step in f, and its element address's offset
  // within 16 bytes.
  auto window = [&](const Walk& w) {
    return f + ((long long)w.m * nf + w.k) * pfield +
           (long long)w.iz * sh.tz * psz + (long long)w.iy * sh.ty * psy +
           (long long)w.ix * sh.tx;
  };
  auto offset16 = [&](const T* src) {
    return int(unsigned(reinterpret_cast<uintptr_t>(src) / sizeof(T)) &
               (V - 1));
  };

  // Staging: window row (z, y) starts a elements into its first 16 bytes
  // and at element b = s0 + z plane + y pitch of the buffer (b = a mod V);
  // its chunk q is the 16 bytes at q V - a of the row, copied to b - a +
  // q V. The threads take the (row, chunk) pairs in turn, neighbouring
  // threads on neighbouring chunks.
  const int cq = cdiv(sh.wx + V - 1, V);  // most chunks a row covers
  const int jobs = sh.wz * sh.wy * cq;
  const FastDiv by_cq(cq), by_wy(sh.wy);
  auto stage = [&](const Walk& wu, int slot) {
    const T* src = window(wu);
    const unsigned sb = unsigned(reinterpret_cast<uintptr_t>(src) /
                                 sizeof(T));
    const int s0 = int(sb & (V - 1));
    T* dst = buffer(slot);
    for (int j = tid; j < jobs; j += nthr) {
      const int row = by_cq(j), q = j - row * cq;
      const int z = by_wy(row), y = row - z * sh.wy;
      const int a = int((sb + unsigned(z) * usz + unsigned(y) * usy) &
                        (V - 1));
      if (q * V >= a + sh.wx) continue;  // past the row's last chunk
      const int b = s0 + z * sh.plane + y * sh.pitch;
      cp_async16(dst + b - a + q * V, src + z * psz + y * psy - a + q * V,
                 16);
    }
  };

  // The points of a round: thread tid takes tid + i nthr, i < U.
  const FastDiv by_tx(sh.tx), by_ty(sh.ty);
  const int per_round = nthr * U;

  Walk ahead = wk.at(blockIdx.x), cur = ahead;
  int ahead_slot = 0, cur_slot = 0;
  for (int s = 0; s < NS - 1; ++s) {
    if (s < units) {
      stage(ahead, ahead_slot);
      wk.next(ahead);
      ahead_slot = ahead_slot + 1 == NS ? 0 : ahead_slot + 1;
    }
    cp_async_commit();
  }
  for (int u = 0; u < units; ++u) {
    if (NS == 3) {  // unit u has landed, u + 1 may be in flight
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // unit u has landed; every thread is done with u - 1
    if (u + NS - 1 < units) {
      stage(ahead, ahead_slot);
      wk.next(ahead);
      ahead_slot = ahead_slot + 1 == NS ? 0 : ahead_slot + 1;
    }
    cp_async_commit();

    const int k = cur.k;
    const T* __restrict__ w = buffer(cur_slot);
    const int s0 = offset16(window(cur));
    // The step's first output in each output row of this member.
    const long long o0 = (long long)cur.iz * sh.tz * osz +
                         (long long)cur.iy * sh.ty * osy +
                         (long long)cur.ix * sh.tx;
    for (int p0 = 0; p0 < sh.points; p0 += per_round) {
      // Output i of this thread: its window centre, and where it goes (the
      // point's offset in the output field for select, its column of the
      // shared tile for MHD); a point past the step repeats the last one
      // and is not stored.
      int cen[U], at[U];
      bool live[U];
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int p = p0 + tid + i * nthr;
        live[i] = p < sh.points;
        at[i] = live[i] ? p : sh.points - 1;
        const int t = by_tx(at[i]), x = at[i] - t * sh.tx;
        const int z = by_ty(t), y = t - z * sh.ty;
        cen[i] = s0 + (z + g.r[0]) * sh.plane + (y + g.r[1]) * sh.pitch + x +
                 g.r[2];
        at[i] = KIND == KIND_SELECT ? int(z * osz + y * osy + x) : at[i];
      }
      // Operator op's taps, in table order, into U sums.
      auto sum_taps = [&](int op, T(&acc)[U]) {
#pragma unroll
        for (int i = 0; i < U; ++i) acc[i] = T(0);
        const int e = start[op + 1];
#pragma unroll 4
        for (int t = start[op]; t < e; ++t) {
          const Tap<T> tap = taps[t];
#pragma unroll
          for (int i = 0; i < U; ++i)
            acc[i] = mac(tap.coef, w[cen[i] + tap.offset], acc[i]);
        }
      };
      T acc[U];
      if constexpr (KIND == KIND_SELECT) {
        // out[k] = op_slot0(f[k]), stored from the registers.
        sum_taps(g.slot[0], acc);
        T* o = out + ((long long)cur.m * g.n_out + k) * ofield + o0;
#pragma unroll
        for (int i = 0; i < U; ++i)
          if (live[i]) o[at[i]] = acc[i];
      } else {
        // Each slot phi reads on field k, one at a time, into the shared
        // tile.
        for (int sl = 0; sl < mhd::N_SLOTS; ++sl) {
          if (!((mhd::fields_read(sl, KIND == KIND_MHD_SUBSTEP) >> k) & 1u))
            continue;
          sum_taps(g.slot[sl], acc);
          T* to = sums + (size_t(sl) * nf + k) * sh.points;
#pragma unroll
          for (int i = 0; i < U; ++i)
            if (live[i]) to[at[i]] = acc[i];
        }
      }
    }

    if constexpr (KIND != KIND_SELECT) {
      if (k == nf - 1) {
        __syncthreads();  // every field's sums are in
        const SweepPhi<T> ph(prm_row(g, 0));
        const long long obase = (long long)cur.m * g.n_out * ofield + o0;
        const long long abase = (long long)cur.m * g.n_aux * ofield + o0;
        for (int p = tid; p < sh.points; p += nthr) {
          const int t = by_tx(p), x = p - t * sh.tx;
          const int z = by_ty(t), y = t - z * sh.ty;
          const long long at = z * osz + y * osy + x;
          // (The loads of the pairs phi does not read are never made.)
          T d[mhd::N_SLOTS][mhd::N_FIELDS];
#pragma unroll
          for (int s = 0; s < mhd::N_SLOTS; ++s)
#pragma unroll
            for (int kk = 0; kk < mhd::N_FIELDS; ++kk)
              d[s][kk] = sums[(size_t(s) * mhd::N_FIELDS + kk) * sh.points + p];
          const T* a = KIND == KIND_MHD_SUBSTEP ? aux + abase + at : nullptr;
          mhd_phi<T, KIND>(d, ph, a, ofield, [&](int j, T v) {
            out[obase + j * ofield + at] = v;
          });
        }
      }
    }
    wk.next(cur);
    cur_slot = cur_slot + 1 == NS ? 0 : cur_slot + 1;
  }
}

}  // namespace swc
}  // namespace stencil
