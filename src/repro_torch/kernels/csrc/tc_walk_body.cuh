// The walk body of the tc kernel (fused_stencil_tc.cu at depth S > 1: the
// select kind in f32 and bf16 at ranks 2 and 3, the MHD kinds in f32 and
// bf16 at rank 3): the column walk of temporal_walk_body.cuh with the
// derivatives contracted on the tensor cores as tc_body.cuh contracts them
// at depth 1.
//
// Replaces, at depth S > 1, the TPU kernel repro/kernels/emit.py:
// _kernel_temporal (line 271) with derivs_fn=_block_derivs_tc
// (emit.py:549-554): S sweeps, each every operator of phi on the tile
// widened by r(S-1-s), the taps split by tc_axis_groups, a multi-tap group
// a banded contraction accumulated in f32 with the band in the field type,
// a lone tap (c in T) x value rounded in T, the groups summed in f32 in
// sorted (axis, rest) order and cast to T once per operator, then phi.
//
// Design, on an H100 (132 SMs, 228 KB of shared memory each; 3.35 TB/s;
// 67 TFLOP/s on the f64 MMA, 989 on bf16). What held the one-tile body
// (temporal_body.cuh with TcEval) back was one tile per block with nothing
// in flight, each sweep's z margin recomputed per tile (3.10 evaluations
// per output-step at 512^3 S=2), every operator sum round-tripped through
// a shared tile with a barrier per source, and the band built in registers
// per segment. The parts below cut those.
// - The walk, temporal_walk_body.cuh's own (walk::walk_columns; its
//   header says how and why):
//   persistent blocks over (member, segment, y, x) columns (Walker); the
//   input ring filled steps ahead by 16-byte cp.async into rows and slots
//   congruent to the padded field's modulo 16 bytes (bf16 too); a ring of
//   tau + 2rz planes per intermediate sweep, stored rounded to T; the
//   substep's w' carry ring of tau + rz slots; segments that recompute only
//   their ends. Its schedule (plan.walk_schedule) is unchanged.
// - Patches. Sweep s's planes are cut into patches of ROWS lines x 8
//   outputs (ROWS 8 on the f64 m8n8k4 that f32 fields take, 16 on bf16
//   m16n8k16): consecutive y rows of one 8-wide column strip, or, where
//   the walk has no y radius (rank 2 lifted to (Y, 1, X)), consecutive
//   8-wide segments of the plane's rows ("lines", as rank 1 at depth 1).
//   The x contraction is window . band (A the window lines, B the band),
//   the y contraction band^T . window (A the band, B the window columns):
//   both land on D[line][x] in the same lanes, so an operator's f32 sum
//   stays in registers across its groups and axes. The z arm runs as FMAs
//   on the same lanes' outputs, reading the ring slot of each plane
//   through its own plane offset ((c + dz) mod slots), f64 accumulation
//   for f32 fields as the f64 MMA, f32 for bf16. Lone taps are scalar.
// - The table. The wrapper hands over the depth-1 table (emit.tc_table,
//   at rank 2 lifted as the walk lifts it: Y's groups are z arms): group
//   rows, each y or x group's band as ready MMA fragments, a z arm's or
//   lone tap's coefficients already rounded to T. A block copies it to
//   shared memory once.
// - Ragged patches. A ring holds its region unpadded, so a load past the
//   source's rows or columns (a patch past the region, the band's k
//   padding) reads zero instead, and outputs past the region are computed
//   and not stored: a band zero never meets a stale value.
// - select: warp w takes (plane, field, batch of PB patches) units w, w +
//   warps, ...; the PB patches share each group's row and fragments and
//   give the warp PB independent MMA chains; sums go from registers to the
//   next ring (rounded to T) or, in the last sweep, to device memory.
// - MHD: batches of MHD_PATCHES patches (ROWS x 8 points each: 64 in f32,
//   128 in bf16) of the step's planes; the warps take the (slot, field)
//   pairs phi reads (mhd::fields_read) in turn, each contracting the
//   pair's operator on the batch's patches into a shared tile of f32
//   sums, n_slots x n_f per point; then one thread a point casts its sums
//   to T once and runs phi, as tc_body.cuh does (bf16: each operation of
//   phi rounded once, phi_mhd.cuh's Bf16). Eight fields' rings, the table
//   and phi's inputs fill the block, so the input ring holds one step
//   (g.n_buf = 1), the next fetched once sweep 0 has read it.
// plan.py mirrors the layout (tc_walk_smem_bytes), the patches
// (tc_walk_patches) and the multiply-adds issued (tc_issued_macs).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "persistent.cuh"
#include "phi_mhd.cuh"
#include "stencil_common.cuh"
#include "stencil_sweep.cuh"
#include "tc_body.cuh"
#include "temporal_walk_body.cuh"

namespace stencil {
namespace tcwalk {

// Threads a block takes (plan.py:TC_WALK_THREADS): 16 warps, at most 128
// registers a thread, one block an SM.
constexpr int THREADS = 512;
// MHD: patches of ROWS x 8 points whose phi inputs share memory at once
// (plan.py:TC_WALK_MHD_PATCHES).
constexpr int MHD_PATCHES = 2;

// Points of one patch: ROWS lines x 8 outputs.
template <typename T>
__host__ __device__ constexpr int patch_points() {
  return tc::Mma<T>::ROWS * tc::SEG;
}

// Patches a warp takes at once: 4 for f32 select, 2 where more outputs per
// lane (bf16) or phi (MHD) hold registers (plan.py:TC_PATCH_BATCH).
template <typename T, int KIND>
__host__ __device__ constexpr int patch_batch() {
  return KIND == KIND_SELECT && sizeof(T) == 4 ? 4 : 2;
}

// Sweep s's region and its patches (plan.py:tc_walk_patches).
struct Sweep {
  int wy, wx;   // the region across the walk
  int segx;     // 8-wide strips of a row
  int ppp;      // patches per plane
  bool lines;   // lines are row segments (no y radius), else y rows
};

template <typename T>
__host__ __device__ inline Sweep tc_sweep(const Geometry& g, int s) {
  constexpr int ROWS = tc::Mma<T>::ROWS;
  Sweep w;
  w.wy = walk::region_y(g, s);
  w.wx = walk::region_x(g, s);
  w.segx = cdiv(w.wx, tc::SEG);
  w.lines = g.r[1] == 0;
  w.ppp = w.lines ? cdiv(w.wy * w.segx, ROWS) : cdiv(w.wy, ROWS) * w.segx;
  return w;
}

// Byte offsets of the shared memory: the input ring (all fields) | the
// intermediate rings of sweeps 0 .. S-2 | (substep) their carry rings |
// two FastDiv factors per sweep | the depth-1 table (padded to 16 bytes) |
// (MHD) phi's f32 inputs, n_slots x n_f values for MHD_PATCHES patches'
// points. The rings are temporal_walk_body.cuh's. plan.py:
// tc_walk_smem_bytes mirrors it.
struct Layout {
  size_t mid, carry, div, table, sums, total;
};

template <typename T>
__host__ __device__ inline Layout tc_walk_layout(const Geometry& g) {
  const walk::Shape s = walk::walk_shape<T>(g);
  const int S = g.fuse_steps;
  Layout L;
  L.mid = round_up16(size_t(g.n_f) * s.fstride * sizeof(T));
  size_t off = L.mid;
  for (int i = 0; i < S - 1; ++i) off += walk::mid_bytes<T>(g, i);
  L.carry = off;
  for (int i = 0; i < S - 1; ++i) off += walk::carry_bytes<T>(g, i);
  L.div = off;
  L.table = L.div + size_t(S) * 2 * sizeof(unsigned long long);
  L.sums = L.table + round_up16(size_t(g.table_words) * 4);
  L.total = L.sums;
  if (g.n_slots > 1)
    L.total += sizeof(float) * g.n_slots * g.n_f * MHD_PATCHES *
               patch_points<T>();
  return L;
}

// PB patches of one plane each (their centre slots c), this lane's lines
// of each: rows gid (and gid + 8 in bf16) at row y, first column x; a
// patch's first row y0 and column x0 (the y contraction's).
template <typename T, int PB>
struct Patches {
  static constexpr int NR = tc::Mma<T>::ROWS / 8;
  int c[PB];
  int y[PB][NR], x[PB][NR];
  int y0[PB], x0[PB];
};

template <typename T>
__device__ __forceinline__ T zero() {
  return tc::from_float<T>(0.0f);
}

// sum[b][*] += operator `op` of the field at fk (in sweep a's source
// ring) on this lane's outputs of patch b: its groups in table order
// (sorted (axis, rest)), each added to the f32 sum once.
template <typename T, int PB>
__device__ __forceinline__ void contract(
    const int* __restrict__ tab, const int4* __restrict__ recs, int op,
    const T* __restrict__ fk, const walk::SweepAt<T>& sr,
    const Patches<T, PB>& pt, const Geometry& g, int lane,
    float (&sum)[PB][tc::Mma<T>::ROWS / 4]) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int NR = tc::Mma<T>::ROWS / 8;
  const int gid = lane >> 2, tig = lane & 3;
  const int rz = g.r[0], ry = g.r[1], rx = g.r[2];
  const int swy = sr.wy + 2 * ry, swx = sr.wx + 2 * rx;  // source extents
  auto slot = [&](int c) {  // plane slot c wrapped into the ring
    c += c < 0 ? sr.per : 0;
    return c - (c >= sr.per ? sr.per : 0);
  };
  auto ld = [&](const T* p, int at, bool ok) { return ok ? p[at] : zero<T>(); };
  const int ee = tab[op + 1];
  for (int e = tab[op]; e < ee; ++e) {
    const int4 ra = recs[2 * e], rb = recs[2 * e + 1];
    const int axis = ra.x;
    const int* data = tab + rb.z;
    if (rb.x) {
      // A lone tap: (c in T) x value, rounded in T, widened.
      const int j = rb.y;
      const T cj = tc::from_double<T>(*reinterpret_cast<const double*>(data));
      const int dz = axis == 0 ? j : ra.y, dy = axis == 1 ? j : ra.z,
                dx = axis == 2 ? j : ra.w;
#pragma unroll
      for (int b = 0; b < PB; ++b) {
        const T* pl = fk + slot(pt.c[b] + dz) * sr.ss;
#pragma unroll
        for (int h = 0; h < NR; ++h) {
          const int y = pt.y[b][h], x = pt.x[b][h] + 2 * tig;
          const int at = (y + ry + dy) * sr.sp + x + rx + dx;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const T v = ld(pl, at + i, y < sr.wy && x + i < sr.wx);
            if constexpr (BF) {
              sum[b][2 * h + i] += __bfloat162float(bf16_mul(cj, v));
            } else {
              sum[b][2 * h + i] += __fmul_rn(cj, v);  // rounded, added
            }
          }
        }
      }
    } else if (axis == 0) {
      // The z arm: FMAs on this lane's outputs over the ring slots of the
      // planes c - rz .. c + rz, the band in T; f64 sums for f32 fields,
      // f32 for bf16.
      const double* cz = reinterpret_cast<const double*>(data);
      float accf[PB][2 * NR];
      double accd[PB][2 * NR];
#pragma unroll
      for (int b = 0; b < PB; ++b)
#pragma unroll
        for (int i = 0; i < 2 * NR; ++i) {
          accf[b][i] = 0.0f;
          accd[b][i] = 0.0;
        }
      for (int jj = 0; jj <= 2 * rz; ++jj) {
        const double c = cz[jj];
        if (c == 0.0) continue;  // no tap at this offset
#pragma unroll
        for (int b = 0; b < PB; ++b) {
          const T* pl = fk + slot(pt.c[b] - rz + jj) * sr.ss;
#pragma unroll
          for (int h = 0; h < NR; ++h) {
            const int y = pt.y[b][h], x = pt.x[b][h] + 2 * tig;
            const int at = (y + ry) * sr.sp + x + rx;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const T v = ld(pl, at + i, y < sr.wy && x + i < sr.wx);
              if constexpr (BF) {
                accf[b][2 * h + i] =
                    fmaf(float(c), __bfloat162float(v), accf[b][2 * h + i]);
              } else {
                accd[b][2 * h + i] = fma(c, double(v), accd[b][2 * h + i]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int b = 0; b < PB; ++b)
#pragma unroll
        for (int i = 0; i < 2 * NR; ++i)
          sum[b][i] += BF ? accf[b][i] : float(accd[b][i]);
    } else if (axis == 1) {
      // y: D = band^T (A, fragments) . window columns (B), rows y0 + k of
      // the column x0 + n + rx, in the plane of the group's rest z.
      const int nk = tc::ksteps(ry, BF, true);
      const T* pl[PB];
      int col[PB];
#pragma unroll
      for (int b = 0; b < PB; ++b) {
        pl[b] = fk + slot(pt.c[b] + ra.y) * sr.ss;
        col[b] = pt.x0[b] + gid + rx;
      }
      if constexpr (BF) {
        float d[PB][4];
#pragma unroll
        for (int b = 0; b < PB; ++b) d[b][0] = d[b][1] = d[b][2] = d[b][3] = 0.f;
        for (int ks = 0; ks < nk; ++ks) {
          const uint4 a = reinterpret_cast<const uint4*>(data)[ks * 32 + lane];
#pragma unroll
          for (int b = 0; b < PB; ++b) {
            const int r0 = pt.y0[b] + 16 * ks + 2 * tig;
            const bool cok = col[b] < swx;
            T v[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int r = r0 + (q & 1) + 8 * (q >> 1);
              v[q] = ld(pl[b], r * sr.sp + col[b], cok && r < swy);
            }
            tc::mma_bf16(d[b], a.x, a.y, a.z, a.w, tc::pack_bf16(v[0], v[1]),
                         tc::pack_bf16(v[2], v[3]));
          }
        }
#pragma unroll
        for (int b = 0; b < PB; ++b)
#pragma unroll
          for (int i = 0; i < 4; ++i) sum[b][i] += d[b][i];
      } else {
        double d0[PB], d1[PB];
#pragma unroll
        for (int b = 0; b < PB; ++b) d0[b] = d1[b] = 0.0;
        const double* fd = reinterpret_cast<const double*>(data) + lane;
        for (int ks = 0; ks < nk; ++ks) {
          const double a = fd[ks * 32];
#pragma unroll
          for (int b = 0; b < PB; ++b) {
            const int r = pt.y0[b] + 4 * ks + tig;
            const T v = ld(pl[b], r * sr.sp + col[b],
                           col[b] < swx && r < swy);
            tc::mma_f64(d0[b], d1[b], a, double(v));
          }
        }
#pragma unroll
        for (int b = 0; b < PB; ++b) {
          sum[b][0] += float(d0[b]);
          sum[b][1] += float(d1[b]);
        }
      }
    } else {
      // x: D = window lines (A) . band (B, fragments): line m's row in the
      // plane of the group's rest z, columns x + k.
      const int nk = tc::ksteps(rx, BF, false);
      const T* pl[PB];
      int row[PB][NR];
      bool rok[PB][NR];
#pragma unroll
      for (int b = 0; b < PB; ++b) {
        pl[b] = fk + slot(pt.c[b] + ra.y) * sr.ss;
#pragma unroll
        for (int h = 0; h < NR; ++h) {
          rok[b][h] = pt.y[b][h] < sr.wy;
          row[b][h] = (pt.y[b][h] + ry + ra.z) * sr.sp;
        }
      }
      if constexpr (BF) {
        float d[PB][4];
#pragma unroll
        for (int b = 0; b < PB; ++b) d[b][0] = d[b][1] = d[b][2] = d[b][3] = 0.f;
        for (int ks = 0; ks < nk; ++ks) {
          const uint2 f2 = reinterpret_cast<const uint2*>(data)[ks * 32 + lane];
#pragma unroll
          for (int b = 0; b < PB; ++b) {
            T v[8];  // A[gid][k..k+1], A[gid+8][..], A[gid][k+8..], A[gid+8][k+8..]
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              const int h = (q >> 1) & 1;
              const int k = 16 * ks + 2 * tig + (q & 1) + 8 * (q >> 2);
              const int x = pt.x[b][h] + k;
              v[q] = ld(pl[b], row[b][h] + x, rok[b][h] && x < swx);
            }
            tc::mma_bf16(d[b], tc::pack_bf16(v[0], v[1]),
                         tc::pack_bf16(v[2], v[3]), tc::pack_bf16(v[4], v[5]),
                         tc::pack_bf16(v[6], v[7]), f2.x, f2.y);
          }
        }
#pragma unroll
        for (int b = 0; b < PB; ++b)
#pragma unroll
          for (int i = 0; i < 4; ++i) sum[b][i] += d[b][i];
      } else {
        double d0[PB], d1[PB];
#pragma unroll
        for (int b = 0; b < PB; ++b) d0[b] = d1[b] = 0.0;
        const double* fd = reinterpret_cast<const double*>(data) + lane;
        for (int ks = 0; ks < nk; ++ks) {
          const double fb = fd[ks * 32];
#pragma unroll
          for (int b = 0; b < PB; ++b) {
            const int x = pt.x[b][0] + 4 * ks + tig;
            const T v = ld(pl[b], row[b][0] + x, rok[b][0] && x < swx);
            tc::mma_f64(d0[b], d1[b], double(v), fb);
          }
        }
#pragma unroll
        for (int b = 0; b < PB; ++b) {
          sum[b][0] += float(d0[b]);
          sum[b][1] += float(d1[b]);
        }
      }
    }
  }
}

// The MHD phi at point (z, y, x) of sweep a.s from its inputs d, and its
// stores: the last sweep to the column's outputs; an intermediate one its
// fields to ring s and the substep's w' to carry ring s, cut to sweep s +
// 1's region. The substep's w is the aux (padded by r (S - 1), no batch:
// the planner refuses a batched aux at depth > 1) in sweep 0, else the
// carry sweep s - 1 wrote at its plane z + rz. (Divisors by the ring's
// and the carry ring's slots, kept live across the loop, spill more here:
// the pair at 256^3 took 127.3 ms with them against 118.9, PERF.md.)
template <typename T, int KIND>
__device__ __forceinline__ void walk_phi(const Geometry& g,
                                         const walk::SweepAt<T>& a,
                                         const SweepPhi<T>& ph,
                                         const T (&d)[mhd::N_SLOTS]
                                                     [mhd::N_FIELDS],
                                         const T* __restrict__ aux, int z,
                                         int y, int x) {
  const int S = g.fuse_steps, nf = g.n_f;
  const int rz = g.r[0], ry = g.r[1], rx = g.r[2];
  const int wy = a.wy, wx = a.wx, pts = wy * wx;
  const int wy1 = wy - 2 * ry, wx1 = wx - 2 * rx;  // region s + 1
  const long long osy = g.n[2], osz = osy * g.n[1], ofield = osz * g.n[0];
  const T* w = nullptr;
  long long wstride = 0;
  const int cq = g.t[0] + rz;  // carry slots
  const int q = g.t[0] + 2 * rz;  // ring slots
  if constexpr (KIND == KIND_MHD_SUBSTEP) {
    if (a.s == 0) {
      const long long asy = g.n[2] + 2 * rx * (S - 1);
      const long long asz = asy * (g.n[1] + 2 * ry * (S - 1));
      w = aux + (a.z0 + z) * asz + (a.y0 + y) * asy + (a.x0 + x);
      wstride = asz * (g.n[0] + 2 * rz * (S - 1));
    } else {
      const int cz = (z + rz) % cq;
      w = a.cin + cz * pts + y * wx + x;
      wstride = (long long)cq * pts;
    }
  }
  const int zq = z % q, zc = z % cq;
  const int cy = y - ry, cx = x - rx;
  const bool cut = cy >= 0 && cy < wy1 && cx >= 0 && cx < wx1;
  mhd_phi<T, KIND>(d, ph, w, wstride, [&](int jr, T v) {
    if (a.last) {
      a.ocol[jr * ofield + z * osz + y * osy + x] = v;
    } else if (jr < nf) {
      a.dst[(jr * q + zq) * pts + y * wx + x] = v;
    } else if (cut) {  // w', cut to sweep s + 1's region
      a.cout[((jr - nf) * cq + zc) * wy1 * wx1 + cy * wx1 + cx] = v;
    }
  });
}

template <typename T, int KIND>
__device__ __forceinline__ void tc_walk_body(const T* __restrict__ f,
                                             const T* __restrict__ aux,
                                             T* __restrict__ out,
                                             const int* __restrict__ table,
                                             const Geometry& g,
                                             unsigned char* smem) {
  constexpr bool kSelect = KIND == KIND_SELECT;
  constexpr int ROWS = tc::Mma<T>::ROWS;
  constexpr int NO = ROWS / 4, NR = ROWS / 8;
  constexpr int PB = patch_batch<T, KIND>();
  static_assert(kSelect || PB == MHD_PATCHES,
                "MHD batches are the MHD_PATCHES patches a warp contracts");
  const walk::Shape sh = walk::walk_shape<T>(g);
  const Layout L = tc_walk_layout<T>(g);
  const int S = g.fuse_steps, nf = g.n_f, Q = sh.q, rz = g.r[0];
  FastDiv* div = reinterpret_cast<FastDiv*>(smem + L.div);
  int* tab = reinterpret_cast<int*>(smem + L.table);
  float* sums = reinterpret_cast<float*>(smem + L.sums);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = nthr >> 5;
  const int gid = lane >> 2, tig = lane & 3;

  // Once per block: the table, and each sweep's divisors (its 8-wide
  // strips; its batches of PB patches per plane for select, its patches
  // per plane for MHD).
  for (int i = tid; i < g.table_words; i += nthr) tab[i] = __ldg(table + i);
  for (int s = tid; s < S; s += nthr) {
    const Sweep w = tc_sweep<T>(g, s);
    div[2 * s] = FastDiv(w.segx);
    div[2 * s + 1] = FastDiv(kSelect ? cdiv(w.ppp, PB) : w.ppp);
  }
  // Group e's row: recs[2 e] = (axis, rest z, y, x), recs[2 e + 1] =
  // (lone tap, its offset, its data's word offset, 0).
  const int4* recs =
      reinterpret_cast<const int4*>(tab + ((g.n_ops + 4) & ~3));

  const long long osy = g.n[2], osz = osy * g.n[1], ofield = osz * g.n[0];
  const FastDiv by_nf(nf), by_Q(Q);

  walk::walk_columns<T>(f, out, g, sh, L.mid, L.carry, smem,
                        [&](const walk::SweepAt<T>& a) {
    const int s = a.s, wy = a.wy, wx = a.wx, pts = wy * wx;
    const Sweep sw = tc_sweep<T>(g, s);
    const FastDiv by_segx = div[2 * s], by_2 = div[2 * s + 1];
    // Line mm of patch p: its row and first column.
    auto line = [&](int p, int mm, int& y, int& x) {
      if (sw.lines) {
        const int l = p * ROWS + mm;
        y = by_segx(l);
        x = (l - y * sw.segx) * tc::SEG;
      } else {
        const int py = by_segx(p);
        y = py * ROWS + mm;
        x = (p - py * sw.segx) * tc::SEG;
      }
    };
    // This lane's lines of patch p (plane slot c) as patch b.
    auto place = [&](Patches<T, PB>& pt, int b, int p, int c) {
      pt.c[b] = c;
      const int py = by_segx(p);
      pt.y0[b] = py * ROWS;
      pt.x0[b] = (p - py * sw.segx) * tc::SEG;
#pragma unroll
      for (int h = 0; h < NR; ++h) line(p, gid + 8 * h, pt.y[b][h],
                                        pt.x[b][h]);
    };
    if constexpr (kSelect) {
      const int nb = cdiv(sw.ppp, PB);
      const int units = (a.hi - a.lo) * nf * nb;
      const int op = g.slot[0];
      for (int j = warp; j < units; j += warps) {
        const int pf = by_2(j), bt = j - pf * nb;
        const int pl = by_nf(pf), k = pf - pl * nf;
        const int z = a.lo + pl;
        const int c = a.centre(z, rz);
        Patches<T, PB> pt;
        bool live[PB];
#pragma unroll
        for (int b = 0; b < PB; ++b) {
          const int p = bt * PB + b;
          live[b] = p < sw.ppp;
          place(pt, b, live[b] ? p : sw.ppp - 1, c);
        }
        float sum[PB][NO];
#pragma unroll
        for (int b = 0; b < PB; ++b)
#pragma unroll
          for (int q = 0; q < NO; ++q) sum[b][q] = 0.0f;
        contract<T, PB>(tab, recs, op, a.src + k * a.sf, a, pt, g, lane,
                        sum);
        T* o = a.last ? a.ocol + k * ofield + z * osz
                      : a.dst + (k * Q + z - by_Q(z) * Q) * pts;
        const long long oy = a.last ? osy : wx;
#pragma unroll
        for (int b = 0; b < PB; ++b) {
          if (!live[b]) continue;
#pragma unroll
          for (int h = 0; h < NR; ++h) {
            const int y = pt.y[b][h], x = pt.x[b][h] + 2 * tig;
            if (y >= wy) continue;
#pragma unroll
            for (int q = 0; q < 2; ++q)
              if (x + q < wx)
                o[y * oy + x + q] = tc::from_float<T>(sum[b][2 * h + q]);
          }
        }
      }
    } else {
      // MHD: batches of MHD_PATCHES patches of ROWS x 8 points of the
      // step's planes; the warps take the (slot, field) pairs phi reads in
      // turn into the shared tile, then one thread a point runs phi.
      constexpr bool kSub = KIND == KIND_MHD_SUBSTEP;
      constexpr int PP = patch_points<T>(), NPT = MHD_PATCHES * PP;
      const SweepPhi<T> ph(prm_row(g, s));
      const int total = (a.hi - a.lo) * sw.ppp;
      for (int p0 = 0; p0 < total; p0 += MHD_PATCHES) {
        Patches<T, PB> pt;
#pragma unroll
        for (int b = 0; b < PB; ++b) {
          const int pp = min(p0 + b, total - 1);
          const int pl = by_2(pp);
          place(pt, b, pp - pl * sw.ppp, a.centre(a.lo + pl, rz));
        }
        // Pair r (counted in slot-major order) to warp r mod warps.
        int r = 0, mine = warp;
        for (int sl = 0; sl < mhd::N_SLOTS; ++sl) {
          const unsigned fr = mhd::fields_read(sl, kSub);
          for (int k = 0; k < mhd::N_FIELDS; ++k) {
            if (!((fr >> k) & 1u) || r++ != mine) continue;
            mine += warps;
            float sum[PB][NO];
#pragma unroll
            for (int b = 0; b < PB; ++b)
#pragma unroll
              for (int q = 0; q < NO; ++q) sum[b][q] = 0.0f;
            contract<T, PB>(tab, recs, g.slot[sl], a.src + k * a.sf, a, pt,
                            g, lane, sum);
            float* to = sums + (sl * mhd::N_FIELDS + k) * NPT;
#pragma unroll
            for (int b = 0; b < PB; ++b)
#pragma unroll
              for (int h = 0; h < NR; ++h) {
                float* row = to + b * PP + (gid + 8 * h) * tc::SEG + 2 * tig;
                row[0] = sum[b][2 * h];
                row[1] = sum[b][2 * h + 1];
              }
          }
        }
        __syncthreads();  // every pair's sums are in
        for (int j = tid; j < NPT; j += nthr) {
          const int pp = p0 + j / PP;
          if (pp >= total) continue;
          const int pl = by_2(pp);
          int y, x;
          line(pp - pl * sw.ppp, (j >> 3) % ROWS, y, x);
          x += j & 7;
          if (y >= wy || x >= wx) continue;
          T d[mhd::N_SLOTS][mhd::N_FIELDS];
#pragma unroll
          for (int sl = 0; sl < mhd::N_SLOTS; ++sl)
#pragma unroll
            for (int kk = 0; kk < mhd::N_FIELDS; ++kk)
              d[sl][kk] = tc::from_float<T>(
                  sums[(sl * mhd::N_FIELDS + kk) * NPT + j]);
          walk_phi<T, KIND>(g, a, ph, d, aux, a.lo + pl, y, x);
        }
        __syncthreads();  // the tile is read before the next batch
      }
    }
  });
}

}  // namespace tcwalk
}  // namespace stencil
