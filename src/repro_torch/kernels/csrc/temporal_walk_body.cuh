// The walk body of the temporal kernel (fused_stencil_temporal.cu, swc at
// depth S > 1: the select kind at ranks 2 and 3, the MHD kinds in f32):
// persistent blocks walk tile columns along the slowest axis, each sweep
// keeping its planes in a ring of its own, so the widened z margin of every
// sweep is evaluated once per column segment instead of once per tile.
//
// The walk of the columns (walk_columns: fetches, steps, sweeps, ring
// offsets) is shared with tc_walk_body.cuh, which contracts each sweep's
// planes on the tensor cores instead. phi's stores stay each body's own:
// here the ring and carry offsets and the aux strides are set once a
// sweep or a block (a shared store function that set them per point cost
// the f32 MHD pair 2%, PERF.md).
//
// Design, on an H100 (132 SMs, 228 KB of shared memory each; 3.35 TB/s).
// Diffusion is bound by bytes. What held the one-tile body
// (temporal_body.cuh) back was the redundant work of its 3-D tiles (sweep
// s covers the tile widened by r(S-1-s) on every axis, z included: 3.10
// evaluations per output-step at 512^3 S=2 on (4, 8, 32)), one tile per
// block with nothing in flight, 4-byte staging, and one output per visit
// with two divisions and two shared loads per tap. The parts below cut
// those.
// - Persistent blocks walk columns. The grid is the kernel's resident
//   blocks per SM times the SMs; block b takes columns b, b + grid, ...:
//   member x segment of the slowest axis x y x x cross tiles, x fastest
//   (persistent.cuh's Walker). A column segment's L output planes are
//   computed tau at a time (the step; g.t[0]).
// - A ring of input planes. Each field's padded planes of the column's
//   window (cross tile + 2rS) go to a ring of P plane slots, plane j of
//   the segment's window to slot j mod P, by 16-byte cp.async into rows
//   and slots congruent to the padded field's modulo 16 bytes
//   (stream_body.cuh's ring; P >= n_buf tau + 2rz, P plane a multiple of
//   16 bytes). With n_buf = 2 (select) step i + 1 is in flight while step
//   i is read; the first step brings the 2rz leading planes too.
// - A ring of planes per intermediate sweep. Sweep s < S-1 covers its
//   region's cross extent, tile + 2r(S-1-s), and along z the segment
//   widened by rz(S-1-s) a side; at step i it computes its planes that the
//   planes landed so far allow, tau of them once the walk runs, and writes
//   them, rounded to T as the plain version stores them, to its ring of
//   Q = tau + 2rz slots (sweep s's plane k in slot k mod Q). Sweep s + 1
//   reads them where they land. Only the last sweep writes to device
//   memory. A segment recomputes only its two ends (2rz(S-1-s) planes of
//   sweep s), as the stream kernel's segments do.
// - Reading planes where they land. A tap's offset depends on the slot of
//   the point's own plane, so every ring has a tap row per slot, built once
//   per block: tap (dz, dy, dx) at ((c + dz) mod P - c) plane + dy pitch +
//   dx from a point whose plane sits in slot c, the coefficient cast to T
//   beside it (one shared load per tap).
// - Several outputs per thread. Warp w takes runs w, w + warps, ... of 32 U
//   points of one plane of one field, lane l its points l + 32 i (i < U),
//   a run past the plane's end repeating its last point unstored: the U
//   points share one tap row and read each tap once for U multiply-adds.
//   Points are split by multiplies (FastDiv, its factors for each sweep
//   kept in shared memory), not divisions.
// - MHD (f32; in f64 the eight fields' rings fit no tile beside phi's
//   inputs). One item (field, point) a thread evaluates the (slot, field)
//   pairs phi reads (mhd::fields_read) one at a time into a shared tile
//   of MHD_BATCH points, then one thread a point runs phi, as
//   swc_body.cuh does. The substep's carry w' is read only at the next
//   sweep's own point, so it goes to a ring of tau + rz slots cut to that
//   sweep's region; sweep 0 reads the aux w from device memory. Eight
//   fields' rings fill the block, so the input ring holds one step
//   (g.n_buf = 1) and the next is fetched once sweep 0 has read it.
// - Order of arithmetic: each operator sums its taps in table order from
//   zero, one FMA per tap, as the one-tile body's apply_op did, so the
//   outputs are that body's bit for bit, and a member of a batched launch
//   is its unbatched launch bit for bit.
// Rank 2 runs lifted as the stream kernel lifts it, (Y, 1, X) with the
// walk along Y: with no radius along the kernel's y, a tap's (0, dy, dx)
// is read as (dy, 0, dx).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "persistent.cuh"
#include "phi_mhd.cuh"
#include "stencil_common.cuh"
#include "stencil_sweep.cuh"
#include "swc_body.cuh"

namespace stencil {
namespace walk {

// Threads a block takes at most and the blocks an SM's registers must
// allow (__launch_bounds__(512, 1): at most 128 registers a thread, so two
// select blocks of 256 share an SM; plan.py:WALK_THREADS): the tap loop
// wants 16 warps an SM, and the MHD phi takes ~120 registers.
constexpr int MAX_THREADS = 512;

// Outputs a thread computes (plan.py:WALK_OUTPUTS): select 4, each tap
// read once for four multiply-adds; MHD 1 (phi runs one thread a point).
template <int KIND>
__host__ __device__ constexpr int outputs() {
  return KIND == KIND_SELECT ? 4 : 1;
}

// MHD: points of a sweep's planes whose phi inputs share memory at once
// (plan.py:WALK_MHD_BATCH).
constexpr int MHD_BATCH = 128;

// The column's input ring and the intermediate rings
// (plan.py:walk_ring mirrors it). Element index of input plane slot c,
// window row y, column x of field k: k fstride + s0 + c plane + y pitch +
// x, s0 the column's start offset within its 16 bytes. Ring s holds sweep
// s's planes of its region (wy_s, wx_s) unpadded: field k's plane in slot
// c at (k q + c) wy_s wx_s. The substep kind's carry ring s holds the aux
// rows (w') sweep s writes, cut to sweep s + 1's region: row k's plane in
// slot c at (k cq + c) wy_{s+1} wx_{s+1}.
struct Shape {
  int tau, ty, tx;    // planes per step and cross tile
  int wy, wx;         // the input cross window, tile + 2 r S
  int lead;           // 2 rz
  int pitch, plane;   // input ring elements per row and per plane slot
  int period;         // P, input plane slots
  int fstride;        // input ring elements per field
  int q;              // slots of each intermediate ring, tau + 2 rz
  int cq;             // slots of each carry ring, tau + rz
  int seg;            // output planes of a column segment
};

template <typename T>
__host__ __device__ inline Shape walk_shape(const Geometry& g) {
  constexpr int V = 16 / sizeof(T);
  const int S = g.fuse_steps;
  Shape s;
  s.tau = g.t[0];
  s.ty = g.t[1];
  s.tx = g.t[2];
  s.wy = s.ty + 2 * g.r[1] * S;
  s.wx = s.tx + 2 * g.r[2] * S;
  s.lead = 2 * g.r[0];
  s.pitch = swc::congruent_up(s.wx + V - 1, g.p[2] % V, V);
  const long long psz = (long long)g.p[1] * g.p[2];
  s.plane = swc::congruent_up(s.wy * s.pitch, int(psz % V), V);
  int period = g.n_buf * s.tau + s.lead;
  while ((long long)period * s.plane % V) ++period;
  s.period = period;
  const int elems = V * cdiv(V - 1 + (period - 1) * s.plane +
                                 (s.wy - 1) * s.pitch + s.wx,
                             V);
  s.fstride = swc::congruent_up(elems, int(psz * g.p[0] % V), V);
  s.q = s.tau + s.lead;
  s.cq = s.tau + g.r[0];
  s.seg = g.n[0] / g.n_seg;
  return s;
}

// Sweep s's region across the walk: tile + 2r(S-1-s).
__host__ __device__ inline int region_y(const Geometry& g, int s) {
  return g.t[1] + 2 * g.r[1] * (g.fuse_steps - 1 - s);
}
__host__ __device__ inline int region_x(const Geometry& g, int s) {
  return g.t[2] + 2 * g.r[2] * (g.fuse_steps - 1 - s);
}

// Bytes of intermediate ring s (all fields) and of carry ring s (all aux
// rows), each padded to 16.
template <typename T>
__host__ __device__ inline size_t mid_bytes(const Geometry& g, int s) {
  return round_up16(size_t(g.n_f) * (g.t[0] + 2 * g.r[0]) * region_y(g, s) *
                    region_x(g, s) * sizeof(T));
}
template <typename T>
__host__ __device__ inline size_t carry_bytes(const Geometry& g, int s) {
  return round_up16(size_t(g.n_aux) * (g.t[0] + g.r[0]) *
                    region_y(g, s + 1) * region_x(g, s + 1) * sizeof(T));
}

// Byte offsets of the shared memory: the input ring (all fields) | the
// intermediate rings of sweeps 0 .. S-2 | (substep) their carry rings |
// two FastDiv factors per sweep | the tap rows (P for the input ring, then
// q for each intermediate ring) | (MHD, from a 16-byte boundary) phi's
// inputs, n_slots x n_f values of T for MHD_BATCH points.
// plan.py:walk_smem_bytes mirrors it.
struct Layout {
  size_t mid, carry, div, taps, sums, total;
};

template <typename T>
__host__ __device__ inline Layout walk_layout(const Geometry& g) {
  const Shape s = walk_shape<T>(g);
  const int S = g.fuse_steps;
  Layout L;
  L.mid = round_up16(size_t(g.n_f) * s.fstride * sizeof(T));
  size_t off = L.mid;
  for (int i = 0; i < S - 1; ++i) off += mid_bytes<T>(g, i);
  L.carry = off;
  for (int i = 0; i < S - 1; ++i) off += carry_bytes<T>(g, i);
  L.div = off;
  L.taps = L.div + size_t(S) * 2 * sizeof(unsigned long long);
  L.total = L.taps + size_t(s.period + (S - 1) * s.q) * g.n_taps *
                         sizeof(Tap<T>);
  L.sums = L.total;
  if (g.n_slots > 1) {
    L.sums = round_up16(L.total);
    L.total = L.sums + size_t(g.n_slots) * g.n_f * MHD_BATCH * sizeof(T);
  }
  return L;
}

// The walk's rules (the temporal and the stream kernel ask them): the
// select kind (one operator, no aux) or an MHD kind (8 fields, 10 slots,
// the substep's 8 aux rows), the threads, outputs and ring it is built for,
// tiles and segments that divide.
inline bool valid(const Geometry& g, int kind) {
  const bool select = kind == KIND_SELECT;
  const int n_aux = kind == KIND_MHD_SUBSTEP ? mhd::N_FIELDS : 0;
  if (select ? g.n_slots != 1
             : g.n_f != mhd::N_FIELDS || g.n_slots != mhd::N_SLOTS)
    return false;
  const int u = select ? outputs<KIND_SELECT>() : outputs<KIND_MHD_RHS>();
  if (g.n_aux != n_aux || g.u_out != u || g.n_thr < 32 || g.n_thr % 32 ||
      g.n_thr > MAX_THREADS || g.n_buf < 1 || g.n_buf > 2 || g.n_seg < 1 ||
      g.n_b < 1 || (n_aux && g.n_b != 1) || g.n[0] % g.n_seg)
    return false;
  for (int a = 0; a < 3; ++a)
    if (g.t[a] < 1 || g.n[a] % g.t[a]) return false;
  return g.t[0] <= g.n[0] / g.n_seg;
}

// One sweep's planes at one step of a column, as walk_columns hands them
// to a body: sweep s computes its planes [lo, hi) (numbered from its
// region's first, rz(S-1-s) before the segment's first output plane) over
// its region (wy, wx). It reads src: element (field k, slot c, row y,
// column x) at src + k sf + c ss + y sp + x, the input ring (s = 0) or
// ring s - 1, whose plane z + rz of sweep s - 1 is sweep s's plane z's
// centre (slot = centre(z)); it writes ring s (dst: field k's plane z at
// (k q + z mod q) wy wx) or, in the last sweep, the column's outputs
// (ocol). The substep's carry: cin (ring s - 1), cout (ring s).
template <typename T>
struct SweepAt {
  int s, lo, hi;
  bool last;
  int wy, wx;
  const T* src;
  int sp, ss, sf, per;
  T* dst;
  const T* cin;
  T* cout;
  T* ocol;
  int z0, y0, x0;  // the column's origin (first output plane, row, x)
  __device__ int centre(int z, int rz) const { return (z + rz) % per; }
};

// The walk of tile columns that both walk bodies share (this one and
// tc_walk_body.cuh): persistent blocks over (member, segment, y, x)
// columns (Walker); per column the input ring filled by 16-byte cp.async
// into rows and slots congruent to the padded field's modulo 16 bytes,
// step i's planes fetched NB - 1 steps ahead (with one stage once sweep 0
// has read the ring); per step every sweep's planes that the landed planes
// allow, handed to body(SweepAt) with a barrier between sweeps.
// plan.walk_schedule mirrors it.
template <typename T, typename Body>
__device__ __forceinline__ void walk_columns(const T* __restrict__ f,
                                             T* __restrict__ out,
                                             const Geometry& g,
                                             const Shape& sh, size_t mid,
                                             size_t carry,
                                             unsigned char* smem,
                                             Body&& body) {
  constexpr int V = 16 / sizeof(T);
  const int S = g.fuse_steps, nf = g.n_f;
  const int P = sh.period, Q = sh.q;
  const int rx = g.r[2], ry = g.r[1];
  T* ring = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const long long psy = g.p[2], psz = psy * g.p[1], pfield = psz * g.p[0];
  const long long osy = g.n[2], osz = osy * g.n[1], ofield = osz * g.n[0];
  const unsigned usz = unsigned(psz), usy = unsigned(psy),
                 uf = unsigned(pfield);
  Walker wk;
  wk.nx = g.n[2] / sh.tx;
  wk.ny = g.n[1] / sh.ty;
  wk.nz = g.n_seg;
  wk.nf = 1;
  {
    const Walk s = wk.at(gridDim.x);
    wk.sx = s.ix;
    wk.sy = s.iy;
    wk.sz = s.iz;
    wk.sm = s.m;
  }
  const long long items = (long long)wk.nx * wk.ny * wk.nz * g.n_b;
  // Steps of planes the input ring holds: with two or more, step i + NB -
  // 1 is fetched once step i starts; with one (MHD), step i + 1 once sweep
  // 0 of step i has read the ring.
  const int NB = g.n_buf;
  // Input planes of a segment's window, and the steps that compute its
  // outputs (the last sweep lags 2 rz (S-1) planes behind the input).
  const int planes = sh.seg + sh.lead * S;
  const int steps = cdiv(sh.seg + sh.lead * (S - 1), sh.tau);
  const int cq = cdiv(sh.wx + V - 1, V);  // most chunks a row covers
  const FastDiv by_cq(cq), by_wy(sh.wy), by_P(P);

  Walk w = wk.at(blockIdx.x);
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    SweepAt<T> sa{0, 0, 0, false, 0, 0, nullptr, 0, 0, 0, 0, nullptr,
                 nullptr, nullptr, nullptr, w.iz * sh.seg, w.iy * sh.ty,
                 w.ix * sh.tx};
    // The column's window starts at padded plane z0 (its first output
    // plane's window) and padded row and column (y0, x0).
    const T* column = f + (long long)w.m * nf * pfield + sa.z0 * psz +
                      sa.y0 * psy + sa.x0;
    sa.ocol = out + (long long)w.m * g.n_out * ofield + sa.z0 * osz +
              sa.y0 * osy + sa.x0;
    const unsigned sb = unsigned(reinterpret_cast<uintptr_t>(column) /
                                 sizeof(T));
    const int s0 = int(sb & (V - 1));

    // Staging: planes [j0, j0 + np) of the window, every field, plane j to
    // slot j mod P. Window row (j, y) of field k starts a elements into its
    // first 16 bytes and at ring element b = k fstride + s0 + slot plane +
    // y pitch (b = a mod V); its chunk q is the 16 bytes at q V - a of the
    // row, copied to b - a + q V.
    auto fetch = [&](int j0, int np) {
      const int slot0 = j0 - by_P(j0) * P;
      const int jobs = np * sh.wy * cq;
      for (int k = 0; k < nf; ++k) {
        const T* src_k = column + k * pfield;
        T* dst_k = ring + k * sh.fstride + s0;
        const unsigned sbk = sb + unsigned(k) * uf;
        for (int j = tid; j < jobs; j += nthr) {
          const int row = by_cq(j), q = j - row * cq;
          const int pl = by_wy(row), y = row - pl * sh.wy;
          const int jj = j0 + pl;
          const int a = int((sbk + unsigned(jj) * usz + unsigned(y) * usy) &
                            (V - 1));
          if (q * V >= a + sh.wx) continue;  // past the row's last chunk
          int slot = slot0 + pl;
          slot -= slot >= P ? P : 0;
          cp_async16(dst_k + slot * sh.plane + y * sh.pitch - a + q * V,
                     src_k + jj * psz + y * psy - a + q * V, 16);
        }
      }
    };
    // Step i's planes not yet fetched: the first brings the 2rz leading
    // ones too.
    auto fetch_step = [&](int i) {
      if (i >= steps) return;
      if (i == 0) {
        fetch(0, sh.tau + sh.lead);
      } else {
        const int j0 = i * sh.tau + sh.lead;
        fetch(j0, min(sh.tau, planes - j0));
      }
    };

    __syncthreads();  // the previous column's planes are read
    for (int i = 0; i < (NB > 1 ? NB - 1 : 1); ++i) {
      fetch_step(i);
      cp_async_commit();
    }
    for (int i = 0; i < steps; ++i) {
      cp_async_wait<0>();  // step i's planes have landed
      __syncthreads();  // ... for every thread; step i - 1 is done
      if (NB > 1) {
        fetch_step(i + NB - 1);
        cp_async_commit();
      }
      size_t src_at = 0, dst_at = mid;  // rings read and written
      size_t cin_at = 0, cout_at = carry;  // carry rings likewise
      for (int s = 0; s < S; ++s) {
        sa.s = s;
        sa.wy = region_y(g, s);
        sa.wx = region_x(g, s);
        // Sweep s's planes (numbered from its region's first) that the
        // planes landed so far allow and it has not computed yet.
        const int K = sh.seg + sh.lead * (S - 1 - s);
        sa.hi = min(K, (i + 1) * sh.tau - sh.lead * s);
        sa.lo = max(0, min(K, i * sh.tau - sh.lead * s));
        sa.last = s == S - 1;
        if (sa.hi > sa.lo) {
          // Where sweep s reads: the input ring, or ring s - 1 (its
          // region one radius wider than sweep s's on every side).
          if (s == 0) {
            sa.src = ring + s0;
            sa.sp = sh.pitch;
            sa.ss = sh.plane;
            sa.sf = sh.fstride;
            sa.per = P;
          } else {
            sa.src = reinterpret_cast<const T*>(smem + src_at);
            sa.sp = sa.wx + 2 * rx;
            sa.ss = (sa.wy + 2 * ry) * sa.sp;
            sa.sf = Q * sa.ss;
            sa.per = Q;
          }
          sa.dst = reinterpret_cast<T*>(smem + dst_at);
          sa.cin = reinterpret_cast<const T*>(smem + cin_at);
          sa.cout = reinterpret_cast<T*>(smem + cout_at);
          body(static_cast<const SweepAt<T>&>(sa));
        }
        if (!sa.last) {
          __syncthreads();  // sweep s's planes are in for sweep s + 1
          if (s == 0 && NB == 1) {  // sweep 0 has read the input ring
            fetch_step(i + 1);
            cp_async_commit();
          }
          src_at = dst_at;
          dst_at += mid_bytes<T>(g, s);
          cin_at = cout_at;
          cout_at += carry_bytes<T>(g, s);
        }
      }
    }
    wk.next(w);
  }
}

template <typename T, int KIND, int U>
__device__ __forceinline__ void walk_body(
    const T* __restrict__ f, const T* __restrict__ aux, T* __restrict__ out,
    const int* __restrict__ tap_off, const double* __restrict__ tap_coef,
    const int* __restrict__ op_start, const Geometry& g,
    unsigned char* smem) {
  constexpr bool kSelect = KIND == KIND_SELECT;
  const Shape sh = walk_shape<T>(g);
  const Layout L = walk_layout<T>(g);
  const int S = g.fuse_steps, nf = g.n_f, nt = g.n_taps;
  const int P = sh.period, Q = sh.q;
  const int rz = g.r[0], ry = g.r[1], rx = g.r[2];
  FastDiv* div = reinterpret_cast<FastDiv*>(smem + L.div);
  Tap<T>* taps = reinterpret_cast<Tap<T>*>(smem + L.taps);
  T* sums = reinterpret_cast<T*>(smem + L.sums);
  const int tid = threadIdx.x, nthr = blockDim.x;

  // Once per block: each sweep's divisors (its region's x, and its runs
  // of 32 U points per plane for select, its points per plane for MHD)
  // and the tap rows of every ring.
  for (int s = tid; s < S; s += nthr) {
    const int wx = region_x(g, s), pts = region_y(g, s) * wx;
    div[2 * s] = FastDiv(wx);
    div[2 * s + 1] = FastDiv(kSelect ? cdiv(pts, 32 * U) : pts);
  }
  const int rows = P + (S - 1) * Q;
  for (int i = tid; i < rows * nt; i += nthr) {
    const int row = i / nt, t = i - row * nt;
    int per = P, c = row, pitch = sh.pitch, plane = sh.plane;
    if (row >= P) {  // ring s's row c
      const int s = (row - P) / Q;
      c = row - P - s * Q;
      per = Q;
      pitch = region_x(g, s);
      plane = region_y(g, s) * pitch;
    }
    int dz = tap_off[3 * t], dy = tap_off[3 * t + 1];
    if (ry == 0) {  // rank 2 lifted: dy runs along the walk
      dz += dy;
      dy = 0;
    }
    int zc = c + dz;
    zc += zc < 0 ? per : 0;
    zc -= zc >= per ? per : 0;
    taps[i].coef = cast_coef<T>(tap_coef[t]);  // cast before the multiply
    taps[i].offset = (zc - c) * plane + dy * pitch + tap_off[3 * t + 2];
  }
  const int b0 = op_start[g.slot[0]], e0 = op_start[g.slot[0] + 1];
  const long long osy = g.n[2], osz = osy * g.n[1], ofield = osz * g.n[0];
  // The substep's aux w, padded by r (S - 1), read by sweep 0 (no batch:
  // the planner refuses a batched aux at depth > 1).
  const long long asy = g.n[2] + 2 * rx * (S - 1);
  const long long asz = asy * (g.n[1] + 2 * ry * (S - 1));
  const long long afield = asz * (g.n[0] + 2 * rz * (S - 1));
  const FastDiv by_nf(nf), by_P(P), by_Q(Q), by_C(sh.cq);
  const int lane = tid & 31, warp = tid >> 5, warps = nthr >> 5;

  walk_columns<T>(f, out, g, sh, L.mid, L.carry, smem,
                  [&](const SweepAt<T>& a) {
    const int s = a.s, wy = a.wy, wx = a.wx, pts = wy * wx;
    const int sp = a.sp, ss = a.ss, sf = a.sf;
    const int row0 = s == 0 ? 0 : P + (s - 1) * Q;  // its tap rows
    const FastDiv by_wx = div[2 * s], by_2 = div[2 * s + 1];
    // Sweep s's plane z: its centre plane's slot in the source ring.
    auto centre = [&](int z) {
      const int c = z + rz;
      return c - (s == 0 ? by_P(c) * P : by_Q(c) * Q);
    };
    if constexpr (kSelect) {
      const int R = cdiv(pts, 32 * U);
      const int runs = (a.hi - a.lo) * nf * R;
      for (int j = warp; j < runs; j += warps) {
        const int pf = by_2(j), r = j - pf * R;
        const int pl = by_nf(pf), k = pf - pl * nf;
        const int z = a.lo + pl;  // sweep s's plane
        const int c = centre(z);
        const T* __restrict__ wsrc = a.src + k * sf + c * ss + ry * sp + rx;
        const Tap<T>* __restrict__ trow = taps + (row0 + c) * nt;
        int cen[U], at[U];
        bool live[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int p = r * 32 * U + lane + 32 * u;
          live[u] = p < pts;
          const int pp = live[u] ? p : pts - 1;
          const int y = by_wx(pp), x = pp - y * wx;
          cen[u] = y * sp + x;
          at[u] = a.last ? int(y * osy) + x : pp;
        }
        // out[k] = op_slot0(f[k]): its taps, in table order, into U sums,
        // one tap read for U multiply-adds.
        T acc[U];
#pragma unroll
        for (int u = 0; u < U; ++u) acc[u] = T(0);
#pragma unroll 4
        for (int t = b0; t < e0; ++t) {
          const Tap<T> tap = trow[t];
#pragma unroll
          for (int u = 0; u < U; ++u)
            acc[u] = swc::mac(tap.coef, wsrc[cen[u] + tap.offset], acc[u]);
        }
        T* o = a.last ? a.ocol + k * ofield + z * osz
                      : a.dst + (k * Q + z - by_Q(z) * Q) * pts;
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (live[u]) o[at[u]] = acc[u];
      }
    } else {
      // MHD, in batches of MHD_BATCH points of the step's planes: one
      // (field, point) item a thread evaluates the slots phi reads on its
      // field, one at a time, into the shared tile; then one thread a
      // point runs phi.
      constexpr bool kSub = KIND == KIND_MHD_SUBSTEP;
      const SweepPhi<T> ph(prm_row(g, s));
      const int total = (a.hi - a.lo) * pts;
      const int wy1 = wy - 2 * ry, wx1 = wx - 2 * rx;  // region s + 1
      const int C = sh.cq;  // carry slots
      const T* cin = a.cin;
      T* cout = a.cout;
      T* dst = a.dst;
      T* ocol = a.ocol;
      const bool last = a.last;
      const long long z0 = a.z0, y0 = a.y0, x0 = a.x0;
      for (int p0 = 0; p0 < total; p0 += MHD_BATCH) {
        const int nb = min(MHD_BATCH, total - p0);
        for (int it2 = tid; it2 < nf * MHD_BATCH; it2 += nthr) {
          const int k = it2 / MHD_BATCH, j = it2 - k * MHD_BATCH;
          if (j >= nb) continue;
          const int p = p0 + j, pl = by_2(p), q = p - pl * pts;
          const int y = by_wx(q), x = q - y * wx;
          const int c = centre(a.lo + pl);
          const T* __restrict__ wsrc =
              a.src + k * sf + c * ss + (y + ry) * sp + x + rx;
          const Tap<T>* __restrict__ trow = taps + (row0 + c) * nt;
          for (int sl = 0; sl < mhd::N_SLOTS; ++sl) {
            if (!((mhd::fields_read(sl, kSub) >> k) & 1u)) continue;
            const int op = g.slot[sl];
            T acc = T(0);
            const int e = op_start[op + 1];
#pragma unroll 4
            for (int t = op_start[op]; t < e; ++t) {
              const Tap<T> tap = trow[t];
              acc = swc::mac(tap.coef, wsrc[tap.offset], acc);
            }
            sums[(sl * mhd::N_FIELDS + k) * MHD_BATCH + j] = acc;
          }
        }
        __syncthreads();  // every field's sums are in
        for (int j = tid; j < nb; j += nthr) {
          const int p = p0 + j, pl = by_2(p), q = p - pl * pts;
          const int y = by_wx(q), x = q - y * wx;
          // (The loads of the pairs phi does not read are never made.)
          T d[mhd::N_SLOTS][mhd::N_FIELDS];
#pragma unroll
          for (int sl = 0; sl < mhd::N_SLOTS; ++sl)
#pragma unroll
            for (int kk = 0; kk < mhd::N_FIELDS; ++kk)
              d[sl][kk] = sums[(sl * mhd::N_FIELDS + kk) * MHD_BATCH + j];
          const int z = a.lo + pl;
          // The substep's w at the point: aux in sweep 0, else the carry
          // sweep s - 1 wrote (its plane z + rz).
          const T* aw = nullptr;
          long long astride = 0;
          if constexpr (kSub) {
            if (s == 0) {
              aw = aux + (z0 + z) * asz + (y0 + y) * asy + x0 + x;
              astride = afield;
            } else {
              const int cz = z + rz - by_C(z + rz) * C;
              aw = cin + cz * pts + y * wx + x;
              astride = (long long)C * pts;
            }
          }
          const int zq = z - by_Q(z) * Q, zc = z - by_C(z) * C;
          const int cy = y - ry, cx = x - rx;
          const bool cut = cy >= 0 && cy < wy1 && cx >= 0 && cx < wx1;
          mhd_phi<T, KIND>(d, ph, aw, astride, [&](int jr, T v) {
            if (last) {
              ocol[jr * ofield + z * osz + y * osy + x] = v;
            } else if (jr < nf) {
              dst[(jr * Q + zq) * pts + y * wx + x] = v;
            } else if (cut) {  // w', cut to sweep s + 1's region
              cout[((jr - nf) * C + zc) * wy1 * wx1 + cy * wx1 + cx] = v;
            }
          });
        }
        __syncthreads();  // the tile is read before the next batch
      }
    }
  });
}

}  // namespace walk
}  // namespace stencil
