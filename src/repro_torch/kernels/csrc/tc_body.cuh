// The depth-1 body of the tc kernel (fused_stencil_tc.cu): a persistent
// tile walk with windows in flight, the band as ready MMA fragments,
// operator sums in registers, and the MHD phi's inputs in shared memory.
//
// Replaces, at depth 1, the TPU kernel repro/kernels/emit.py:_kernel_tc
// (line 233) with _block_derivs_tc (line 153), _tc_band (line 123) and
// _contract (line 98). It computes what the reference computes: the taps
// of every operator split as tc_axis_groups splits them, a multi-tap group
// a banded contraction accumulated in f32 with the band in the field
// type, a lone tap (c in T) x value rounded in T, the groups summed in f32
// in sorted (axis, rest) order (z, then y, then x), the sum cast to T once
// per operator, then phi. Depth > 1 walks tile columns with this body's
// patch contraction (tc_walk_body.cuh); rank 1 there keeps
// temporal_body.cuh with TcEval.
//
// Design, on an H100 (132 SMs, 228 KB of shared memory each; 3.35 TB/s;
// 67 TFLOP/s on the f64 MMA, 989 on bf16). Diffusion is bound by bytes,
// the MHD RHS by operations; what bounds this kernel is instruction
// issue and latency (PERF.md section 5), which the parts below cut.
// - Persistent blocks. The grid is the kernel's resident blocks per SM
//   times the SMs, and block b takes steps
//   b, b + grid, ... of the launch: member x z x y x x tiles, x fastest
//   (a step is one tile, at rank 1 several consecutive ones, so that
//   every warp has MMAs), advanced in mixed radix without a division. A
//   unit is one field of one step: its window, tile + 2r, is copied into
//   one of g.n_buf ring buffers with 16-byte cp.async (zero-filled past
//   the window; what no window reaches is zeroed once per block), issued
//   n_buf - 1 units ahead, so the next windows are in flight while this
//   one is contracted; one barrier per unit. A buffer row keeps its
//   global alignment modulo 16 bytes: its data starts `shift` elements
//   in (row_off), so every copy is 16 bytes, bf16 included (the padded
//   rows' pitch is no multiple of 16 bytes, which also rules out TMA).
// - Patches. The outputs of a step are cut into patches of ROWS lines x
//   8 outputs (ROWS = 8 on the f64 m8n8k4 that f32 fields take, 16 on
//   bf16 m16n8k16). At rank 1 the lines are consecutive 8-point segments
//   of x; otherwise they are consecutive y rows of one z plane. The x
//   contraction is window . band (A the window lines, B the band), the y
//   contraction band^T . window (A the band, B the window columns): both
//   land on D[y][x] in the same lanes, so an operator's f32 sum stays in
//   registers across its groups and axes. The z arm runs as FMAs on the
//   same lanes' outputs (f64 accumulation for f32 fields, as the f64 MMA;
//   f32 for bf16). Lone taps are scalar on the same lanes. A warp takes
//   PB patches at once: each group's row, coefficients and fragments are
//   read once for all of them, and their MMA chains are independent.
// - The table. emit.tc_table gives each operator's groups as one run per
//   axis (z, y, x) with each group's data: a y or x group's band B[k][n]
//   = c[k - n] as the words each lane holds per k-step, a z arm's or
//   lone tap's coefficients already rounded to T. A block copies it to
//   shared memory once; the MMA loop reads one fragment per k-step: no
//   table scan, no compare, no conversion.
// - Ragged patches. Window rows and columns past the staged window read
//   zeros, so a band zero never meets a non-finite value; outputs past
//   the tile are computed and not stored.
// - select: a warp's patches are stored straight from its registers.
//   MHD: the warps take (patch batch, slot) units, dealt out once per
//   block by the slots' group counts (the mixed partials have 6 groups,
//   the value 1), each slot's f32 sums go to a shared tile of n_slots x
//   n_f values per point, and after the 8th field one thread per point
//   reads its 80 values and runs phi: the contraction no longer holds
//   phi's inputs beside its own state. One warp stages the next field
//   while the other 15 contract.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "persistent.cuh"
#include "phi_mhd.cuh"
#include "stencil_common.cuh"
#include "stencil_sweep.cuh"

namespace stencil {
namespace tc {

constexpr int SEG = 8;  // outputs per line of a patch (the MMA's n)
// The wrapper's group rows (emit.py:tc_table): per group ENT_LEN ints,
// the columns E_* (column 6 is the word offset of the group's data in the
// depth-1 table).
constexpr int ENT_LEN = 8;
constexpr int E_AXIS = 0, E_REST = 1, E_SINGLE = 4, E_J = 5;
constexpr int THREADS_SELECT = 256, THREADS_MHD = 512;

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// A coefficient the host rounded to T (emit.tc_table), stored widened.
template <typename T>
__device__ __forceinline__ T from_double(double c);
template <>
__device__ __forceinline__ float from_double<float>(double c) {
  return float(c);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_double<__nv_bfloat16>(
    double c) {
  return __float2bfloat16(float(c));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) |
         (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

// D = A B + D, A 8x4 (row), B 4x8 (col), f64.
__device__ __forceinline__ void mma_f64(double& d0, double& d1, double a,
                                        double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, "
      "{%0,%1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

// D = A B + D, A 16x16 bf16 (row), B 16x8 bf16 (col), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The MMA of each field type: rows of a patch, k per step, elements per
// 16-byte copy.
template <typename T>
struct Mma;
template <>
struct Mma<float> {  // f32 fields on the f64 m8n8k4
  static constexpr int ROWS = 8, KSTEP = 4, V = 4;
};
template <>
struct Mma<__nv_bfloat16> {  // bf16 m16n8k16
  static constexpr int ROWS = 16, KSTEP = 16, V = 8;
};

// k-steps of one contraction (plan.py:tc_band_ksteps): the f64 MMA takes
// the band of 8 + 2r rows in steps of 4; bf16 in steps of 16, 8 + 2r rows
// along x, 16 + 2r along y (16 outputs).
__host__ __device__ inline int ksteps(int r, bool bf16, bool y) {
  if (bf16) return cdiv((y ? 16 : SEG) + 2 * r, 16);
  return cdiv(SEG + 2 * r, 4);
}

// One step of the walk and its window buffer (plan.py:tc_step mirrors
// it).
struct Shape {
  bool line1d;       // rank 1: lines are x segments
  int tz, ty, tx;    // outputs of a step
  int wy, wx;        // staged window rows per plane and columns
  int wz;            // staged planes
  int wyp, pitch;    // buffer rows per plane, elements per buffer row
  int segy, segx;    // patches along y and x (2-D patches)
  int patches;
  size_t buf;        // bytes of one ring buffer
};

template <typename T>
__host__ __device__ inline Shape tc_shape(const Geometry& g) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int ROWS = Mma<T>::ROWS, V = Mma<T>::V, KS = Mma<T>::KSTEP;
  Shape s;
  s.tz = g.t[0];
  s.ty = g.t[1];
  s.tx = g.t[2] * g.tps;
  s.wz = s.tz + 2 * g.r[0];
  s.wy = s.ty + 2 * g.r[1];
  s.wx = s.tx + 2 * g.r[2];
  const int kx = ksteps(g.r[2], BF, false) * KS;
  s.line1d = s.tz == 1 && s.ty == 1 && g.r[0] == 0 && g.r[1] == 0;
  int width;
  if (s.line1d) {
    s.segy = 1;
    s.segx = cdiv(s.tx, SEG);
    s.patches = cdiv(s.segx, ROWS);
    s.wyp = 1;
    width = imax((s.patches * ROWS - 1) * SEG + kx,
                 s.patches * ROWS * SEG + 2 * g.r[2]);
  } else {
    s.segy = cdiv(s.ty, ROWS);
    s.segx = cdiv(s.tx, SEG);
    s.patches = s.tz * s.segy * s.segx;
    s.wyp = (s.segy - 1) * ROWS + ksteps(g.r[1], BF, true) * KS;
    width = imax((s.segx - 1) * SEG + kx, s.segx * SEG + 2 * g.r[2]);
  }
  s.pitch = cdiv(width + V - 1, V) * V;
  s.buf = round_up16(size_t(s.wz) * s.wyp * s.pitch * sizeof(T));
  return s;
}

// Byte offsets of the shared memory: the ring of g.n_buf windows | the
// table (emit.py:tc_table: operator starts, group rows, fragments) |
// (MHD) the f32 operator sums, n_slots x n_f values per point of a step.
// plan.py:tc_smem_bytes mirrors it.
struct Layout {
  size_t table, sums, total;
};

template <typename T>
__host__ __device__ inline Layout tc_layout(const Geometry& g) {
  const Shape s = tc_shape<T>(g);
  Layout L;
  L.table = size_t(g.n_buf) * s.buf;
  L.sums = L.table + round_up16(size_t(g.table_words) * 4);
  L.total = L.sums;
  if (g.n_slots > 1)
    L.total += size_t(4) * g.n_slots * g.n_f * s.tz * s.ty * s.tx;
  return L;
}

template <typename T, int KIND>
__device__ __forceinline__ void tc_body(
    const T* __restrict__ f, const T* __restrict__ aux, T* __restrict__ out,
    const int* __restrict__ table, const Geometry& g, unsigned char* smem) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int ROWS = Mma<T>::ROWS, V = Mma<T>::V;
  constexpr int NO = ROWS / 4;  // outputs per lane of a patch
  constexpr int NR = NO / 2;    // their rows (pairs of adjacent columns)
  // Patches a warp takes at once: 4 for f32 select, 2 where more outputs
  // per lane (bf16) or phi (MHD) hold registers.
  constexpr int PB = KIND == KIND_SELECT && !BF ? 4 : 2;
  const Shape sh = tc_shape<T>(g);
  const Layout L = tc_layout<T>(g);
  int* tab = reinterpret_cast<int*>(smem + L.table);
  float* sums = reinterpret_cast<float*>(smem + L.sums);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, nwarp = nthr >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  for (int i = tid; i < g.table_words; i += nthr) tab[i] = __ldg(table + i);
  // Group e's row: recs[2 e] = (axis, rest z, y, x), recs[2 e + 1] =
  // (lone tap, its offset, its data's word offset, 0).
  const int4* recs = reinterpret_cast<const int4*>(tab + ((g.n_ops + 4) & ~3));

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
  const int points = sh.tz * sh.ty * sh.tx;

  auto buffer = [&](int slot) {
    return reinterpret_cast<T*>(smem + size_t(slot) * sh.buf);
  };
  // Field k's window of a step in f, and the low bits of its element
  // address: row (z, y) of it starts (sb + z psz + y psy) mod V elements
  // past a 16-byte boundary.
  auto window = [&](const Walk& w) {
    return f + ((long long)w.m * nf + w.k) * pfield +
           (long long)w.iz * sh.tz * psz + (long long)w.iy * sh.ty * psy +
           (long long)w.ix * sh.tx;
  };
  auto addr_bits = [&](const T* src) {
    return unsigned(reinterpret_cast<uintptr_t>(src) / sizeof(T));
  };
  auto row_off = [&](unsigned sb, int z, int y) {
    return (z * sh.wyp + y) * sh.pitch +
           int((sb + unsigned(z) * usz + unsigned(y) * usy) & (V - 1));
  };

  // Staging: chunk q of buffer row (z, y) holds the 16 aligned bytes at
  // q * V - shift of the window row, zero-filled past the window. Only
  // the window's rows and the first cq chunks of each can ever hold data:
  // the rest of every buffer is zeroed once, here. The threads take the
  // (row, chunk) pairs in turn, neighbouring threads on neighbouring
  // chunks.
  {
    uint4* z4 = reinterpret_cast<uint4*>(smem);
    const int n4 = int(size_t(NS) * sh.buf / 16);
    for (int i = tid; i < n4; i += nthr) z4[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  // select: every warp stages and contracts. MHD: the last warp stages
  // the next field's window while the others contract this one (its
  // copies wait on the memory system without holding up the MMAs).
  const int cwarps = KIND == KIND_SELECT ? nwarp : nwarp - 1;
  const bool stager = warp >= nwarp - (KIND == KIND_SELECT ? nwarp : 1);
  const int stid = tid - (nwarp * 32 - (KIND == KIND_SELECT ? nthr : 32));
  const int sthr = KIND == KIND_SELECT ? nthr : 32;
  const int cq = cdiv(sh.wx + V - 1, V);
  const int jobs = sh.wz * sh.wy * cq;  // (row, chunk) pairs of a window
  const FastDiv by_cq(cq), by_wy(sh.wy);
  auto stage = [&](const Walk& wu, int slot) {
    if (!stager) return;
    const T* src = window(wu);
    const unsigned sb = addr_bits(src);
    const T* aligned = src - (sb & (V - 1));  // a valid source for zeros
    T* dst = buffer(slot);
    for (int j = stid; j < jobs; j += sthr) {
      const int row = by_cq(j), q = j - row * cq;
      const int z = by_wy(row), y = row - z * sh.wy;
      const unsigned sr = sb + unsigned(z) * usz + unsigned(y) * usy;
      const int s = int(sr & (V - 1));
      const int lo = q * V - s;
      int n = sh.wx - lo;
      n = n < 0 ? 0 : (n > V ? V : n);
      cp_async16(dst + (z * sh.wyp + y) * sh.pitch + q * V,
                 n ? src + z * psz + y * psy - s + q * V : aligned,
                 n * int(sizeof(T)));
    }
  };

  // A warp's units: (batch of PB consecutive patches, slot) pairs, by
  // default wu = warp, warp + cwarps, ... The PB patches of a unit share
  // each group's row and fragments and give the warp PB independent MMA
  // chains.
  const FastDiv by_slots(g.n_slots), by_segx(sh.segx), by_segy(sh.segy);
  const int nunit = cdiv(sh.patches, PB) * g.n_slots;
  // MHD: the slots' operators take 1 to 6 groups (the mixed partials 6),
  // so round robin leaves some warps twice the average. Up to 64 units
  // are dealt out once per block instead, heaviest first (by group
  // count), each to the least loaded warp (ties to the lowest): this
  // warp's units as a bit mask over u = batch * n_slots + slot.
  const bool by_mask = KIND != KIND_SELECT && nunit <= 64;
  unsigned long long my_units = 0;
  if (by_mask) {
    auto cost = [&](int sl) { return tab[g.slot[sl] + 1] - tab[g.slot[sl]]; };
    int load[THREADS_MHD / 32], heaviest = 0;
    for (int w = 0; w < cwarps; ++w) load[w] = 0;
    for (int sl = 0; sl < g.n_slots; ++sl) heaviest = imax(heaviest, cost(sl));
    for (int c = heaviest; c >= 0; --c)
      for (int u = 0; u < nunit; ++u) {
        if (cost(u - by_slots(u) * g.n_slots) != c) continue;
        int best = 0;
        for (int w = 1; w < cwarps; ++w)
          if (load[w] < load[best]) best = w;
        load[best] += c;
        if (best == warp) my_units |= 1ull << u;
      }
  }

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
    if (NS == 3) {
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
    const int z0 = cur.iz * sh.tz, y0t = cur.iy * sh.ty, x0t = cur.ix * sh.tx;
    const T* __restrict__ w = buffer(cur_slot);
    const unsigned sb = addr_bits(window(cur));
    unsigned long long pending = my_units;
    for (int wu = warp - cwarps;;) {
      if (by_mask) {
        if (!pending) break;
        wu = __ffsll(pending) - 1;
        pending &= pending - 1;
      } else {
        wu += cwarps;
        if (wu >= nunit || warp >= cwarps) break;
      }
      const int batch = by_slots(wu);
      const int sl = wu - batch * g.n_slots;
      // Patch b of the batch: its plane pz, first row y0 and column x0;
      // this lane's outputs in it: pairs h of adjacent columns 2 tig,
      // 2 tig + 1 in row gid (and gid + 8), at oy[b][h], ox[b][h] (+1).
      // A batch past the last patch repeats it and stores nothing.
      int pz[PB], y0[PB], x0[PB], oy[PB][NR], ox[PB][NR];
      bool live[PB];
#pragma unroll
      for (int b = 0; b < PB; ++b) {
        int patch = batch * PB + b;
        live[b] = patch < sh.patches;
        patch = live[b] ? patch : sh.patches - 1;
        if (sh.line1d) {
          pz[b] = 0;
          y0[b] = 0;
          x0[b] = patch * ROWS * SEG;
        } else {
          const int t = by_segx(patch);
          pz[b] = by_segy(t);
          y0[b] = (t - pz[b] * sh.segy) * ROWS;
          x0[b] = (patch - t * sh.segx) * SEG;
        }
#pragma unroll
        for (int h = 0; h < NR; ++h) {
          const int row = gid + 8 * h;
          oy[b][h] = sh.line1d ? 0 : y0[b] + row;
          ox[b][h] = sh.line1d ? x0[b] + row * SEG + 2 * tig : x0[b] + 2 * tig;
        }
      }
      float sum[PB][NO];
#pragma unroll
      for (int b = 0; b < PB; ++b)
#pragma unroll
        for (int i = 0; i < NO; ++i) sum[b][i] = 0.0f;
      const int op = g.slot[sl];
      const int ee = tab[op + 1];
      for (int e = tab[op]; e < ee; ++e) {
        const int4 ra = recs[2 * e], rb = recs[2 * e + 1];
        const int axis = ra.x, rz = ra.y, ry = ra.z, rx = ra.w;
        const int* data = tab + rb.z;
        if (rb.x) {
          // A lone tap: (c in T) x value, rounded in T, widened.
          const int j = rb.y;
          const T cj = from_double<T>(*reinterpret_cast<const double*>(data));
          const int dz = axis == 0 ? j : rz, dy = axis == 1 ? j : ry,
                    dx = axis == 2 ? j : rx;
#pragma unroll
          for (int b = 0; b < PB; ++b)
#pragma unroll
            for (int h = 0; h < NR; ++h) {
              const int at = row_off(sb, pz[b] + g.r[0] + dz,
                                     oy[b][h] + g.r[1] + dy) +
                             ox[b][h] + g.r[2] + dx;
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const T v = w[at + i];
                if constexpr (BF) {
                  sum[b][2 * h + i] += __bfloat162float(bf16_mul(cj, v));
                } else {
                  sum[b][2 * h + i] += __fmul_rn(cj, v);  // rounded, added
                }
              }
            }
        } else if (axis == 0) {
          // The z arm: FMAs on this lane's outputs, the band in T; f64
          // sums for f32 fields (exact products, as the f64 MMA), f32 for
          // bf16 (exact products, as the bf16 MMA). Plane jj is wyp
          // pitches further on and its rows shift by psz more.
          const double* cz = reinterpret_cast<const double*>(data);
          float accf[PB][NO];
          double accd[PB][NO];
          int base[PB][NR];
          unsigned shift[PB][NR];
#pragma unroll
          for (int b = 0; b < PB; ++b)
#pragma unroll
            for (int h = 0; h < NR; ++h) {
              base[b][h] = (pz[b] * sh.wyp + oy[b][h] + g.r[1]) * sh.pitch +
                           ox[b][h] + g.r[2];
              shift[b][h] = sb + unsigned(pz[b]) * usz +
                            unsigned(oy[b][h] + g.r[1]) * usy;
              accf[b][2 * h] = accf[b][2 * h + 1] = 0.0f;
              accd[b][2 * h] = accd[b][2 * h + 1] = 0.0;
            }
          const int plane = sh.wyp * sh.pitch;
          for (int jj = 0; jj <= 2 * g.r[0]; ++jj) {
            const double c = cz[jj];
            if (c != 0.0) {  // no tap at this offset otherwise
#pragma unroll
              for (int b = 0; b < PB; ++b)
#pragma unroll
                for (int h = 0; h < NR; ++h) {
                  const int at = base[b][h] + int(shift[b][h] & (V - 1));
#pragma unroll
                  for (int i = 0; i < 2; ++i) {
                    const T v = w[at + i];
                    if constexpr (BF) {
                      accf[b][2 * h + i] = fmaf(float(c), __bfloat162float(v),
                                                accf[b][2 * h + i]);
                    } else {
                      accd[b][2 * h + i] =
                          fma(c, double(v), accd[b][2 * h + i]);
                    }
                  }
                }
            }
#pragma unroll
            for (int b = 0; b < PB; ++b)
#pragma unroll
              for (int h = 0; h < NR; ++h) {
                base[b][h] += plane;
                shift[b][h] += usz;
              }
          }
#pragma unroll
          for (int b = 0; b < PB; ++b)
#pragma unroll
            for (int i = 0; i < NO; ++i)
              sum[b][i] += BF ? accf[b][i] : float(accd[b][i]);
        } else if (axis == 1) {
          // y: D = band^T (A, fragments) . window columns (B). Rows 4 (f64)
          // or 8 (bf16) apart keep their shift (V divides the step).
          const int nk = ksteps(g.r[1], BF, true);
          if constexpr (BF) {
            int r0[PB], r1[PB];
            float d[PB][4];
#pragma unroll
            for (int b = 0; b < PB; ++b) {
              const int zr = pz[b] + g.r[0] + rz, col = x0[b] + gid + g.r[2];
              r0[b] = row_off(sb, zr, y0[b] + 2 * tig) + col;
              r1[b] = row_off(sb, zr, y0[b] + 2 * tig + 1) + col;
              d[b][0] = d[b][1] = d[b][2] = d[b][3] = 0.0f;
            }
            const int eight = 8 * sh.pitch;
            for (int ks = 0; ks < nk; ++ks) {
              const uint4 a =
                  reinterpret_cast<const uint4*>(data)[ks * 32 + lane];
              const int o = ks * 16 * sh.pitch;
#pragma unroll
              for (int b = 0; b < PB; ++b)
                mma_bf16(d[b], a.x, a.y, a.z, a.w,
                         pack_bf16(w[r0[b] + o], w[r1[b] + o]),
                         pack_bf16(w[r0[b] + o + eight],
                                   w[r1[b] + o + eight]));
            }
#pragma unroll
            for (int b = 0; b < PB; ++b)
#pragma unroll
              for (int i = 0; i < 4; ++i) sum[b][i] += d[b][i];
          } else {
            int r0[PB];
            double d0[PB], d1[PB];
#pragma unroll
            for (int b = 0; b < PB; ++b) {
              r0[b] = row_off(sb, pz[b] + g.r[0] + rz, y0[b] + tig) + x0[b] +
                      gid + g.r[2];
              d0[b] = d1[b] = 0.0;
            }
            const double* fd = reinterpret_cast<const double*>(data) + lane;
            const int four = 4 * sh.pitch;
            for (int ks = 0; ks < nk; ++ks) {
              const double a = fd[ks * 32];
#pragma unroll
              for (int b = 0; b < PB; ++b)
                mma_f64(d0[b], d1[b], a, double(w[r0[b] + ks * four]));
            }
#pragma unroll
            for (int b = 0; b < PB; ++b) {
              sum[b][0] += float(d0[b]);
              sum[b][1] += float(d1[b]);
            }
          }
        } else {
          // x: D = window lines (A) . band (B, fragments).
          const int nk = ksteps(g.r[2], BF, false);
          auto line = [&](int b, int m) {
            return sh.line1d ? row_off(sb, 0, 0) + x0[b] + m * SEG
                             : row_off(sb, pz[b] + g.r[0] + rz,
                                       y0[b] + m + g.r[1] + ry) +
                                   x0[b];
          };
          if constexpr (BF) {
            int l0[PB], l1[PB];
            float d[PB][4];
#pragma unroll
            for (int b = 0; b < PB; ++b) {
              l0[b] = line(b, gid) + 2 * tig;
              l1[b] = line(b, gid + 8) + 2 * tig;
              d[b][0] = d[b][1] = d[b][2] = d[b][3] = 0.0f;
            }
            for (int ks = 0; ks < nk; ++ks) {
              const int k0 = 16 * ks;
              const uint2 f2 =
                  reinterpret_cast<const uint2*>(data)[ks * 32 + lane];
#pragma unroll
              for (int b = 0; b < PB; ++b)
                mma_bf16(d[b], pack_bf16(w[l0[b] + k0], w[l0[b] + k0 + 1]),
                         pack_bf16(w[l1[b] + k0], w[l1[b] + k0 + 1]),
                         pack_bf16(w[l0[b] + k0 + 8], w[l0[b] + k0 + 9]),
                         pack_bf16(w[l1[b] + k0 + 8], w[l1[b] + k0 + 9]), f2.x,
                         f2.y);
            }
#pragma unroll
            for (int b = 0; b < PB; ++b)
#pragma unroll
              for (int i = 0; i < 4; ++i) sum[b][i] += d[b][i];
          } else {
            int l0[PB];
            double d0[PB], d1[PB];
#pragma unroll
            for (int b = 0; b < PB; ++b) {
              l0[b] = line(b, gid) + tig;
              d0[b] = d1[b] = 0.0;
            }
            const double* fd = reinterpret_cast<const double*>(data) + lane;
            for (int ks = 0; ks < nk; ++ks) {
              const double f = fd[ks * 32];
#pragma unroll
              for (int b = 0; b < PB; ++b)
                mma_f64(d0[b], d1[b], double(w[l0[b] + 4 * ks]), f);
            }
#pragma unroll
            for (int b = 0; b < PB; ++b) {
              sum[b][0] += float(d0[b]);
              sum[b][1] += float(d1[b]);
            }
          }
        }
      }
      // Store the pairs whose outputs lie in the step.
#pragma unroll
      for (int b = 0; b < PB; ++b) {
        if (!live[b]) continue;
#pragma unroll
        for (int h = 0; h < NR; ++h) {
          if (oy[b][h] >= sh.ty) continue;
          const bool ok0 = ox[b][h] < sh.tx, ok1 = ox[b][h] + 1 < sh.tx;
          if constexpr (KIND == KIND_SELECT) {
            T* o = out + ((long long)cur.m * g.n_out + k) * ofield +
                   (z0 + pz[b]) * osz + (y0t + oy[b][h]) * osy + x0t +
                   ox[b][h];
            if (ok0) o[0] = from_float<T>(sum[b][2 * h]);
            if (ok1) o[1] = from_float<T>(sum[b][2 * h + 1]);
          } else {
            float* to = sums + (size_t(sl) * nf + k) * points +
                        (pz[b] * sh.ty + oy[b][h]) * sh.tx + ox[b][h];
            if (ok0) to[0] = sum[b][2 * h];
            if (ok1) to[1] = sum[b][2 * h + 1];
          }
        }
      }
    }

    if constexpr (KIND != KIND_SELECT) {
      if (k == nf - 1) {
        __syncthreads();  // every field's sums are in
        const SweepPhi<T> ph(prm_row(g, 0));
        const long long obase = (long long)cur.m * g.n_out * ofield;
        const long long abase = (long long)cur.m * g.n_aux * ofield;
        for (int p = tid; p < points; p += nthr) {
          const int x = p % sh.tx, t = p / sh.tx;
          const int y = t % sh.ty, z = t / sh.ty;
          const long long at =
              (z0 + z) * osz + (y0t + y) * osy + x0t + x;
          T d[mhd::N_SLOTS][mhd::N_FIELDS];
#pragma unroll
          for (int s = 0; s < mhd::N_SLOTS; ++s)
#pragma unroll
            for (int kk = 0; kk < mhd::N_FIELDS; ++kk)
              d[s][kk] = from_float<T>(
                  sums[(size_t(s) * mhd::N_FIELDS + kk) * points + p]);
          const T* a = KIND == KIND_MHD_SUBSTEP ? aux + abase + at : nullptr;
          mhd_phi<T, KIND>(d, ph, a, ofield,
                           [&](int j, T v) { out[obase + j * ofield + at] = v; });
        }
      }
    }
    wk.next(cur);
    cur_slot = cur_slot + 1 == NS ? 0 : cur_slot + 1;
  }
}

}  // namespace tc
}  // namespace stencil
