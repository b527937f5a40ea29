// The body of the depth-1 stream kernel (fused_stencil_stream.cu at
// fuse_steps 1): a ring of planes per field filled chunks ahead by 16-byte
// cp.async, every plane read in the slot it landed in, several outputs
// per thread from a tap table built once per block, and the MHD phi's
// inputs in shared memory.
//
// Design, on an H100 (132 SMs, 228 KB of shared memory each; 3.35 TB/s).
// Diffusion is bound by bytes, the MHD RHS by operations. What held the
// one-buffer body back (PERF.md section 6) was its chunk's fixed
// cost: one chunk in flight and none during the copy of the fresh planes
// behind the carried halo, that copy and the carry copy (one shared load
// and store per element each, 3 barriers a chunk), 4-byte staging, and
// one output per thread with a division per point. The parts below cut
// those.
// - A ring of planes. A block walks one column (member, stream segment,
//   cross tile) chunk by chunk, as the reference's grid step does. Each
//   field's planes go to a ring of P plane slots, plane j of the segment
//   (its padded planes from the segment's first) to slot j mod P, so the
//   2h0 planes a chunk shares with the next stay where they landed: no
//   copy of the carried halo and none of the fresh planes. P holds the
//   chunks resident at once (g.n_buf of them, the first with its 2h0
//   leading planes): P >= n_buf tau0 + 2h0.
// - Reading planes where they land. A window of chunk i starts at slot
//   (i tau0) mod P and may wrap past the ring's end, so a tap's offset
//   depends on the slot of the point's own plane q: the tap table holds
//   one row per slot, tap (dz, dy, dx) at ((q + dz) mod P - q) plane + dy
//   pitch + dx. A point reads each tap at its centre plus that offset,
//   the same one load and add as a linear window, with no modulo in the
//   tap loop. (A mirrored ring, the first 2h0 slots copied again past its
//   end, would keep one row but take 2h0 planes more per field; the MHD
//   kind's eight fields then no longer fit beside phi's inputs.)
// - Staging. Rows and plane slots are congruent to the padded field's
//   modulo 16 bytes, as in swc_body.cuh (P plane is a multiple of 16 bytes
//   too, so that a plane keeps its alignment in every pass of the ring):
//   every global 16 bytes land on 16 shared bytes with one cp.async.
//   Select fetches chunk i + n_buf - 1 after the barrier that starts
//   chunk i (n_buf - 1 chunks in flight while one is read); MHD fetches
//   chunk i + n_buf after its sums of chunk i, so the fetch runs beside
//   phi, which reads no plane.
// - Several outputs per thread. Warp w of a round takes a run of 32 U
//   points, lane l points l + 32 i (i < U): neighbouring lanes read
//   neighbouring addresses, and since a plane's points ty tx are a
//   multiple of 32 U (the planner takes U so, the launch refuses other
//   tiles) a run lies in one plane, a thread's U points share one tap
//   row, and each tap is read once for U multiply-adds. Points are split
//   into (z, y, x) by a multiply (FastDiv), not a division.
// - Order of arithmetic: each operator sums its taps in table order from
//   zero, one FMA per tap, as the one-buffer body's apply_op did, so the
//   outputs are its outputs bit for bit, and a member of a batched launch
//   is its unbatched launch bit for bit.
// - MHD (f32). The chunk is one plane (tau0 = 1). A thread takes one
//   (field, point) item of the chunk at a time (512 threads: two fields of
//   a 256-point plane a round, a warp within one field), evaluates the
//   (slot, field) pairs phi reads (mhd::fields_read) one at a time into a
//   shared tile of n_slots x n_f values per point, then one thread per
//   point runs phi, as swc_body.cuh does.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "persistent.cuh"
#include "phi_mhd.cuh"
#include "stencil_common.cuh"
#include "stencil_sweep.cuh"
#include "swc_body.cuh"

namespace stencil {
namespace stream {

// Threads a block of the depth-1 stream kernel takes at most, and the
// blocks an SM's registers must allow (__launch_bounds__; both 128
// registers a thread; plan.py:STREAM_THREADS): select 256 x 2, MHD 512 x
// 1 (phi takes ~120 registers, and the tap loop wants 16 warps an SM).
template <int KIND>
__host__ __device__ constexpr int max_threads() {
  return KIND == KIND_SELECT ? 256 : 512;
}
template <int KIND>
__host__ __device__ constexpr int min_blocks() {
  return KIND == KIND_SELECT ? 2 : 1;
}

// Whether the body is built for U outputs a thread per round of the kind
// (plan.py:STREAM_OUTPUTS picks one): select 1, 2 or 4, each tap read
// once for U multiply-adds; MHD 1 (phi runs one thread per point).
template <int KIND>
__host__ __device__ constexpr bool built_for(int u) {
  return KIND == KIND_SELECT ? (u == 1 || u == 2 || u == 4) : u == 1;
}

// The ring (plan.py:stream_ring mirrors it). Element index of plane slot
// s, window row y, column x of field k: k fstride + s0 + s plane + y pitch
// + x, s0 the column's global start offset within its 16 bytes.
struct Ring {
  int tz, ty, tx;     // chunk (tau0) and cross tile
  int wy, wx;         // the cross window
  int lead;           // planes of the carried halo, 2 h0
  int pitch, plane;   // buffer elements per row and per plane slot
  int period;         // P, plane slots
  int fstride;        // elements per field
};

template <typename T>
__host__ __device__ inline Ring ring_shape(const Geometry& g) {
  constexpr int V = 16 / sizeof(T);
  Ring s;
  s.tz = g.t[0];
  s.ty = g.t[1];
  s.tx = g.t[2];
  s.wy = s.ty + 2 * g.r[1];
  s.wx = s.tx + 2 * g.r[2];
  s.lead = 2 * g.r[0];
  s.pitch = swc::congruent_up(s.wx + V - 1, g.p[2] % V, V);
  const long long psz = (long long)g.p[1] * g.p[2];
  s.plane = swc::congruent_up(s.wy * s.pitch, int(psz % V), V);
  int period = g.n_buf * s.tz + s.lead;
  while ((long long)period * s.plane % V) ++period;
  s.period = period;
  const int elems = V * cdiv(V - 1 + (period - 1) * s.plane +
                                 (s.wy - 1) * s.pitch + s.wx,
                             V);
  s.fstride = swc::congruent_up(elems, int(psz * g.p[0] % V), V);
  return s;
}

// Byte offsets of the shared memory: the ring (all fields) | the tap table
// (one row per plane slot) | the operator starts | (MHD, from a 16-byte
// boundary) phi's inputs, n_slots x n_f values of T per point of a chunk.
// plan.py:stream_ring_smem_bytes mirrors it.
struct Layout {
  size_t taps, starts, sums, total;
};

template <typename T>
__host__ __device__ inline Layout ring_layout(const Geometry& g) {
  const Ring s = ring_shape<T>(g);
  Layout L;
  L.taps = round_up16(size_t(g.n_f) * s.fstride * sizeof(T));
  L.starts = L.taps + size_t(s.period) * g.n_taps * sizeof(Tap<T>);
  L.total = L.starts + size_t(g.n_ops + 1) * sizeof(int);
  L.sums = L.total;
  if (g.n_slots > 1) {
    L.sums = round_up16(L.total);
    L.total = L.sums + size_t(g.n_slots) * g.n_f * s.tz * s.ty * s.tx *
                           sizeof(T);
  }
  return L;
}

// Wait until at most `lag` (0-2) of the newest cp.async groups are in
// flight.
__device__ __forceinline__ void wait_lag(int lag) {
  if (lag >= 2) {
    cp_async_wait<2>();
  } else if (lag == 1) {
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
}

template <typename T, int KIND, int U>
__device__ __forceinline__ void stream_body(
    const T* __restrict__ f, T* __restrict__ out,
    const int* __restrict__ tap_off, const double* __restrict__ tap_coef,
    const int* __restrict__ op_start, const Geometry& g,
    unsigned char* smem) {
  constexpr int V = 16 / sizeof(T);
  constexpr bool kSelect = KIND == KIND_SELECT;
  const Ring sh = ring_shape<T>(g);
  const Layout L = ring_layout<T>(g);
  T* ring = reinterpret_cast<T*>(smem);
  Tap<T>* taps = reinterpret_cast<Tap<T>*>(smem + L.taps);
  int* start = reinterpret_cast<int*>(smem + L.starts);
  T* sums = reinterpret_cast<T*>(smem + L.sums);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int P = sh.period, nt = g.n_taps;

  // The tap table, once per block: row q for a point whose plane sits in
  // slot q, each coefficient cast to T (before any multiply, as the
  // reference casts it) beside its offset.
  // Rank 2 runs lifted to (Y, 1, X) while the tap table keeps its (0, dy,
  // dx) offsets: with no radius along the kernel's y, a tap's y offset is
  // its offset along the stream axis.
  for (int i = tid; i < P * nt; i += nthr) {
    const int q = i / nt, t = i - q * nt;
    int dz = tap_off[3 * t], dy = tap_off[3 * t + 1];
    if (g.r[1] == 0) {
      dz += dy;
      dy = 0;
    }
    int zq = q + dz;
    zq += zq < 0 ? P : 0;
    zq -= zq >= P ? P : 0;
    taps[i].coef = cast_coef<T>(tap_coef[t]);
    taps[i].offset =
        (zq - q) * sh.plane + dy * sh.pitch + tap_off[3 * t + 2];
  }
  for (int i = tid; i <= g.n_ops; i += nthr) start[i] = op_start[i];

  const long long psy = g.p[2], psz = psy * g.p[1], pfield = psz * g.p[0];
  const long long osy = g.n[2], osz = osy * g.n[1], ofield = osz * g.n[0];
  const unsigned usz = unsigned(psz), usy = unsigned(psy),
                 uf = unsigned(pfield);
  // This block's column: the member (blockIdx.z = member x segments +
  // segment), the cross tile, and the segment's chunks; its window starts
  // at padded plane first tau0.
  const MemberZ mz = member_z(g);
  const int nf = g.n_f;
  const int chunks = g.n[0] / (sh.tz * g.n_seg);
  const int first = mz.z * chunks;
  const long long y0 = (long long)blockIdx.y * sh.ty;
  const long long x0 = (long long)blockIdx.x * sh.tx;
  const T* column = f + (long long)mz.member * nf * pfield +
                    (long long)first * sh.tz * psz + y0 * psy + x0;
  const unsigned sb = unsigned(reinterpret_cast<uintptr_t>(column) /
                               sizeof(T));
  const int s0 = int(sb & (V - 1));

  // Staging: planes [j0, j0 + np) of the segment, every field, plane j to
  // slot j mod P. Window row (j, y) of field k starts a elements into its
  // first 16 bytes and at ring element b = k fstride + s0 + slot plane + y
  // pitch (b = a mod V); its chunk q is the 16 bytes at q V - a of the
  // row, copied to b - a + q V.
  const int cq = cdiv(sh.wx + V - 1, V);  // most chunks a row covers
  const FastDiv by_cq(cq), by_wy(sh.wy);
  auto fetch = [&](int j0, int np) {
    const int slot0 = j0 % P;
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
  // Chunk i's planes not yet fetched: the first brings the 2h0 leading
  // ones too.
  auto fetch_chunk = [&](int i) {
    if (i == 0) {
      fetch(0, sh.tz + sh.lead);
    } else {
      fetch(i * sh.tz + sh.lead, sh.tz);
    }
  };

  // The points of a round: warp w takes the run p0 + 32 U w, lane l its
  // points l + 32 i (i < U).
  const int points = sh.tz * sh.ty * sh.tx;
  const int per_round = nthr * U;
  const int lane = tid & 31, run = (tid >> 5) * 32 * U;
  const FastDiv by_tx(sh.tx), by_ty(sh.ty), by_pts(points);
  const long long obase = (long long)mz.member * g.n_out * ofield;

  // Chunks fetched before the first is read: select n_buf - 1 (the last
  // one's fetch waits for the first barrier), MHD n_buf.
  const int NB = g.n_buf;
  const int ahead = kSelect ? NB - 1 : NB;
  for (int i = 0; i < ahead; ++i) {
    if (i < chunks) fetch_chunk(i);
    cp_async_commit();
  }
  int wslot = 0;  // slot of chunk i's first window plane, (i tau0) mod P
  for (int i = 0; i < chunks; ++i) {
    wait_lag(ahead - 1);  // chunk i has landed, later ones may not
    __syncthreads();  // ... for every thread; chunk i - 1 is read
    if (kSelect) {
      if (i + NB - 1 < chunks) fetch_chunk(i + NB - 1);
      cp_async_commit();
    }
    const long long zc = (long long)(first + i) * sh.tz;  // interior plane
    // Where point pp of the chunk sits: its centre in the ring (field 0)
    // and the first tap of its tap row.
    auto locate = [&](int pp, int& cen, int& row) {
      const int t = by_tx(pp), x = pp - t * sh.tx;
      const int z = by_ty(t), y = t - z * sh.ty;
      int q = wslot + z + g.r[0];
      q -= q >= P ? P : 0;
      cen = s0 + q * sh.plane + (y + g.r[1]) * sh.pitch + x + g.r[2];
      row = q * nt;
      return z * int(osz) + y * int(osy) + x;  // its offset in the output
    };
    if constexpr (kSelect) {
      for (int k = 0; k < nf; ++k) {
        const T* __restrict__ w = ring + k * sh.fstride;
        T* o = out + obase + k * ofield + zc * osz + y0 * osy + x0;
        for (int p0 = 0; p0 < points; p0 += per_round) {
          // Output u of this thread: its centre and its offset in the
          // output field, and the tap row they share; a point past the
          // chunk repeats the last one and is not stored (with U > 1 a
          // whole run is in the chunk or past it).
          int cen[U], at[U], row = 0;
          bool live[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int p = p0 + run + lane + 32 * u;
            live[u] = p < points;
            at[u] = locate(live[u] ? p : points - 1, cen[u], row);
          }
          // out[k] = op_slot0(f[k]): its taps, in table order, into U sums,
          // one tap read for U multiply-adds.
          T acc[U];
#pragma unroll
          for (int u = 0; u < U; ++u) acc[u] = T(0);
          const Tap<T>* __restrict__ r0 = taps + row;
          const int e = start[g.slot[0] + 1];
#pragma unroll 4
          for (int t = start[g.slot[0]]; t < e; ++t) {
            const Tap<T> tap = r0[t];
#pragma unroll
            for (int u = 0; u < U; ++u)
              acc[u] = swc::mac(tap.coef, w[cen[u] + tap.offset], acc[u]);
          }
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (live[u]) o[at[u]] = acc[u];
        }
      }
    } else {
      // One (field, point) item a thread: each slot phi reads on the
      // field, one at a time, into the tile.
      const int items = nf * points;
      for (int i0 = 0; i0 < items; i0 += nthr) {
        const int it = i0 + tid;
        const bool live = it < items;
        const int ii = live ? it : items - 1;
        const int k = by_pts(ii), pp = ii - k * points;
        int cen, row;
        locate(pp, cen, row);
        const T* __restrict__ w = ring + k * sh.fstride;
        const Tap<T>* __restrict__ r0 = taps + row;
        for (int sl = 0; sl < mhd::N_SLOTS; ++sl) {
          if (!((mhd::fields_read(sl, KIND == KIND_MHD_SUBSTEP) >> k) & 1u))
            continue;
          const int op = g.slot[sl];
          T acc = T(0);
          const int e = start[op + 1];
#pragma unroll 4
          for (int t = start[op]; t < e; ++t) {
            const Tap<T> tap = r0[t];
            acc = swc::mac(tap.coef, w[cen + tap.offset], acc);
          }
          if (live) sums[(size_t(sl) * nf + k) * points + pp] = acc;
        }
      }
    }
    if constexpr (!kSelect) {
      __syncthreads();  // every field's sums are in; no plane of i is read
      if (i + NB < chunks) fetch_chunk(i + NB);
      cp_async_commit();
      const SweepPhi<T> ph(prm_row(g, 0));
      T* o = out + obase + zc * osz + y0 * osy + x0;
      for (int p = tid; p < points; p += nthr) {
        const int t = by_tx(p), x = p - t * sh.tx;
        const int z = by_ty(t), y = t - z * sh.ty;
        const long long at = z * osz + y * osy + x;
        // (The loads of the pairs phi does not read are never made.)
        T d[mhd::N_SLOTS][mhd::N_FIELDS];
#pragma unroll
        for (int s = 0; s < mhd::N_SLOTS; ++s)
#pragma unroll
          for (int kk = 0; kk < mhd::N_FIELDS; ++kk)
            d[s][kk] = sums[(size_t(s) * mhd::N_FIELDS + kk) * points + p];
        mhd_phi<T, KIND>(d, ph, nullptr, ofield,
                         [&](int j, T v) { o[j * ofield + at] = v; });
      }
    }
    wslot += sh.tz;
    wslot -= wslot >= P ? P : 0;
  }
}

}  // namespace stream
}  // namespace stencil
