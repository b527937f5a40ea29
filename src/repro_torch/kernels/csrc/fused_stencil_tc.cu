// Fused stencil phi(A.B) with the derivatives as banded contractions on
// the tensor cores ("tc"), any temporal depth S, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/emit.py:_kernel_tc (line 233)
// with _block_derivs_tc (line 153), _tc_band (line 123) and _contract
// (line 98), launched by fused_stencil_pallas through pl.pallas_call
// (line 565); at depth S > 1 the reference runs _kernel_temporal with
// derivs_fn=_block_derivs_tc (emit.py:549-554).
//
// Two bodies. Depth 1 is tc_body.cuh: persistent blocks walking the
// output tiles with windows in flight, the band as ready MMA fragments,
// operator sums in registers (its header says how and why). Depth S > 1
// runs the sweeps of temporal_body.cuh, shared with
// fused_stencil_temporal.cu, with the tensor-core evaluator TcEval below
// in place of the tap table.
//
// What both compute. The taps of every operator are split as the
// reference's tc_axis_groups splits them (repro_torch/kernels/plan.py,
// the wrapper hands over the groups in sorted (axis, rest) order): a
// group gathers the taps whose last nonzero offset axis is `axis`, the
// other offsets being `rest`. A group of several taps is a banded
// contraction along its axis, accumulated in f32 with the band in the
// field type (as _tc_band builds it); a lone tap is (c in T) x value,
// rounded in T, then widened to f32. Groups are summed in f32 in sorted
// order and the sum is cast to T once per operator, then phi runs.
// - bf16: mma.sync.m16n8k16 bf16 x bf16 -> f32.
// - f32: not TF32, which keeps about three digits against the
//   reference's f32 tolerance of 2e-5 (tests/test_tc.py:66). The f32
//   operands are widened to f64 and contracted with mma.sync.m8n8k4.f64:
//   every product of two f32 values is exact in f64 and the sum is
//   rounded to f32 once per group, closer to the exact sum than the plain
//   f32 version (chip_smoke.py prints the error).
//
// TcEval (depth > 1). Every contraction is cut into 8-wide output
// segments along its axis, the n of mma.sync, and all segments share one
// band B[k][n] = c[k - n] (k - n in [0, 2r], else 0) of 8 + 2r rows,
// contracted in ceil((8 + 2r) / 16) bf16 or ceil((8 + 2r) / 4) f64
// k-steps, generated in registers from the group's 2r + 1 coefficients.
// The rows of an MMA are row-segments: (position on the other two axes,
// segment) pairs taken in order. Window values beyond a row's 8 + 2r, or
// past the staged extent, are masked to zero, and a masked output is never
// stored. Each warp owns the same row-segment tiles for every group of one
// axis and sums those groups in registers; the block writes the
// per-operator f32 sums into a shared-memory tile between axes and phi's
// thread reads its point's slots from it. MHD takes its points in batches
// of one per thread, each batch's planes contracted per field.
//
// Bound on an H100 SXM: 3.35 TB/s; tensor cores 989 TFLOP/s bf16, 67
// TFLOP/s f64. Diffusion is bound by bytes, the MHD RHS by operations.
// plan.tc_issued_macs counts the band's multiply-adds the MMAs issue
// against the taps'.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "phi_mhd.cuh"
#include "stencil_common.cuh"
#include "stencil_sweep.cuh"
#include "tc_body.cuh"
#include "temporal_body.cuh"

namespace {

using namespace stencil;
using namespace stencil::tc;

// The wrapper's group table (repro_torch/kernels/emit.py:tc_table): per
// group ENT_LEN ints (axis lifted to rank 3: 0 z, 1 y, 2 x; the rest
// offsets z, y, x; 1 for a lone tap; its offset along the axis) and
// Geometry::coef_len (2 r_max + 1) doubles c[j + r], j = -r..r, r the
// group axis's radius; per operator the start of its groups (ENT_LEN and
// the E_* columns are tc_body.cuh's).

// Points of the f32 sum tiles, per operator slot: sweep 0's region for
// select (its fields are contracted whole), one batch of n_thr points
// and the two planes it may straddle for MHD.
__host__ __device__ inline int acc_points(const Geometry& g) {
  const Box r0 = region(g, 0);
  if (g.n_slots == 1) return r0.size();
  const int cap = g.n_thr + 2 * r0.y * r0.x;
  return cap < r0.size() ? cap : r0.size();
}

// One row-segment of a contraction along axis a: its first window index
// (the segment's first k), how many k it may read, and its first output.
struct RowSeg {
  bool valid;
  int base;   // source index of k = 0 (rest offsets not added)
  int kmax;   // k < kmax is inside the band and the staged extent
  int seg0;   // axis-a coordinate of output n = 0
  int local;  // box index of output n = 0
};

// The tensor-core derivative evaluator (see stencil_sweep.cuh for the
// interface). T is float (f64 MMA) or __nv_bfloat16 (bf16 MMA).
template <typename T>
struct TcEval {
  static constexpr bool kCooperative = true;
  static constexpr bool kF64 = sizeof(T) == 4;
  static constexpr int ROWS = kF64 ? 8 : 16;  // row-segments per MMA tile
  const int* __restrict__ ent;
  const double* __restrict__ coef;
  const int* __restrict__ estart;
  float* acc;  // n_slots x cap f32 sums
  int cap;
  int axes;  // bit a: some slot's operator has a group on axis a

  __host__ __device__ static size_t smem_bytes(const Geometry& g) {
    return size_t(g.n_slots) * acc_points(g) * sizeof(float);
  }

  __device__ TcEval(const Geometry& g, unsigned char* smem, const int* e,
                    const double* c, const int* s, int, int)
      : ent(e), coef(c), estart(s), acc(reinterpret_cast<float*>(smem)),
        cap(acc_points(g)), axes(0) {
    for (int sl = 0; sl < g.n_slots; ++sl) {
      const int op = g.slot[sl];
      for (int i = __ldg(estart + op); i < __ldg(estart + op + 1); ++i)
        axes |= 1 << __ldg(ent + i * ENT_LEN + E_AXIS);
    }
  }

  __device__ void set_source(const Box&, int, int) const {
    __syncthreads();  // the previous sweep's fields are written
  }
  __device__ void done() const {
    __syncthreads();  // every thread has read the sums
  }
  __device__ T value(const Geometry&, int sl, const T*, int,
                     int local) const {
    return from_float<T>(acc[sl * cap + local]);
  }

  // The f32 sums of every slot's operator at every point of planes
  // [zlo, zhi] of region rb, from one field `fld` of extents src whose
  // first plane is region plane zsrc - r. Ends with the sums visible to
  // the block.
  __device__ void prepare(const Geometry& g, const T* __restrict__ fld,
                          const Box& src, const Box& rb, int zlo, int zhi,
                          int zsrc, int tid, int nthr) const {
    const int ext[3] = {zhi - zlo + 1, rb.y, rb.x};
    const int sstr[3] = {src.y * src.x, src.x, 1};
    const int ostr[3] = {rb.y * rb.x, rb.x, 1};
    const int zoff = zlo - zsrc;
    const int warp = tid >> 5, nwarp = nthr >> 5;
    const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
    for (int a = 0; a < 3; ++a) {
      if (!(axes >> a & 1)) continue;
      const int b = a == 0 ? 1 : 0;
      const int c = a == 2 ? 1 : 2;
      const int ta = ext[a], ra = g.r[a];
      const int nseg = (ta + SEG - 1) / SEG;
      const int nrs = nseg * ext[b] * ext[c];
      auto rowseg = [&](int q) {
        RowSeg s;
        s.valid = q < nrs;
        const int qq = s.valid ? q : 0;
        const int seg = qq % nseg, row = qq / nseg;
        const int pb = row / ext[c], pc = row - (row / ext[c]) * ext[c];
        int src_c[3], out_c[3];
        src_c[a] = seg * SEG + (a == 0 ? zoff : 0);
        src_c[b] = pb + g.r[b] + (b == 0 ? zoff : 0);
        src_c[c] = pc + g.r[c];
        out_c[a] = seg * SEG;
        out_c[b] = pb;
        out_c[c] = pc;
        s.base = src_c[0] * sstr[0] + src_c[1] * sstr[1] + src_c[2];
        s.local = out_c[0] * ostr[0] + out_c[1] * ostr[1] + out_c[2];
        s.seg0 = seg * SEG;
        const int band = SEG + 2 * ra, left = ta + 2 * ra - seg * SEG;
        s.kmax = band < left ? band : left;
        return s;
      };
      for (int ti = warp; ti * ROWS < nrs; ti += nwarp) {
        // This lane's A rows and C outputs: rows gid (and gid + 8 in
        // bf16), outputs n = 2 tig, 2 tig + 1 of each.
        RowSeg rs[ROWS / 8];
#pragma unroll
        for (int h = 0; h < ROWS / 8; ++h)
          rs[h] = rowseg(ti * ROWS + gid + 8 * h);
        int loc[ROWS / 4];
        bool ok[ROWS / 4];
#pragma unroll
        for (int i = 0; i < ROWS / 4; ++i) {
          const RowSeg& r = rs[i >> 1];
          const int n = 2 * tig + (i & 1);
          ok[i] = r.valid && r.seg0 + n < ta;
          loc[i] = r.local + n * ostr[a];
        }
        for (int sl = 0; sl < g.n_slots; ++sl) {
          const int op = g.slot[sl];
          const int eb = __ldg(estart + op), ee = __ldg(estart + op + 1);
          bool any = false;
          for (int e = eb; e < ee; ++e)
            any |= __ldg(ent + e * ENT_LEN + E_AXIS) == a;
          if (!any) continue;
          float* out = acc + sl * cap;
          const bool first = __ldg(ent + eb * ENT_LEN + E_AXIS) == a;
          float sum[ROWS / 4];
#pragma unroll
          for (int i = 0; i < ROWS / 4; ++i)
            sum[i] = (!first && ok[i]) ? out[loc[i]] : 0.0f;
          for (int e = eb; e < ee; ++e) {
            const int* en = ent + e * ENT_LEN;
            if (__ldg(en + E_AXIS) != a) continue;
            const int roff = __ldg(en + E_REST) * sstr[0] +
                             __ldg(en + E_REST + 1) * sstr[1] +
                             __ldg(en + E_REST + 2);
            const double* cf = coef + e * g.coef_len;
            if (__ldg(en + E_SINGLE)) {
              // A lone tap: (c in T) x value, rounded in T, widened.
              const T cj = cast_coef<T>(__ldg(cf + __ldg(en + E_J) + ra));
              const int jo = roff + (__ldg(en + E_J) + ra) * sstr[a];
#pragma unroll
              for (int i = 0; i < ROWS / 4; ++i) {
                const int n = 2 * tig + (i & 1);
                if (ok[i]) {
                  const T v = fld[rs[i >> 1].base + jo + n * sstr[a]];
                  if constexpr (kF64) {
                    sum[i] += __fmul_rn(cj, v);  // rounded before the add
                  } else {
                    sum[i] += __bfloat162float(bf16_mul(cj, v));
                  }
                }
              }
            } else {
              contract(fld, rs, roff, sstr[a], ra, cf, gid, tig, sum);
            }
          }
#pragma unroll
          for (int i = 0; i < ROWS / 4; ++i)
            if (ok[i]) out[loc[i]] = sum[i];
        }
      }
      __syncthreads();  // this axis's sums are written for the next
    }
  }

  // One multi-tap group on one MMA tile: sum[i] += the banded
  // contraction at this lane's outputs, the product summed in f32 (bf16)
  // or f64 (f32 fields) and added to sum[i] once.
  __device__ __forceinline__ void contract(const T* __restrict__ fld,
                                           const RowSeg (&rs)[ROWS / 8],
                                           int roff, int sa, int ra,
                                           const double* __restrict__ cf,
                                           int gid, int tig,
                                           float (&sum)[ROWS / 4]) const {
    const int top = 2 * ra;  // band index k - n runs over [0, 2r]
    if constexpr (kF64) {
      // A[m][k] = window(row m, k), B[k][n] = c[k - n]; k-blocks of 4.
      const RowSeg& r = rs[0];
      double d0 = 0.0, d1 = 0.0;
      const int nkb = (SEG + top + 3) / 4;
      for (int kb = 0; kb < nkb; ++kb) {
        const int k = 4 * kb + tig;
        const double av =
            (r.valid && k < r.kmax) ? double(fld[r.base + roff + k * sa]) : 0.0;
        const int j = k - gid;
        const double bv = (j >= 0 && j <= top)
                              ? double(cast_coef<float>(__ldg(cf + j)))
                              : 0.0;
        mma_f64(d0, d1, av, bv);
      }
      sum[0] += float(d0);
      sum[1] += float(d1);
    } else {
      auto a_at = [&](const RowSeg& r, int k) {
        return (r.valid && k < r.kmax) ? fld[r.base + roff + k * sa]
                                       : __float2bfloat16(0.0f);
      };
      auto b_at = [&](int k) {
        const int j = k - gid;
        return (j >= 0 && j <= top) ? cast_coef<__nv_bfloat16>(__ldg(cf + j))
                                    : __float2bfloat16(0.0f);
      };
      // k-steps of 16 over the band's 8 + 2r rows (one for r <= 4).
      const int nks = (SEG + top + 15) / 16;
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int ks = 0; ks < nks; ++ks) {
        const int k0 = 16 * ks + 2 * tig;
        const uint32_t av[4] = {
            pack_bf16(a_at(rs[0], k0), a_at(rs[0], k0 + 1)),
            pack_bf16(a_at(rs[1], k0), a_at(rs[1], k0 + 1)),
            pack_bf16(a_at(rs[0], k0 + 8), a_at(rs[0], k0 + 9)),
            pack_bf16(a_at(rs[1], k0 + 8), a_at(rs[1], k0 + 9)),
        };
        mma_bf16(d, av[0], av[1], av[2], av[3],
                 pack_bf16(b_at(k0), b_at(k0 + 1)),
                 pack_bf16(b_at(k0 + 8), b_at(k0 + 9)));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[i] += d[i];
    }
  }
};

template <typename T, int KIND>
__global__ void __launch_bounds__(KIND == KIND_SELECT ? 1024 : 256, 1)
    tc_kernel(const T* __restrict__ f, const T* __restrict__ aux,
              T* __restrict__ out, const int* __restrict__ ent,
              const double* __restrict__ coef,
              const int* __restrict__ estart,
              const __grid_constant__ Geometry g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  temporal_body<T, KIND, TcEval<T>>(f, aux, out, ent, coef, estart, g,
                                    smem_raw);
}

// Depth 1: persistent blocks (tc_body.cuh). select runs 8 warps with at
// most 128 registers (two blocks resident per SM at least); MHD 16 warps,
// one block per SM holding 512 points' phi inputs.
template <typename T, int KIND>
__global__ void __launch_bounds__(
    KIND == KIND_SELECT ? THREADS_SELECT : THREADS_MHD,
    KIND == KIND_SELECT ? 2 : 1)
    tc_d1_kernel(const T* __restrict__ f, const T* __restrict__ aux,
                 T* __restrict__ out, const int* __restrict__ table,
                 const __grid_constant__ Geometry g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tc_body<T, KIND>(f, aux, out, table, g, smem_raw);
}

template <typename T, int KIND>
cudaError_t launch(const void* f, const void* aux, void* out,
                   const void* ent, const void* coef, const void* estart,
                   Geometry g, cudaStream_t stream) {
  const size_t smem = temporal_layout<T, TcEval<T>>(g).total;
  auto kernel = tc_kernel<T, KIND>;
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
      static_cast<T*>(out), static_cast<const int*>(ent),
      static_cast<const double*>(coef), static_cast<const int*>(estart), g);
  return cudaGetLastError();
}

// The depth-1 grid: the kernel's resident blocks per SM (the occupancy of
// its registers, threads and shared memory) times the SMs, at most the
// steps of the launch. Also sets the kernel's
// dynamic shared-memory limit, which the occupancy needs.
template <typename T, int KIND>
cudaError_t d1_grid(const Geometry& g, int device, long long& grid) {
  auto kernel = tc_d1_kernel<T, KIND>;
  const size_t smem = tc_layout<T>(g).total;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const Shape s = tc_shape<T>(g);
  const long long items = (long long)(g.n[2] / s.tx) * (g.n[1] / s.ty) *
                          (g.n[0] / s.tz) * g.n_b;
  // The occupancy and the SM count per (device, shared memory), cached:
  // a serving loop launches the same shapes again and again.
  static int last_dev = -1, last_per_sm = 0, last_sms = 0;
  static size_t last_smem = 0;
  if (device != last_dev || smem != last_smem) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        g.n_thr, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    last_dev = device;
    last_smem = smem;
    last_per_sm = per_sm;
    last_sms = sms;
  }
  const long long full = (long long)last_per_sm * last_sms;
  grid = items < full ? items : full;
  if (grid < 1) grid = 1;
  return cudaSuccess;
}

template <typename T, int KIND>
cudaError_t launch_d1(const void* f, const void* aux, void* out,
                      const void* table, Geometry g, int device,
                      cudaStream_t stream) {
  long long grid = 0;
  const cudaError_t err = d1_grid<T, KIND>(g, device, grid);
  if (err != cudaSuccess) return err;
  const size_t smem = tc_layout<T>(g).total;
  tc_d1_kernel<T, KIND><<<unsigned(grid), g.n_thr, smem, stream>>>(
      static_cast<const T*>(f), static_cast<const T*>(aux),
      static_cast<T*>(out), static_cast<const int*>(table), g);
  return cudaGetLastError();
}

bool valid_tc(const Geometry& g, int kind) {
  for (int a = 0; a < 3; ++a)
    if (2 * g.r[a] + 1 > g.coef_len) return false;  // a band row per group
  if ((kind == KIND_SELECT) != (g.n_slots == 1) || g.unroll != 1)
    return false;
  if (g.fuse_steps == 1) {
    const int tx = g.t[2] * g.tps;
    return (g.n_buf == 2 || g.n_buf == 3) && g.tps >= 1 && tx > 0 &&
           g.n[2] % tx == 0 && g.table_words >= 0 &&
           g.n_thr == (kind == KIND_SELECT ? THREADS_SELECT : THREADS_MHD) &&
           (kind == KIND_SELECT ||
            (g.n_f == mhd::N_FIELDS && g.n_slots == mhd::N_SLOTS));
  }
  return g.n_buf >= 1 && g.n_buf <= 2 && g.n_thr >= 32 &&
         g.n_thr % 32 == 0 && g.n_thr <= (kind == KIND_SELECT ? 1024 : 256);
}

// One launch (grid == nullptr) or one depth-1 grid query of (kind,
// dtype): f64 is not a tc type, and bf16 MHD waits for ROADMAP B4b.
template <typename T, int KIND>
cudaError_t run(const void* f, const void* aux, void* out, const void* ent,
                const void* coef, const void* estart, const void* table,
                const Geometry& g, int device, cudaStream_t stream,
                long long* grid) {
  if (grid) return d1_grid<T, KIND>(g, device, *grid);
  if (g.fuse_steps == 1)
    return launch_d1<T, KIND>(f, aux, out, table, g, device, stream);
  return launch<T, KIND>(f, aux, out, ent, coef, estart, g, stream);
}

cudaError_t dispatch(int kind, int dtype, const void* f, const void* aux,
                     void* out, const void* ent, const void* coef,
                     const void* estart, const void* table, const Geometry& g,
                     int device, cudaStream_t stream, long long* grid) {
  switch (kind * 3 + dtype) {
    case KIND_SELECT * 3 + DTYPE_F32:
      return run<float, KIND_SELECT>(f, aux, out, ent, coef, estart, table, g,
                                     device, stream, grid);
    case KIND_SELECT * 3 + DTYPE_BF16:
      return run<__nv_bfloat16, KIND_SELECT>(f, aux, out, ent, coef, estart,
                                             table, g, device, stream, grid);
    case KIND_MHD_RHS * 3 + DTYPE_F32:
      return run<float, KIND_MHD_RHS>(f, aux, out, ent, coef, estart, table,
                                      g, device, stream, grid);
    case KIND_MHD_SUBSTEP * 3 + DTYPE_F32:
      return run<float, KIND_MHD_SUBSTEP>(f, aux, out, ent, coef, estart,
                                          table, g, device, stream, grid);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch the tc kernel on `stream`. `tap_off`, `tap_coef`, `op_start` and
// `table` carry the group table (emit.py:tc_table: group ints, band
// coefficients, operator starts; depth 1 reads `table` alone, the starts,
// group ints and each group's data, the band's MMA fragments among
// them); `geom` (G_LEN
// ints) is a host array; every other pointer, `params` (fuse_steps rows
// of n_params doubles) included, is device memory. `dtype` is DTYPE_F32
// or DTYPE_BF16 (select only). Returns the cudaError_t of the launch (0
// on success).
int repro_fused_stencil_tc(const void* f, const void* aux, void* out,
                           const void* tap_off, const void* tap_coef,
                           const void* op_start, const void* table,
                           const int* geom, const double* params,
                           int n_params, int kind, int dtype, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  Geometry g;
  if (!read_geometry(geom, params, n_params, g) || !valid_tc(g, kind))
    return int(cudaErrorInvalidValue);
  return int(dispatch(kind, dtype, f, aux, out, tap_off, tap_coef, op_start,
                      table, g, device, static_cast<cudaStream_t>(stream),
                      nullptr));
}

// The blocks a depth-1 launch of `geom` takes (d1_grid), or a negative
// cudaError_t.
long long repro_fused_stencil_tc_grid(const int* geom, int kind, int dtype,
                                      int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(long long)err;
  Geometry g;
  if (!read_geometry(geom, nullptr, 0, g) || g.fuse_steps != 1 ||
      !valid_tc(g, kind))
    return -(long long)cudaErrorInvalidValue;
  long long grid = 0;
  err = dispatch(kind, dtype, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, nullptr, g, device, nullptr, &grid);
  return err == cudaSuccess ? grid : -(long long)err;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory one block of this kernel uses for `geom` (the plan's
// StencilPlan.smem_bytes must equal it).
long long repro_fused_stencil_tc_smem_bytes(const int* geom, int dtype) {
  Geometry g;
  if (!read_geometry(geom, nullptr, 0, g)) return -1;
  const bool d1 = g.fuse_steps == 1;
  switch (dtype) {
    case DTYPE_F32:
      return d1 ? (long long)tc_layout<float>(g).total
                : (long long)temporal_layout<float, TcEval<float>>(g).total;
    case DTYPE_BF16:
      return d1 ? (long long)tc_layout<__nv_bfloat16>(g).total
                : (long long)temporal_layout<__nv_bfloat16,
                                             TcEval<__nv_bfloat16>>(g).total;
    default:
      return -1;
  }
}

int repro_fused_stencil_tc_geometry_len(void) { return G_LEN; }

}  // extern "C"
