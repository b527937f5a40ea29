// What the persistent depth-1 kernels share: swc_body.cuh (swc,
// fused_stencil.cu) and tc_body.cuh (tc, fused_stencil_tc.cu). The walk
// of the output steps (plan.py:persistent_walk mirrors it), a division by
// a multiply, and the 16-byte cp.async that stages their windows.
//
// Each body lays its ring buffers out its own way, so the staging loop
// stays in each: swc reads every tap at a linear offset, so its buffer rows
// are congruent to the global rows modulo 16 bytes (swc_body.cuh); tc's
// MMAs read zero-filled columns after each row for the band's zeros, so
// its rows start at a per-row shift (tc_body.cuh).
#pragma once

#include <cuda_runtime.h>

namespace stencil {

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// 16 bytes global -> shared, of which the first src_bytes are read and
// the rest zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// n / d by a multiply: with m = ceil(2^32 / d) = (2^32 + e) / d, e < d,
// floor(n m / 2^32) = floor(n / d) whenever n d <= 2^32 (as member_z).
struct FastDiv {
  unsigned long long mul;
  __device__ explicit FastDiv(int d)
      : mul(((1ull << 32) + unsigned(d) - 1) / unsigned(d)) {}
  __device__ __forceinline__ int operator()(int n) const {
    return int((unsigned(n) * mul) >> 32);
  }
};

// The persistent walk (plan.py:persistent_walk mirrors it): block b takes
// steps b, b + grid, ...; step i is (member, z, y, x) tiles, x fastest,
// its x extent tiles_per_step tiles. A Walk holds one step's coordinates
// and the field of its unit, and moves on by a unit at a time, the step
// advancing by the grid in mixed radix (no division).
struct Walk {
  int ix, iy, iz, m, k;
};

struct Walker {
  int nx, ny, nz, nf;
  int sx, sy, sz, sm;  // the grid in the walk's mixed radix
  __device__ Walk at(long long i) const {
    Walk w;
    w.ix = int(i % nx);
    i /= nx;
    w.iy = int(i % ny);
    i /= ny;
    w.iz = int(i % nz);
    w.m = int(i / nz);
    w.k = 0;
    return w;
  }
  __device__ void next(Walk& w) const {
    if (++w.k < nf) return;
    w.k = 0;
    w.ix += sx;
    int c = w.ix >= nx;
    w.ix -= c ? nx : 0;
    w.iy += sy + c;
    c = w.iy >= ny;
    w.iy -= c ? ny : 0;
    w.iz += sz + c;
    c = w.iz >= nz;
    w.iz -= c ? nz : 0;
    w.m += sm + c;
  }
};

}  // namespace stencil
