// φ of the 8-field compressible MHD right-hand side, for the fused
// stencil kernel (fused_stencil.cu).
//
// A line-for-line port of repro/physics/mhd.py:87-221 (the jnp φ the
// Pallas kernel traces), in the same order of operations: every
// constant is combined in double exactly as the Python side combines
// it (p.gamma - 1.0, p.gamma / p.cp, 2.0 * p.nu, ...), cast to the
// field type once, and then used. nvcc contracts a*b+c into FMA, so
// f32 and f64 results agree with the reference to rounding, not bit for
// bit.
//
// bf16 (B4b). The plain version computes every product, sum, quotient
// and exp of bf16 tensors in f32 and rounds it once to bf16, as XLA's
// elementwise bf16 arithmetic does. Operators on __nv_bfloat16 need not
// round each step so, and nvcc may contract a product and a sum. So phi
// runs in bf16 on Bf16 below: a value already rounded to bf16, kept in
// an f32 register, whose + - * / call __fadd_rn/__fsub_rn/__fmul_rn/
// __fdiv_rn (never contracted) and round once, and whose exp is expf
// (no fast math: build.py) rounded once. The one rhs source stays.
#pragma once

#include <cuda_bf16.h>

namespace mhd {

// Derivative slots (the order of repro_torch.kernels.phi.MHD_OPERATORS).
enum Slot { VAL, DX, DY, DZ, DXX, DYY, DZZ, DXY, DXZ, DYZ, N_SLOTS };
// Field rows of the (8, z, y, x) stack.
enum Field { LNRHO, UX, UY, UZ, SS, AX, AY, AZ, N_FIELDS };
// Parameter layout (repro_torch.kernels.phi.MHD_PARAM_NAMES).
enum Param {
  P_NU, P_ZETA, P_ETA, P_MU0, P_CP, P_GAMMA, P_CS0, P_LNRHO0, P_KAPPA,
  P_HEAT, P_COOL, P_LNT0, P_ALPHA, P_BETA, P_DT, N_PARAMS
};

// The fields whose operator slot `slot` phi reads, bit k for field k
// (read off rhs below): 62 (slot, field) pairs of 80 for the RHS, 65 for
// the fused substep, which also reads every field's value. A kernel that
// evaluates slots one at a time skips the others.
__host__ __device__ constexpr unsigned fields_read(int slot, bool substep) {
  switch (slot) {
    case VAL: return substep ? 0xFF : 0x1F;  // lnrho, u, ss
    case DX: return 0xDF;   // all but ax
    case DY: return 0xBF;   // all but ay
    case DZ: return 0x7F;   // all but az
    case DXY: return 0x66;  // ux, uy, ax, ay
    case DXZ: return 0xAA;  // ux, uz, ax, az
    case DYZ: return 0xCC;  // uy, uz, ay, az
    default: return 0xFF;   // DXX, DYY, DZZ: every Laplacian
  }
}

// Arithmetic operations of mhd_rhs per point (exp and division counted
// once each), for the compute bound; the stencil's own multiply-adds
// are counted from the tap table.
constexpr int RHS_FLOPS = 246;
constexpr int SUBSTEP_EXTRA_FLOPS = 40;  // w' = αw + Δt·rhs, f' = f + βw'

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

// A bf16 value held in an f32 register; each operation is computed in f32
// and rounded once to bf16 (the header says why).
struct Bf16 {
  float v;  // always a bf16 value
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  Bf16() = default;
  __device__ explicit Bf16(__nv_bfloat16 x) : v(__bfloat162float(x)) {}
  // A constant combined in double, cast as PyTorch casts a Python float
  // to bf16: through float, then rounded once.
  __device__ explicit Bf16(double c) : v(round(float(c))) {}
  __device__ explicit Bf16(int c) : v(round(float(c))) {}
  __device__ static Bf16 of(float x) {
    Bf16 b;
    b.v = round(x);
    return b;
  }
  __device__ __nv_bfloat16 bits() const { return __float2bfloat16_rn(v); }
};
__device__ __forceinline__ Bf16 operator+(Bf16 a, Bf16 b) {
  return Bf16::of(__fadd_rn(a.v, b.v));
}
__device__ __forceinline__ Bf16 operator-(Bf16 a, Bf16 b) {
  return Bf16::of(__fsub_rn(a.v, b.v));
}
__device__ __forceinline__ Bf16 operator*(Bf16 a, Bf16 b) {
  return Bf16::of(__fmul_rn(a.v, b.v));
}
__device__ __forceinline__ Bf16 operator/(Bf16 a, Bf16 b) {
  return Bf16::of(__fdiv_rn(a.v, b.v));
}
__device__ __forceinline__ Bf16 operator-(Bf16 a) {
  Bf16 b;
  b.v = -a.v;
  return b;
}
__device__ __forceinline__ Bf16 exp_t(Bf16 x) { return Bf16::of(expf(x.v)); }

// The type phi computes in for field type T: T itself, Bf16 for bf16.
template <typename T>
struct PhiType {
  using type = T;
};
template <>
struct PhiType<__nv_bfloat16> {
  using type = Bf16;
};

// A field value in the type phi computes in, and back: identities but
// for bf16.
__device__ __forceinline__ float to_phi(float x) { return x; }
__device__ __forceinline__ double to_phi(double x) { return x; }
__device__ __forceinline__ Bf16 to_phi(__nv_bfloat16 x) { return Bf16(x); }
__device__ __forceinline__ float from_phi(float x) { return x; }
__device__ __forceinline__ double from_phi(double x) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_phi(Bf16 x) { return x.bits(); }

template <typename T>
struct Consts {
  T mu0, cp, cs0_sq, g, g_m1, lnrho0, lnT0, nu, zeta, g_over_cp, kappa,
      heat_m_cool, eta_mu0, two_nu, eta;

  __device__ explicit Consts(const double* p)
      : mu0(T(p[P_MU0])),
        cp(T(p[P_CP])),
        cs0_sq(T(p[P_CS0] * p[P_CS0])),
        g(T(p[P_GAMMA])),
        g_m1(T(p[P_GAMMA] - 1.0)),
        lnrho0(T(p[P_LNRHO0])),
        lnT0(T(p[P_LNT0])),
        nu(T(p[P_NU])),
        zeta(T(p[P_ZETA])),
        g_over_cp(T(p[P_GAMMA] / p[P_CP])),
        kappa(T(p[P_KAPPA])),
        heat_m_cool(T(p[P_HEAT] - p[P_COOL])),
        eta_mu0(T(p[P_ETA] * p[P_MU0])),
        two_nu(T(2.0 * p[P_NU])),
        eta(T(p[P_ETA])) {}
};

// d[slot][field] -> out[field]: the 8 time derivatives at one point.
template <typename T>
__device__ __forceinline__ void rhs(const T (&d)[N_SLOTS][N_FIELDS],
                                    const Consts<T>& c,
                                    T (&out)[N_FIELDS]) {
  const T* val = d[VAL];
  const T *dx = d[DX], *dy = d[DY], *dz = d[DZ];
  const T *dxx = d[DXX], *dyy = d[DYY], *dzz = d[DZZ];
  const T *dxy = d[DXY], *dxz = d[DXZ], *dyz = d[DYZ];

  const T lnrho = val[LNRHO];
  const T u[3] = {val[UX], val[UY], val[UZ]};
  const T ss = val[SS];

  const T grad_lnrho[3] = {dx[LNRHO], dy[LNRHO], dz[LNRHO]};
  const T grad_ss[3] = {dx[SS], dy[SS], dz[SS]};
  const T div_u = dx[UX] + dy[UY] + dz[UZ];
  auto lap = [&](int i) { return dxx[i] + dyy[i] + dzz[i]; };
  auto advect = [&](const T (&gq)[3]) {
    return u[0] * gq[0] + u[1] * gq[1] + u[2] * gq[2];
  };

  // --- magnetic quantities ---------------------------------------------
  const T B[3] = {dy[AZ] - dz[AY], dz[AX] - dx[AZ], dx[AY] - dy[AX]};
  const T grad_div_a[3] = {
      dxx[AX] + dxy[AY] + dxz[AZ],
      dxy[AX] + dyy[AY] + dyz[AZ],
      dxz[AX] + dyz[AY] + dzz[AZ],
  };
  const T lap_a[3] = {lap(AX), lap(AY), lap(AZ)};
  T jj[3];
  for (int i = 0; i < 3; ++i) jj[i] = (grad_div_a[i] - lap_a[i]) / c.mu0;
  const T j2 = jj[0] * jj[0] + jj[1] * jj[1] + jj[2] * jj[2];

  // --- thermodynamics (ideal gas closure) ------------------------------
  const T s_over_cp = ss / c.cp;
  const T cs2 =
      c.cs0_sq * exp_t(c.g * s_over_cp + c.g_m1 * (lnrho - c.lnrho0));
  const T rho = exp_t(lnrho);
  const T lnT = c.lnT0 + c.g * s_over_cp + c.g_m1 * (lnrho - c.lnrho0);
  const T temp = exp_t(lnT);

  // --- rate-of-shear tensor S (traceless, symmetric) -------------------
  const T du[3][3] = {
      {dx[UX], dy[UX], dz[UX]},
      {dx[UY], dy[UY], dz[UY]},
      {dx[UZ], dy[UZ], dz[UZ]},
  };  // du[i][j] = du_i/dx_j
  const T third_div = div_u / T(3.0);
  T S[3][3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) S[i][j] = T(0.5) * (du[i][j] + du[j][i]);
    S[i][i] = S[i][i] - third_div;
  }
  T ss_contract = T(0);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) ss_contract = ss_contract + S[i][j] * S[i][j];
  T s_dot_glnrho[3];
  for (int i = 0; i < 3; ++i) {
    s_dot_glnrho[i] = T(0);
    for (int j = 0; j < 3; ++j)
      s_dot_glnrho[i] = s_dot_glnrho[i] + S[i][j] * grad_lnrho[j];
  }

  // --- continuity --------------------------------------------------------
  const T dlnrho_dt = -advect(grad_lnrho) - div_u;

  // --- momentum ----------------------------------------------------------
  const T grad_div_u[3] = {
      dxx[UX] + dxy[UY] + dxz[UZ],
      dxy[UX] + dyy[UY] + dyz[UZ],
      dxz[UX] + dyz[UY] + dzz[UZ],
  };
  const T jxB[3] = {
      jj[1] * B[2] - jj[2] * B[1],
      jj[2] * B[0] - jj[0] * B[2],
      jj[0] * B[1] - jj[1] * B[0],
  };
  T du_dt[3];
  for (int i = 0; i < 3; ++i) {
    const T gu[3] = {dx[UX + i], dy[UX + i], dz[UX + i]};
    const T adv_u = advect(gu);
    const T pressure = cs2 * (grad_ss[i] / c.cp + grad_lnrho[i]);
    const T viscous =
        c.nu * (lap(UX + i) + grad_div_u[i] / T(3.0) +
                T(2.0) * s_dot_glnrho[i]) +
        c.zeta * grad_div_u[i];
    du_dt[i] = -adv_u - pressure + jxB[i] / rho + viscous;
  }

  // --- entropy: div(K grad T) = K T (lap lnT + |grad lnT|^2) -----------
  T grad_lnT[3];
  for (int i = 0; i < 3; ++i)
    grad_lnT[i] = c.g_over_cp * grad_ss[i] + c.g_m1 * grad_lnrho[i];
  const T lap_lnT = c.g_over_cp * lap(SS) + c.g_m1 * lap(LNRHO);
  const T div_K_gradT =
      c.kappa * temp *
      (lap_lnT + grad_lnT[0] * grad_lnT[0] + grad_lnT[1] * grad_lnT[1] +
       grad_lnT[2] * grad_lnT[2]);
  const T heating = c.heat_m_cool + div_K_gradT + c.eta_mu0 * j2 +
                    c.two_nu * rho * ss_contract +
                    c.zeta * rho * (div_u * div_u);
  const T dss_dt = -advect(grad_ss) + heating / (rho * temp);

  // --- induction ---------------------------------------------------------
  const T uxB[3] = {
      u[1] * B[2] - u[2] * B[1],
      u[2] * B[0] - u[0] * B[2],
      u[0] * B[1] - u[1] * B[0],
  };

  out[LNRHO] = dlnrho_dt;
  out[UX] = du_dt[0];
  out[UY] = du_dt[1];
  out[UZ] = du_dt[2];
  out[SS] = dss_dt;
  for (int i = 0; i < 3; ++i) out[AX + i] = uxB[i] + c.eta * lap_a[i];
}

}  // namespace mhd
