"""Compressible non-ideal magnetohydrodynamics (paper Sec. 3.3, App. A;
port of ``repro.physics.mhd``).

Eight coupled fields — log-density lnρ, velocity u (3), specific entropy
s, magnetic vector potential A (3) — advanced with explicit third-order
2N-storage Runge-Kutta (Williamson), spatial derivatives from 6th-order
central differences (radius-3 stencils).

The whole right-hand side is ONE fused stencil operation (paper Eq. 9):
the 10-operator derivative set is evaluated for all 8 fields and the
point-wise map φ turns them into the 8 time derivatives. On the card φ
is compiled into the kernel (``kernels/csrc/phi_mhd.cuh``); here it is
also written in plain PyTorch (:func:`mhd_rhs_phi`), line for line after
the reference, for the CPU path and as the kernel's plain version.

Equations (App. A, non-conservative form):

  D lnρ/Dt = −∇·u
  D u/Dt   = −c_s²∇(s/c_p + lnρ) + j×B/ρ
             + ν[∇²u + ⅓∇(∇·u) + 2S·∇lnρ] + ζ∇(∇·u)
  ρT Ds/Dt = H − C + ∇·(K∇T) + ημ₀j² + 2ρν S⊗S + ζρ(∇·u)²
  ∂A/∂t    = u×B + η∇²A
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Mapping

import numpy as np
import torch

from repro_torch import as_dtype, resolve_device
from repro_torch.core.fusion import FusedStencilOp
from repro_torch.core.stencil import OperatorSet, derivative_operator_set
from repro_torch.kernels.phi import MHD_OPERATORS, DevicePhi

# Field indices in the (8, z, y, x) stack.
LNRHO = 0
UX, UY, UZ = 1, 2, 3
SS = 4
AX, AY, AZ = 5, 6, 7
N_FIELDS = 8
FIELD_NAMES = ("lnrho", "ux", "uy", "uz", "ss", "ax", "ay", "az")

# Williamson 2N-storage RK3 (the Astaroth/Pencil integrator).
RK3_ALPHA = (0.0, -5.0 / 9.0, -153.0 / 128.0)
RK3_BETA = (1.0 / 3.0, 15.0 / 16.0, 8.0 / 15.0)

# Arithmetic operations φ adds per point on top of the stencil's
# multiply-adds (phi_mhd.cuh: mhd::RHS_FLOPS, SUBSTEP_EXTRA_FLOPS).
RHS_PHI_FLOPS = 246
SUBSTEP_PHI_FLOPS = RHS_PHI_FLOPS + 40


@dataclasses.dataclass(frozen=True)
class MHDParams:
    nu: float = 5e-3  # kinematic viscosity
    zeta: float = 0.0  # bulk viscosity
    eta: float = 5e-3  # magnetic diffusivity
    mu0: float = 1.0  # vacuum permeability
    cp: float = 1.0  # specific heat, constant pressure
    gamma: float = 5.0 / 3.0  # adiabatic index
    cs0: float = 1.0  # sound speed at reference state
    lnrho0: float = 0.0  # reference log density
    kappa: float = 1e-3  # radiative conductivity K
    heat: float = 0.0  # explicit heating H
    cool: float = 0.0  # explicit cooling C

    @property
    def lnT0(self) -> float:
        # c_s0² = (γ−1)·c_p·T0
        T0 = self.cs0**2 / ((self.gamma - 1.0) * self.cp)
        return float(np.log(T0))

    def device_params(
        self, alpha: float = 0.0, beta: float = 0.0, dt: float = 0.0
    ) -> tuple[float, ...]:
        """The kernel's parameter vector (``phi.MHD_PARAM_NAMES``)."""
        fields = tuple(float(v) for v in dataclasses.astuple(self))
        return fields + (self.lnT0, float(alpha), float(beta), float(dt))


def mhd_rhs_phi(params: MHDParams):
    """Build φ: derivative tensors → the 8 field time-derivatives.

    ``derivs[name]`` has shape (8, *tile); returns (8, *tile). Each
    constant is cast to the field dtype before use, as the reference's
    ``c(x)`` does.
    """
    p = params
    g = p.gamma

    def phi(d: Mapping[str, torch.Tensor]) -> torch.Tensor:
        val = d["val"]
        dx, dy, dz = d["dx"], d["dy"], d["dz"]
        dxx, dyy, dzz = d["dxx"], d["dyy"], d["dzz"]
        dxy, dxz, dyz = d["dxy"], d["dxz"], d["dyz"]
        dtype = val.dtype

        def c(x):
            return torch.tensor(x, dtype=dtype)

        lnrho = val[LNRHO]
        u = val[UX : UZ + 1]  # (3, *tile)
        ss = val[SS]

        # First derivatives, indexed [component][axis].
        grad = lambda i: torch.stack([dx[i], dy[i], dz[i]])  # noqa: E731
        grad_lnrho = grad(LNRHO)
        grad_ss = grad(SS)
        div_u = dx[UX] + dy[UY] + dz[UZ]
        lap = lambda i: dxx[i] + dyy[i] + dzz[i]  # noqa: E731

        # u advection helper: (u·∇)q.
        def advect(gq):
            return u[0] * gq[0] + u[1] * gq[1] + u[2] * gq[2]

        # --- magnetic quantities ------------------------------------------
        B = torch.stack(
            [
                dy[AZ] - dz[AY],
                dz[AX] - dx[AZ],
                dx[AY] - dy[AX],
            ]
        )
        # j = μ0⁻¹ (∇(∇·A) − ∇²A)
        grad_div_a = torch.stack(
            [
                dxx[AX] + dxy[AY] + dxz[AZ],
                dxy[AX] + dyy[AY] + dyz[AZ],
                dxz[AX] + dyz[AY] + dzz[AZ],
            ]
        )
        lap_a = torch.stack([lap(AX), lap(AY), lap(AZ)])
        jj = (grad_div_a - lap_a) / c(p.mu0)
        j2 = jj[0] ** 2 + jj[1] ** 2 + jj[2] ** 2

        # --- thermodynamics (ideal gas closure) ---------------------------
        s_over_cp = ss / c(p.cp)
        cs2 = c(p.cs0**2) * torch.exp(
            c(g) * s_over_cp + c(g - 1.0) * (lnrho - c(p.lnrho0))
        )
        rho = torch.exp(lnrho)
        lnT = c(p.lnT0) + c(g) * s_over_cp + c(g - 1.0) * (
            lnrho - c(p.lnrho0)
        )
        T = torch.exp(lnT)

        # --- rate-of-shear tensor S (traceless, symmetric) ----------------
        du = [
            [dx[UX], dy[UX], dz[UX]],
            [dx[UY], dy[UY], dz[UY]],
            [dx[UZ], dy[UZ], dz[UZ]],
        ]  # du[i][j] = ∂u_i/∂x_j
        third_div = div_u / c(3.0)
        S = [[None] * 3 for _ in range(3)]
        for i in range(3):
            for jx in range(3):
                S[i][jx] = c(0.5) * (du[i][jx] + du[jx][i])
            S[i][i] = S[i][i] - third_div
        SS_contract = sum(S[i][jx] ** 2 for i in range(3) for jx in range(3))
        # 2 S·∇lnρ (vector)
        S_dot_glnrho = torch.stack(
            [
                sum(S[i][jx] * grad_lnrho[jx] for jx in range(3))
                for i in range(3)
            ]
        )

        # --- continuity -----------------------------------------------------
        dlnrho_dt = -advect(grad_lnrho) - div_u

        # --- momentum -------------------------------------------------------
        grad_div_u = torch.stack(
            [
                dxx[UX] + dxy[UY] + dxz[UZ],
                dxy[UX] + dyy[UY] + dyz[UZ],
                dxz[UX] + dyz[UY] + dzz[UZ],
            ]
        )
        lap_u = torch.stack([lap(UX), lap(UY), lap(UZ)])
        jxB = torch.stack(
            [
                jj[1] * B[2] - jj[2] * B[1],
                jj[2] * B[0] - jj[0] * B[2],
                jj[0] * B[1] - jj[1] * B[0],
            ]
        )
        adv_u = torch.stack([advect(grad(UX + i)) for i in range(3)])
        pressure = cs2 * (grad_ss / c(p.cp) + grad_lnrho)
        viscous = c(p.nu) * (
            lap_u + grad_div_u / c(3.0) + c(2.0) * S_dot_glnrho
        ) + c(p.zeta) * grad_div_u
        du_dt = -adv_u - pressure + jxB / rho + viscous

        # --- entropy --------------------------------------------------------
        # ∇·(K∇T) = K·T·(∇²lnT + |∇lnT|²), constant K.
        grad_lnT = c(g / p.cp) * grad_ss + c(g - 1.0) * grad_lnrho
        lap_lnT = c(g / p.cp) * lap(SS) + c(g - 1.0) * lap(LNRHO)
        div_K_gradT = c(p.kappa) * T * (
            lap_lnT
            + grad_lnT[0] ** 2
            + grad_lnT[1] ** 2
            + grad_lnT[2] ** 2
        )
        heating = (
            c(p.heat - p.cool)
            + div_K_gradT
            + c(p.eta * p.mu0) * j2
            + c(2.0 * p.nu) * rho * SS_contract
            + c(p.zeta) * rho * div_u**2
        )
        dss_dt = -advect(grad_ss) + heating / (rho * T)

        # --- induction ------------------------------------------------------
        uxB = torch.stack(
            [
                u[1] * B[2] - u[2] * B[1],
                u[2] * B[0] - u[0] * B[2],
                u[0] * B[1] - u[1] * B[0],
            ]
        )
        dA_dt = uxB + c(p.eta) * lap_a

        return torch.cat(
            [dlnrho_dt[None], du_dt, dss_dt[None], dA_dt]
        )

    return phi


def mhd_rhs_device_phi(params: MHDParams) -> DevicePhi:
    """The MHD right-hand side as a kernel φ (kind ``mhd_rhs``)."""
    return DevicePhi(
        "mhd_rhs", params.device_params(), mhd_rhs_phi(params),
        MHD_OPERATORS,
    )


def mhd_substep_device_phi(
    params: MHDParams, alpha: float, beta: float, dt: float
) -> DevicePhi:
    """φ for one fused-axpy RK substep: w' = αw + Δt·RHS(f),
    f' = f + βw' (aux = w). Output rows 0..7 = f', 8..15 = w'."""
    rhs_phi = mhd_rhs_phi(params)

    def phi(d, aux):
        rhs = rhs_phi(d)
        dtype = rhs.dtype
        w_new = torch.tensor(alpha, dtype=dtype) * aux + torch.tensor(
            dt, dtype=dtype
        ) * rhs
        f_new = d["val"] + torch.tensor(beta, dtype=dtype) * w_new
        return torch.cat([f_new, w_new])

    return DevicePhi(
        "mhd_substep", params.device_params(alpha, beta, dt), phi,
        MHD_OPERATORS,
    )


@dataclasses.dataclass(frozen=True)
class MHDSolver:
    """Fused-stencil MHD integrator over a periodic (n, n, n) box of
    extent 2π (paper Table B2).

    ``device`` defaults to the card (raising without one); pass
    ``device="cpu"`` for the plain PyTorch path. ``block`` is the
    kernel tile at depth > 1 and on ``swc_stream``: those kernels keep 80
    derivative values per point in registers, so a tile holds at most
    256 points (the temporal pair's planner halves it further until its
    shared memory fits). At depth 1 on ``swc`` and ``tc`` the kernels
    hold φ's inputs in shared memory and take their planner's tile
    (``plan.SWC_MHD_BLOCK``, ``plan.TC_MHD_BLOCK``); the pair at depth 2
    keeps ``block``.

    ``strategy="swc_stream"`` runs the plain RK3 form through the
    stream kernel (``rhs_op``, three launches per step; ``block[0]`` is
    the chunk of the walk along z). In float32 its depth-1 ring body
    (``csrc/stream_body.cuh``) holds φ's inputs in shared memory beside
    all 8 fields' planes, 512 threads on the (1, 8, 32) tile
    (``plan.STREAM_MHD_BLOCK``); in float64 the one-buffer body keeps
    them in registers, the planner halving the cross tile until the 8
    fields' working set fits shared memory. The
    fused-axpy forms (``fuse_rk_axpy``, ``fuse_rk_pairs``) hand φ the
    carry as aux, which ``swc_stream`` refuses with ``ValueError``, as
    the reference does. ``strategy="tc"`` runs all three forms through
    the tensor-core kernel (float32; the pair at depth 2); bfloat16
    fields raise ``NotImplementedError`` on the CUDA strategies (ROADMAP
    B4b).
    """

    shape: tuple[int, int, int]
    params: MHDParams = MHDParams()
    accuracy: int = 6
    strategy: str = "hwc"
    block: tuple[int, int, int] | None = (1, 8, 32)
    fuse_rk_axpy: bool = False  # beyond-paper: fold the RK update into φ
    # Temporal fusion of the RK3 substeps: substeps 1+2 run as ONE
    # depth-2 launch (per-substep φ, the w carry kept in shared memory),
    # substep 3 as a depth-1 fused-axpy launch — two launches per RK3
    # step instead of three. Implies the fused-axpy formulation.
    fuse_rk_pairs: bool = False
    device: str | torch.device | None = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def spacing(self) -> tuple[float, float, float]:
        return tuple(2.0 * np.pi / n for n in self.shape)

    @functools.cached_property
    def operator_set(self) -> OperatorSet:
        return derivative_operator_set(3, self.accuracy, self.spacing)

    def _op(
        self, phi: DevicePhi | tuple[DevicePhi, ...], n_out: int,
        fuse_steps: int = 1,
    ) -> FusedStencilOp:
        return FusedStencilOp(
            ops=self.operator_set,
            phi=phi,
            n_out=n_out,
            boundary_mode="periodic",
            strategy=self.strategy,
            block=(None if self.strategy in ("swc", "tc") and fuse_steps == 1
                   else self.block),
            fuse_steps=fuse_steps,
            device=self.device,
        )

    def rhs_op(self) -> FusedStencilOp:
        return self._op(mhd_rhs_device_phi(self.params), N_FIELDS)

    def _fused_substep_op(self, alpha: float, beta: float, dt) -> FusedStencilOp:
        """One kernel running one fused-axpy RK substep."""
        phi = mhd_substep_device_phi(self.params, alpha, beta, float(dt))
        return self._op(phi, 2 * N_FIELDS)

    def _fused_pair_op(self, dt) -> FusedStencilOp:
        """RK3 substeps 1+2 as ONE depth-2 launch: the two substeps' φs
        applied back to back on one staged tile, the intermediate (f, w)
        never reaching device memory."""
        phis = tuple(
            mhd_substep_device_phi(self.params, a, b, float(dt))
            for a, b in zip(RK3_ALPHA[:2], RK3_BETA[:2])
        )
        return self._op(phis, 2 * N_FIELDS, fuse_steps=2)

    def _check_fields(self, f: torch.Tensor) -> None:
        if f.device != self.device:
            raise ValueError(
                f"fields on {f.device}, solver on {self.device}"
            )
        if tuple(f.shape) != (N_FIELDS,) + tuple(self.shape):
            raise ValueError(
                f"fields {tuple(f.shape)} != {(N_FIELDS,) + tuple(self.shape)}"
            )

    def rhs(self, f: torch.Tensor) -> torch.Tensor:
        """Time derivatives of all fields: one fused φ(A·B) application."""
        self._check_fields(f)
        return self.rhs_op()(f)

    def step(self, f: torch.Tensor, dt) -> torch.Tensor:
        """One full RK3 step: three fused substeps (paper Sec. 3.3),
        three kernel launches, or two with ``fuse_rk_pairs``."""
        self._check_fields(f)
        if self.fuse_rk_pairs:
            out = self._fused_pair_op(dt)(f, aux=torch.zeros_like(f))
            f, w = out[:N_FIELDS], out[N_FIELDS:]
            out = self._fused_substep_op(RK3_ALPHA[2], RK3_BETA[2], dt)(
                f, aux=w
            )
            return out[:N_FIELDS]
        if self.fuse_rk_axpy:
            w = torch.zeros_like(f)
            for a, b in zip(RK3_ALPHA, RK3_BETA):
                out = self._fused_substep_op(a, b, dt)(f, aux=w)
                f, w = out[:N_FIELDS], out[N_FIELDS:]
            return f
        op = self.rhs_op()
        w = torch.zeros_like(f)
        dt_c = torch.tensor(float(dt), dtype=f.dtype)
        for a, b in zip(RK3_ALPHA, RK3_BETA):
            w = torch.tensor(a, dtype=f.dtype) * w + dt_c * op(f)
            f = f + torch.tensor(b, dtype=f.dtype) * w
        return f

    def cfl_dt(
        self, f: torch.Tensor, cdt: float = 0.4, cdtv: float = 0.3
    ) -> torch.Tensor:
        """Advective + diffusive CFL bound (Brandenburg 2003 form)."""
        p = self.params
        h = min(self.spacing)
        u = f[UX : UZ + 1]
        umax = torch.max(torch.sqrt(torch.sum(u * u, dim=0)))
        cs2_max = torch.max(
            p.cs0**2
            * torch.exp(
                p.gamma * f[SS] / p.cp
                + (p.gamma - 1.0) * (f[LNRHO] - p.lnrho0)
            )
        )
        v_signal = umax + torch.sqrt(cs2_max)
        dt_adv = cdt * h / torch.clamp(v_signal, min=1e-30)
        diff_max = max(p.nu, p.eta, p.kappa / p.cp)
        dt_diff = cdtv * h * h / max(diff_max, 1e-30)
        return torch.clamp(dt_adv, max=dt_diff)

    def simulate(
        self, f0: torch.Tensor, n_steps: int, dt: float
    ) -> torch.Tensor:
        """``n_steps`` RK3 steps of fixed size ``dt``."""
        f = f0
        for _ in range(n_steps):
            f = self.step(f, dt)
        return f

    def init_fields(
        self, seed: int = 0, amplitude: float = 1e-5,
        dtype: str | torch.dtype = torch.float32,
    ) -> torch.Tensor:
        """Paper Table B2 benchmark init: uniform in (−amplitude,
        amplitude], the reference's numpy draw, on the solver's device."""
        rng = np.random.default_rng(seed)
        f = rng.uniform(-amplitude, amplitude, size=(N_FIELDS,) + self.shape)
        return torch.as_tensor(f, dtype=as_dtype(dtype), device=self.device)

    def init_smooth(
        self, seed: int = 0, amplitude: float = 1e-3, kmax: int = 2,
        dtype: str | torch.dtype = torch.float64,
    ) -> torch.Tensor:
        """Band-limited random init (low-k Fourier modes), the
        reference's numpy draw, on the solver's device."""
        rng = np.random.default_rng(seed)
        zz, yy, xx = np.meshgrid(
            *(np.linspace(0, 2 * np.pi, n, endpoint=False) for n in self.shape),
            indexing="ij",
        )
        f = np.zeros((N_FIELDS,) + self.shape)
        for fi in range(N_FIELDS):
            for _ in range(3):
                k = rng.integers(-kmax, kmax + 1, size=3)
                ph = rng.uniform(0, 2 * np.pi)
                amp = rng.uniform(0.3, 1.0) * amplitude
                f[fi] += amp * np.cos(k[0] * zz + k[1] * yy + k[2] * xx + ph)
        return torch.as_tensor(f, dtype=as_dtype(dtype), device=self.device)
