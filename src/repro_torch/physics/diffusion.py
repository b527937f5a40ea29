"""Diffusion equation ∂f/∂t = α∇²f as a linear stencil computation
(paper Sec. 3.2, Figs. 10-12; port of ``repro.physics.diffusion``).

Forward-Euler time integration folds into a SINGLE merged stencil
g = c^(1) + Δt·α·c^(2) (paper Eqs. 5-7): one stencil application per
step, any dimensionality, any even accuracy order. On the card each
step is one launch of the fused-stencil kernel with the ``select`` φ,
or ``fuse_steps`` steps are one launch of the temporal kernel; with
``strategy="swc_stream"`` (ranks 2 and 3) one launch of the stream
kernel per call at any depth; with ``strategy="tc"`` (float32 or
bfloat16 fields) one launch of the tensor-core kernel per call at any
depth. At rank 1, :func:`step_1d_xcorr` takes one step as the paper's
cross-correlation (Eq. 5): one launch of ``csrc/xcorr1d.cu``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from repro_torch import as_dtype, resolve_device
from repro_torch.core.fusion import FusedStencilOp, integrate
from repro_torch.core.stencil import (
    OperatorSet,
    diffusion_kernel_1d,
    diffusion_kernel_nd,
)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.phi import select_phi


@dataclasses.dataclass(frozen=True)
class DiffusionProblem:
    """Numerical setup following the paper's App. B (Table B2): periodic
    domain of extent 2π per axis, Δs_i = 2π/n_i."""

    shape: tuple[int, ...]  # grid points per axis (z, y, x ordering)
    accuracy: int = 6  # FD accuracy order (radius = accuracy // 2)
    alpha: float = 1.0
    safety: float = 0.2  # dt = safety · min(Δs)² / (2·d·α)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def spacing(self) -> tuple[float, ...]:
        return tuple(2.0 * np.pi / n for n in self.shape)

    @property
    def dt(self) -> float:
        d = self.ndim
        h = min(self.spacing)
        return self.safety * h * h / (2.0 * d * self.alpha)

    @property
    def radius(self) -> int:
        return self.accuracy // 2

    def merged_stencil(self):
        """Paper Eq. 7: identity + Δt·α·∇² as one stencil."""
        return diffusion_kernel_nd(
            self.ndim, self.accuracy, self.dt, self.alpha, self.spacing
        )

    def step_op(
        self,
        strategy: str = "hwc",
        block: tuple[int, ...] | None = None,
        fuse_steps: int = 1,
        device: str | torch.device | None = None,
    ) -> FusedStencilOp:
        """One forward-Euler step as a fused op (φ selects the merged
        "step" operator). ``strategy="swc"`` runs the CUDA kernel at any
        rank, ``strategy="swc_stream"`` the explicit-streaming kernel
        (2-D/3-D: it walks the slowest axis, carrying its halo planes),
        ``strategy="tc"`` the tensor-core kernel (float32 or bfloat16);
        ``block`` is a rank-length tile or None for the default (on
        ``swc_stream`` ``block[0]`` is the chunk of the walk);
        ``fuse_steps > 1`` advances that many steps per call (one
        launch, of the temporal kernel on ``swc``, of the stream kernel
        on ``swc_stream``). ``device`` (the card by default) holds the
        op's tap table."""
        device = resolve_device(device)
        spec = dataclasses.replace(self.merged_stencil(), name="step")
        return FusedStencilOp(
            ops=OperatorSet((spec,)),
            phi=select_phi("step"),
            n_out=1,
            boundary_mode="periodic",
            strategy=strategy,
            block=block,
            fuse_steps=fuse_steps,
            device=device,
        )

    def init_field(
        self,
        seed: int = 0,
        amplitude: float = 1e-5,
        *,
        device: str | torch.device | None = None,
        dtype: str | torch.dtype = torch.float32,
    ) -> torch.Tensor:
        """Benchmark initialization (paper Table B2: random in
        (-1e-5, 1e-5]); the same numpy draw as the reference."""
        device = resolve_device(device)
        rng = np.random.default_rng(seed)
        f = rng.uniform(-amplitude, amplitude, size=self.shape)
        return torch.as_tensor(f[None], dtype=as_dtype(dtype), device=device)

    def fourier_mode(
        self,
        k: Sequence[int],
        *,
        device: str | torch.device | None = None,
        dtype: str | torch.dtype = torch.float64,
    ) -> torch.Tensor:
        """sin(k·x) eigenmode — decays analytically as exp(-α|k|²t)."""
        device = resolve_device(device)
        axes = [
            np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
            for n in self.shape
        ]
        grids = np.meshgrid(*axes, indexing="ij")
        phase = sum(ki * gi for ki, gi in zip(k, grids))
        return torch.as_tensor(
            np.sin(phase)[None], dtype=as_dtype(dtype), device=device
        )

    def analytic_decay(self, k: Sequence[int], t: float) -> float:
        return float(np.exp(-self.alpha * sum(ki * ki for ki in k) * t))


@functools.lru_cache(maxsize=64)
def _xcorr_taps(
    accuracy: int, dt: float, alpha: float, spacing: float,
    dtype: torch.dtype, device: torch.device,
) -> torch.Tensor:
    """The merged 1-D kernel g of Eq. 5 in ``dtype`` on ``device``, made
    once per problem, dtype and device."""
    g = diffusion_kernel_1d(accuracy, dt, alpha, spacing)
    return torch.as_tensor(g, dtype=dtype, device=device)


def step_1d_xcorr(
    f: torch.Tensor,
    problem: DiffusionProblem,
    *,
    strategy: str = "hwc",
    block_size: int = 2048,
) -> torch.Tensor:
    """1-D diffusion step via the cross-correlation kernel path (the
    paper's cuDNN/MIOpen-comparable formulation): pad periodically, then
    f' = g ⋆ f̂ with the merged kernel of Eq. 5. ``f`` is (n,) on the
    device the step runs on; on ``baseline``, ``pointwise`` and
    ``elementwise`` a CUDA tensor takes one launch of the B6 kernel."""
    g = _xcorr_taps(
        problem.accuracy, problem.dt, problem.alpha, problem.spacing[0],
        f.dtype, f.device,
    )
    r = problem.radius
    fp = torch.cat([f[-r:], f, f[:r]])
    return kops.xcorr1d(fp, g, strategy=strategy, block_size=block_size)


def simulate(
    problem: DiffusionProblem,
    f0: torch.Tensor | np.ndarray,
    n_steps: int,
    *,
    strategy: str = "hwc",
    block: tuple[int, ...] | None = None,
    fuse_steps: int = 1,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Run ``n_steps`` of forward-Euler diffusion with the fused engine
    on ``device`` (the card unless the caller asks for the CPU).

    ``fuse_steps > 1`` advances that many steps per call (on ``swc``
    one temporal-kernel launch, on ``swc_stream`` one stream-kernel
    launch; a remainder is finished at shallower depth with the same
    strategy, so the step count stays exact)."""
    device = resolve_device(device)
    if not isinstance(f0, torch.Tensor):
        f0 = torch.from_numpy(np.array(f0))
    f0 = f0.to(device)
    op = problem.step_op(strategy, block, fuse_steps, device=device)
    return integrate(op, f0, n_steps)
