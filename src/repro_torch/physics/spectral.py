"""Spectral (FFT) derivative oracle for validating the FD stencil engine
(port of ``repro.physics.spectral`` on ``torch.fft``).

On a periodic band-limited field, spectral derivatives are exact; the
6th-order FD derivatives must agree to their truncation error. Feeding
the SAME φ both derivative sets validates the whole fused pipeline's
calculus independently of the stencil machinery (the paper's
model-solution verification, Sec. 5.1, where closed-form answers do not
exist: MHD). Everything runs in float64 (complex128 spectra) on the
field's device.
"""
from __future__ import annotations

import math
from typing import Callable

import torch


def _wavenumbers(
    shape: tuple[int, ...], spacing: tuple[float, ...],
    device: torch.device | None = None,
) -> list[torch.Tensor]:
    return [
        2.0 * math.pi * torch.fft.fftfreq(
            n, d=h, dtype=torch.float64, device=device
        )
        for n, h in zip(shape, spacing)
    ]


def spectral_derivatives(
    f: torch.Tensor, spacing: tuple[float, ...]
) -> dict[str, torch.Tensor]:
    """All 10 derivative operators of the MHD set, spectrally.

    ``f``: (n_f, z, y, x), taken in float64 on its device. Returns
    {name: (n_f, z, y, x)} float64.
    """
    f = torch.as_tensor(f).to(torch.float64)
    kz, ky, kx = _wavenumbers(tuple(f.shape[1:]), spacing, f.device)
    KZ = kz[:, None, None]
    KY = ky[None, :, None]
    KX = kx[None, None, :]
    fh = torch.fft.fftn(f, dim=(1, 2, 3))

    def inv(spec):
        return torch.fft.ifftn(spec, dim=(1, 2, 3)).real

    out: dict[str, torch.Tensor] = {"val": f.clone()}
    out["dx"] = inv(1j * KX * fh)
    out["dy"] = inv(1j * KY * fh)
    out["dz"] = inv(1j * KZ * fh)
    out["dxx"] = inv(-(KX**2) * fh)
    out["dyy"] = inv(-(KY**2) * fh)
    out["dzz"] = inv(-(KZ**2) * fh)
    out["dxy"] = inv(-(KX * KY) * fh)
    out["dxz"] = inv(-(KX * KZ) * fh)
    out["dyz"] = inv(-(KY * KZ) * fh)
    return out


def spectral_rhs(
    f: torch.Tensor,
    spacing: tuple[float, ...],
    phi: Callable[..., torch.Tensor],
) -> torch.Tensor:
    """Evaluate a torch φ (``physics.mhd.mhd_rhs_phi``, or a
    ``DevicePhi``'s ``torch_fn``) on spectrally exact derivatives;
    float64 on ``f``'s device."""
    return phi(spectral_derivatives(f, spacing)).to(torch.float64)
