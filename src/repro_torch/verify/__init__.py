"""Verification harnesses — correctness layers that gate the engine
(port of ``repro.verify``).

``repro_torch.verify.mms`` is the method-of-manufactured-solutions
convergence harness: it drives analytically known fields through
:class:`~repro_torch.core.fusion.FusedStencilOp` at every generated
accuracy order, rank and boundary family, on any strategy (the CUDA
kernels included), and fits the observed error slope against the
nominal order.
"""
from repro_torch.verify.mms import (  # noqa: F401
    MMSResult,
    fit_slope,
    manufactured_solution,
    run_convergence,
)
