"""Diffusion and compressible MHD solvers on the fused-stencil engine."""
