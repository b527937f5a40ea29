"""Stencil weights, boundary padding and the fused-op module."""
