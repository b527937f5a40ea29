"""Checkpoints (port of ``repro.checkpoint``): async atomic saves,
keep-k retention, restore onto the target's devices."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
