"""Data (port of ``repro.data``): deterministic synthetic datasets and
the host-sharded batch iterator."""
from repro_torch.data.pipeline import (  # noqa: F401
    BatchIterator,
    MarkovLMDataset,
    SyntheticLMDataset,
    make_physics_init,
)
