"""Fault tolerance of the serving loop (port of ``repro.ft``): the
straggler monitor and the seeded deterministic fault-injection layer
the serving failure domains are tested against. The training
``Supervisor`` and ``SimulatedFailure`` are not ported yet (they belong
to the model zoo, ROADMAP A13)."""
from repro_torch.ft.faults import (  # noqa: F401
    FaultInjector,
    FaultSpec,
    InjectedCompileFailure,
    InjectedFault,
    InjectedResourceExhausted,
    chaos_specs,
)
from repro_torch.ft.supervisor import StragglerMonitor  # noqa: F401
