"""Fault tolerance (port of ``repro.ft``): the training ``Supervisor``
with ``SimulatedFailure``, the straggler monitor, and the seeded
deterministic fault-injection layer the serving failure domains are
tested against."""
from repro_torch.ft.faults import (  # noqa: F401
    FaultInjector,
    FaultSpec,
    InjectedCompileFailure,
    InjectedFault,
    InjectedResourceExhausted,
    chaos_specs,
)
from repro_torch.ft.supervisor import (  # noqa: F401
    SimulatedFailure,
    StragglerMonitor,
    Supervisor,
)
