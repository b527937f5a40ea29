"""Data-parallel distribution (port of ``repro.distrib``): sharding rules
and their placement on a process mesh (``sharding``), gradient sync and
accumulation (``grad_sync``), and the collectives they call (``comm``)."""
