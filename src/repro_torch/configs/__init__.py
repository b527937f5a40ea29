"""Per-architecture configurations of the port and the registry that
looks them up (``registry.get_config``/``get_model``)."""
