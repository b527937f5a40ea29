"""Language models of the port: the configuration dataclass, the layer
helpers mamba2 needs, and mamba2 itself (``ssm``)."""
