"""Language models of the port: the configuration dataclass, the layers,
the decoder-only transformer (dense and VLM, ``transformer``) and
mamba2 (``ssm``)."""
