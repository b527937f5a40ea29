"""Plan, plain reference, and the hand-written CUDA kernel with its wrapper."""
