"""Device ops of the port: hand-written CUDA kernels beside their plain
PyTorch versions, and the host builders they need."""
