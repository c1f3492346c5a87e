"""Hand-written CUDA kernels (csrc/), their launch wrappers and plain
PyTorch versions (ref), dispatched by device in ops."""
