"""Compute ops: flash attention on hand-written CUDA kernels, plain
attention, and the hierarchical topology spec the process group reads."""
