"""Geometry ops and the two hand-written CUDA kernels of the main path."""
