"""Tensor primitives and the hand-written Hopper kernels' wrappers."""
