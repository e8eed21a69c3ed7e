"""Recurrence primitives and the hand-written CUDA rollout kernels."""
