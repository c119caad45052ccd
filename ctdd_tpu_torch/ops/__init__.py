"""Tensor ops and the fused tau-leap CUDA kernel."""
