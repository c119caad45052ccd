"""PyTorch and CUDA port of ctdd_tpu for NVIDIA Hopper."""
