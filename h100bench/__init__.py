"""The benchmark of the PyTorch and CUDA port on the H100 (see run.py)."""
