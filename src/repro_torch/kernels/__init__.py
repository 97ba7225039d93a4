# Hand-written CUDA kernels (csrc/), their ctypes wrappers, their plain
# PyTorch versions (ref.py), and the dispatch between the two (ops.py).
