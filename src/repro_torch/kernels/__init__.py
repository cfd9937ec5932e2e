# Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
# PyTorch version: csrc/*.cu are built by build.py at first use.
