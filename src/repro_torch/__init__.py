"""PyTorch/CUDA port of the Splitwiser serving system.

Runs beside the JAX reference package (``src/repro``) and imports
nothing of it.  Entry points run on the GPU unless the caller passes
``device="cpu"``; see ``repro_torch.device``.
"""
