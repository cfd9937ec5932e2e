"""Device resolution for the port's entry points.

Entry points run on the GPU: ``device=None`` means ``cuda``, and a
machine without a card raises instead of dropping to the CPU.  Callers
that want the CPU (the tests, the kernels' plain versions) say so with
``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device=\"cpu\" to run "
                "the port on the CPU (plain PyTorch versions of the kernels)")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} was requested but no CUDA device is "
            "available; pass device=\"cpu\" to run on the CPU")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}: use cuda or cpu")
    return dev
