"""Build the CUDA kernels in ``csrc/`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` at first use — nothing is
built when a module is imported, so the CPU tests never need ``nvcc``.
Libraries land in ``_build/`` beside this file (listed in
``.gitignore``; ``REPRO_TORCH_BUILD_DIR`` overrides it), named by a hash
of their sources and flags, so an edited kernel is rebuilt and an
unchanged one is reused.  :func:`build` compiles several sources at once,
one ``nvcc`` process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import torch

CSRC = Path(__file__).parent / "csrc"
KERNELS = ("paged_attention", "flash_attention", "paged_attention_int8")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build wall time (0.0 when reused), "ptxas": log}
build_log: Dict[str, dict] = {}


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR",
                               Path(__file__).parent / "_build"))


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named kernels (default: all) that are not built yet,
    all ``nvcc`` processes at once.  Raises with the compiler's output if
    one fails."""
    names = list(KERNELS if names is None else names)
    build_dir().mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    t0 = time.perf_counter()
    for n, path in paths.items():
        if path.exists():
            build_log.setdefault(n, {"seconds": 0.0, "ptxas": "(reused)"})
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, paths[n])
        build_log[n] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = ctypes.CDLL(str(build([name])[name]))
    return lib


def kernel_fn(name: str, symbol: str, argtypes: Sequence):
    """C entry point ``symbol`` of kernel ``name``, returning a CUDA error
    code.  Every pointer and the stream must be ``c_void_p`` in
    ``argtypes``: ctypes would otherwise pass a 32-bit int."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn


def check_cuda_args(tensors: Dict[str, torch.Tensor], int32: Sequence[str],
                    dtype: torch.dtype, d: int, kv_itemsize: int = 0) -> None:
    """Raise unless ``tensors`` fit the kernels' C interface: f32 or bf16
    data, int32 indices (the ``int32`` names), contiguous and 16-byte
    aligned, a head dim ``d <= 256`` of whole 16-byte vectors of K/V
    elements (``kv_itemsize`` bytes each; default: ``dtype``'s)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, got {dtype}")
    vec = 16 // (kv_itemsize or dtype.itemsize)
    if d > 256 or d % vec:
        raise ValueError(f"the CUDA kernels take d <= 256 with d % {vec} == 0, "
                         f"got d={d}")
    for name in int32:
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32 on CUDA, got {tensors[name].dtype}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
