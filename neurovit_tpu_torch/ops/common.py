"""Shared pieces of the op wrappers: the CPU/CUDA dispatch rule and the
checks every kernel launch makes on its operands."""

from __future__ import annotations

import ctypes

import torch

from neurovit_tpu_torch.ops import _build

VOID = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float


def on_cpu(*tensors: torch.Tensor) -> bool:
    """Dispatch rule of every public op: CPU operands run the plain PyTorch
    version, CUDA operands the kernel. A mix raises; there is no fallback
    from one to the other."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"operands on {sorted(kinds)}: the op runs its plain "
                     "version on CPU tensors and its CUDA kernel on CUDA "
                     "tensors, all on one device")


def check_operand(name: str, t: torch.Tensor, dtype: torch.dtype,
                  shape=None) -> None:
    """Raise unless ``t`` is what a kernel takes: a contiguous CUDA tensor
    of ``dtype`` (and ``shape``), 16-byte aligned for vector loads."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def launch(name: str, argtypes, like: torch.Tensor, *args) -> None:
    """Launch the kernel ``name`` on ``like``'s device, on PyTorch's current
    stream there (passed as the last argument); the kernel never
    synchronises. Raises if the launch was refused."""
    with torch.cuda.device(like.device):
        s = ctypes.c_void_p(torch.cuda.current_stream(like.device).cuda_stream)
        _build.launch(name, tuple(argtypes) + (VOID,), *args, s)
