"""Shared pieces of the op wrappers: the CPU/CUDA dispatch rule and the
checks every kernel launch makes on its operands."""

from __future__ import annotations

import ctypes

import torch

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.ops import _build

VOID = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float
U64 = ctypes.c_uint64


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


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer for a launch; None gives a null pointer."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def is_training(*tensors: torch.Tensor) -> bool:
    """Whether a call records a graph: then the op runs through its
    ``autograd.Function``, whose forward also keeps what the backward
    kernel reads. Serving (no grad) launches the forward alone."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def weight_grad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """dW = a^T b over the rows of two [M, *] activations, in their dtype:
    the products that JAX leaves to XLA outside its kernels
    (fused_mlp.py:290-297). bf16 operands with f32 accumulation; on the CPU
    the f32 matmul of the exact products, rounded once."""
    if a.device.type == "cpu":
        return torch.matmul(a.float().t(), b.float()).to(a.dtype)
    return torch.matmul(a.t(), b)


def dropout_args(rate: float):
    """(inv_keep, keep_q) of a launch: keep_q 0 turns a kernel's dropout
    off (then inv_keep is 1)."""
    q, keep = nn.keep_threshold(rate)
    return (1.0 / keep, q) if rate else (1.0, 0)


def launch(name: str, argtypes, like: torch.Tensor, *args) -> None:
    """Launch the kernel ``name`` on ``like``'s device, on PyTorch's current
    stream there (passed as the last argument); the kernel never
    synchronises. Raises if the launch was refused."""
    with torch.cuda.device(like.device):
        s = ctypes.c_void_p(torch.cuda.current_stream(like.device).cuda_stream)
        _build.launch(name, tuple(argtypes) + (VOID,), *args, s)
