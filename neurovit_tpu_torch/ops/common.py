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
U32 = ctypes.c_uint
I64 = ctypes.c_longlong
U64 = ctypes.c_uint64

# Dynamic shared memory one block may opt into on the H100 (sm_90): 227 KB.
SMEM_LIMIT = 232448
# Where the shape limits that remain are queued.
SHAPE_QUEUE = "ROADMAP.md, Queue 3"
# Every width a kernel takes is a multiple of this: rows of bf16 and int8
# operands start on 16-byte boundaries, as TMA's tensor maps and the vector
# loads need.
WIDTH_MULTIPLE = 16


def round_up(x: int, to: int) -> int:
    return (x + to - 1) // to * to


def check_widths(what: str, **widths: int) -> None:
    """Raise unless every named width is a positive multiple of 16: the
    shapes the kernel ``what`` takes."""
    for name, w in widths.items():
        if w < WIDTH_MULTIPLE or w % WIDTH_MULTIPLE:
            raise ValueError(
                f"the {what} kernel takes {name} as a multiple of "
                f"{WIDTH_MULTIPLE} (TMA's 16-byte rows), got {w} "
                f"({SHAPE_QUEUE})")


def check_smem(what: str, nbytes: int) -> None:
    """Raise before a launch that would ask for more shared memory than a
    block may have."""
    if nbytes > SMEM_LIMIT:
        raise ValueError(
            f"the {what} kernel would need {nbytes} bytes of shared memory "
            f"per block at these widths; a block may have {SMEM_LIMIT} "
            f"({SHAPE_QUEUE})")


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


def pick(plain, kernel, f32_kernel, *tensors: torch.Tensor):
    """The forward or backward a block op runs on ``tensors``, the first
    one's dtype deciding: the plain version on CPU tensors, ``f32_kernel``
    on f32 CUDA tensors and ``kernel`` (the bf16 one, which raises for a
    dtype it does not take) on any other. There is no fallback."""
    if on_cpu(*tensors):
        return plain
    return f32_kernel if tensors[0].dtype == torch.float32 else kernel


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
