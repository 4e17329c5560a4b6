"""Fused attention out-projection + bias + residual, forward, deterministic.

Counterpart of ``neurovit_tpu/ops/fused_outproj.py``
(``fused_outproj_residual`` with dropout off; TPU kernel ``_fwd_kernel``
:44):

    y = x + (attn @ Wout^T + b)       bias and residual added in f32,
                                      rounded once to x's dtype

CPU tensors run :func:`fused_outproj_residual_plain`; CUDA tensors run
``csrc/fused_outproj.cu`` through :func:`fused_outproj_residual_cuda`.
"""

from __future__ import annotations

import torch

from neurovit_tpu_torch.ops.common import (INT, VOID, check_operand, launch,
                                           on_cpu, ptr)


def fused_outproj_residual_plain(x: torch.Tensor, attn: torch.Tensor,
                                 w_out: torch.Tensor,
                                 b_out: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, same rounding points.
    x [B, N, dim], attn [B, N, inner], w_out [dim, inner], b_out [dim]."""
    z = torch.matmul(attn.float(), w_out.to(x.dtype).float().t())
    z = z + b_out.float()
    return (z + x.float()).to(x.dtype)


def fused_outproj_residual_cuda(x: torch.Tensor, attn: torch.Tensor,
                                w_out: torch.Tensor,
                                b_out: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel on bf16 activations."""
    b, n, dim = x.shape
    inner = attn.shape[-1]
    check_operand("x", x, torch.bfloat16)
    check_operand("attn", attn, torch.bfloat16, (b, n, inner))
    w = w_out.to(torch.bfloat16).contiguous()
    bias = b_out.float().contiguous()
    check_operand("w_out", w, torch.bfloat16, (dim, inner))
    check_operand("b_out", bias, torch.float32, (dim,))
    if inner % 32 or dim % 512:
        raise ValueError(f"the out-projection kernel takes inner % 32 == 0 "
                         f"and dim % 512 == 0, got {inner}, {dim}")
    y = torch.empty_like(x)
    launch("nvt_fused_outproj_fwd", (VOID,) * 5 + (INT, INT, INT), x,
           ptr(attn), ptr(x), ptr(w), ptr(bias), ptr(y), b * n, inner, dim)
    fused_outproj_residual_cuda.launches += 1
    return y


fused_outproj_residual_cuda.launches = 0


def fused_outproj_residual(x: torch.Tensor, attn: torch.Tensor,
                           w_out: torch.Tensor,
                           b_out: torch.Tensor) -> torch.Tensor:
    """x + attn @ Wout^T + b, [B, N, dim]. CPU tensors take the plain
    version, CUDA tensors the kernel."""
    fn = (fused_outproj_residual_plain if on_cpu(x, attn, w_out, b_out)
          else fused_outproj_residual_cuda)
    return fn(x, attn, w_out, b_out)
