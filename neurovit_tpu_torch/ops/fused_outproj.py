"""Fused attention out-projection + dropout + residual, forward and backward.

Counterpart of ``neurovit_tpu/ops/fused_outproj.py``
(``fused_outproj_residual``; TPU kernels ``_fwd_kernel`` :44 and
``_bwd_kernel`` :56):

    z = attn @ Wout^T + b             f32
    z = z * (mask * (1 / keep))       training, dropout_rate > 0
    y = x + z                         residual added in f32, rounded once

The backward (:class:`FusedOutproj`) regenerates the mask: dz = dy * mask
/ keep and dattn = dz @ Wout in the kernel; dx = dy, dWout = dz^T attn and
db = sum(dz) outside it, as in JAX.

CPU tensors run the ``*_plain`` functions; CUDA tensors run
``csrc/fused_outproj.cu`` (K3) and ``csrc/fused_outproj_bwd.cu`` (K8).
"""

from __future__ import annotations

import torch

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.ops.common import (FLOAT, INT, U64, VOID,
                                           check_operand, dropout_args,
                                           is_training, launch, on_cpu, ptr,
                                           weight_grad)


def fused_outproj_residual_plain(x: torch.Tensor, attn: torch.Tensor,
                                 w_out: torch.Tensor, b_out: torch.Tensor, *,
                                 dropout_rate: float = 0.0,
                                 seed: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch, same rounding points.
    x [B, N, dim], attn [B, N, inner], w_out [dim, inner], b_out [dim]."""
    z = torch.matmul(attn.float(), w_out.to(x.dtype).float().t())
    z = z + b_out.float()
    if dropout_rate:
        z = z * nn.mask_scale(seed, z.shape, dropout_rate, x.device)
    return (z + x.float()).to(x.dtype)


def fused_outproj_bwd_plain(dy: torch.Tensor, w_out: torch.Tensor, *,
                            dropout_rate: float = 0.0, seed: int = 0):
    """The backward kernel's function in plain PyTorch: (dattn, dz), both
    in dy's dtype."""
    dz = dy.float()
    if dropout_rate:
        dz = dz * nn.mask_scale(seed, dz.shape, dropout_rate, dy.device)
    dz = dz.to(dy.dtype)
    dattn = torch.matmul(dz.float(), w_out.to(dy.dtype).float())
    return dattn.to(dy.dtype), dz


def fused_outproj_residual_cuda(x: torch.Tensor, attn: torch.Tensor,
                                w_out: torch.Tensor, b_out: torch.Tensor, *,
                                dropout_rate: float = 0.0,
                                seed: int = 0) -> torch.Tensor:
    """Launch the Hopper kernel K3 on bf16 activations."""
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
    inv_keep, keep_q = dropout_args(dropout_rate)
    y = torch.empty_like(x)
    launch("nvt_fused_outproj_fwd",
           (VOID,) * 5 + (INT,) * 3 + (FLOAT, INT, U64), x, ptr(attn),
           ptr(x), ptr(w), ptr(bias), ptr(y), b * n, inner, dim, inv_keep,
           keep_q, int(seed))
    fused_outproj_residual_cuda.launches += 1
    return y


fused_outproj_residual_cuda.launches = 0


def fused_outproj_bwd_cuda(dy: torch.Tensor, w_out: torch.Tensor, *,
                           dropout_rate: float = 0.0, seed: int = 0):
    """Launch the Hopper kernel K8; returns (dattn, dz) bf16."""
    b, n, dim = dy.shape
    inner = w_out.shape[1]
    check_operand("dy", dy, torch.bfloat16)
    w = w_out.to(torch.bfloat16).contiguous()
    check_operand("w_out", w, torch.bfloat16, (dim, inner))
    if dim % 32 or inner % 128:
        raise ValueError(f"the out-projection backward takes dim % 32 == 0 "
                         f"and inner % 128 == 0, got {dim}, {inner}")
    inv_keep, keep_q = dropout_args(dropout_rate)
    dattn = dy.new_empty(b, n, inner)
    dz = torch.empty_like(dy)
    launch("nvt_fused_outproj_bwd",
           (VOID,) * 4 + (INT,) * 3 + (FLOAT, INT, U64), dy, ptr(dy),
           ptr(w), ptr(dattn), ptr(dz), b * n, inner, dim, inv_keep, keep_q,
           int(seed))
    fused_outproj_bwd_cuda.launches += 1
    return dattn, dz


fused_outproj_bwd_cuda.launches = 0


class FusedOutproj(torch.autograd.Function):
    """K3 forward, K8 backward; dWout, db and dx = dy outside."""

    @staticmethod
    def forward(ctx, x, attn, w_out, b_out, dropout_rate, seed):
        fwd = (fused_outproj_residual_plain
               if on_cpu(x, attn, w_out, b_out)
               else fused_outproj_residual_cuda)
        y = fwd(x, attn, w_out, b_out, dropout_rate=dropout_rate, seed=seed)
        ctx.save_for_backward(attn, w_out)
        ctx.args = dict(dropout_rate=dropout_rate, seed=seed)
        return y

    @staticmethod
    def backward(ctx, dy):
        attn, w_out = ctx.saved_tensors
        dy = dy.contiguous()
        bwd = (fused_outproj_bwd_plain if on_cpu(dy, w_out)
               else fused_outproj_bwd_cuda)
        dattn, dz = bwd(dy, w_out, **ctx.args)
        m = dy.shape[0] * dy.shape[1]
        dz2 = dz.reshape(m, -1)
        dw = weight_grad(dz2, attn.reshape(m, -1)).to(w_out.dtype)
        db = dz2.float().sum(0)
        return dy, dattn, dw, db, None, None


def fused_outproj_residual(x: torch.Tensor, attn: torch.Tensor,
                           w_out: torch.Tensor, b_out: torch.Tensor, *,
                           dropout_rate: float = 0.0,
                           seed: int = 0) -> torch.Tensor:
    """x + Drop(attn @ Wout^T + b), [B, N, dim]. Differentiable when an
    input requires grad. CPU tensors take the plain version, CUDA tensors
    the kernels."""
    if is_training(x, attn, w_out, b_out):
        return FusedOutproj.apply(x, attn, w_out, b_out, float(dropout_rate),
                                  int(seed))
    fn = (fused_outproj_residual_plain if on_cpu(x, attn, w_out, b_out)
          else fused_outproj_residual_cuda)
    return fn(x, attn, w_out, b_out, dropout_rate=dropout_rate, seed=seed)
