"""Fused residual MLP block, forward, deterministic.

Counterpart of ``neurovit_tpu/ops/fused_mlp.py`` (``fused_mlp_block`` with
dropout off; TPU kernel ``_fwd_kernel`` :108):

    u = LN(x) * gamma + beta          f32, rounded to x's dtype
    h = u @ W1^T + b1                 f32, rounded to x's dtype before GELU
    g = GELU(h)                       exact-erf GELU in f32, rounded
    y = x + (g @ W2^T + b2)           b2 and x added in f32, rounded once

The hidden [B*N, mlp_dim] never reaches device memory in the kernel.
CPU tensors run :func:`fused_mlp_block_plain`; CUDA tensors run
``csrc/fused_mlp.cu`` through :func:`fused_mlp_block_cuda`.
"""

from __future__ import annotations

import torch

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.ops.common import (FLOAT, INT, VOID, check_operand,
                                           launch, on_cpu, ptr)


def fused_mlp_block_plain(x: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, w1: torch.Tensor,
                          b1: torch.Tensor, w2: torch.Tensor,
                          b2: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, same rounding points.
    x [B, N, dim], w1 [hid, dim], b1 [hid], w2 [dim, hid], b2 [dim]."""
    u = nn.layer_norm(x, gamma, beta)
    h = torch.matmul(u.float(), w1.to(x.dtype).float().t()) + b1.float()
    g = nn.gelu(h.to(x.dtype).float()).to(x.dtype)
    z = torch.matmul(g.float(), w2.to(x.dtype).float().t()) + b2.float()
    return (z + x.float()).to(x.dtype)


def fused_mlp_block_cuda(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, w1: torch.Tensor,
                         b1: torch.Tensor, w2: torch.Tensor,
                         b2: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel on bf16 x [B, N, dim]."""
    b, n, dim = x.shape
    hid = w1.shape[0]
    check_operand("x", x, torch.bfloat16)
    w1b = w1.to(torch.bfloat16).contiguous()
    w2b = w2.to(torch.bfloat16).contiguous()
    vecs = [t.float().contiguous() for t in (gamma, beta, b1, b2)]
    check_operand("w1", w1b, torch.bfloat16, (hid, dim))
    check_operand("w2", w2b, torch.bfloat16, (dim, hid))
    for name, t, size in zip(("gamma", "beta", "b1", "b2"), vecs,
                             (dim, dim, hid, dim)):
        check_operand(name, t, torch.float32, (size,))
    if dim % 128 or hid % 128:
        raise ValueError(f"the MLP kernel takes dim % 128 == 0 and "
                         f"mlp_dim % 128 == 0, got {dim}, {hid}")
    g, be, b1f, b2f = vecs
    y = torch.empty_like(x)
    launch("nvt_fused_mlp_fwd", (VOID,) * 8 + (INT, INT, INT, FLOAT), x,
           ptr(x), ptr(g), ptr(be), ptr(w1b), ptr(b1f), ptr(w2b), ptr(b2f),
           ptr(y), b * n, dim, hid, nn.LN_EPS)
    fused_mlp_block_cuda.launches += 1
    return y


fused_mlp_block_cuda.launches = 0


def fused_mlp_block(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor) -> torch.Tensor:
    """x + fc2(GELU(fc1(LN(x)))), [B, N, dim]. CPU tensors take the plain
    version, CUDA tensors the kernel."""
    fn = (fused_mlp_block_plain if on_cpu(x, gamma, beta, w1, b1, w2, b2)
          else fused_mlp_block_cuda)
    return fn(x, gamma, beta, w1, b1, w2, b2)
