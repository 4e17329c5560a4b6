"""Fused LayerNorm + bias-free QKV projection, forward.

Counterpart of ``neurovit_tpu/ops/fused_qkv.py`` (``fused_ln_qkv``, TPU
kernel ``_fwd_kernel`` :57):

    u = LN(x) * gamma + beta          f32, rounded once to x's dtype
    q, k, v = split(u @ Wqkv^T)       f32 accumulation, no bias

``w_qkv`` is the torch Linear weight [3 * heads * dim_head, dim] with rows
ordered (3, heads, dim_head), so q, k and v come out [B, N, H, D], the
layout the attention op takes. CPU tensors run :func:`fused_ln_qkv_plain`;
CUDA tensors run ``csrc/fused_qkv.cu`` through :func:`fused_ln_qkv_cuda`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.ops.common import (FLOAT, INT, VOID, check_operand,
                                           launch, on_cpu, ptr)

QKV = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def fused_ln_qkv_plain(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, w_qkv: torch.Tensor, heads: int,
                       dim_head: int) -> QKV:
    """The kernel's function in plain PyTorch, same rounding points."""
    b, n, _ = x.shape
    u = nn.layer_norm(x, gamma, beta)
    out = torch.matmul(u.float(), w_qkv.to(x.dtype).float().t()).to(x.dtype)
    q, k, v = out.reshape(b, n, 3, heads, dim_head).unbind(2)
    return q.contiguous(), k.contiguous(), v.contiguous()


def fused_ln_qkv_cuda(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, w_qkv: torch.Tensor, heads: int,
                      dim_head: int) -> QKV:
    """Launch the Hopper kernel on bf16 x [B, N, dim]; the weight is cast to
    bf16 and the LN affine to f32, as the JAX op casts them."""
    b, n, dim = x.shape
    inner = heads * dim_head
    check_operand("x", x, torch.bfloat16)
    w = w_qkv.to(torch.bfloat16).contiguous()
    g = gamma.float().contiguous()
    be = beta.float().contiguous()
    check_operand("w_qkv", w, torch.bfloat16, (3 * inner, dim))
    check_operand("gamma", g, torch.float32, (dim,))
    check_operand("beta", be, torch.float32, (dim,))
    if dim % 32 or inner % 128:
        raise ValueError(f"the LN+QKV kernel takes dim % 32 == 0 and "
                         f"heads * dim_head % 128 == 0, got {dim}, {inner}")
    q, k, v = (x.new_empty(b, n, heads, dim_head) for _ in range(3))
    launch("nvt_fused_ln_qkv_fwd",
           (VOID,) * 7 + (INT, INT, INT, FLOAT), x,
           ptr(x), ptr(g), ptr(be), ptr(w), ptr(q), ptr(k), ptr(v),
           b * n, dim, inner, nn.LN_EPS)
    fused_ln_qkv_cuda.launches += 1
    return q, k, v


fused_ln_qkv_cuda.launches = 0


def fused_ln_qkv(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 w_qkv: torch.Tensor, heads: int, dim_head: int) -> QKV:
    """LN(x) then the QKV projection: [B, N, dim] -> q, k, v [B, N, H, D].
    CPU tensors take the plain version, CUDA tensors the kernel."""
    fn = (fused_ln_qkv_plain if on_cpu(x, gamma, beta, w_qkv)
          else fused_ln_qkv_cuda)
    return fn(x, gamma, beta, w_qkv, heads, dim_head)
