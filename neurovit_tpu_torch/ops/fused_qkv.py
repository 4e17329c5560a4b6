"""Fused LayerNorm + bias-free QKV projection, forward and backward.

Counterpart of ``neurovit_tpu/ops/fused_qkv.py`` (``fused_ln_qkv``, TPU
kernels ``_fwd_kernel`` :57 and ``_bwd_kernel`` :71):

    u = LN(x) * gamma + beta          f32, rounded once to x's dtype
    q, k, v = split(u @ Wqkv^T)       f32 accumulation, no bias

``w_qkv`` is the torch Linear weight [3 * heads * dim_head, dim] with rows
ordered (3, heads, dim_head), so q, k and v come out [B, N, H, D], the
layout the attention op takes. In training the forward also returns u,
the operand of dWqkv = [dq | dk | dv]^T u (a plain matmul, as in JAX), and
the backward (:class:`FusedLnQkv`) computes du = [dq | dk | dv] Wqkv and
the LayerNorm backward (dx, dgamma, dbeta).

CPU tensors run the ``*_plain`` functions; CUDA tensors run
``csrc/fused_qkv.cu`` (K2) and ``csrc/fused_qkv_bwd.cu`` (K7).
"""

from __future__ import annotations

from typing import Tuple

import torch

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.ops.common import (FLOAT, INT, VOID, check_operand,
                                           is_training, launch, on_cpu, ptr,
                                           weight_grad)

QKV = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def fused_ln_qkv_plain(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, w_qkv: torch.Tensor, heads: int,
                       dim_head: int, *, return_u: bool = False):
    """The kernel's function in plain PyTorch, same rounding points."""
    b, n, _ = x.shape
    u = nn.layer_norm(x, gamma, beta)
    out = torch.matmul(u.float(), w_qkv.to(x.dtype).float().t()).to(x.dtype)
    q, k, v = out.reshape(b, n, 3, heads, dim_head).unbind(2)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return (q, k, v, u) if return_u else (q, k, v)


def _ln_stats(xf: torch.Tensor):
    """(xhat, rstd) per row in f32, as nn.layer_norm computes them."""
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + nn.LN_EPS)
    return xc * rstd, rstd


def ln_backward_plain(x2d: torch.Tensor, du: torch.Tensor,
                      gamma: torch.Tensor):
    """LayerNorm backward of f32 du at rows x2d (fused_qkv.py:80-96):
    f32 (dx, dgamma, dbeta)."""
    xhat, rstd = _ln_stats(x2d.float())
    dgamma = (du * xhat).sum(0)
    dbeta = du.sum(0)
    dxhat = du * gamma.float()
    m1 = dxhat.mean(dim=1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=1, keepdim=True)
    return rstd * (dxhat - m1 - xhat * m2), dgamma, dbeta


def fused_ln_qkv_bwd_plain(dq, dk, dv, x, gamma, w_qkv):
    """The backward kernel's function in plain PyTorch: dx (x's dtype),
    dgamma, dbeta (f32)."""
    b, n, dim = x.shape
    dqkv = torch.cat([t.reshape(b * n, -1) for t in (dq, dk, dv)], dim=1)
    du = torch.matmul(dqkv.float(), w_qkv.to(x.dtype).float())
    dx, dgamma, dbeta = ln_backward_plain(x.reshape(b * n, dim), du, gamma)
    return dx.to(x.dtype).reshape(x.shape), dgamma, dbeta


def _operands(x, w_qkv, heads, dim_head, **vectors):
    """The launch's bf16 weight and f32 LN vectors (gamma, beta by name),
    checked."""
    dim, inner = x.shape[-1], heads * dim_head
    check_operand("x", x, torch.bfloat16)
    w = w_qkv.to(torch.bfloat16).contiguous()
    check_operand("w_qkv", w, torch.bfloat16, (3 * inner, dim))
    vecs = {}
    for name, t in vectors.items():
        vecs[name] = t.float().contiguous()
        check_operand(name, vecs[name], torch.float32, (dim,))
    if dim % 32 or inner % 128:
        raise ValueError(f"the LN+QKV kernel takes dim % 32 == 0 and "
                         f"heads * dim_head % 128 == 0, got {dim}, {inner}")
    return w, vecs


def fused_ln_qkv_cuda(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, w_qkv: torch.Tensor, heads: int,
                      dim_head: int, *, return_u: bool = False):
    """Launch the Hopper kernel K2 on bf16 x [B, N, dim]; the weight is cast
    to bf16 and the LN affine to f32, as the JAX op casts them."""
    b, n, dim = x.shape
    w, vecs = _operands(x, w_qkv, heads, dim_head, gamma=gamma, beta=beta)
    q, k, v = (x.new_empty(b, n, heads, dim_head) for _ in range(3))
    u = torch.empty_like(x) if return_u else None
    launch("nvt_fused_ln_qkv_fwd",
           (VOID,) * 8 + (INT, INT, INT, FLOAT), x,
           ptr(x), ptr(vecs["gamma"]), ptr(vecs["beta"]), ptr(w), ptr(q),
           ptr(k), ptr(v), ptr(u), b * n, dim, heads * dim_head, nn.LN_EPS)
    fused_ln_qkv_cuda.launches += 1
    return (q, k, v, u) if return_u else (q, k, v)


fused_ln_qkv_cuda.launches = 0


def fused_ln_qkv_bwd_cuda(dq, dk, dv, x, gamma, w_qkv):
    """Launch the Hopper kernel K7 (du GEMM, LayerNorm rows, dgamma/dbeta
    sums); returns dx bf16, dgamma and dbeta f32."""
    b, n, dim = x.shape
    heads, dim_head = dq.shape[2], dq.shape[3]
    inner = heads * dim_head
    w, vecs = _operands(x, w_qkv, heads, dim_head, gamma=gamma)
    for name, t in (("dq", dq), ("dk", dk), ("dv", dv)):
        check_operand(name, t, torch.bfloat16, (b, n, heads, dim_head))
    if dim % 256 or dim > 1024:
        raise ValueError(f"the LN+QKV backward takes dim % 256 == 0 and "
                         f"dim <= 1024, got {dim}")
    m = b * n
    f32 = dict(dtype=torch.float32, device=x.device)
    du = torch.empty((m, dim), **f32)
    parts = torch.empty((2, (m + 31) // 32, dim), **f32)
    dgb = torch.empty((2, dim), **f32)
    dx = torch.empty_like(x)
    launch("nvt_fused_ln_qkv_bwd", (VOID,) * 12 + (INT, INT, INT, FLOAT), x,
           ptr(dq), ptr(dk), ptr(dv), ptr(x), ptr(vecs["gamma"]), ptr(w),
           ptr(du), ptr(parts[0]), ptr(parts[1]), ptr(dx), ptr(dgb[0]),
           ptr(dgb[1]), m, dim, inner, nn.LN_EPS)
    fused_ln_qkv_bwd_cuda.launches += 1
    return dx, dgb[0], dgb[1]


fused_ln_qkv_bwd_cuda.launches = 0


class FusedLnQkv(torch.autograd.Function):
    """K2 forward (with u), K7 backward; dWqkv = dqkv^T u outside."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w_qkv, heads, dim_head):
        fwd = (fused_ln_qkv_plain if on_cpu(x, gamma, beta, w_qkv)
               else fused_ln_qkv_cuda)
        q, k, v, u = fwd(x, gamma, beta, w_qkv, heads, dim_head,
                         return_u=True)
        ctx.save_for_backward(x, gamma, w_qkv, u)
        return q, k, v

    @staticmethod
    def backward(ctx, dq, dk, dv):
        x, gamma, w_qkv, u = ctx.saved_tensors
        dq, dk, dv = (t.contiguous() for t in (dq, dk, dv))
        bwd = (fused_ln_qkv_bwd_plain if on_cpu(x, dq)
               else fused_ln_qkv_bwd_cuda)
        dx, dgamma, dbeta = bwd(dq, dk, dv, x, gamma, w_qkv)
        m = x.shape[0] * x.shape[1]
        dqkv = torch.cat([t.reshape(m, -1) for t in (dq, dk, dv)], dim=1)
        dw = weight_grad(dqkv, u.reshape(m, -1)).to(w_qkv.dtype)
        return dx, dgamma, dbeta, dw, None, None


def fused_ln_qkv(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 w_qkv: torch.Tensor, heads: int, dim_head: int) -> QKV:
    """LN(x) then the QKV projection: [B, N, dim] -> q, k, v [B, N, H, D].
    Differentiable when an input requires grad. CPU tensors take the plain
    version, CUDA tensors the kernels."""
    if is_training(x, gamma, beta, w_qkv):
        return FusedLnQkv.apply(x, gamma, beta, w_qkv, heads, dim_head)
    fn = (fused_ln_qkv_plain if on_cpu(x, gamma, beta, w_qkv)
          else fused_ln_qkv_cuda)
    return fn(x, gamma, beta, w_qkv, heads, dim_head)
