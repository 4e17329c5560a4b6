"""Fused residual MLP block, forward and backward, deterministic.

Counterpart of ``neurovit_tpu/ops/fused_mlp.py`` (``fused_mlp_block``; TPU
kernels ``_fwd_kernel`` :108 and ``_bwd_kernel`` :141):

    u = LN(x) * gamma + beta          f32, rounded to x's dtype
    h = u @ W1^T + b1                 f32, rounded to x's dtype before GELU
    g = GELU(h) * mask1 / keep        exact-erf GELU in f32, rounded
    z = (g @ W2^T + b2) * mask2 / keep    f32
    y = x + z                         x added in f32, rounded once

The masks (``dropout_rate`` > 0, training) are the Philox masks of two
sites, the hidden and the output, with the keys ``seeds``. The hidden
[B*N, mlp_dim] never reaches device memory in the serving kernel; in
training the forward stores h, which the backward (:class:`FusedMlp`)
reads: it recomputes LN, GELU and both masks, and emits dx, u, a, dz, dh
and dgamma / dbeta. dW1 = dh^T u, dW2 = dz^T a and the bias gradients are
plain matmuls and sums outside, as in JAX.

CPU tensors run the ``*_plain`` functions; CUDA tensors run
``csrc/fused_mlp.cu`` (K4) and ``csrc/fused_mlp_bwd.cu`` (K9).
"""

from __future__ import annotations

from typing import Tuple

import torch

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.ops.common import (FLOAT, INT, U64, VOID,
                                           check_operand, dropout_args,
                                           is_training, launch, on_cpu, ptr,
                                           weight_grad)
from neurovit_tpu_torch.ops.fused_qkv import ln_backward_plain

Seeds = Tuple[int, int]


def fused_mlp_block_plain(x: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, w1: torch.Tensor,
                          b1: torch.Tensor, w2: torch.Tensor,
                          b2: torch.Tensor, *, dropout_rate: float = 0.0,
                          seeds: Seeds = (0, 0), return_h: bool = False):
    """The kernel's function in plain PyTorch, same rounding points.
    x [B, N, dim], w1 [hid, dim], b1 [hid], w2 [dim, hid], b2 [dim]."""
    u = nn.layer_norm(x, gamma, beta)
    h = torch.matmul(u.float(), w1.to(x.dtype).float().t()) + b1.float()
    h = h.to(x.dtype)
    g = nn.gelu(h.float())
    if dropout_rate:
        g = g * nn.mask_scale(seeds[0], g.shape, dropout_rate, x.device)
    g = g.to(x.dtype)
    z = torch.matmul(g.float(), w2.to(x.dtype).float().t()) + b2.float()
    if dropout_rate:
        z = z * nn.mask_scale(seeds[1], z.shape, dropout_rate, x.device)
    y = (z + x.float()).to(x.dtype)
    return (y, h) if return_h else y


def fused_mlp_bwd_plain(dy, x, h, gamma, beta, w1, w2, *,
                        dropout_rate: float = 0.0, seeds: Seeds = (0, 0)):
    """The backward kernel's function in plain PyTorch, step by step as
    fused_mlp.py:156-196: (dx, u, a, dz, dh) in x's dtype, dgamma and
    dbeta f32."""
    dt = x.dtype
    dim = x.shape[-1]
    x2 = x.reshape(-1, dim)
    hf = h.reshape(x2.shape[0], -1).float()
    u = nn.layer_norm(x2, gamma, beta)
    a = nn.gelu(hf)
    dyf = dy.reshape(x2.shape).float()
    dz = dyf
    if dropout_rate:
        m1 = nn.mask_scale(seeds[0], hf.shape, dropout_rate, x.device)
        a = a * m1
        dz = dyf * nn.mask_scale(seeds[1], dyf.shape, dropout_rate, x.device)
    dz = dz.to(dt)
    da = torch.matmul(dz.float(), w2.to(dt).float())
    dh = da * nn.gelu_grad(hf)
    if dropout_rate:
        dh = dh * m1
    dh = dh.to(dt)
    du = torch.matmul(dh.float(), w1.to(dt).float())
    dx, dgamma, dbeta = ln_backward_plain(x2, du, gamma)
    dx = (dx + dyf).to(dt).reshape(x.shape)
    return dx, u, a.to(dt), dz, dh, dgamma, dbeta


def _operands(x, w1, w2, **vectors):
    """The launch's bf16 weights and f32 vectors (gamma, beta, b1, b2 by
    name), checked."""
    dim, hid = x.shape[-1], w1.shape[0]
    check_operand("x", x, torch.bfloat16)
    w1b = w1.to(torch.bfloat16).contiguous()
    w2b = w2.to(torch.bfloat16).contiguous()
    check_operand("w1", w1b, torch.bfloat16, (hid, dim))
    check_operand("w2", w2b, torch.bfloat16, (dim, hid))
    sizes = {"gamma": dim, "beta": dim, "b1": hid, "b2": dim}
    vecs = {}
    for name, t in vectors.items():
        vecs[name] = t.float().contiguous()
        check_operand(name, vecs[name], torch.float32, (sizes[name],))
    if dim % 128 or hid % 128:
        raise ValueError(f"the MLP kernel takes dim % 128 == 0 and "
                         f"mlp_dim % 128 == 0, got {dim}, {hid}")
    return w1b, w2b, vecs


def fused_mlp_block_cuda(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, w1: torch.Tensor,
                         b1: torch.Tensor, w2: torch.Tensor,
                         b2: torch.Tensor, *, dropout_rate: float = 0.0,
                         seeds: Seeds = (0, 0), return_h: bool = False):
    """Launch the Hopper kernel K4 on bf16 x [B, N, dim]."""
    b, n, dim = x.shape
    hid = w1.shape[0]
    w1b, w2b, vecs = _operands(x, w1, w2, gamma=gamma, beta=beta, b1=b1, b2=b2)
    inv_keep, keep_q = dropout_args(dropout_rate)
    y = torch.empty_like(x)
    h = x.new_empty(b, n, hid) if return_h else None
    launch("nvt_fused_mlp_fwd",
           (VOID,) * 9 + (INT, INT, INT, FLOAT, FLOAT, INT, U64, U64), x,
           ptr(x), ptr(vecs["gamma"]), ptr(vecs["beta"]), ptr(w1b),
           ptr(vecs["b1"]), ptr(w2b), ptr(vecs["b2"]), ptr(y), ptr(h), b * n,
           dim, hid, nn.LN_EPS, inv_keep, keep_q, int(seeds[0]),
           int(seeds[1]))
    fused_mlp_block_cuda.launches += 1
    return (y, h) if return_h else y


fused_mlp_block_cuda.launches = 0


def fused_mlp_bwd_cuda(dy, x, h, gamma, beta, w1, w2, *,
                       dropout_rate: float = 0.0, seeds: Seeds = (0, 0)):
    """Launch the Hopper kernel K9 (hidden pass, du GEMM, LayerNorm rows,
    dgamma/dbeta sums); returns (dx, u, a, dz, dh, dgamma, dbeta)."""
    b, n, dim = x.shape
    hid = w1.shape[0]
    m = b * n
    w1b, w2b, vecs = _operands(x, w1, w2, gamma=gamma, beta=beta)
    check_operand("dy", dy, torch.bfloat16, (b, n, dim))
    check_operand("h", h, torch.bfloat16, (b, n, hid))
    if dim % 256 or dim > 1024:
        raise ValueError(f"the MLP backward takes dim % 256 == 0 and "
                         f"dim <= 1024, got {dim}")
    inv_keep, keep_q = dropout_args(dropout_rate)
    dx, u, dz = (torch.empty_like(x) for _ in range(3))
    a, dh = (x.new_empty(m, hid) for _ in range(2))
    f32 = dict(dtype=torch.float32, device=x.device)
    du = torch.empty((m, dim), **f32)
    parts = torch.empty((2, (m + 31) // 32, dim), **f32)
    dgb = torch.empty((2, dim), **f32)
    launch("nvt_fused_mlp_bwd",
           (VOID,) * 17 + (INT, INT, INT, FLOAT, FLOAT, INT, U64, U64), x,
           ptr(dy), ptr(x), ptr(h), ptr(vecs["gamma"]), ptr(vecs["beta"]),
           ptr(w1b), ptr(w2b), ptr(dx), ptr(u), ptr(a), ptr(dz), ptr(dh),
           ptr(du), ptr(parts[0]), ptr(parts[1]), ptr(dgb[0]), ptr(dgb[1]),
           m, dim, hid, nn.LN_EPS, inv_keep, keep_q, int(seeds[0]),
           int(seeds[1]))
    fused_mlp_bwd_cuda.launches += 1
    return (dx, u.reshape(m, dim), a, dz.reshape(m, dim), dh, dgb[0],
            dgb[1])


fused_mlp_bwd_cuda.launches = 0


class FusedMlp(torch.autograd.Function):
    """K4 forward (with h), K9 backward; dW1, dW2, db1, db2 outside."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, dropout_rate, seeds):
        cpu = on_cpu(x, gamma, beta, w1, b1, w2, b2)
        fwd = fused_mlp_block_plain if cpu else fused_mlp_block_cuda
        y, h = fwd(x, gamma, beta, w1, b1, w2, b2, dropout_rate=dropout_rate,
                   seeds=seeds, return_h=True)
        ctx.save_for_backward(x, h, gamma, beta, w1, w2)
        ctx.args = dict(dropout_rate=dropout_rate, seeds=seeds)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, h, gamma, beta, w1, w2 = ctx.saved_tensors
        dy = dy.contiguous()
        bwd = fused_mlp_bwd_plain if on_cpu(x, dy) else fused_mlp_bwd_cuda
        dx, u, a, dz, dh, dgamma, dbeta = bwd(dy, x, h, gamma, beta, w1, w2,
                                              **ctx.args)
        dw1 = weight_grad(dh, u).to(w1.dtype)
        dw2 = weight_grad(dz, a).to(w2.dtype)
        db1 = dh.float().sum(0)
        db2 = dz.float().sum(0)
        return dx, dgamma, dbeta, dw1, db1, dw2, db2, None, None


def fused_mlp_block(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor, *, dropout_rate: float = 0.0,
                    seeds: Seeds = (0, 0)) -> torch.Tensor:
    """x + Drop(fc2(Drop(GELU(fc1(LN(x)))))), [B, N, dim]. Differentiable
    when an input requires grad. CPU tensors take the plain version, CUDA
    tensors the kernels."""
    args = (x, gamma, beta, w1, b1, w2, b2)
    if is_training(*args):
        return FusedMlp.apply(*args, float(dropout_rate),
                              (int(seeds[0]), int(seeds[1])))
    fn = fused_mlp_block_plain if on_cpu(*args) else fused_mlp_block_cuda
    return fn(*args, dropout_rate=dropout_rate, seeds=seeds)
