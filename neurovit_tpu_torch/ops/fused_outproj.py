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
``csrc/fused_outproj.cu`` (K3) and ``csrc/fused_outproj_bwd.cu`` (K8), both
on TMA + ``wgmma``. K3 is one launch of K4's last pass
(:func:`outproj_plan`). K8 is K9's dz rows pass without the LayerNorm,
at dropout > 0 only, then a GEMM that reads Wout as it lies
(:func:`outproj_bwd_plan`); at dropout 0 dz is dy. Both take inner and
dim as any multiples of 16. f32 CUDA tensors run
``csrc/fused_outproj_f32.cu`` (K3 at f32, :func:`outproj_f32_plan`: the
forwards' weight pre-pass of ``ops/tf32x3.py`` on Wout as it lies, then
one launch of K4 f32's fc2_residual pass in 3xTF32 on ``wgmma``,
``csrc/tf32x3_wgmma.cuh``) and ``csrc/fused_outproj_bwd_f32.cu`` (K8 at
f32, :func:`outproj_bwd_f32_plan`: the transposing weight pre-pass of
``ops/tf32x3.py``, K9 f32's dz rows pass without the LayerNorm at dropout
> 0, then the GEMM in 3xTF32 on ``wgmma``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.ops import tf32x3
from neurovit_tpu_torch.ops.common import (FLOAT, INT, U64, VOID,
                                           check_operand, check_widths,
                                           dropout_args, is_training, launch,
                                           pick, ptr, weight_grad)
from neurovit_tpu_torch.ops.fused_mlp import (GEMM_THREADS, MLP_TILE,
                                              ROW_WARPS, gemm_smem_bytes,
                                              gemm_tile_n)


def check_fwd_shapes(dim: int, inner: int) -> None:
    """Raise unless K3 takes the attention width inner and the model width
    dim: multiples of 16, the 16-byte rows of its TMA operands, of any size
    (no row block of a is held in shared memory)."""
    check_widths("out-projection", inner=inner, dim=dim)


def check_bwd_shapes(dim: int, inner: int) -> None:
    """Raise unless K8 takes these widths: multiples of 16, the 16-byte
    rows of its TMA operands, of any size (no row of dz is held in shared
    memory)."""
    check_widths("out-projection backward", inner=inner, dim=dim)


class OutprojPlan(NamedTuple):
    """How one K3 call covers a [m, inner] and x [m, dim]: ``launches``,
    its one kernel (name, grid, threads, dynamic shared memory bytes), K4's
    fc2_residual pass over (column tiles of dim, row tiles of 128); and
    ``tile_n``, its output tile columns."""
    launches: tuple
    tile_n: int


def outproj_plan(m: int, dim: int, inner: int) -> OutprojPlan:
    """K3's plan for m rows (the kernel's own count of the shared memory is
    ``nvt_fused_outproj_smem_bytes``; the card test holds the two equal).
    The tiles are 128 x 128, or 128 x 64 where 128-wide tiles over the
    [m, dim] output would give the card fewer blocks than SMs
    (:func:`~neurovit_tpu_torch.ops.fused_mlp.gemm_tile_n`). Raises where
    the kernel does not take the widths."""
    check_fwd_shapes(dim, inner)
    if m < 1:
        raise ValueError(f"the out-projection kernel takes at least one row, "
                         f"got {m}")
    tile_n = gemm_tile_n(m, dim)
    return OutprojPlan(launches=(("fc2_residual",
                                  (-(-dim // tile_n), -(-m // MLP_TILE)),
                                  GEMM_THREADS, gemm_smem_bytes(tile_n)),),
                       tile_n=tile_n)


def outproj_f32_plan(m: int, dim: int, inner: int) -> OutprojPlan:
    """K3 f32's plan for m rows, its launches in order: split_wout, the
    forwards' weight pre-pass on Wout [dim, inner] as it lies
    (:func:`.tf32x3.split_launch`, its own wrapper), then K4 f32's
    fc2_residual pass in 3xTF32 on ``wgmma`` on 128 x 128 tiles over the
    [m, dim] output with K = inner (:func:`.tf32x3.gemm_launch`; the
    kernel's own count of the shared memory is
    ``nvt_fused_outproj_f32_smem_bytes``, the card test holds the two
    equal). The widths K3 takes. Raises where the kernel does not take
    them."""
    check_fwd_shapes(dim, inner)
    if m < 1:
        raise ValueError(f"the out-projection kernel takes at least one row, "
                         f"got {m}")
    return OutprojPlan(launches=(tf32x3.split_launch("split_wout",
                                                     dim * inner),
                                 tf32x3.gemm_launch("fc2_residual", m, dim)),
                       tile_n=tf32x3.TILE)


class OutprojBwdPlan(NamedTuple):
    """How one K8 call covers dy [m, dim] and dattn [m, inner]:
    ``launches``, its kernels in launch order, each (name, grid, threads,
    dynamic shared memory bytes): at dropout > 0 dz_rows (one warp a row,
    K9's pass 1 without the LayerNorm), then dattn, the GEMM over (column
    tiles of inner, row tiles of 128); and ``tile_n``, dattn's output tile
    columns."""
    launches: tuple
    tile_n: int


def outproj_bwd_plan(m: int, dim: int, inner: int,
                     dropout_rate: float) -> OutprojBwdPlan:
    """K8's plan for m rows (the kernel's own count of the shared memory is
    ``nvt_fused_outproj_bwd_smem_bytes``; the card test holds the two
    equal). The tiles are 128 x 128, or 128 x 64 where 128-wide tiles over
    the [m, inner] output would give the card fewer blocks than SMs
    (:func:`~neurovit_tpu_torch.ops.fused_mlp.gemm_tile_n`). At dropout 0
    the GEMM reads dy and there is no dz_rows launch. Raises where the
    kernel does not take the widths."""
    check_bwd_shapes(dim, inner)
    if m < 1:
        raise ValueError(f"the out-projection backward kernel takes at "
                         f"least one row, got {m}")
    tile_n = gemm_tile_n(m, inner)
    dattn = ("dattn", (-(-inner // tile_n), -(-m // MLP_TILE)),
             GEMM_THREADS, gemm_smem_bytes(tile_n))
    rows = ("dz_rows", (-(-m // ROW_WARPS), 1), ROW_WARPS * 32, 0)
    return OutprojBwdPlan(
        launches=(rows, dattn) if dropout_rate else (dattn,), tile_n=tile_n)


def outproj_bwd_f32_plan(m: int, dim: int, inner: int,
                         dropout_rate: float) -> OutprojBwdPlan:
    """K8 f32's plan for m rows, its launches in order: wsplit, the weight
    pre-pass (Wout's transpose split for 3xTF32, :mod:`.tf32x3`); at
    dropout > 0 dz_rows (K9 f32's pass 1 without the LayerNorm); then
    dattn, the 3xTF32 ``wgmma`` GEMM on 128 x 128 tiles over the [m,
    inner] output (its shared memory ``nvt_fused_outproj_f32_bwd_smem_bytes``;
    the card test holds the two equal). The widths K8 takes. Raises where
    the kernel does not take them."""
    check_bwd_shapes(dim, inner)
    if m < 1:
        raise ValueError(f"the out-projection backward kernel takes at "
                         f"least one row, got {m}")
    wsplit = tf32x3.split_t_launch(dim, inner)
    dattn = tf32x3.gemm_launch("dattn", m, inner)
    rows = ("dz_rows", (-(-m // ROW_WARPS), 1), ROW_WARPS * 32, 0)
    return OutprojBwdPlan(
        launches=(wsplit, rows, dattn) if dropout_rate else (wsplit, dattn),
        tile_n=tf32x3.TILE)


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
    """Launch the Hopper kernel K3 on bf16 activations: one launch
    (:func:`outproj_plan`) on the current stream; the C entry point encodes
    the two tensor maps and raises through ``launch`` on any failure."""
    b, n, dim = x.shape
    inner = attn.shape[-1]
    check_operand("x", x, torch.bfloat16)
    check_operand("attn", attn, torch.bfloat16, (b, n, inner))
    w = w_out.to(torch.bfloat16).contiguous()
    bias = b_out.float().contiguous()
    check_operand("w_out", w, torch.bfloat16, (dim, inner))
    check_operand("b_out", bias, torch.float32, (dim,))
    outproj_plan(b * n, dim, inner)
    inv_keep, keep_q = dropout_args(dropout_rate)
    y = torch.empty_like(x)
    launch("nvt_fused_outproj_fwd",
           (VOID,) * 5 + (INT,) * 3 + (FLOAT, INT, U64), x, ptr(attn),
           ptr(x), ptr(w), ptr(bias), ptr(y), b * n, inner, dim, inv_keep,
           keep_q, int(seed))
    fused_outproj_residual_cuda.launches += 1
    return y


fused_outproj_residual_cuda.launches = 0


def fused_outproj_residual_f32_cuda(x: torch.Tensor, attn: torch.Tensor,
                                    w_out: torch.Tensor, b_out: torch.Tensor,
                                    *, dropout_rate: float = 0.0,
                                    seed: int = 0) -> torch.Tensor:
    """Launch K3 at f32 (:func:`outproj_f32_plan`) on f32 activations:
    Wout's split by the pre-pass (:func:`.tf32x3.split_cuda`, which counts
    its own launch), then the f32 products in 3xTF32 on the tensor cores,
    K4 f32's fc2_residual pass with A = attn."""
    b, n, dim = x.shape
    inner = attn.shape[-1]
    check_operand("x", x, torch.float32)
    check_operand("attn", attn, torch.float32, (b, n, inner))
    w = w_out.float().contiguous()
    bias = b_out.float().contiguous()
    check_operand("w_out", w, torch.float32, (dim, inner))
    check_operand("b_out", bias, torch.float32, (dim,))
    outproj_f32_plan(b * n, dim, inner)
    inv_keep, keep_q = dropout_args(dropout_rate)
    y = torch.empty_like(x)
    w_big, w_small = tf32x3.split_cuda(w)
    launch("nvt_fused_outproj_f32_fwd",
           (VOID,) * 6 + (INT,) * 3 + (FLOAT, INT, U64), x, ptr(attn),
           ptr(x), ptr(w_big), ptr(w_small), ptr(bias), ptr(y), b * n,
           inner, dim, inv_keep, keep_q, int(seed))
    fused_outproj_residual_f32_cuda.launches += 1
    return y


fused_outproj_residual_f32_cuda.launches = 0


def _forward(*tensors):
    """The forward of a call (``common.pick``): plain, K3 or K3 at f32."""
    return pick(fused_outproj_residual_plain, fused_outproj_residual_cuda,
                fused_outproj_residual_f32_cuda, *tensors)


def fused_outproj_bwd_cuda(dy: torch.Tensor, w_out: torch.Tensor, *,
                           dropout_rate: float = 0.0, seed: int = 0):
    """Launch the Hopper kernel K8 (:func:`outproj_bwd_plan`) on the
    current stream; the C entry point encodes the tensor maps and raises
    through ``launch`` on any failure. Returns (dattn, dz) bf16; at
    dropout 0 dz is dy itself, the plain version's bits."""
    b, n, dim = dy.shape
    inner = w_out.shape[1]
    check_operand("dy", dy, torch.bfloat16)
    w = w_out.to(torch.bfloat16).contiguous()
    check_operand("w_out", w, torch.bfloat16, (dim, inner))
    outproj_bwd_plan(b * n, dim, inner, dropout_rate)
    inv_keep, keep_q = dropout_args(dropout_rate)
    dattn = dy.new_empty(b, n, inner)
    dz = torch.empty_like(dy) if keep_q else None
    launch("nvt_fused_outproj_bwd",
           (VOID,) * 4 + (INT,) * 3 + (FLOAT, INT, U64), dy, ptr(dy),
           ptr(w), ptr(dattn), ptr(dz), b * n, inner, dim, inv_keep, keep_q,
           int(seed))
    fused_outproj_bwd_cuda.launches += 1
    return dattn, dy if dz is None else dz


fused_outproj_bwd_cuda.launches = 0


def fused_outproj_bwd_f32_cuda(dy: torch.Tensor, w_out: torch.Tensor, *,
                               dropout_rate: float = 0.0, seed: int = 0):
    """Launch K8 at f32 (:func:`outproj_bwd_f32_plan`) on f32 dy: Wout's
    split transpose by the pre-pass (:func:`.tf32x3.split_t_cuda`, which
    counts its own launch), then dz and the f32 products in 3xTF32 on the
    tensor cores. Returns (dattn, dz) f32; at dropout 0 dz is dy itself."""
    b, n, dim = dy.shape
    inner = w_out.shape[1]
    check_operand("dy", dy, torch.float32)
    w = w_out.float().contiguous()
    check_operand("w_out", w, torch.float32, (dim, inner))
    outproj_bwd_f32_plan(b * n, dim, inner, dropout_rate)
    inv_keep, keep_q = dropout_args(dropout_rate)
    dattn = dy.new_empty(b, n, inner)
    dz = torch.empty_like(dy) if keep_q else None
    wt_big, wt_small = tf32x3.split_t_cuda(w)
    launch("nvt_fused_outproj_f32_bwd",
           (VOID,) * 5 + (INT,) * 3 + (FLOAT, INT, U64), dy, ptr(dy),
           ptr(wt_big), ptr(wt_small), ptr(dattn), ptr(dz), b * n, inner,
           dim, inv_keep, keep_q, int(seed))
    fused_outproj_bwd_f32_cuda.launches += 1
    return dattn, dy if dz is None else dz


fused_outproj_bwd_f32_cuda.launches = 0


class FusedOutproj(torch.autograd.Function):
    """K3 forward, K8 backward (bf16 or f32, ``common.pick``); dWout, db
    and dx = dy outside."""

    @staticmethod
    def forward(ctx, x, attn, w_out, b_out, dropout_rate, seed):
        fwd = _forward(x, attn, w_out, b_out)
        y = fwd(x, attn, w_out, b_out, dropout_rate=dropout_rate, seed=seed)
        ctx.save_for_backward(attn, w_out)
        ctx.args = dict(dropout_rate=dropout_rate, seed=seed)
        return y

    @staticmethod
    def backward(ctx, dy):
        attn, w_out = ctx.saved_tensors
        dy = dy.contiguous()
        bwd = pick(fused_outproj_bwd_plain, fused_outproj_bwd_cuda,
                   fused_outproj_bwd_f32_cuda, dy, w_out)
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
    the kernels (bf16 or f32)."""
    if is_training(x, attn, w_out, b_out):
        return FusedOutproj.apply(x, attn, w_out, b_out, float(dropout_rate),
                                  int(seed))
    return _forward(x, attn, w_out, b_out)(x, attn, w_out, b_out,
                                           dropout_rate=dropout_rate,
                                           seed=seed)
