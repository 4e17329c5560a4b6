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
``csrc/fused_qkv.cu`` (K2) and ``csrc/fused_qkv_bwd.cu`` (K7), both on TMA
+ ``wgmma``. K2 runs in two launches (:func:`qkv_plan`): K4's LayerNorm
rows pass writes u (the caller's u in training, a scratch in serving),
then the QKV GEMM, each column tile serving one of q, k, v. K7 runs in
four (:func:`qkv_bwd_plan`): each row's LayerNorm statistics, then K9's
last three passes (``csrc/ln_bwd.cuh``): du = [dq | dk | dv] Wqkv in f32
with the tile's partial LayerNorm-backward sums in its epilogue, the
LayerNorm backward rows, the dgamma / dbeta sums over the row tiles in a
fixed order; du, the statistics and the partial sums go through one
scratch allocation. Both take dim and heads * dim_head as multiples of
16, of any size. f32 CUDA tensors run ``csrc/fused_qkv_f32.cu`` (K2 at
f32, :func:`qkv_f32_plan`: the weight pre-pass of :mod:`.tf32x3` on
Wqkv, the LayerNorm rows, then the QKV GEMM in 3xTF32 on ``wgmma``,
``csrc/tf32x3_wgmma.cuh``) and ``csrc/fused_qkv_bwd_f32.cu`` (K7 at f32,
:func:`qkv_bwd_f32_plan`: the transposing weight pre-pass of
:mod:`.tf32x3` on Wqkv, then the same passes with the du GEMM in 3xTF32
on ``wgmma``, the last three K9 f32's, ``csrc/tf32x3_ln_bwd.cuh``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.ops import tf32x3
from neurovit_tpu_torch.ops.common import (FLOAT, INT, VOID, check_operand,
                                           check_widths, is_training, launch,
                                           pick, ptr, round_up, weight_grad)
from neurovit_tpu_torch.ops.fused_mlp import (GEMM_THREADS, MLP_TILE,
                                              ROW_WARPS, SCRATCH_ALIGN,
                                              gemm_smem_bytes, gemm_tile_n,
                                              ln_backward_plain,
                                              ln_bwd_f32_passes,
                                              ln_bwd_passes)


def check_fwd_shapes(dim: int, inner: int) -> None:
    """Raise unless K2 takes x [*, dim] and heads * dim_head = inner:
    multiples of 16, the 16-byte rows of its TMA operands, of any size (its
    LayerNorm rows read the row again for each statistic, and its GEMM
    stages no whole row)."""
    check_widths("LN+QKV", dim=dim, inner=inner)


class QkvPlan(NamedTuple):
    """How one K2 call covers x [m, dim] with heads * dim_head = inner.
    ``launches``: the kernels in launch order, each (name, grid, threads,
    dynamic shared memory bytes), a grid (x, y): K4's LayerNorm rows pass,
    then the GEMM over (3 column tiles of inner each rounded up, row tiles
    of 128); at f32 the weight pre-pass first and the GEMM over the [m, 3
    inner] output. ``tile_n``: the GEMM's output tile columns.
    ``scratch``: the pieces of the scratch allocation, name -> (byte
    offset, bytes), in ``scratch_bytes`` bytes: u [m, dim] in x's dtype in
    serving, nothing in training, where u is the call's own output."""
    launches: tuple
    tile_n: int
    scratch: dict
    scratch_bytes: int


def qkv_plan(m: int, dim: int, inner: int, *,
             return_u: bool = False) -> QkvPlan:
    """K2's plan for m rows (the kernel's own counts are
    ``nvt_fused_ln_qkv_fwd_scratch_bytes``, for serving, and
    ``nvt_fused_ln_qkv_fwd_smem_bytes``; the card test holds them equal).
    The GEMM's tiles are 128 x 128, or 128 x 64 where 128-wide tiles over
    the [m, 3 inner] output would give the card fewer blocks than SMs
    (:func:`~neurovit_tpu_torch.ops.fused_mlp.gemm_tile_n`). Raises where
    the kernel does not take the widths."""
    check_fwd_shapes(dim, inner)
    if m < 1:
        raise ValueError(f"the LN+QKV kernel takes at least one row, got {m}")
    tile_n = gemm_tile_n(m, 3 * inner)
    launches = (
        ("ln_rows", (-(-m // ROW_WARPS), 1), ROW_WARPS * 32, 0),
        ("qkv_gemm", (3 * -(-inner // tile_n), -(-m // MLP_TILE)),
         GEMM_THREADS, gemm_smem_bytes(tile_n)))
    if return_u:
        return QkvPlan(launches=launches, tile_n=tile_n, scratch={},
                       scratch_bytes=0)
    return QkvPlan(launches=launches, tile_n=tile_n,
                   scratch={"u": (0, m * dim * 2)},
                   scratch_bytes=round_up(m * dim * 2, SCRATCH_ALIGN))


def qkv_f32_plan(m: int, dim: int, inner: int, *,
                 return_u: bool = False) -> QkvPlan:
    """K2 f32's plan for m rows, its launches in order: the weight
    pre-pass on Wqkv (:func:`.tf32x3.split_launch`, of its own wrapper),
    LayerNorm rows, then the QKV GEMM in 3xTF32 on ``wgmma`` on 128 x 128
    tiles over the [m, 3 inner] output (:func:`.tf32x3.gemm_launch`; the
    kernel's own count of the shared memory is
    ``nvt_fused_ln_qkv_f32_smem_bytes``); u [m, dim] f32 in the scratch
    when serving. The widths K2 takes. Raises where the kernel does not
    take them."""
    check_fwd_shapes(dim, inner)
    if m < 1:
        raise ValueError(f"the LN+QKV kernel takes at least one row, got {m}")
    launches = (tf32x3.split_launch("split_wqkv", 3 * inner * dim),
                ("ln_rows", (-(-m // ROW_WARPS), 1), ROW_WARPS * 32, 0),
                tf32x3.gemm_launch("qkv_gemm", m, 3 * inner))
    if return_u:
        return QkvPlan(launches=launches, tile_n=tf32x3.TILE, scratch={},
                       scratch_bytes=0)
    return QkvPlan(launches=launches, tile_n=tf32x3.TILE,
                   scratch={"u": (0, m * dim * 4)},
                   scratch_bytes=round_up(m * dim * 4, SCRATCH_ALIGN))


def check_bwd_shapes(dim: int, inner: int) -> None:
    """Raise unless K7 takes these widths: multiples of 16, the 16-byte
    rows of its TMA operands, of any size (its LayerNorm rows read the row
    again for each statistic, and its GEMM stages no whole row)."""
    check_widths("LN+QKV backward", dim=dim, inner=inner)


class QkvBwdPlan(NamedTuple):
    """How one K7 call covers m rows of width dim with heads * dim_head =
    inner. ``launches``: the kernels in launch order (four; five at f32,
    the weight pre-pass first), each (name, grid, threads, dynamic shared
    memory bytes), a grid (x, y): the row statistics, then
    :func:`~neurovit_tpu_torch.ops.fused_mlp.ln_bwd_passes`
    (the du GEMM over K = 3 inner, the LayerNorm backward rows, the column
    sums). ``scratch``: the pieces of the one scratch allocation, name ->
    (byte offset, bytes), in ``scratch_bytes`` bytes: du [m, dim] f32, each
    row's (mean, rstd) as two f32, the du pass's row partials [2, m, column
    tiles] f32 and its column partials [2, row tiles, dim] f32."""
    launches: tuple
    scratch: dict
    scratch_bytes: int


def qkv_bwd_plan(m: int, dim: int, inner: int) -> QkvBwdPlan:
    """K7's plan for m rows (the kernel's own counts are
    ``nvt_fused_ln_qkv_bwd_scratch_bytes`` and
    ``nvt_fused_ln_qkv_bwd_smem_bytes``; the card test holds them equal).
    Raises where the kernel does not take the widths."""
    check_bwd_shapes(dim, inner)
    if m < 1:
        raise ValueError(f"the LN+QKV backward kernel takes at least one "
                         f"row, got {m}")
    tail, scratch, nbytes = ln_bwd_passes(m, dim)
    launches = (("row_stats", (-(-m // ROW_WARPS), 1), ROW_WARPS * 32, 0),
                ) + tail
    return QkvBwdPlan(launches=launches, scratch=scratch,
                      scratch_bytes=nbytes)


def qkv_bwd_f32_plan(m: int, dim: int, inner: int) -> QkvBwdPlan:
    """K7 f32's plan for m rows: the weight pre-pass on Wqkv [3 inner,
    dim] (:func:`.tf32x3.split_t_launch`, of its own wrapper: du
    contracts Wqkv's out dimension, so it is turned), the row statistics
    (K2 f32's), then
    :func:`~neurovit_tpu_torch.ops.fused_mlp.ln_bwd_f32_passes` (the du
    GEMM over K = 3 inner in 3xTF32 on ``wgmma``, its shared memory
    ``nvt_fused_ln_qkv_f32_bwd_smem_bytes``, the LayerNorm backward rows,
    the column sums). The widths K7 takes, the same as bf16's. Raises
    where the kernel does not take them."""
    check_bwd_shapes(dim, inner)
    if m < 1:
        raise ValueError(f"the LN+QKV backward kernel takes at least one "
                         f"row, got {m}")
    tail, scratch, nbytes = ln_bwd_f32_passes(m, dim)
    launches = (tf32x3.split_t_launch(3 * inner, dim, "wsplit_wqkv"),
                ("row_stats", (-(-m // ROW_WARPS), 1), ROW_WARPS * 32, 0),
                ) + tail
    return QkvBwdPlan(launches=launches, scratch=scratch,
                      scratch_bytes=nbytes)


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


def fused_ln_qkv_bwd_plain(dqkv, x, gamma, w_qkv):
    """The backward kernel's function in plain PyTorch on dqkv = [dq | dk |
    dv] [B, N, 3 * heads * dim_head]: dx (x's dtype), dgamma, dbeta
    (f32)."""
    b, n, dim = x.shape
    du = torch.matmul(dqkv.reshape(b * n, -1).float(),
                      w_qkv.to(x.dtype).float())
    dx, dgamma, dbeta = ln_backward_plain(x.reshape(b * n, dim), du, gamma)
    return dx.to(x.dtype).reshape(x.shape), dgamma, dbeta


def _operands(x, w_qkv, inner, dtype=torch.bfloat16, **vectors):
    """The launch's weight in ``dtype`` (x's) and f32 LN vectors (gamma,
    beta by name), checked, for heads * dim_head = inner."""
    dim = x.shape[-1]
    check_operand("x", x, dtype)
    w = w_qkv.to(dtype).contiguous()
    check_operand("w_qkv", w, dtype, (3 * inner, dim))
    vecs = {}
    for name, t in vectors.items():
        vecs[name] = t.float().contiguous()
        check_operand(name, vecs[name], torch.float32, (dim,))
    return w, vecs


def fused_ln_qkv_cuda(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, w_qkv: torch.Tensor, heads: int,
                      dim_head: int, *, return_u: bool = False):
    """Launch the Hopper kernel K2 (:func:`qkv_plan`: LayerNorm rows, the
    QKV GEMM) on bf16 x [B, N, dim]; the weight is cast to bf16 and the LN
    affine to f32, as the JAX op casts them. u goes into the returned
    tensor with ``return_u``, else into one scratch allocation."""
    b, n, dim = x.shape
    w, vecs = _operands(x, w_qkv, heads * dim_head, gamma=gamma, beta=beta)
    plan = qkv_plan(b * n, dim, heads * dim_head, return_u=return_u)
    q, k, v = (x.new_empty(b, n, heads, dim_head) for _ in range(3))
    u = (torch.empty_like(x) if return_u else
         torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=x.device))
    launch("nvt_fused_ln_qkv_fwd",
           (VOID,) * 8 + (INT, INT, INT, FLOAT), x,
           ptr(x), ptr(vecs["gamma"]), ptr(vecs["beta"]), ptr(w), ptr(q),
           ptr(k), ptr(v), ptr(u), b * n, dim, heads * dim_head, nn.LN_EPS)
    fused_ln_qkv_cuda.launches += 1
    return (q, k, v, u) if return_u else (q, k, v)


fused_ln_qkv_cuda.launches = 0


def fused_ln_qkv_f32_cuda(x: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, w_qkv: torch.Tensor,
                          heads: int, dim_head: int, *,
                          return_u: bool = False):
    """Launch K2 at f32 (:func:`qkv_f32_plan`) on f32 x [B, N, dim]: Wqkv's
    split by the pre-pass (:func:`.tf32x3.split_cuda`, which counts its own
    launch), the LayerNorm rows, then the f32 products in 3xTF32 on the
    tensor cores. u goes into the returned tensor with ``return_u``, else
    into a scratch."""
    b, n, dim = x.shape
    inner = heads * dim_head
    w, vecs = _operands(x, w_qkv, inner, torch.float32, gamma=gamma,
                        beta=beta)
    plan = qkv_f32_plan(b * n, dim, inner, return_u=return_u)
    q, k, v = (x.new_empty(b, n, heads, dim_head) for _ in range(3))
    u = (torch.empty_like(x) if return_u else
         torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=x.device))
    w_big, w_small = tf32x3.split_cuda(w)
    launch("nvt_fused_ln_qkv_f32_fwd",
           (VOID,) * 9 + (INT, INT, INT, FLOAT), x,
           ptr(x), ptr(vecs["gamma"]), ptr(vecs["beta"]), ptr(w_big),
           ptr(w_small), ptr(q), ptr(k), ptr(v), ptr(u), b * n, dim, inner,
           nn.LN_EPS)
    fused_ln_qkv_f32_cuda.launches += 1
    return (q, k, v, u) if return_u else (q, k, v)


fused_ln_qkv_f32_cuda.launches = 0


def _forward(*tensors):
    """The forward of a call (``common.pick``): plain, K2 or K2 at f32."""
    return pick(fused_ln_qkv_plain, fused_ln_qkv_cuda, fused_ln_qkv_f32_cuda,
                *tensors)


def fused_ln_qkv_bwd_cuda(dqkv, x, gamma, w_qkv):
    """Launch the Hopper kernel K7 (:func:`qkv_bwd_plan`: row statistics,
    the du GEMM, LayerNorm backward rows, dgamma/dbeta sums) on dqkv = [dq
    | dk | dv] [B, N, 3 * inner] bf16; returns dx bf16, dgamma and dbeta
    f32."""
    b, n, dim = x.shape
    inner = dqkv.shape[-1] // 3
    w, vecs = _operands(x, w_qkv, inner, gamma=gamma)
    check_operand("dqkv", dqkv, torch.bfloat16, (b, n, 3 * inner))
    m = b * n
    plan = qkv_bwd_plan(m, dim, inner)
    dx = torch.empty_like(x)
    dgb = torch.empty((2, dim), dtype=torch.float32, device=x.device)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=x.device)
    launch("nvt_fused_ln_qkv_bwd", (VOID,) * 8 + (INT, INT, INT, FLOAT), x,
           ptr(dqkv), ptr(x), ptr(vecs["gamma"]), ptr(w), ptr(dx),
           ptr(dgb[0]), ptr(dgb[1]), ptr(scratch), m, dim, inner, nn.LN_EPS)
    fused_ln_qkv_bwd_cuda.launches += 1
    return dx, dgb[0], dgb[1]


fused_ln_qkv_bwd_cuda.launches = 0


def fused_ln_qkv_bwd_f32_cuda(dqkv, x, gamma, w_qkv):
    """Launch K7 at f32 (:func:`qkv_bwd_f32_plan`) on f32 dqkv = [dq | dk |
    dv] [B, N, 3 * inner] and x: Wqkv's split transpose by the pre-pass
    (:func:`.tf32x3.split_t_cuda`, which counts its own launch), then the
    f32 products in 3xTF32 on the tensor cores; returns dx, dgamma and
    dbeta, f32."""
    b, n, dim = x.shape
    inner = dqkv.shape[-1] // 3
    w, vecs = _operands(x, w_qkv, inner, torch.float32, gamma=gamma)
    check_operand("dqkv", dqkv, torch.float32, (b, n, 3 * inner))
    m = b * n
    plan = qkv_bwd_f32_plan(m, dim, inner)
    dx = torch.empty_like(x)
    dgb = torch.empty((2, dim), dtype=torch.float32, device=x.device)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=x.device)
    wt_big, wt_small = tf32x3.split_t_cuda(w)
    launch("nvt_fused_ln_qkv_f32_bwd", (VOID,) * 9 + (INT, INT, INT, FLOAT),
           x, ptr(dqkv), ptr(x), ptr(vecs["gamma"]), ptr(wt_big),
           ptr(wt_small), ptr(dx), ptr(dgb[0]), ptr(dgb[1]), ptr(scratch), m,
           dim, inner, nn.LN_EPS)
    fused_ln_qkv_bwd_f32_cuda.launches += 1
    return dx, dgb[0], dgb[1]


fused_ln_qkv_bwd_f32_cuda.launches = 0


class FusedLnQkv(torch.autograd.Function):
    """K2 forward (with u), K7 backward (bf16 or f32, ``common.pick``);
    dWqkv = dqkv^T u outside."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w_qkv, heads, dim_head):
        fwd = _forward(x, gamma, beta, w_qkv)
        q, k, v, u = fwd(x, gamma, beta, w_qkv, heads, dim_head,
                         return_u=True)
        ctx.save_for_backward(x, gamma, w_qkv, u)
        return q, k, v

    @staticmethod
    def backward(ctx, dq, dk, dv):
        x, gamma, w_qkv, u = ctx.saved_tensors
        b, n, _ = x.shape
        # [dq | dk | dv] once, the operand of both du and dWqkv.
        dqkv = torch.cat([t.reshape(b, n, -1) for t in (dq, dk, dv)], dim=2)
        bwd = pick(fused_ln_qkv_bwd_plain, fused_ln_qkv_bwd_cuda,
                   fused_ln_qkv_bwd_f32_cuda, x, dqkv)
        dx, dgamma, dbeta = bwd(dqkv, x, gamma, w_qkv)
        dw = weight_grad(dqkv.reshape(b * n, -1),
                         u.reshape(b * n, -1)).to(w_qkv.dtype)
        return dx, dgamma, dbeta, dw, None, None


def fused_ln_qkv(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 w_qkv: torch.Tensor, heads: int, dim_head: int) -> QKV:
    """LN(x) then the QKV projection: [B, N, dim] -> q, k, v [B, N, H, D].
    Differentiable when an input requires grad. CPU tensors take the plain
    version, CUDA tensors the kernels (bf16 or f32)."""
    if is_training(x, gamma, beta, w_qkv):
        return FusedLnQkv.apply(x, gamma, beta, w_qkv, heads, dim_head)
    return _forward(x, gamma, beta, w_qkv)(x, gamma, beta, w_qkv, heads,
                                           dim_head)
