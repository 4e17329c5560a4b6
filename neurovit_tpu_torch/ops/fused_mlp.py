"""Fused residual MLP block, forward and backward, deterministic.

Counterpart of ``neurovit_tpu/ops/fused_mlp.py`` (``fused_mlp_block``; TPU
kernels ``_fwd_kernel`` :108 and ``_bwd_kernel`` :141):

    u = LN(x) * gamma + beta          f32, rounded to x's dtype
    h = u @ W1^T + b1                 f32, rounded to x's dtype before GELU
    g = GELU(h) * mask1 / keep        exact-erf GELU in f32, rounded
    z = (g @ W2^T + b2) * mask2 / keep    f32
    y = x + z                         x added in f32, rounded once

The masks (``dropout_rate`` > 0, training) are the Philox masks of two
sites, the hidden and the output, with the keys ``seeds``. In training the
forward stores h, which the backward (:class:`FusedMlp`) reads: it
recomputes LN, GELU and both masks, and emits dx, u, a, dz, dh and dgamma /
dbeta. dW1 = dh^T u, dW2 = dz^T a and the bias gradients are plain matmuls
and sums outside, as in JAX.

CPU tensors run the ``*_plain`` functions; bf16 CUDA tensors run
``csrc/fused_mlp.cu`` (K4) and ``csrc/fused_mlp_bwd.cu`` (K9), both on TMA
+ ``wgmma``; f32 CUDA tensors run ``csrc/fused_mlp_f32.cu`` (K4 at f32,
:func:`mlp_f32_plan`: the weight pre-pass of :mod:`.tf32x3` on W1 and W2,
the LayerNorm rows, then fc1 and fc2 in 3xTF32 on ``wgmma``,
``csrc/tf32x3_wgmma.cuh``) and ``csrc/fused_mlp_bwd_f32.cu`` (K9 at f32,
:func:`mlp_bwd_f32_plan`: the transposing weight pre-pass of
:mod:`.tf32x3` on W2 and W1, then the same passes with both GEMMs in
3xTF32 on ``wgmma``, the last three (:func:`ln_bwd_f32_passes`,
``csrc/tf32x3_ln_bwd.cuh``) shared with K7 at f32). K4 runs in
three launches (:func:`mlp_plan`): LN rows into u, fc1 with bias, GELU
and the hidden mask in its epilogue into g, fc2 with bias, the output
mask and the residual; u and g go through one scratch allocation. K9 runs in five (:func:`mlp_bwd_plan`): dz, u and each row's
LN statistics; da = dz W2 with a and dh in its epilogue; du = dh W1 in f32
with the tile's partial LN-backward sums (per row and per column) in its
epilogue; the LayerNorm backward rows with the residual; the dgamma /
dbeta sums over the row tiles in a fixed order. du, the statistics and
the partial sums go through one scratch allocation. Both take dim and
mlp_dim as any multiples of 16. K9's last three passes
(:func:`ln_bwd_passes`, csrc/ln_bwd.cuh) are also K7's, the LN + QKV
backward (ops/fused_qkv.py).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.ops import tf32x3
from neurovit_tpu_torch.ops.common import (FLOAT, INT, U64, VOID,
                                           check_operand, check_widths,
                                           dropout_args, is_training, launch,
                                           pick, ptr, round_up, weight_grad)
from neurovit_tpu_torch.ops.int8_gemm import ALIGN_SLACK, BOX_BYTES

Seeds = Tuple[int, int]
# K4's passes (csrc/fused_mlp.cu): rows (one warp each) a block of the LN
# pass, the GEMM passes' output tile rows (and columns, or half that where
# full tiles would give the card's 132 SMs fewer blocks) and ring stages
# (three, so two GEMM blocks share an SM), and the alignment of each piece
# of the scratch.
ROW_WARPS, MLP_TILE, MLP_STAGES, SCRATCH_ALIGN = 8, 128, 3, 256
SMS = 132
# A GEMM block: two consumer warpgroups and the producer warp.
GEMM_THREADS = 2 * 128 + 32
# K9's column-sum pass: columns of [dgamma, dbeta] a block (one a lane),
# and its warps, which split the row tiles.
SUM_COLUMNS, SUM_WARPS = 32, 8


def gemm_tile_n(m: int, n: int) -> int:
    """Output columns of a K4 GEMM block with an [m, n] output: 128, or 64
    where 128-wide tiles would make fewer blocks than the card has SMs."""
    return 64 if -(-n // MLP_TILE) * -(-m // MLP_TILE) < SMS else MLP_TILE


def gemm_smem_bytes(tile_n: int) -> int:
    """Dynamic shared memory of a K4 GEMM block: the ring's stages of a
    128 x 128-byte A box and a tile_n x 128-byte Bt box, a full and an
    empty barrier a stage, and the slack that aligns the ring to 1 KiB
    (csrc/hopper_gemm.cuh, Mainloop::kSmemBytes)."""
    return (ALIGN_SLACK + MLP_STAGES * (MLP_TILE + tile_n) * BOX_BYTES
            + 2 * MLP_STAGES * 8)


class MlpPlan(NamedTuple):
    """How one K4 call covers x [m, dim] with mlp_dim hid. ``launches``:
    the kernels in launch order (three; five at f32), each (name, grid,
    threads, dynamic shared memory bytes), a grid (x, y). ``scratch``: the
    pieces of the one scratch allocation, name -> (byte offset, bytes), in
    ``scratch_bytes`` bytes: u [m, dim] then g [m, hid], in x's dtype."""
    launches: tuple
    scratch: dict
    scratch_bytes: int


def check_fwd_shapes(dim: int, hid: int) -> None:
    """Raise unless K4 takes x [*, dim] and mlp_dim hid: multiples of 16,
    the 16-byte rows of its TMA operands, of any size (no row is held
    whole in registers or shared memory)."""
    check_widths("MLP", dim=dim, mlp_dim=hid)


def mlp_plan(m: int, dim: int, hid: int) -> MlpPlan:
    """K4's plan for m rows (the kernel's own counts are
    ``nvt_fused_mlp_scratch_bytes`` and ``nvt_fused_mlp_smem_bytes``; the
    card test holds them equal). Raises where the kernel does not take the
    widths."""
    check_fwd_shapes(dim, hid)
    if m < 1:
        raise ValueError(f"the MLP kernel takes at least one row, got {m}")
    m_tiles = -(-m // MLP_TILE)
    launches = [("ln_rows", (-(-m // ROW_WARPS), 1), ROW_WARPS * 32, 0)]
    for name, n in (("fc1_gelu", hid), ("fc2_residual", dim)):
        tile_n = gemm_tile_n(m, n)
        launches.append((name, (-(-n // tile_n), m_tiles), GEMM_THREADS,
                         gemm_smem_bytes(tile_n)))
    scratch, at = {}, 0
    for name, nbytes in (("u", m * dim * 2), ("g", m * hid * 2)):
        scratch[name] = (at, nbytes)
        at = round_up(at + nbytes, SCRATCH_ALIGN)
    return MlpPlan(launches=tuple(launches), scratch=scratch,
                   scratch_bytes=at)


def mlp_f32_plan(m: int, dim: int, hid: int) -> MlpPlan:
    """K4 f32's plan for m rows, its launches in order: the weight
    pre-pass on W1 and on W2 (:func:`.tf32x3.split_launch`, each of its own
    wrapper), LayerNorm rows, then fc1 with GELU and fc2 with the residual
    in 3xTF32 on ``wgmma`` on 128 x 128 tiles (:func:`.tf32x3.gemm_launch`;
    the kernel's own count of the shared memory is
    ``nvt_fused_mlp_f32_smem_bytes``, of the scratch
    ``nvt_fused_mlp_f32_scratch_bytes``); u [m, dim] and g [m, hid] f32 in
    the scratch. The widths K4 takes, the same as bf16's. Raises where the
    kernel does not take them."""
    check_fwd_shapes(dim, hid)
    if m < 1:
        raise ValueError(f"the MLP kernel takes at least one row, got {m}")
    launches = (tf32x3.split_launch("split_w1", hid * dim),
                tf32x3.split_launch("split_w2", dim * hid),
                ("ln_rows", (-(-m // ROW_WARPS), 1), ROW_WARPS * 32, 0),
                tf32x3.gemm_launch("fc1_gelu", m, hid),
                tf32x3.gemm_launch("fc2_residual", m, dim))
    scratch, at = {}, 0
    for name, nbytes in (("u", m * dim * 4), ("g", m * hid * 4)):
        scratch[name] = (at, nbytes)
        at = round_up(at + nbytes, SCRATCH_ALIGN)
    return MlpPlan(launches=launches, scratch=scratch, scratch_bytes=at)


def check_bwd_shapes(dim: int, hid: int) -> None:
    """Raise unless K9 takes these widths: multiples of 16, of any size
    (its LayerNorm rows read the row again for each statistic, and its
    GEMM passes stage no whole row)."""
    check_widths("MLP backward", dim=dim, mlp_dim=hid)


class MlpBwdPlan(NamedTuple):
    """How one K9 call covers m rows of width dim with mlp_dim hid.
    ``launches``: the kernels in launch order (five; seven at f32), each
    (name, grid, threads, dynamic shared memory bytes), a grid (x, y).
    ``scratch``: the pieces of the one scratch allocation, name -> (byte
    offset, bytes), in ``scratch_bytes`` bytes: du [m, dim] f32, each
    row's (mean, rstd) as two f32, the du pass's row partials of sum(du
    gamma) and sum(du gamma xhat), [2, m, column tiles] f32, and its
    column partials of dgamma and dbeta, [2, row tiles, dim] f32."""
    launches: tuple
    scratch: dict
    scratch_bytes: int


def ln_bwd_passes(m: int, dim: int) -> tuple:
    """The passes K9 and K7 share (csrc/ln_bwd.cuh) for m rows of width
    dim: (launches, scratch, scratch_bytes). ``launches``: the du GEMM on
    K4's tiles and ring (:func:`gemm_tile_n`, :func:`gemm_smem_bytes`), the
    LayerNorm backward rows (one warp a row) and the column sums (a lane a
    column of dgamma and dbeta), each (name, grid, threads, dynamic shared
    memory bytes). ``scratch``: du [m, dim] f32, each row's (mean, rstd)
    as two f32, the du pass's row partials of sum(du gamma) and sum(du
    gamma xhat), [2, m, column tiles] f32, and its column partials of
    dgamma and dbeta, [2, row tiles, dim] f32, name -> (byte offset,
    bytes), each on a 256-byte boundary, in ``scratch_bytes`` bytes."""
    m_tiles = -(-m // MLP_TILE)
    tile_n = gemm_tile_n(m, dim)
    n_tiles = -(-dim // tile_n)
    du = ("du", (n_tiles, m_tiles), GEMM_THREADS, gemm_smem_bytes(tile_n))
    return _ln_bwd_tail(du, m, dim, n_tiles, m_tiles)


def _ln_bwd_tail(du: tuple, m: int, dim: int, col_parts: int,
                 row_parts: int) -> tuple:
    """(launches, scratch, scratch_bytes) of a du pass ``du`` whose
    epilogue writes ``col_parts`` partial sums a row and ``row_parts`` a
    column, then the LayerNorm backward rows and the column sums."""
    launches = (du,
                ("ln_bwd", (-(-m // ROW_WARPS), 1), ROW_WARPS * 32, 0),
                ("colsum", (2 * dim // SUM_COLUMNS, 1), SUM_WARPS * 32, 0))
    scratch, at = {}, 0
    for name, nbytes in (("du", m * dim * 4), ("stats", m * 8),
                         ("rowpart", 2 * m * col_parts * 4),
                         ("colpart", 2 * row_parts * dim * 4)):
        scratch[name] = (at, nbytes)
        at = round_up(at + nbytes, SCRATCH_ALIGN)
    return launches, scratch, at


def ln_bwd_f32_passes(m: int, dim: int) -> tuple:
    """The passes K9 and K7 at f32 share (csrc/tf32x3_ln_bwd.cuh) for m
    rows of width dim: (launches, scratch, scratch_bytes), as
    :func:`ln_bwd_passes`. ``launches``: the du GEMM in 3xTF32 on
    ``wgmma`` on 128 x 128 tiles (:func:`.tf32x3.gemm_launch`) with the
    LayerNorm backward's partial sums in its epilogue, the LayerNorm
    backward rows and the column sums. ``scratch``: du [m, dim] f32, each
    row's (mean, rstd), the du pass's row partials [2, m, column tiles]
    f32 and its column partials [2, row tiles, dim] f32, each on a
    256-byte boundary. The kernels' own count is
    ``nvt_ln_bwd_f32_scratch_bytes``."""
    return _ln_bwd_tail(tf32x3.gemm_launch("du", m, dim), m, dim,
                        -(-dim // tf32x3.TILE), -(-m // tf32x3.TILE))


def mlp_bwd_plan(m: int, dim: int, hid: int) -> MlpBwdPlan:
    """K9's plan for m rows (the kernel's own counts are
    ``nvt_fused_mlp_bwd_scratch_bytes`` and ``nvt_fused_mlp_bwd_smem_bytes``;
    the card test holds them equal): dz rows and the hidden GEMM on K4's
    tiles and ring, then :func:`ln_bwd_passes`. Raises where the kernel
    does not take the widths."""
    check_bwd_shapes(dim, hid)
    if m < 1:
        raise ValueError(f"the MLP backward kernel takes at least one row, "
                         f"got {m}")
    tile_n = gemm_tile_n(m, hid)
    tail, scratch, nbytes = ln_bwd_passes(m, dim)
    launches = (("dz_rows", (-(-m // ROW_WARPS), 1), ROW_WARPS * 32, 0),
                ("hidden", (-(-hid // tile_n), -(-m // MLP_TILE)),
                 GEMM_THREADS, gemm_smem_bytes(tile_n))) + tail
    return MlpBwdPlan(launches=launches, scratch=scratch,
                      scratch_bytes=nbytes)


def mlp_bwd_f32_plan(m: int, dim: int, hid: int) -> MlpBwdPlan:
    """K9 f32's plan for m rows, its launches in order: the weight
    pre-pass on W2 [dim, hid] and on W1 [hid, dim]
    (:func:`.tf32x3.split_t_launch`, each of its own wrapper: both
    products contract the weight's out dimension, so each is turned), dz
    rows (u, the statistics and, at dropout > 0, dz), the hidden GEMM in
    3xTF32 on ``wgmma`` on 128 x 128 tiles over the [m, hid] output with a
    and dh in its epilogue (:func:`.tf32x3.gemm_launch`; the kernel's own
    count of the shared memory is ``nvt_fused_mlp_f32_bwd_smem_bytes``),
    then :func:`ln_bwd_f32_passes`. The widths K9 takes, the same as
    bf16's. Raises where the kernel does not take them."""
    check_bwd_shapes(dim, hid)
    if m < 1:
        raise ValueError(f"the MLP backward kernel takes at least one row, "
                         f"got {m}")
    tail, scratch, nbytes = ln_bwd_f32_passes(m, dim)
    launches = (tf32x3.split_t_launch(dim, hid, "wsplit_w2"),
                tf32x3.split_t_launch(hid, dim, "wsplit_w1"),
                ("dz_rows", (-(-m // ROW_WARPS), 1), ROW_WARPS * 32, 0),
                tf32x3.gemm_launch("hidden", m, hid)) + tail
    return MlpBwdPlan(launches=launches, scratch=scratch,
                      scratch_bytes=nbytes)


def _ln_stats(xf: torch.Tensor):
    """(xhat, rstd) per row in f32, as nn.layer_norm computes them."""
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + nn.LN_EPS)
    return xc * rstd, rstd


def ln_backward_plain(x2d: torch.Tensor, du: torch.Tensor,
                      gamma: torch.Tensor):
    """LayerNorm backward of f32 du at rows x2d (neurovit_tpu/ops/
    fused_qkv.py:80-96, fused_mlp.py:188-196), the plain version of
    :func:`ln_bwd_passes` without its GEMM and residual: f32 (dx, dgamma,
    dbeta)."""
    xhat, rstd = _ln_stats(x2d.float())
    dgamma = (du * xhat).sum(0)
    dbeta = du.sum(0)
    dxhat = du * gamma.float()
    m1 = dxhat.mean(dim=1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=1, keepdim=True)
    return rstd * (dxhat - m1 - xhat * m2), dgamma, dbeta


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


def _operands(x, w1, w2, dtype=torch.bfloat16, **vectors):
    """The launch's weights in ``dtype`` (x's) and f32 vectors (gamma,
    beta, b1, b2 by name), checked."""
    dim, hid = x.shape[-1], w1.shape[0]
    check_operand("x", x, dtype)
    w1b = w1.to(dtype).contiguous()
    w2b = w2.to(dtype).contiguous()
    check_operand("w1", w1b, dtype, (hid, dim))
    check_operand("w2", w2b, dtype, (dim, hid))
    sizes = {"gamma": dim, "beta": dim, "b1": hid, "b2": dim}
    vecs = {}
    for name, t in vectors.items():
        vecs[name] = t.float().contiguous()
        check_operand(name, vecs[name], torch.float32, (sizes[name],))
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
    plan = mlp_plan(b * n, dim, hid)
    inv_keep, keep_q = dropout_args(dropout_rate)
    y = torch.empty_like(x)
    h = x.new_empty(b, n, hid) if return_h else None
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=x.device)
    launch("nvt_fused_mlp_fwd",
           (VOID,) * 10 + (INT,) * 3 + (FLOAT, FLOAT, INT, U64, U64), x,
           ptr(x), ptr(vecs["gamma"]), ptr(vecs["beta"]), ptr(w1b),
           ptr(vecs["b1"]), ptr(w2b), ptr(vecs["b2"]), ptr(y), ptr(h),
           ptr(scratch), b * n, dim, hid, nn.LN_EPS, inv_keep, keep_q,
           int(seeds[0]), int(seeds[1]))
    fused_mlp_block_cuda.launches += 1
    return (y, h) if return_h else y


fused_mlp_block_cuda.launches = 0


def fused_mlp_block_f32_cuda(x: torch.Tensor, gamma: torch.Tensor,
                             beta: torch.Tensor, w1: torch.Tensor,
                             b1: torch.Tensor, w2: torch.Tensor,
                             b2: torch.Tensor, *, dropout_rate: float = 0.0,
                             seeds: Seeds = (0, 0), return_h: bool = False):
    """Launch K4 at f32 (:func:`mlp_f32_plan`) on f32 x [B, N, dim]: W1's
    and W2's splits by the pre-pass (:func:`.tf32x3.split_cuda`, which
    counts its own launches), then the f32 products in 3xTF32 on the
    tensor cores; h is the pre-GELU hidden."""
    b, n, dim = x.shape
    hid = w1.shape[0]
    w1f, w2f, vecs = _operands(x, w1, w2, torch.float32, gamma=gamma,
                               beta=beta, b1=b1, b2=b2)
    plan = mlp_f32_plan(b * n, dim, hid)
    inv_keep, keep_q = dropout_args(dropout_rate)
    y = torch.empty_like(x)
    h = x.new_empty(b, n, hid) if return_h else None
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=x.device)
    w1_big, w1_small = tf32x3.split_cuda(w1f)
    w2_big, w2_small = tf32x3.split_cuda(w2f)
    launch("nvt_fused_mlp_f32_fwd",
           (VOID,) * 12 + (INT,) * 3 + (FLOAT, FLOAT, INT, U64, U64), x,
           ptr(x), ptr(vecs["gamma"]), ptr(vecs["beta"]), ptr(w1_big),
           ptr(w1_small), ptr(vecs["b1"]), ptr(w2_big), ptr(w2_small),
           ptr(vecs["b2"]), ptr(y), ptr(h), ptr(scratch), b * n, dim, hid,
           nn.LN_EPS, inv_keep, keep_q, int(seeds[0]), int(seeds[1]))
    fused_mlp_block_f32_cuda.launches += 1
    return (y, h) if return_h else y


fused_mlp_block_f32_cuda.launches = 0


def _forward(*tensors):
    """The forward of a call (``common.pick``): plain, K4 or K4 at f32."""
    return pick(fused_mlp_block_plain, fused_mlp_block_cuda,
                fused_mlp_block_f32_cuda, *tensors)


def fused_mlp_bwd_cuda(dy, x, h, gamma, beta, w1, w2, *,
                       dropout_rate: float = 0.0, seeds: Seeds = (0, 0)):
    """Launch the Hopper kernel K9 (:func:`mlp_bwd_plan`: dz rows, the
    hidden GEMM, the du GEMM, LayerNorm backward rows, dgamma/dbeta sums);
    returns (dx, u, a, dz, dh, dgamma, dbeta)."""
    b, n, dim = x.shape
    hid = w1.shape[0]
    m = b * n
    w1b, w2b, vecs = _operands(x, w1, w2, gamma=gamma, beta=beta)
    check_operand("dy", dy, torch.bfloat16, (b, n, dim))
    check_operand("h", h, torch.bfloat16, (b, n, hid))
    plan = mlp_bwd_plan(m, dim, hid)
    inv_keep, keep_q = dropout_args(dropout_rate)
    dx, u, dz = (torch.empty_like(x) for _ in range(3))
    a, dh = (x.new_empty(m, hid) for _ in range(2))
    dgb = torch.empty((2, dim), dtype=torch.float32, device=x.device)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=x.device)
    launch("nvt_fused_mlp_bwd",
           (VOID,) * 15 + (INT, INT, INT, FLOAT, FLOAT, INT, U64, U64), x,
           ptr(dy), ptr(x), ptr(h), ptr(vecs["gamma"]), ptr(vecs["beta"]),
           ptr(w1b), ptr(w2b), ptr(dx), ptr(u), ptr(a), ptr(dz), ptr(dh),
           ptr(dgb[0]), ptr(dgb[1]), ptr(scratch), m, dim, hid, nn.LN_EPS,
           inv_keep, keep_q, int(seeds[0]), int(seeds[1]))
    fused_mlp_bwd_cuda.launches += 1
    return (dx, u.reshape(m, dim), a, dz.reshape(m, dim), dh, dgb[0],
            dgb[1])


fused_mlp_bwd_cuda.launches = 0


def fused_mlp_bwd_f32_cuda(dy, x, h, gamma, beta, w1, w2, *,
                           dropout_rate: float = 0.0, seeds: Seeds = (0, 0)):
    """Launch K9 at f32 (:func:`mlp_bwd_f32_plan`) on f32 operands: W2's
    and W1's split transposes by the pre-pass (:func:`.tf32x3.split_t_cuda`,
    which counts its own launches), then the f32 products in 3xTF32 on the
    tensor cores; returns (dx, u, a, dz, dh, dgamma, dbeta) in f32. At
    dropout 0 dz is dy itself, the plain version's values."""
    b, n, dim = x.shape
    hid = w1.shape[0]
    m = b * n
    w1f, w2f, vecs = _operands(x, w1, w2, torch.float32, gamma=gamma,
                               beta=beta)
    check_operand("dy", dy, torch.float32, (b, n, dim))
    check_operand("h", h, torch.float32, (b, n, hid))
    plan = mlp_bwd_f32_plan(m, dim, hid)
    inv_keep, keep_q = dropout_args(dropout_rate)
    dx, u = torch.empty_like(x), torch.empty_like(x)
    dz = torch.empty_like(dy) if keep_q else None
    a, dh = (x.new_empty(m, hid) for _ in range(2))
    dgb = torch.empty((2, dim), dtype=torch.float32, device=x.device)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=x.device)
    w2t_big, w2t_small = tf32x3.split_t_cuda(w2f)
    w1t_big, w1t_small = tf32x3.split_t_cuda(w1f)
    launch("nvt_fused_mlp_f32_bwd",
           (VOID,) * 17 + (INT, INT, INT, FLOAT, FLOAT, INT, U64, U64), x,
           ptr(dy), ptr(x), ptr(h), ptr(vecs["gamma"]), ptr(vecs["beta"]),
           ptr(w2t_big), ptr(w2t_small), ptr(w1t_big), ptr(w1t_small),
           ptr(dx), ptr(u), ptr(a), ptr(dz), ptr(dh), ptr(dgb[0]),
           ptr(dgb[1]), ptr(scratch), m, dim, hid, nn.LN_EPS, inv_keep,
           keep_q, int(seeds[0]), int(seeds[1]))
    fused_mlp_bwd_f32_cuda.launches += 1
    dz = dy if dz is None else dz
    return (dx, u.reshape(m, dim), a, dz.reshape(m, dim), dh, dgb[0],
            dgb[1])


fused_mlp_bwd_f32_cuda.launches = 0


class FusedMlp(torch.autograd.Function):
    """K4 forward (with h), K9 backward (bf16 or f32, ``common.pick``);
    dW1, dW2, db1, db2 outside."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, dropout_rate, seeds):
        fwd = _forward(x, gamma, beta, w1, b1, w2, b2)
        y, h = fwd(x, gamma, beta, w1, b1, w2, b2, dropout_rate=dropout_rate,
                   seeds=seeds, return_h=True)
        ctx.save_for_backward(x, h, gamma, beta, w1, w2)
        ctx.args = dict(dropout_rate=dropout_rate, seeds=seeds)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, h, gamma, beta, w1, w2 = ctx.saved_tensors
        dy = dy.contiguous()
        bwd = pick(fused_mlp_bwd_plain, fused_mlp_bwd_cuda,
                   fused_mlp_bwd_f32_cuda, x, dy)
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
    tensors the kernels (bf16 or f32)."""
    args = (x, gamma, beta, w1, b1, w2, b2)
    if is_training(*args):
        return FusedMlp.apply(*args, float(dropout_rate),
                              (int(seeds[0]), int(seeds[1])))
    return _forward(*args)(*args, dropout_rate=dropout_rate, seeds=seeds)
