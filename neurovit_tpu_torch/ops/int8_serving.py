"""int8 serving: weight quantization and the four int8 block ops.

Counterpart of ``neurovit_tpu/ops/int8_serving.py``. The scheme
(int8_serving.py:13-22): the four GEMM weights of a block are int8,
symmetric per output channel, quantized once on the host by
:func:`quantize_weight`; activations are quantized per row inside the
kernels, symmetric, with

    scale = amax / 127 where amax > 0, else 1
    code = clamp(round(u / scale), -127, 127)     half-even, IEEE division

and every product is an exact int32 sum, dequantized in f32 as
``float(acc) * s_row * s_col``. The ops, each a ``*_plain`` and a
``*_cuda`` function behind a dispatcher:

    int8_ln_qkv            (K10)  LN -> rowquant -> int8 QKV (no bias)
    int8_outproj_residual  (K11)  rowquant -> int8 out-projection + b + x
    int8_mlp_block         (K12)  LN -> rowquant -> W1 + b1 -> GELU ->
                                  rowquant -> W2 + b2 + x
    int8_flash_attention   (K13)  QK^T in x's dtype and exp2 softmax,
                                  int8 PV

Unlike the bf16 ops, LN's u and the MLP's h stay f32: they are quantized,
not rounded to bf16. The plain versions compute the int8 products as f64
matmuls of the integer-valued operands, exact here (|acc| <= 127^2 * K <
2^53; an f32 matmul is exact only to 2^24, and ``torch.matmul`` has no int8
path on CUDA); the int32 -> f32 conversion then rounds as the kernels'.

SERVING-ONLY, as in JAX: there is no backward and no dropout. CPU tensors
run the plain versions; bf16 CUDA tensors run ``csrc/int8_qkv.cu``,
``csrc/int8_outproj.cu``, ``csrc/int8_mlp.cu`` and
``csrc/int8_attention.cu``, and f32 CUDA tensors (the int8 serving of an
f32 ViT, where the JAX kernels write ``x.dtype``) their f32 instances:
K10-K12's ``nvt_int8_*_f32`` entry points in the same sources (the same
passes on f32 loads and stores, the same plans), and K13 at f32 in
``csrc/int8_attention_f32.cu`` (QK^T in 3xTF32 on ``mma.sync`` in two
sweeps, P8 . V8 on s8 ``mma.sync`` from registers,
:func:`int8_attn_f32_plan`). The kernels take widths that are multiples of
16, of any size: K10 in two launches (the LN row quantizer it shares with
K12, then its GEMM on the TMA + ``wgmma`` mainloop, :func:`qkv_plan`), K11
in two (that row quantizer without the LayerNorm, then K12's last pass,
:func:`int8_outproj_plan`), K12 in four on that mainloop
(:func:`mlp_plan`); K13 takes K1's
head dims (8 to 128, zero-padded to 64 or 128) in three launches on TMA +
``wgmma``: V's quantization prologue in two passes, then the two-sweep
attention with the P V product as an s8 ``wgmma`` from registers
(:func:`int8_attn_plan`, :func:`v8_key_order`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.ops.common import (FLOAT, INT, SHAPE_QUEUE, VOID,
                                           check_operand, check_smem,
                                           check_widths, launch, pick, ptr,
                                           round_up)
from neurovit_tpu_torch.ops.flash_attention import (FWD_ALIGN_SLACK, LOG2E,
                                                    MAX_GRID_X,
                                                    MIN_KERNEL_HEAD_DIM,
                                                    _block_rows, _check_grid,
                                                    _check_qkv, _n_valid,
                                                    _offsets, _probs,
                                                    flash_attention,
                                                    fwd_head_dim,
                                                    pad_head_dim)
from neurovit_tpu_torch.ops.fused_mlp import (GEMM_THREADS, gemm_smem_bytes,
                                              gemm_tile_n)

# Above this sequence length, or below head dim 8, int8_flash_attention
# takes the bf16 attention (int8_serving.py:343-347: MAX_RESIDENT_N).
MAX_RESIDENT_N = 4096
QKV = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """The symmetric int8 scale of a row or channel with largest magnitude
    amax: amax / 127, an IEEE division. The divisor is a tensor: PyTorch
    divides a CUDA tensor by a Python scalar as a product with the
    scalar's reciprocal, one ulp off the quotient for some amax, while the
    CPU and the kernels divide."""
    return torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                       torch.ones_like(amax))


def _rowquant(u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric quant of f32 u [..., K] (int8_serving.py:130-141):
    (integer-valued f32 codes, scale [..., 1])."""
    scale = _scale(u.abs().amax(dim=-1, keepdim=True))
    return torch.clamp(torch.round(u / scale), -127, 127), scale


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of a torch Linear weight [N, K]:
    (w8 int8 [N, K], scale f32 [N]) with w ~= w8 * scale[:, None]. From the
    f32 master weight, as JAX quantizes its f32 params
    (int8_serving.py:73-81): w8 is JAX's w8 transposed, and both equal JAX's
    bit for bit."""
    codes, scale = _rowquant(w.detach().float())
    return codes.to(torch.int8), scale[..., 0]


def _deq_dot(codes: torch.Tensor, s_row: torch.Tensor, w8: torch.Tensor,
             s_col: torch.Tensor) -> torch.Tensor:
    """float(codes . w8^T) * s_row * s_col, f32 (int8_serving.py:144-147);
    the int32 product as an exact f64 matmul."""
    acc = torch.matmul(codes.double(), w8.double().t()).float()
    return acc * s_row * s_col.float()


def _ln(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor
        ) -> torch.Tensor:
    """u = LN(x) * gamma + beta in f32, not rounded (int8_serving.py:122-127,
    158-159)."""
    return nn.layer_norm(x.float(), gamma, beta)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def int8_ln_qkv_plain(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, w8: torch.Tensor,
                      scale: torch.Tensor, heads: int, dim_head: int) -> QKV:
    """K10's function in plain PyTorch. x [B, N, dim]; w8 [3 * inner, dim]
    int8 with rows ordered (3, heads, dim_head); scale [3 * inner]. Returns
    q, k, v [B, N, H, D] in x's dtype."""
    b, n, _ = x.shape
    codes, s_row = _rowquant(_ln(x, gamma, beta))
    out = _deq_dot(codes, s_row, w8, scale).to(x.dtype)
    q, k, v = out.reshape(b, n, 3, heads, dim_head).unbind(2)
    return q.contiguous(), k.contiguous(), v.contiguous()


def int8_outproj_residual_plain(x: torch.Tensor, a: torch.Tensor,
                                w8: torch.Tensor, scale: torch.Tensor,
                                bias: torch.Tensor) -> torch.Tensor:
    """K11's function in plain PyTorch: x + (rowquant(a) . w8^T) * s + b.
    x [B, N, dim], a [B, N, inner], w8 [dim, inner] int8, scale and bias
    [dim]."""
    codes, s_row = _rowquant(a.float())
    z = _deq_dot(codes, s_row, w8, scale) + bias.float()
    return (z + x.float()).to(x.dtype)


def int8_mlp_block_plain(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, w1: torch.Tensor,
                         s1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                         s2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """K12's function in plain PyTorch: x + fc2(GELU(fc1(LN(x)))) with both
    GEMMs int8. w1 [hid, dim], w2 [dim, hid] int8; s1, b1 [hid]; s2, b2
    [dim]. GELU runs on the f32 h and g is quantized over its whole row."""
    codes, s_row = _rowquant(_ln(x, gamma, beta))
    h = _deq_dot(codes, s_row, w1, s1) + b1.float()
    codes, s_row = _rowquant(nn.gelu(h))
    z = _deq_dot(codes, s_row, w2, s2) + b2.float()
    return (z + x.float()).to(x.dtype)


def attn_codes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float, n_valid: int) -> tuple:
    """K13's quantized operands in plain PyTorch, over [B, N, H, D]:
    (p8 [B, H, N, N], v8 [B, H, N, D], both integer-valued f32; s_p and
    denom [B, H, N, 1]; s_v [B, H, 1, D]). V is quantized per channel over
    the keys below n_valid only; the probabilities per row against their
    row max, after the row sum of the exact f32 p is taken."""
    qf, kf, vf = (t.permute(0, 2, 1, 3).float() for t in (q, k, v))
    p = _probs(qf, kf, scale, n_valid)
    denom = p.sum(dim=-1, keepdim=True)
    s_p = _scale(p.amax(dim=-1, keepdim=True))
    p8 = torch.clamp(torch.round(p / s_p), 0, 127)
    s_v = _scale(vf[:, :, :n_valid].abs().amax(dim=2, keepdim=True))
    v8 = torch.clamp(torch.round(vf / s_v), -127, 127)
    return p8, v8, s_p, denom, s_v


def int8_flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, scale: float,
                               n_valid: Optional[int] = None) -> torch.Tensor:
    """K13's function in plain PyTorch (int8_serving.py:286-333), over
    [B, N, H, D]: o = float(p8 . v8) * (s_p / denom * s_v) from
    :func:`attn_codes`."""
    n_valid = _n_valid(q, n_valid)
    p8, v8, s_p, denom, s_v = attn_codes(q, k, v, scale, n_valid)
    acc = torch.matmul(p8.double(), v8.double()).float()
    o = acc * (s_p / denom * s_v)
    return o.to(q.dtype).permute(0, 2, 1, 3).contiguous()


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _vectors(**named) -> dict:
    """f32 contiguous copies of 1-D operands, each checked against its
    length: name -> (tensor, length)."""
    out = {}
    for name, (t, length) in named.items():
        out[name] = t.float().contiguous()
        check_operand(name, out[name], torch.float32, (length,))
    return out


def check_qkv_shapes(dim: int, inner: int) -> None:
    """Raise unless K10 takes x [*, dim] and heads * dim_head = inner:
    multiples of 16, the 16-byte rows of its TMA operands, of any size."""
    check_widths("int8 LN+QKV", dim=dim, inner=inner)


def check_outproj_shapes(dim: int, inner: int) -> None:
    """Raise unless K11 takes a [*, inner] and x [*, dim]: multiples of 16,
    the 16-byte rows of its TMA operands, of any size (its row quantizer
    reads a row again from L1/L2 for the codes)."""
    check_widths("int8 out-projection", dim=dim, inner=inner)


def check_mlp_shapes(dim: int, hid: int) -> None:
    """Raise unless K12 takes x [*, dim] and mlp_dim hid: multiples of 16,
    the 16-byte rows of its TMA operands, of any size (no row is held
    whole in registers or shared memory)."""
    check_widths("int8 MLP", dim=dim, mlp_dim=hid)


# K10's, K11's and K12's passes (csrc/int8_qkv.cu, csrc/int8_outproj.cu,
# csrc/int8_mlp.cu): rows (one warp each) a block of the row passes, the
# GEMM passes' output tile rows (and K12's columns; their ring of three
# stages is K4's, so two GEMM blocks share an SM), and the alignment of
# each piece of the scratch.
ROW_WARPS, MLP_TILE, SCRATCH_ALIGN = 8, 128, 256


class MlpPlan(NamedTuple):
    """How one K12 call covers x [m, dim] with mlp_dim hid. ``launches``:
    the four kernels in launch order, each (name, grid, threads, dynamic
    shared memory bytes), a grid (x, y). ``scratch``: the pieces of the one
    scratch allocation, name -> (byte offset, bytes), in ``scratch_bytes``
    bytes. g comes first, [m, hid] f32: the scratch an older checkout's
    ``nvt_int8_mlp`` takes at the same argument, so
    ``scripts/torch_kernel_ab.py`` can time either library through this
    wrapper."""
    launches: tuple
    scratch: dict
    scratch_bytes: int


def mlp_plan(m: int, dim: int, hid: int) -> MlpPlan:
    """K12's plan for m rows (the kernel's own count of the scratch is
    ``nvt_int8_mlp_scratch_bytes``; the card test holds the two equal).
    Raises where the kernel does not take the widths."""
    check_mlp_shapes(dim, hid)
    if m < 1:
        raise ValueError(f"the int8 MLP kernel takes at least one row, got "
                         f"{m}")
    m_tiles, hid_tiles = -(-m // MLP_TILE), -(-hid // MLP_TILE)
    rows = -(-m // ROW_WARPS)
    gemm_smem = gemm_smem_bytes(MLP_TILE)
    launches = (
        ("ln_rowquant", (rows, 1), ROW_WARPS * 32, 0),
        ("fc1_gelu", (hid_tiles, m_tiles), GEMM_THREADS, gemm_smem),
        ("g_rowquant", (rows, 1), ROW_WARPS * 32, 0),
        ("fc2_residual", (-(-dim // MLP_TILE), m_tiles), GEMM_THREADS,
         gemm_smem))
    scratch, at = {}, 0
    for name, nbytes in (("g", m * hid * 4), ("u8", m * dim),
                         ("g8", m * hid), ("gmax", m * hid_tiles * 4),
                         ("s1_row", m * 4), ("s2_row", m * 4)):
        scratch[name] = (at, nbytes)
        at = round_up(at + nbytes, SCRATCH_ALIGN)
    return MlpPlan(launches=launches, scratch=scratch, scratch_bytes=at)


class QkvPlan(NamedTuple):
    """How one K10 call covers x [m, dim] with heads * dim_head = inner.
    ``launches``: the two kernels in launch order, each (name, grid,
    threads, dynamic shared memory bytes), a grid (x, y): the LN row
    quantizer, then the GEMM over (3 column tiles of inner each rounded
    up, row tiles of 128). ``tile_n``: the GEMM's output tile columns.
    ``scratch``: the pieces of the one scratch allocation, name -> (byte
    offset, bytes), in ``scratch_bytes`` bytes: u8 [m, dim] int8, then
    s_row [m] f32."""
    launches: tuple
    tile_n: int
    scratch: dict
    scratch_bytes: int


def qkv_plan(m: int, dim: int, inner: int) -> QkvPlan:
    """K10's plan for m rows (the kernel's own counts are
    ``nvt_int8_qkv_scratch_bytes`` and ``nvt_int8_qkv_smem_bytes``; the
    card test holds them equal). The GEMM's tiles are 128 x 128, or 128 x
    64 where 128-wide tiles over the [m, 3 inner] output would give the
    card fewer blocks than SMs, the rule of K4's passes
    (:func:`~neurovit_tpu_torch.ops.fused_mlp.gemm_tile_n`). Raises where
    the kernel does not take the widths."""
    check_qkv_shapes(dim, inner)
    if m < 1:
        raise ValueError(f"the int8 LN+QKV kernel takes at least one row, "
                         f"got {m}")
    tile_n = gemm_tile_n(m, 3 * inner)
    launches = (
        ("ln_rowquant", (-(-m // ROW_WARPS), 1), ROW_WARPS * 32, 0),
        ("qkv_gemm", (3 * -(-inner // tile_n), -(-m // MLP_TILE)),
         GEMM_THREADS, gemm_smem_bytes(tile_n)))
    scratch, at = {}, 0
    for name, nbytes in (("u8", m * dim), ("s_row", m * 4)):
        scratch[name] = (at, nbytes)
        at = round_up(at + nbytes, SCRATCH_ALIGN)
    return QkvPlan(launches=launches, tile_n=tile_n, scratch=scratch,
                   scratch_bytes=at)


class Int8OutprojPlan(NamedTuple):
    """How one K11 call covers a [m, inner] and x [m, dim]. ``launches``:
    the two kernels in launch order, each (name, grid, threads, dynamic
    shared memory bytes), a grid (x, y): the row quantizer, then K12's
    fc2_residual pass over (column tiles of dim, row tiles of 128).
    ``tile_n``: the GEMM's output tile columns. ``scratch``: the pieces of
    the one scratch allocation, name -> (byte offset, bytes), in
    ``scratch_bytes`` bytes: a8 [m, inner] int8, then s_row [m] f32."""
    launches: tuple
    tile_n: int
    scratch: dict
    scratch_bytes: int


def int8_outproj_plan(m: int, dim: int, inner: int) -> Int8OutprojPlan:
    """K11's plan for m rows (the kernel's own counts are
    ``nvt_int8_outproj_scratch_bytes`` and ``nvt_int8_outproj_smem_bytes``;
    the card test holds them equal). The GEMM's tiles are 128 x 128, or 128
    x 64 where 128-wide tiles over the [m, dim] output would give the card
    fewer blocks than SMs (batch 1 of the flagship), the rule of K10 and of
    K4's passes (:func:`~neurovit_tpu_torch.ops.fused_mlp.gemm_tile_n`).
    Raises where the kernel does not take the widths."""
    check_outproj_shapes(dim, inner)
    if m < 1:
        raise ValueError(f"the int8 out-projection kernel takes at least one "
                         f"row, got {m}")
    tile_n = gemm_tile_n(m, dim)
    launches = (
        ("rowquant", (-(-m // ROW_WARPS), 1), ROW_WARPS * 32, 0),
        ("fc2_residual", (-(-dim // tile_n), -(-m // MLP_TILE)),
         GEMM_THREADS, gemm_smem_bytes(tile_n)))
    scratch, at = {}, 0
    for name, nbytes in (("a8", m * inner), ("s_row", m * 4)):
        scratch[name] = (at, nbytes)
        at = round_up(at + nbytes, SCRATCH_ALIGN)
    return Int8OutprojPlan(launches=launches, tile_n=tile_n,
                           scratch=scratch, scratch_bytes=at)


def _scratch(plan, x: torch.Tensor,
             scratch: Optional[torch.Tensor]) -> torch.Tensor:
    """The one scratch allocation of a K10-K12 call: a new one, or the
    caller's (uint8, at least ``plan.scratch_bytes``), whose pieces
    (``plan.scratch``: the codes and row scales) it can read after."""
    if scratch is None:
        return torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                           device=x.device)
    check_operand("scratch", scratch, torch.uint8)
    if scratch.numel() < plan.scratch_bytes:
        raise ValueError(f"the scratch holds {scratch.numel()} bytes, the "
                         f"call needs {plan.scratch_bytes}")
    return scratch


def _ln_qkv_cuda(symbol: str, dtype: torch.dtype, x, gamma, beta, w8,
                 scale, heads: int, dim_head: int,
                 scratch: Optional[torch.Tensor] = None) -> QKV:
    b, n, dim = x.shape
    inner = heads * dim_head
    check_operand("x", x, dtype)
    check_operand("w8", w8, torch.int8, (3 * inner, dim))
    vecs = _vectors(gamma=(gamma, dim), beta=(beta, dim),
                    scale=(scale, 3 * inner))
    plan = qkv_plan(b * n, dim, inner)
    q, k, v = (x.new_empty(b, n, heads, dim_head) for _ in range(3))
    scratch = _scratch(plan, x, scratch)
    launch(symbol, (VOID,) * 9 + (INT, INT, INT, FLOAT), x,
           ptr(x), ptr(vecs["gamma"]), ptr(vecs["beta"]), ptr(w8),
           ptr(vecs["scale"]), ptr(q), ptr(k), ptr(v), ptr(scratch), b * n,
           dim, inner, nn.LN_EPS)
    return q, k, v


def int8_ln_qkv_cuda(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, w8: torch.Tensor,
                     scale: torch.Tensor, heads: int, dim_head: int) -> QKV:
    """Launch the Hopper kernel K10 on bf16 x [B, N, dim]: its two passes
    (csrc/int8_qkv.cu) on the current stream, one call. They share one
    scratch allocation holding u8 and the row scales (:func:`qkv_plan`);
    the C entry point encodes the two tensor maps and raises through
    ``launch`` on any failure."""
    out = _ln_qkv_cuda("nvt_int8_ln_qkv", torch.bfloat16, x, gamma, beta,
                       w8, scale, heads, dim_head)
    int8_ln_qkv_cuda.launches += 1
    return out


int8_ln_qkv_cuda.launches = 0


def int8_ln_qkv_f32_cuda(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, w8: torch.Tensor,
                         scale: torch.Tensor, heads: int, dim_head: int, *,
                         scratch: Optional[torch.Tensor] = None) -> QKV:
    """Launch K10 at f32 on f32 x [B, N, dim]: the bf16 kernel's two
    passes on f32 loads of x and f32 stores of q, k and v, with its plan
    (:func:`qkv_plan`: the same scratch and shared memory). ``scratch``: a
    caller's uint8 scratch of the plan's bytes, where its u8 and s_row
    stay to be read."""
    out = _ln_qkv_cuda("nvt_int8_ln_qkv_f32", torch.float32, x, gamma, beta,
                       w8, scale, heads, dim_head, scratch)
    int8_ln_qkv_f32_cuda.launches += 1
    return out


int8_ln_qkv_f32_cuda.launches = 0


def _outproj_cuda(symbol: str, dtype: torch.dtype, x, a, w8, scale,
                  bias, scratch: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    b, n, dim = x.shape
    inner = a.shape[-1]
    check_operand("x", x, dtype)
    check_operand("a", a, dtype, (b, n, inner))
    check_operand("w8", w8, torch.int8, (dim, inner))
    vecs = _vectors(scale=(scale, dim), bias=(bias, dim))
    plan = int8_outproj_plan(b * n, dim, inner)
    y = torch.empty_like(x)
    scratch = _scratch(plan, x, scratch)
    launch(symbol, (VOID,) * 7 + (INT,) * 3, x, ptr(a), ptr(x),
           ptr(w8), ptr(vecs["scale"]), ptr(vecs["bias"]), ptr(y),
           ptr(scratch), b * n, inner, dim)
    return y


def int8_outproj_residual_cuda(x: torch.Tensor, a: torch.Tensor,
                               w8: torch.Tensor, scale: torch.Tensor,
                               bias: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel K11 on bf16 x [B, N, dim], a [B, N, inner]:
    its two passes (csrc/int8_outproj.cu) on the current stream, one call.
    They share one scratch allocation holding a8 and the row scales
    (:func:`int8_outproj_plan`); the C entry point encodes the two tensor
    maps and raises through ``launch`` on any failure."""
    y = _outproj_cuda("nvt_int8_outproj", torch.bfloat16, x, a, w8, scale,
                      bias)
    int8_outproj_residual_cuda.launches += 1
    return y


int8_outproj_residual_cuda.launches = 0


def int8_outproj_residual_f32_cuda(x: torch.Tensor, a: torch.Tensor,
                                   w8: torch.Tensor, scale: torch.Tensor,
                                   bias: torch.Tensor, *,
                                   scratch: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """Launch K11 at f32 on f32 x [B, N, dim] and a [B, N, inner]: the
    bf16 kernel's two passes on f32 loads of a and x and f32 stores of y,
    with its plan (:func:`int8_outproj_plan`). ``scratch``: a caller's
    uint8 scratch of the plan's bytes, where a8 and s_row stay."""
    y = _outproj_cuda("nvt_int8_outproj_f32", torch.float32, x, a, w8, scale,
                      bias, scratch)
    int8_outproj_residual_f32_cuda.launches += 1
    return y


int8_outproj_residual_f32_cuda.launches = 0


def _mlp_cuda(symbol: str, dtype: torch.dtype, x, gamma, beta, w1, s1, b1,
              w2, s2, b2, scratch: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    b, n, dim = x.shape
    hid = w1.shape[0]
    check_operand("x", x, dtype)
    check_operand("w1", w1, torch.int8, (hid, dim))
    check_operand("w2", w2, torch.int8, (dim, hid))
    vecs = _vectors(gamma=(gamma, dim), beta=(beta, dim), s1=(s1, hid),
                    b1=(b1, hid), s2=(s2, dim), b2=(b2, dim))
    plan = mlp_plan(b * n, dim, hid)
    y = torch.empty_like(x)
    scratch = _scratch(plan, x, scratch)
    launch(symbol, (VOID,) * 11 + (INT, INT, INT, FLOAT), x,
           ptr(x), ptr(vecs["gamma"]), ptr(vecs["beta"]), ptr(w1),
           ptr(vecs["s1"]), ptr(vecs["b1"]), ptr(w2), ptr(vecs["s2"]),
           ptr(vecs["b2"]), ptr(y), ptr(scratch), b * n, dim, hid, nn.LN_EPS)
    return y


def int8_mlp_block_cuda(x: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, w1: torch.Tensor,
                        s1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                        s2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel K12 on bf16 x [B, N, dim]: its four passes
    (csrc/int8_mlp.cu) on the current stream, one call. They share one
    scratch allocation holding u8, g, g8, the partial amax of g and the two
    row-scale vectors (:func:`mlp_plan`); the C entry point encodes the
    four tensor maps and raises through ``launch`` on any failure."""
    y = _mlp_cuda("nvt_int8_mlp", torch.bfloat16, x, gamma, beta, w1, s1, b1,
                  w2, s2, b2)
    int8_mlp_block_cuda.launches += 1
    return y


int8_mlp_block_cuda.launches = 0


def int8_mlp_block_f32_cuda(x: torch.Tensor, gamma: torch.Tensor,
                            beta: torch.Tensor, w1: torch.Tensor,
                            s1: torch.Tensor, b1: torch.Tensor,
                            w2: torch.Tensor, s2: torch.Tensor,
                            b2: torch.Tensor, *,
                            scratch: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Launch K12 at f32 on f32 x [B, N, dim]: the bf16 kernel's four
    passes on f32 loads of x and f32 stores of y, with its plan
    (:func:`mlp_plan`; g was f32 in both). ``scratch``: a caller's uint8
    scratch of the plan's bytes, where u8, g8 and the row scales stay."""
    y = _mlp_cuda("nvt_int8_mlp_f32", torch.float32, x, gamma, beta, w1, s1,
                  b1, w2, s2, b2, scratch)
    int8_mlp_block_f32_cuda.launches += 1
    return y


int8_mlp_block_f32_cuda.launches = 0


# K13 (csrc/int8_attention.cu): ring stages of its K and v8 tiles, keys a
# tile, and threads of a prologue block.
ATTN_STAGES, ATTN_BKV, ATTN_PROLOGUE_THREADS = 4, 64, 256
# The s8 A operand of K13's P V: for each of its four registers, which of a
# thread's 16 accumulator values of a 32-key chunk (acc[4 j + i], j = 0..3:
# row r + 8 (i // 2), key 8 j + 2 (t % 4) + i % 2) fill its bytes, lowest
# byte first. Registers 0 and 2 hold row r at k 4 (t % 4) .. + 3 and 16 +
# 4 (t % 4) .. + 3, registers 1 and 3 row r + 8 at the same k.
P8_PACK = ((0, 1, 4, 5), (2, 3, 6, 7), (8, 9, 12, 13), (10, 11, 14, 15))


def v8_key_order(n_pad: int) -> torch.Tensor:
    """The key whose code K13's transposed v8 holds at each stored position
    0 .. n_pad - 1 of a channel's row: within each group of 32 keys,
    position 16 half + 4 q + i holds key 16 half + 2 q + 8 (i // 2) + i % 2,
    so that the codes a thread's S accumulator gives, packed by
    :data:`P8_PACK`, meet the v8 of their own keys."""
    k = torch.arange(n_pad)
    half, q, i = k % 32 // 16, k % 16 // 4, k % 4
    return k // 32 * 32 + 16 * half + 2 * q + 8 * (i // 2) + i % 2


class Int8AttnPlan(NamedTuple):
    """How one K13 call covers q, k, v [B, N, H, D] at n_valid = N: the
    head-dim instance ``d_kernel`` (operands zero-padded to it), ``bq``
    query rows a block of the main kernel (64 per consumer warpgroup: one
    at d_kernel 64, where three blocks share an SM; at 128 two where the
    grid of 128-row blocks fills the card's 132 SMs, as K1's);
    ``launches``, the three kernels in launch order, each (name, grid,
    threads, dynamic shared memory bytes): the prologue's two passes on a
    (B * H, key tiles) grid, then the attention on a one-dimensional grid
    of q tiles times B * H; ``offsets`` of the main kernel's Q tiles, K
    ring, v8 ring and barriers from its 1024-byte aligned base; the
    scratch: v8 [B * H, d_kernel, n_pad] int8 (``v8_bytes``, n_pad = N
    rounded up to 64) and the f32 ``stats`` (s_v [B * H, d_kernel] and the
    prologue's partial amax [B * H, N / 64 tiles, d_kernel],
    ``stats_bytes``). A call at n_valid < N runs the prologue over the key
    tiles n_valid reaches."""
    d_kernel: int
    bq: int
    launches: tuple
    offsets: tuple
    n_pad: int
    v8_bytes: int
    stats_bytes: int


def _attn_prologue(b: int, n: int, h: int, d: int) -> tuple:
    """What both instances of K13 share: (the head-dim instance, V's
    prologue launches, n_pad, v8's bytes, the f32 stats' bytes). Raises
    where the kernels do not take the shape."""
    d_kernel = fwd_head_dim(d)
    _check_grid("int8 forward", b, n, h)
    if b * h * d_kernel > MAX_GRID_X:
        raise ValueError(f"the int8 attention takes B * H * D < 2^31 (v8's "
                         f"rows), got B {b}, H {h}, D {d_kernel} "
                         f"({SHAPE_QUEUE})")
    tiles = -(-n // ATTN_BKV)
    prologue = (b * h, tiles)
    launches = (("v_amax", prologue, ATTN_PROLOGUE_THREADS, 0),
                ("v_quant", prologue, ATTN_PROLOGUE_THREADS, 0))
    return (d_kernel, launches, tiles * ATTN_BKV,
            b * h * d_kernel * tiles * ATTN_BKV,
            b * h * d_kernel * (1 + tiles) * 4)


def int8_attn_plan(b: int, n: int, h: int, d: int) -> Int8AttnPlan:
    """K13's plan (the kernel's own counts are ``nvt_int8_attn_smem_bytes``,
    ``nvt_int8_attn_block_rows``, ``nvt_int8_attn_v8_bytes`` and
    ``nvt_int8_attn_stats_bytes``; the card test holds them equal). Raises
    where the kernel does not take the shape."""
    d_kernel, prologue, n_pad, v8_bytes, stats_bytes = _attn_prologue(
        b, n, h, d)
    bq = 64 if d_kernel == 64 else _block_rows(b, n, h)
    offsets, at = _offsets(bq * d_kernel * 2,
                           ATTN_STAGES * ATTN_BKV * d_kernel * 2,
                           ATTN_STAGES * ATTN_BKV * d_kernel,
                           (2 * ATTN_STAGES + 1) * 8)
    smem = FWD_ALIGN_SLACK + at
    check_smem("int8 attention", smem)
    launches = prologue + (
        ("attention", (-(-n // bq) * b * h,), 2 * bq + 32, smem),)
    return Int8AttnPlan(d_kernel=d_kernel, bq=bq, launches=launches,
                        offsets=offsets, n_pad=n_pad, v8_bytes=v8_bytes,
                        stats_bytes=stats_bytes)


# K13 at f32 (csrc/int8_attention_f32.cu): query rows a block (four warps of
# 16), keys a ring step, the ring's stages and threads a block; the Q and K
# boxes are 128-byte swizzled and the v8 boxes 32-byte swizzled,
# FWD_ALIGN_SLACK aligning them to 1024 bytes.
ATTN_F32_BQ, ATTN_F32_BKV, ATTN_F32_STAGES, ATTN_F32_THREADS = 64, 32, 3, 128


class Int8AttnF32Plan(NamedTuple):
    """How one call of K13 at f32 covers q, k, v [B, N, H, D] at n_valid
    = N: the head-dim instance ``d_kernel`` (operands zero-padded to it, as
    the bf16 K13's); ``launches``, the three kernels in launch order, each
    (name, grid, threads, dynamic shared memory bytes): the bf16 K13's
    prologue on f32 V, then the attention on a one-dimensional grid of
    (query tiles of ``bq`` rows x B * H), query tiles fastest, in blocks
    of four warps of 16 rows; ``offsets`` of its Q box (f32 [bq,
    d_kernel]), its ring of ``stages`` K boxes (f32 [bkv, d_kernel]) and
    v8 boxes (int8 [d_kernel, bkv]), and its barriers, from its
    1024-byte aligned base: QK^T in 3xTF32 and P8 . V8 on ``mma.sync``,
    the codes in registers; the scratch as the bf16 K13's (``n_pad``,
    ``v8_bytes``, ``stats_bytes``)."""
    d_kernel: int
    bq: int
    bkv: int
    stages: int
    launches: tuple
    offsets: tuple
    n_pad: int
    v8_bytes: int
    stats_bytes: int


def int8_attn_f32_plan(b: int, n: int, h: int, d: int) -> Int8AttnF32Plan:
    """K13 f32's plan (the kernel's own count of the shared memory is
    ``nvt_int8_attn_f32_smem_bytes``; the card test holds them equal).
    Raises where the kernel does not take the shape: the shapes the bf16
    K13 takes."""
    d_kernel, prologue, n_pad, v8_bytes, stats_bytes = _attn_prologue(
        b, n, h, d)
    bq, bkv, stages = ATTN_F32_BQ, ATTN_F32_BKV, ATTN_F32_STAGES
    offsets, at = _offsets(bq * d_kernel * 4, stages * bkv * d_kernel * 4,
                           stages * d_kernel * bkv, (2 * stages + 1) * 8)
    smem = FWD_ALIGN_SLACK + at
    check_smem("int8 attention", smem)
    launches = prologue + (
        ("attention", (-(-n // bq) * b * h,), ATTN_F32_THREADS, smem),)
    return Int8AttnF32Plan(d_kernel=d_kernel, bq=bq, bkv=bkv, stages=stages,
                           launches=launches, offsets=offsets, n_pad=n_pad,
                           v8_bytes=v8_bytes, stats_bytes=stats_bytes)


def _attn_cuda(symbol: str, plan, q, k, v, scale: float,
               n_valid: Optional[int]) -> torch.Tensor:
    b, n, h, d = q.shape
    n_valid = _n_valid(q, n_valid)
    q, k, v = (pad_head_dim(t, plan.d_kernel) for t in (q, k, v))
    o = torch.empty_like(q)
    v8 = torch.empty((b * h, plan.d_kernel, plan.n_pad), dtype=torch.int8,
                     device=q.device)
    stats = torch.empty(plan.stats_bytes // 4, dtype=torch.float32,
                        device=q.device)
    launch(symbol, (VOID,) * 6 + (INT,) * 5 + (FLOAT,), q,
           ptr(q), ptr(k), ptr(v), ptr(o), ptr(v8), ptr(stats), b, n, h,
           plan.d_kernel, n_valid, float(scale * LOG2E))
    return o[..., :d].contiguous() if plan.d_kernel != d else o


def int8_flash_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, scale: float,
                              n_valid: Optional[int] = None) -> torch.Tensor:
    """Launch the Hopper kernel K13 (V's two-pass quantization prologue,
    then the two-sweep attention): bf16 [B, N, H, D], contiguous, 8 <= D <=
    128 (zero columns to 64 or 128: their codes are 0 and they are sliced
    off). The scratch is v8 and the f32 stats of :func:`int8_attn_plan`;
    the C entry point encodes the four tensor maps and raises through
    ``launch`` on any failure."""
    _check_qkv(q, k, v)
    plan = int8_attn_plan(*q.shape)
    o = _attn_cuda("nvt_int8_attention", plan, q, k, v, scale, n_valid)
    int8_flash_attention_cuda.launches += 1
    return o


int8_flash_attention_cuda.launches = 0


def int8_flash_attention_f32_cuda(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *, scale: float,
                                  n_valid: Optional[int] = None
                                  ) -> torch.Tensor:
    """Launch K13 at f32 (V's prologue on f32 V, then the two-sweep
    attention with QK^T in 3xTF32 and P8 . V8 in s8 on ``mma.sync``, the
    codes packed in registers): f32 [B, N, H, D],
    contiguous, 8 <= D <= 128, zero-padded to 64 or 128 as the bf16 K13's.
    The scratch is v8 and the f32 stats of :func:`int8_attn_f32_plan`."""
    _check_qkv(q, k, v, torch.float32)
    plan = int8_attn_f32_plan(*q.shape)
    o = _attn_cuda("nvt_int8_attention_f32", plan, q, k, v, scale, n_valid)
    int8_flash_attention_f32_cuda.launches += 1
    return o


int8_flash_attention_f32_cuda.launches = 0


# ---------------------------------------------------------------------------
# Dispatchers
# ---------------------------------------------------------------------------

def int8_ln_qkv(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                w8: torch.Tensor, scale: torch.Tensor, heads: int,
                dim_head: int) -> QKV:
    """LN, per-row int8 quantization and the int8 QKV projection:
    [B, N, dim] -> q, k, v [B, N, H, D]. CPU tensors take the plain
    version, CUDA tensors the kernel of x's dtype (``common.pick``: f32 or
    bf16, which raises for any other)."""
    fn = pick(int8_ln_qkv_plain, int8_ln_qkv_cuda, int8_ln_qkv_f32_cuda, x,
              gamma, beta, w8, scale)
    return fn(x, gamma, beta, w8, scale, heads, dim_head)


def int8_outproj_residual(x: torch.Tensor, a: torch.Tensor, w8: torch.Tensor,
                          scale: torch.Tensor, bias: torch.Tensor
                          ) -> torch.Tensor:
    """x + int8 out-projection of the attention output a [B, N, inner]."""
    fn = pick(int8_outproj_residual_plain, int8_outproj_residual_cuda,
              int8_outproj_residual_f32_cuda, x, a, w8, scale, bias)
    return fn(x, a, w8, scale, bias)


def int8_mlp_block(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   w1: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, s2: torch.Tensor, b2: torch.Tensor
                   ) -> torch.Tensor:
    """x + fc2(GELU(fc1(LN(x)))) with both GEMMs int8, [B, N, dim]."""
    args = (x, gamma, beta, w1, s1, b1, w2, s2, b2)
    fn = pick(int8_mlp_block_plain, int8_mlp_block_cuda,
              int8_mlp_block_f32_cuda, *args)
    return fn(*args)


def int8_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float, n_valid: Optional[int] = None
                         ) -> torch.Tensor:
    """Attention over [B, N, H, D] with the PV product in int8; keys at or
    past ``n_valid`` get zero weight. As the JAX wrapper chooses by shape
    (int8_serving.py:343-347), N > 4096 or D < 8 takes
    :func:`flash_attention` (K1, bf16 or f32) instead."""
    b, n, h, d = q.shape
    if n > MAX_RESIDENT_N or d < MIN_KERNEL_HEAD_DIM:
        return flash_attention(q, k, v, scale=scale, n_valid=n_valid)
    fn = pick(int8_flash_attention_plain, int8_flash_attention_cuda,
              int8_flash_attention_f32_cuda, q, k, v)
    return fn(q, k, v, scale=scale, n_valid=n_valid)
