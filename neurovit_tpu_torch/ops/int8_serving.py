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
    int8_flash_attention   (K13)  bf16 QK^T and exp2 softmax, int8 PV

Unlike the bf16 ops, LN's u and the MLP's h stay f32: they are quantized,
not rounded to bf16. The plain versions compute the int8 products as f64
matmuls of the integer-valued operands, exact here (|acc| <= 127^2 * K <
2^53; an f32 matmul is exact only to 2^24, and ``torch.matmul`` has no int8
path on CUDA); the int32 -> f32 conversion then rounds as the kernels'.

SERVING-ONLY, as in JAX: there is no backward and no dropout. CPU tensors
run the plain versions; CUDA tensors run ``csrc/int8_qkv.cu``,
``csrc/int8_outproj.cu``, ``csrc/int8_mlp.cu`` and
``csrc/int8_attention.cu``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.ops.common import (FLOAT, INT, VOID, check_operand,
                                           launch, on_cpu, ptr)
from neurovit_tpu_torch.ops.flash_attention import (LOG2E, _check_qkv,
                                                    _n_valid, _probs,
                                                    flash_attention)

# Above this sequence length, or below head dim 8, int8_flash_attention
# takes the bf16 attention (int8_serving.py:343-347: MAX_RESIDENT_N).
MAX_RESIDENT_N = 4096
QKV = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """The symmetric int8 scale of a row or channel with largest magnitude
    amax."""
    return torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))


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


def int8_flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, scale: float,
                               n_valid: Optional[int] = None) -> torch.Tensor:
    """K13's function in plain PyTorch (int8_serving.py:286-333), over
    [B, N, H, D]. V is quantized per channel over the keys below n_valid
    only; the probabilities per row against their row max, after the row
    sum of the exact f32 p is taken."""
    n_valid = _n_valid(q, n_valid)
    qf, kf, vf = (t.permute(0, 2, 1, 3).float() for t in (q, k, v))
    p = _probs(qf, kf, scale, n_valid)
    denom = p.sum(dim=-1, keepdim=True)
    s_p = _scale(p.amax(dim=-1, keepdim=True))
    p8 = torch.clamp(torch.round(p / s_p), 0, 127)
    s_v = _scale(vf[:, :, :n_valid].abs().amax(dim=2, keepdim=True))
    v8 = torch.clamp(torch.round(vf / s_v), -127, 127)
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


def _rows_fit(what: str, width: int) -> None:
    """The row quantizers hold a row in one warp's registers."""
    if width % 256 or width > 1024:
        raise ValueError(f"the {what} kernel quantizes rows of width % 256 "
                         f"== 0 and <= 1024, got {width}")


def int8_ln_qkv_cuda(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, w8: torch.Tensor,
                     scale: torch.Tensor, heads: int, dim_head: int) -> QKV:
    """Launch the Hopper kernel K10 on bf16 x [B, N, dim]."""
    b, n, dim = x.shape
    inner = heads * dim_head
    check_operand("x", x, torch.bfloat16)
    check_operand("w8", w8, torch.int8, (3 * inner, dim))
    vecs = _vectors(gamma=(gamma, dim), beta=(beta, dim),
                    scale=(scale, 3 * inner))
    _rows_fit("int8 LN+QKV", dim)
    if inner % 128:
        raise ValueError(f"the int8 LN+QKV kernel takes heads * dim_head % "
                         f"128 == 0, got {inner}")
    q, k, v = (x.new_empty(b, n, heads, dim_head) for _ in range(3))
    launch("nvt_int8_ln_qkv", (VOID,) * 8 + (INT, INT, INT, FLOAT), x,
           ptr(x), ptr(vecs["gamma"]), ptr(vecs["beta"]), ptr(w8),
           ptr(vecs["scale"]), ptr(q), ptr(k), ptr(v), b * n, dim, inner,
           nn.LN_EPS)
    int8_ln_qkv_cuda.launches += 1
    return q, k, v


int8_ln_qkv_cuda.launches = 0


def int8_outproj_residual_cuda(x: torch.Tensor, a: torch.Tensor,
                               w8: torch.Tensor, scale: torch.Tensor,
                               bias: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel K11 on bf16 x [B, N, dim], a [B, N, inner]."""
    b, n, dim = x.shape
    inner = a.shape[-1]
    check_operand("x", x, torch.bfloat16)
    check_operand("a", a, torch.bfloat16, (b, n, inner))
    check_operand("w8", w8, torch.int8, (dim, inner))
    vecs = _vectors(scale=(scale, dim), bias=(bias, dim))
    _rows_fit("int8 out-projection", inner)
    if dim % 512:
        raise ValueError(f"the int8 out-projection kernel takes dim % 512 "
                         f"== 0, got {dim}")
    y = torch.empty_like(x)
    launch("nvt_int8_outproj", (VOID,) * 6 + (INT,) * 3, x, ptr(a), ptr(x),
           ptr(w8), ptr(vecs["scale"]), ptr(vecs["bias"]), ptr(y), b * n,
           inner, dim)
    int8_outproj_residual_cuda.launches += 1
    return y


int8_outproj_residual_cuda.launches = 0


def int8_mlp_block_cuda(x: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, w1: torch.Tensor,
                        s1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                        s2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel K12 on bf16 x [B, N, dim]. It takes an f32
    scratch [B * N, mlp_dim] for the one round trip of g (csrc/int8_mlp.cu)."""
    b, n, dim = x.shape
    hid = w1.shape[0]
    check_operand("x", x, torch.bfloat16)
    check_operand("w1", w1, torch.int8, (hid, dim))
    check_operand("w2", w2, torch.int8, (dim, hid))
    vecs = _vectors(gamma=(gamma, dim), beta=(beta, dim), s1=(s1, hid),
                    b1=(b1, hid), s2=(s2, dim), b2=(b2, dim))
    _rows_fit("int8 MLP", dim)
    if hid % 128:
        raise ValueError(f"the int8 MLP kernel takes mlp_dim % 128 == 0, "
                         f"got {hid}")
    y = torch.empty_like(x)
    gbuf = torch.empty((b * n, hid), dtype=torch.float32, device=x.device)
    launch("nvt_int8_mlp", (VOID,) * 11 + (INT, INT, INT, FLOAT), x,
           ptr(x), ptr(vecs["gamma"]), ptr(vecs["beta"]), ptr(w1),
           ptr(vecs["s1"]), ptr(vecs["b1"]), ptr(w2), ptr(vecs["s2"]),
           ptr(vecs["b2"]), ptr(y), ptr(gbuf), b * n, dim, hid, nn.LN_EPS)
    int8_mlp_block_cuda.launches += 1
    return y


int8_mlp_block_cuda.launches = 0


def int8_flash_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, scale: float,
                              n_valid: Optional[int] = None) -> torch.Tensor:
    """Launch the Hopper kernel K13 (V's quantization prologue, then the
    two-sweep attention): bf16 [B, N, H, 64], contiguous."""
    _check_qkv(q, k, v)
    b, n, h, d = q.shape
    n_valid = _n_valid(q, n_valid)
    n_pad = (n + 63) // 64 * 64
    o = torch.empty_like(q)
    v8 = torch.empty((b * h, n_pad, d), dtype=torch.int8, device=q.device)
    s_v = torch.empty((b * h, d), dtype=torch.float32, device=q.device)
    launch("nvt_int8_attention", (VOID,) * 6 + (INT,) * 5 + (FLOAT,), q,
           ptr(q), ptr(k), ptr(v), ptr(o), ptr(v8), ptr(s_v), b, n, h, d,
           n_valid, float(scale * LOG2E))
    int8_flash_attention_cuda.launches += 1
    return o


int8_flash_attention_cuda.launches = 0


# ---------------------------------------------------------------------------
# Dispatchers
# ---------------------------------------------------------------------------

def int8_ln_qkv(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                w8: torch.Tensor, scale: torch.Tensor, heads: int,
                dim_head: int) -> QKV:
    """LN, per-row int8 quantization and the int8 QKV projection:
    [B, N, dim] -> q, k, v [B, N, H, D]. CPU tensors take the plain
    version, CUDA tensors the kernel."""
    fn = (int8_ln_qkv_plain if on_cpu(x, gamma, beta, w8, scale)
          else int8_ln_qkv_cuda)
    return fn(x, gamma, beta, w8, scale, heads, dim_head)


def int8_outproj_residual(x: torch.Tensor, a: torch.Tensor, w8: torch.Tensor,
                          scale: torch.Tensor, bias: torch.Tensor
                          ) -> torch.Tensor:
    """x + int8 out-projection of the attention output a [B, N, inner]."""
    fn = (int8_outproj_residual_plain if on_cpu(x, a, w8, scale, bias)
          else int8_outproj_residual_cuda)
    return fn(x, a, w8, scale, bias)


def int8_mlp_block(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   w1: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, s2: torch.Tensor, b2: torch.Tensor
                   ) -> torch.Tensor:
    """x + fc2(GELU(fc1(LN(x)))) with both GEMMs int8, [B, N, dim]."""
    args = (x, gamma, beta, w1, s1, b1, w2, s2, b2)
    fn = int8_mlp_block_plain if on_cpu(*args) else int8_mlp_block_cuda
    return fn(*args)


def int8_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float, n_valid: Optional[int] = None
                         ) -> torch.Tensor:
    """Attention over [B, N, H, D] with the PV product in int8; keys at or
    past ``n_valid`` get zero weight. As the JAX wrapper chooses by shape
    (int8_serving.py:343-347), N > 4096 or D < 8 takes the bf16
    :func:`flash_attention` (K1) instead."""
    b, n, h, d = q.shape
    if n > MAX_RESIDENT_N or d < 8:
        return flash_attention(q, k, v, scale=scale, n_valid=n_valid)
    fn = (int8_flash_attention_plain if on_cpu(q, k, v)
          else int8_flash_attention_cuda)
    return fn(q, k, v, scale=scale, n_valid=n_valid)
