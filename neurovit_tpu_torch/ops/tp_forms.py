"""The tensor-parallel forms of the block kernels: a shard's partials.

Under Megatron-style tensor parallelism (``parallel/tensor_parallel.py``)
a block's row-parallel products (the out-projection's Wout, the MLP's W2)
contract over the shard's heads or hidden columns only, so each shard's
product is a partial sum, and the bias, the dropout and the residual
belong to the whole sum. The one-process kernels round their output to
x's dtype; summing rounded bf16 partials would round every shard once
more. So each pass that ends a row-parallel product, or a LayerNorm
backward behind a column-parallel one, has a form that writes the shard's
partial in f32 (int8: its int32 accumulator), which the model group sums
and rounds once:

- :func:`outproj_partial` (K3's form, ``nvt_fused_outproj{,_f32}_partial
  _fwd``) and :func:`mlp_partial` (K4's, ``nvt_fused_mlp{,_f32}_partial
  _fwd``): ``[m = 0] x + Drop(a_m W_m^T + [m = 0] b)`` in f32, from K4's
  fc2_residual pass in its partial form. The mask is the whole output's,
  at the same (row, col) under one key across the model group: dropout is
  linear under one mask, so the shards' sum is the whole;
- :func:`ln_qkv_bwd_partial` (K7's, ``nvt_fused_ln_qkv_bwd_partial``) and
  :func:`mlp_bwd_partial` (K9's, ``nvt_fused_mlp{,_f32}_bwd_partial``): the
  LayerNorm backward of the shard's partial du, which it is linear in, plus
  ``[m = 0] dy`` where the block has its residual (K9), as f32 dx; dgamma
  and dbeta are partials too. At f32 K7's dx is f32 already, so its form is
  K7 f32 itself;
- int8: a row-parallel input's per-row scale is the amax over the whole
  row. :func:`int8_row_amax` (``nvt_int8_row_amax``) and
  :func:`int8_mlp_hidden` (K12's LN row-quantize and fc1, then each row's
  amax of g over the shard's tiles) give a shard's row amax; the caller
  maxes it over the model group; :func:`int8_outproj_partial` (K11's codes
  with that amax, then K12's fc2 in its tensor-parallel form) and
  :func:`int8_mlp_partial` (g's codes with it, then fc2) give codes equal
  to the one-card codes bit for bit, and the shard's int32 accumulator
  ``a8_m W8_m^T``. The model group sums the accumulators in int32, which is
  exact, and :func:`int8_dequant_residual` runs the pass's epilogue once on
  the sum: ``x + dequant(acc) + b`` in x's dtype, one card's output bit for
  bit.

``first`` is ``[m = 0]``: in the f32 partials the model group's first
shard adds the bias and the residual; on the others they are null
pointers. Each form has its plain PyTorch version beside it, which CPU
tensors run; CUDA tensors run the kernel, bf16 or f32 (``common.pick``),
or raise. Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.ops import tf32x3
from neurovit_tpu_torch.ops.common import (FLOAT, INT, U64, VOID,
                                           check_operand, dropout_args,
                                           launch, pick, ptr)
from neurovit_tpu_torch.ops.fused_mlp import (Seeds, _operands,
                                              ln_backward_plain,
                                              mlp_bwd_f32_plan, mlp_bwd_plan,
                                              mlp_f32_plan, mlp_plan)
from neurovit_tpu_torch.ops.fused_outproj import (outproj_f32_plan,
                                                  outproj_plan)
from neurovit_tpu_torch.ops.fused_qkv import (fused_ln_qkv_bwd_f32_cuda,
                                              qkv_bwd_plan)
from neurovit_tpu_torch.ops.fused_qkv import _operands as _qkv_operands
from neurovit_tpu_torch.ops.int8_serving import (_deq_dot, _ln, _rowquant,
                                                 _scale, _scratch, _vectors,
                                                 int8_outproj_plan)
from neurovit_tpu_torch.ops.int8_serving import mlp_plan as int8_mlp_plan


# ---------------------------------------------------------------------------
# K3's and K4's forms: the row-parallel product's f32 partial
# ---------------------------------------------------------------------------

def outproj_partial_plain(x: torch.Tensor, attn: torch.Tensor,
                          w_out: torch.Tensor, b_out: torch.Tensor, *,
                          first: bool, dropout_rate: float = 0.0,
                          seed: int = 0) -> torch.Tensor:
    """K3's form in plain PyTorch: x [B, N, dim], attn [B, N, inner_m] the
    shard's heads, w_out [dim, inner_m] its columns, b_out [dim]; f32
    ``(attn Wout^T [+ b]) * mask / keep [+ x]``, b and x where ``first``."""
    z = torch.matmul(attn.float(), w_out.to(x.dtype).float().t())
    if first:
        z = z + b_out.float()
    if dropout_rate:
        z = z * nn.mask_scale(seed, z.shape, dropout_rate, x.device)
    return z + x.float() if first else z


def _outproj_partial_launch(symbol: str, dtype, x, attn, w_out, b_out, *,
                            first: bool, dropout_rate: float, seed: int):
    b, n, dim = x.shape
    inner = attn.shape[-1]
    check_operand("x", x, dtype)
    check_operand("attn", attn, dtype, (b, n, inner))
    w = w_out.to(dtype).contiguous()
    bias = b_out.float().contiguous()
    check_operand("w_out", w, dtype, (dim, inner))
    check_operand("b_out", bias, torch.float32, (dim,))
    plan = outproj_f32_plan if dtype == torch.float32 else outproj_plan
    plan(b * n, dim, inner)
    inv_keep, keep_q = dropout_args(dropout_rate)
    y = torch.empty((b, n, dim), dtype=torch.float32, device=x.device)
    ws = tf32x3.split_cuda(w) if dtype == torch.float32 else (w,)
    launch(symbol, (VOID,) * (4 + len(ws)) + (INT,) * 3 + (FLOAT, INT, U64),
           x, ptr(attn), ptr(x if first else None), *(ptr(t) for t in ws),
           ptr(bias if first else None), ptr(y), b * n, inner, dim,
           inv_keep, keep_q, int(seed))
    return y


def outproj_partial_cuda(x, attn, w_out, b_out, *, first: bool,
                         dropout_rate: float = 0.0, seed: int = 0):
    """Launch K3's form on bf16 x and attn: one launch of K4's fc2 pass in
    its partial form (``csrc/fused_outproj.cu``)."""
    y = _outproj_partial_launch("nvt_fused_outproj_partial_fwd",
                                torch.bfloat16, x, attn, w_out, b_out,
                                first=first, dropout_rate=dropout_rate,
                                seed=seed)
    outproj_partial_cuda.launches += 1
    return y


outproj_partial_cuda.launches = 0


def outproj_partial_f32_cuda(x, attn, w_out, b_out, *, first: bool,
                             dropout_rate: float = 0.0, seed: int = 0):
    """Launch K3 f32's form on f32 x and attn: Wout's split by the
    pre-pass (``tf32x3.split_cuda``, counted there), then K4 f32's fc2 in
    its partial form (``csrc/fused_outproj_f32.cu``)."""
    y = _outproj_partial_launch("nvt_fused_outproj_f32_partial_fwd",
                                torch.float32, x, attn, w_out, b_out,
                                first=first, dropout_rate=dropout_rate,
                                seed=seed)
    outproj_partial_f32_cuda.launches += 1
    return y


outproj_partial_f32_cuda.launches = 0


def outproj_partial(x: torch.Tensor, attn: torch.Tensor, w_out: torch.Tensor,
                    b_out: torch.Tensor, *, first: bool,
                    dropout_rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """A row-parallel shard's out-projection partial, f32 [B, N, dim]."""
    fn = pick(outproj_partial_plain, outproj_partial_cuda,
              outproj_partial_f32_cuda, x, attn, w_out, b_out)
    return fn(x, attn, w_out, b_out, first=first, dropout_rate=dropout_rate,
              seed=seed)


def mlp_partial_plain(x, gamma, beta, w1, b1, w2, b2, *, first: bool,
                      dropout_rate: float = 0.0, seeds: Seeds = (0, 0),
                      return_h: bool = False):
    """K4's form in plain PyTorch on a shard (w1 [hid_m, dim], b1 [hid_m],
    w2 [dim, hid_m]): the one-process block's rounding points up to fc2,
    whose f32 output ``(g W2^T [+ b2]) * mask2 / keep [+ x]`` is not
    rounded; b2 and x where ``first``. With ``return_h`` also h [B, N,
    hid_m] in x's dtype."""
    u = nn.layer_norm(x, gamma, beta)
    h = (torch.matmul(u.float(), w1.to(x.dtype).float().t())
         + b1.float()).to(x.dtype)
    g = nn.gelu(h.float())
    if dropout_rate:
        g = g * nn.mask_scale(seeds[0], g.shape, dropout_rate, x.device)
    g = g.to(x.dtype)
    z = torch.matmul(g.float(), w2.to(x.dtype).float().t())
    if first:
        z = z + b2.float()
    if dropout_rate:
        z = z * nn.mask_scale(seeds[1], z.shape, dropout_rate, x.device)
    y = z + x.float() if first else z
    return (y, h) if return_h else y


def _mlp_partial_launch(symbol: str, dtype, x, gamma, beta, w1, b1, w2, b2, *,
                        first: bool, dropout_rate: float, seeds: Seeds,
                        return_h: bool):
    b, n, dim = x.shape
    hid = w1.shape[0]
    w1c, w2c, vecs = _operands(x, w1, w2, dtype, gamma=gamma, beta=beta,
                               b1=b1, b2=b2)
    plan = (mlp_f32_plan if dtype == torch.float32 else mlp_plan)(b * n, dim,
                                                                  hid)
    inv_keep, keep_q = dropout_args(dropout_rate)
    y = torch.empty((b, n, dim), dtype=torch.float32, device=x.device)
    h = x.new_empty(b, n, hid) if return_h else None
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=x.device)
    if dtype == torch.float32:
        w1s, w2s = tf32x3.split_cuda(w1c), tf32x3.split_cuda(w2c)
    else:
        w1s, w2s = (w1c,), (w2c,)
    args = (ptr(x), ptr(vecs["gamma"]), ptr(vecs["beta"]),
            *(ptr(t) for t in w1s), ptr(vecs["b1"]), *(ptr(t) for t in w2s),
            ptr(vecs["b2"] if first else None), ptr(x if first else None),
            ptr(y), ptr(h), ptr(scratch))
    launch(symbol, (VOID,) * len(args) + (INT,) * 3 + (FLOAT, FLOAT, INT,
                                                       U64, U64),
           x, *args, b * n, dim, hid, nn.LN_EPS, inv_keep, keep_q,
           int(seeds[0]), int(seeds[1]))
    return (y, h) if return_h else y


def mlp_partial_cuda(x, gamma, beta, w1, b1, w2, b2, *, first: bool,
                     dropout_rate: float = 0.0, seeds: Seeds = (0, 0),
                     return_h: bool = False):
    """Launch K4's form on bf16 x: LN rows, fc1 on the shard's hidden
    columns, fc2 in its partial form (``csrc/fused_mlp.cu``)."""
    out = _mlp_partial_launch("nvt_fused_mlp_partial_fwd", torch.bfloat16, x,
                              gamma, beta, w1, b1, w2, b2, first=first,
                              dropout_rate=dropout_rate, seeds=seeds,
                              return_h=return_h)
    mlp_partial_cuda.launches += 1
    return out


mlp_partial_cuda.launches = 0


def mlp_partial_f32_cuda(x, gamma, beta, w1, b1, w2, b2, *, first: bool,
                         dropout_rate: float = 0.0, seeds: Seeds = (0, 0),
                         return_h: bool = False):
    """Launch K4 f32's form on f32 x: W1's and W2's splits (counted by
    ``tf32x3.split_cuda``), then the passes of ``csrc/fused_mlp_f32.cu``
    with fc2 in its partial form."""
    out = _mlp_partial_launch("nvt_fused_mlp_f32_partial_fwd", torch.float32,
                              x, gamma, beta, w1, b1, w2, b2, first=first,
                              dropout_rate=dropout_rate, seeds=seeds,
                              return_h=return_h)
    mlp_partial_f32_cuda.launches += 1
    return out


mlp_partial_f32_cuda.launches = 0


def mlp_partial(x, gamma, beta, w1, b1, w2, b2, *, first: bool,
                dropout_rate: float = 0.0, seeds: Seeds = (0, 0),
                return_h: bool = False):
    """A shard's MLP block partial, f32 [B, N, dim] (and h)."""
    fn = pick(mlp_partial_plain, mlp_partial_cuda, mlp_partial_f32_cuda, x,
              gamma, beta, w1, b1, w2, b2)
    return fn(x, gamma, beta, w1, b1, w2, b2, first=first,
              dropout_rate=dropout_rate, seeds=seeds, return_h=return_h)


# ---------------------------------------------------------------------------
# K7's and K9's forms: the LayerNorm backward of a partial du, f32 dx
# ---------------------------------------------------------------------------

def ln_qkv_bwd_partial_plain(dqkv, x, gamma, w_qkv):
    """K7's form in plain PyTorch on a shard (dqkv [B, N, 3 inner_m], w_qkv
    [3 inner_m, dim] its heads of q, k and v): (dx f32, the LayerNorm
    backward of the shard's du; dgamma, dbeta, its partials)."""
    b, n, dim = x.shape
    du = torch.matmul(dqkv.reshape(b * n, -1).float(),
                      w_qkv.to(x.dtype).float())
    dx, dgamma, dbeta = ln_backward_plain(x.reshape(b * n, dim), du, gamma)
    return dx.reshape(x.shape), dgamma, dbeta


def ln_qkv_bwd_partial_cuda(dqkv, x, gamma, w_qkv):
    """Launch K7's form on bf16 operands: K7's passes with dx written as
    f32 (``csrc/fused_qkv_bwd.cu``)."""
    b, n, dim = x.shape
    inner = dqkv.shape[-1] // 3
    w, vecs = _qkv_operands(x, w_qkv, inner, gamma=gamma)
    check_operand("dqkv", dqkv, torch.bfloat16, (b, n, 3 * inner))
    m = b * n
    plan = qkv_bwd_plan(m, dim, inner)
    dx = torch.empty((b, n, dim), dtype=torch.float32, device=x.device)
    dgb = torch.empty((2, dim), dtype=torch.float32, device=x.device)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=x.device)
    launch("nvt_fused_ln_qkv_bwd_partial",
           (VOID,) * 8 + (INT, INT, INT, FLOAT), x, ptr(dqkv), ptr(x),
           ptr(vecs["gamma"]), ptr(w), ptr(dx), ptr(dgb[0]), ptr(dgb[1]),
           ptr(scratch), m, dim, inner, nn.LN_EPS)
    ln_qkv_bwd_partial_cuda.launches += 1
    return dx, dgb[0], dgb[1]


ln_qkv_bwd_partial_cuda.launches = 0


def ln_qkv_bwd_partial(dqkv, x, gamma, w_qkv):
    """A shard's LN + QKV backward: (f32 dx partial, dgamma, dbeta)."""
    fn = pick(ln_qkv_bwd_partial_plain, ln_qkv_bwd_partial_cuda,
              fused_ln_qkv_bwd_f32_cuda, x, dqkv)
    return fn(dqkv, x, gamma, w_qkv)


def mlp_bwd_partial_plain(dy, x, h, gamma, beta, w1, w2, *, first: bool,
                          dropout_rate: float = 0.0, seeds: Seeds = (0, 0)):
    """K9's form in plain PyTorch on a shard: K9's plain version up to du
    (the shard's partial), then (dx f32 = LN backward of du [+ dy where
    ``first``], u, a, dz, dh, dgamma, dbeta)."""
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
    if first:
        dx = dx + dyf
    return dx.reshape(x.shape), u, a.to(dt), dz, dh, dgamma, dbeta


def mlp_bwd_partial_cuda(dy, x, h, gamma, beta, w1, w2, *, first: bool,
                         dropout_rate: float = 0.0, seeds: Seeds = (0, 0)):
    """Launch K9's form on bf16 operands: K9's five passes, the LayerNorm
    rows writing f32 dx with dy added on the first shard alone
    (``csrc/fused_mlp_bwd.cu``)."""
    b, n, dim = x.shape
    hid = w1.shape[0]
    m = b * n
    w1b, w2b, vecs = _operands(x, w1, w2, gamma=gamma, beta=beta)
    check_operand("dy", dy, torch.bfloat16, (b, n, dim))
    check_operand("h", h, torch.bfloat16, (b, n, hid))
    plan = mlp_bwd_plan(m, dim, hid)
    inv_keep, keep_q = dropout_args(dropout_rate)
    dx = torch.empty((b, n, dim), dtype=torch.float32, device=x.device)
    u, dz = torch.empty_like(x), torch.empty_like(x)
    a, dh = (x.new_empty(m, hid) for _ in range(2))
    dgb = torch.empty((2, dim), dtype=torch.float32, device=x.device)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=x.device)
    launch("nvt_fused_mlp_bwd_partial",
           (VOID,) * 16 + (INT, INT, INT, FLOAT, FLOAT, INT, U64, U64), x,
           ptr(dy), ptr(x), ptr(h), ptr(vecs["gamma"]), ptr(vecs["beta"]),
           ptr(w1b), ptr(w2b), ptr(dy if first else None), ptr(dx), ptr(u),
           ptr(a), ptr(dz), ptr(dh), ptr(dgb[0]), ptr(dgb[1]), ptr(scratch),
           m, dim, hid, nn.LN_EPS, inv_keep, keep_q, int(seeds[0]),
           int(seeds[1]))
    mlp_bwd_partial_cuda.launches += 1
    return (dx, u.reshape(m, dim), a, dz.reshape(m, dim), dh, dgb[0],
            dgb[1])


mlp_bwd_partial_cuda.launches = 0


def mlp_bwd_partial_f32_cuda(dy, x, h, gamma, beta, w1, w2, *, first: bool,
                             dropout_rate: float = 0.0,
                             seeds: Seeds = (0, 0)):
    """Launch K9 f32's form on f32 operands: the split transposes of W2 and
    W1 (counted by ``tf32x3.split_t_cuda``), then K9 f32's passes with dy
    added by the LayerNorm rows on the first shard alone
    (``csrc/fused_mlp_bwd_f32.cu``). At dropout 0 dz is dy."""
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
    launch("nvt_fused_mlp_f32_bwd_partial",
           (VOID,) * 18 + (INT, INT, INT, FLOAT, FLOAT, INT, U64, U64), x,
           ptr(dy), ptr(x), ptr(h), ptr(vecs["gamma"]), ptr(vecs["beta"]),
           ptr(w2t_big), ptr(w2t_small), ptr(w1t_big), ptr(w1t_small),
           ptr(dy if first else None), ptr(dx), ptr(u), ptr(a), ptr(dz),
           ptr(dh), ptr(dgb[0]), ptr(dgb[1]), ptr(scratch), m, dim, hid,
           nn.LN_EPS, inv_keep, keep_q, int(seeds[0]), int(seeds[1]))
    mlp_bwd_partial_f32_cuda.launches += 1
    dz = dy if dz is None else dz
    return (dx, u.reshape(m, dim), a, dz.reshape(m, dim), dh, dgb[0],
            dgb[1])


mlp_bwd_partial_f32_cuda.launches = 0


def mlp_bwd_partial(dy, x, h, gamma, beta, w1, w2, *, first: bool,
                    dropout_rate: float = 0.0, seeds: Seeds = (0, 0)):
    """A shard's MLP backward: (f32 dx partial, u, a, dz, dh, dgamma,
    dbeta)."""
    fn = pick(mlp_bwd_partial_plain, mlp_bwd_partial_cuda,
              mlp_bwd_partial_f32_cuda, x, dy)
    return fn(dy, x, h, gamma, beta, w1, w2, first=first,
              dropout_rate=dropout_rate, seeds=seeds)


# ---------------------------------------------------------------------------
# K11's and K12's forms: the row amax over the model group, the int32
# accumulator summed over it, one epilogue
# ---------------------------------------------------------------------------

def int8_row_amax_plain(a: torch.Tensor) -> torch.Tensor:
    """Each row's amax of |a| over the shard's columns: f32 [B, N]."""
    return a.float().abs().amax(dim=-1)


def _row_amax_launch(symbol: str, dtype, a):
    b, n, inner = a.shape
    check_operand("a", a, dtype)
    amax = torch.empty((b, n), dtype=torch.float32, device=a.device)
    launch(symbol, (VOID,) * 2 + (INT, INT), a, ptr(a), ptr(amax), b * n,
           inner)
    return amax


def int8_row_amax_cuda(a: torch.Tensor) -> torch.Tensor:
    """Launch K11's amax pass on bf16 a (``csrc/int8_rowquant.cu``)."""
    amax = _row_amax_launch("nvt_int8_row_amax", torch.bfloat16, a)
    int8_row_amax_cuda.launches += 1
    return amax


int8_row_amax_cuda.launches = 0


def int8_row_amax_f32_cuda(a: torch.Tensor) -> torch.Tensor:
    """Launch K11's amax pass on f32 a."""
    amax = _row_amax_launch("nvt_int8_row_amax_f32", torch.float32, a)
    int8_row_amax_f32_cuda.launches += 1
    return amax


int8_row_amax_f32_cuda.launches = 0


def int8_row_amax(a: torch.Tensor) -> torch.Tensor:
    """A shard's row amax of the out-projection's input a [B, N, inner_m]."""
    fn = pick(int8_row_amax_plain, int8_row_amax_cuda, int8_row_amax_f32_cuda,
              a)
    return fn(a)


def _codes(u: torch.Tensor, amax: torch.Tensor):
    """Per-row int8 codes of f32 u [..., K] with the row amax [...] given:
    (integer-valued f32 codes, scale [..., 1])."""
    scale = _scale(amax.float()[..., None])
    return torch.clamp(torch.round(u / scale), -127, 127), scale


def _acc(codes: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """codes . w8^T as int32, the int32 product as an exact f64 matmul."""
    return torch.matmul(codes.double(), w8.double().t()).to(torch.int32)


def int8_outproj_partial_plain(a, amax, w8):
    """K11's form in plain PyTorch: a's codes with the whole row's amax,
    then the int32 accumulator ``a8 . w8^T`` [B, N, dim] of the shard."""
    codes, _ = _codes(a.float(), amax)
    return _acc(codes, w8)


def _outproj_partial_int8(symbol: str, dtype, a, amax, w8, scratch=None):
    b, n, inner = a.shape
    dim = w8.shape[0]
    check_operand("a", a, dtype)
    check_operand("amax", amax, torch.float32, (b, n))
    check_operand("w8", w8, torch.int8, (dim, inner))
    plan = int8_outproj_plan(b * n, dim, inner)
    acc = torch.empty((b, n, dim), dtype=torch.int32, device=a.device)
    scratch = _scratch(plan, a, scratch)
    launch(symbol, (VOID,) * 5 + (INT,) * 3, a, ptr(a), ptr(amax), ptr(w8),
           ptr(acc), ptr(scratch), b * n, inner, dim)
    return acc


def int8_outproj_partial_cuda(a, amax, w8, *, scratch=None):
    """Launch K11's form on bf16 a: the codes with the given amax, then
    K12's fc2 in its tensor-parallel form, the int32 accumulator
    (``csrc/int8_outproj.cu``). ``scratch``: a caller's uint8 scratch of
    K11's plan, where the codes stay to be read."""
    acc = _outproj_partial_int8("nvt_int8_outproj_partial", torch.bfloat16, a,
                                amax, w8, scratch)
    int8_outproj_partial_cuda.launches += 1
    return acc


int8_outproj_partial_cuda.launches = 0


def int8_outproj_partial_f32_cuda(a, amax, w8, *, scratch=None):
    """Launch K11's form on f32 a."""
    acc = _outproj_partial_int8("nvt_int8_outproj_partial_f32",
                                torch.float32, a, amax, w8, scratch)
    int8_outproj_partial_f32_cuda.launches += 1
    return acc


int8_outproj_partial_f32_cuda.launches = 0


def int8_outproj_partial(a, amax, w8) -> torch.Tensor:
    """A row-parallel shard's int8 out-projection accumulator, int32 [B, N,
    dim], with ``amax`` [B, N] the whole row's."""
    fn = pick(int8_outproj_partial_plain, int8_outproj_partial_cuda,
              int8_outproj_partial_f32_cuda, a, amax)
    return fn(a, amax, w8)


def int8_mlp_hidden_plain(x, gamma, beta, w1, s1, b1):
    """K12's first half in plain PyTorch on a shard (w1 [hid_m, dim] int8,
    s1, b1 [hid_m]): (g f32 [B, N, hid_m], each row's amax of g over the
    shard's columns [B, N])."""
    codes, s_row = _rowquant(_ln(x, gamma, beta))
    g = nn.gelu(_deq_dot(codes, s_row, w1, s1) + b1.float())
    return g, g.abs().amax(dim=-1)


def _mlp_hidden_int8(symbol: str, dtype, x, gamma, beta, w1, s1, b1):
    b, n, dim = x.shape
    hid = w1.shape[0]
    check_operand("x", x, dtype)
    check_operand("w1", w1, torch.int8, (hid, dim))
    vecs = _vectors(gamma=(gamma, dim), beta=(beta, dim), s1=(s1, hid),
                    b1=(b1, hid))
    plan = int8_mlp_plan(b * n, dim, hid)
    amax = torch.empty((b, n), dtype=torch.float32, device=x.device)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=x.device)
    launch(symbol, (VOID,) * 8 + (INT, INT, INT, FLOAT), x, ptr(x),
           ptr(vecs["gamma"]), ptr(vecs["beta"]), ptr(w1), ptr(vecs["s1"]),
           ptr(vecs["b1"]), ptr(amax), ptr(scratch), b * n, dim, hid,
           nn.LN_EPS)
    return scratch, amax


def int8_mlp_hidden_cuda(x, gamma, beta, w1, s1, b1):
    """Launch K12's first half on bf16 x: LN row-quantize, fc1 + GELU on
    the shard's hidden columns into the scratch, each row's amax
    (``csrc/int8_mlp.cu``). Returns (the scratch, amax)."""
    out = _mlp_hidden_int8("nvt_int8_mlp_hidden", torch.bfloat16, x, gamma,
                           beta, w1, s1, b1)
    int8_mlp_hidden_cuda.launches += 1
    return out


int8_mlp_hidden_cuda.launches = 0


def int8_mlp_hidden_f32_cuda(x, gamma, beta, w1, s1, b1):
    """Launch K12's first half on f32 x."""
    out = _mlp_hidden_int8("nvt_int8_mlp_hidden_f32", torch.float32, x,
                           gamma, beta, w1, s1, b1)
    int8_mlp_hidden_f32_cuda.launches += 1
    return out


int8_mlp_hidden_f32_cuda.launches = 0


def int8_mlp_hidden(x, gamma, beta, w1, s1, b1) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """A shard's int8 MLP up to g: (its state for :func:`int8_mlp_partial`
    (g on the CPU, the kernel's scratch on the card), the row amax)."""
    fn = pick(int8_mlp_hidden_plain, int8_mlp_hidden_cuda,
              int8_mlp_hidden_f32_cuda, x, gamma, beta, w1, s1, b1)
    return fn(x, gamma, beta, w1, s1, b1)


def int8_mlp_partial_plain(state, amax, w2):
    """K12's second half in plain PyTorch: g's codes with the whole row's
    amax, then the int32 accumulator ``g8 . W2^T`` [B, N, dim]."""
    codes, _ = _codes(state, amax)
    return _acc(codes, w2)


def int8_mlp_partial_cuda(state, amax, w2):
    """Launch K12's second half on the first half's scratch (of either
    dtype; g is f32 in it): g's codes with the given amax, then fc2 in its
    tensor-parallel form, the int32 accumulator."""
    b, n = amax.shape
    dim, hid = w2.shape
    check_operand("amax", amax, torch.float32, (b, n))
    check_operand("w2", w2, torch.int8, (dim, hid))
    plan = int8_mlp_plan(b * n, dim, hid)
    check_operand("scratch", state, torch.uint8, (plan.scratch_bytes,))
    acc = torch.empty((b, n, dim), dtype=torch.int32, device=amax.device)
    launch("nvt_int8_mlp_partial", (VOID,) * 4 + (INT, INT, INT), amax,
           ptr(amax), ptr(w2), ptr(acc), ptr(state), b * n, dim, hid)
    int8_mlp_partial_cuda.launches += 1
    return acc


int8_mlp_partial_cuda.launches = 0


def int8_mlp_partial(state, amax, w2) -> torch.Tensor:
    """A shard's int8 MLP accumulator, int32 [B, N, dim], with ``amax`` the
    whole row's."""
    fn = (int8_mlp_partial_plain if amax.device.type == "cpu"
          else int8_mlp_partial_cuda)
    return fn(state, amax, w2)


def int8_dequant_residual_plain(x, acc, amax, scale, bias):
    """The last pass's epilogue in plain PyTorch on the model group's int32
    sum: ``x + (float(acc) * s_row * s_col + bias)`` rounded to x's dtype
    once, s_row the scale of the whole row's amax; the one-card plain
    version's arithmetic."""
    s_row = _scale(amax.float()[..., None])
    z = acc.float() * s_row * scale.float() + bias.float()
    return (z + x.float()).to(x.dtype)


def _dequant_residual_launch(symbol: str, dtype, x, acc, amax, scale, bias):
    b, n, dim = x.shape
    check_operand("x", x, dtype)
    check_operand("acc", acc, torch.int32, (b, n, dim))
    check_operand("amax", amax, torch.float32, (b, n))
    vecs = _vectors(scale=(scale, dim), bias=(bias, dim))
    y = torch.empty_like(x)
    launch(symbol, (VOID,) * 6 + (INT, INT), x, ptr(acc), ptr(amax),
           ptr(vecs["scale"]), ptr(vecs["bias"]), ptr(x), ptr(y), b * n, dim)
    return y


def int8_dequant_residual_cuda(x, acc, amax, scale, bias):
    """Launch the epilogue on bf16 x (``csrc/int8_mlp.cu``)."""
    y = _dequant_residual_launch("nvt_int8_dequant_residual", torch.bfloat16,
                                 x, acc, amax, scale, bias)
    int8_dequant_residual_cuda.launches += 1
    return y


int8_dequant_residual_cuda.launches = 0


def int8_dequant_residual_f32_cuda(x, acc, amax, scale, bias):
    """Launch the epilogue on f32 x."""
    y = _dequant_residual_launch("nvt_int8_dequant_residual_f32",
                                 torch.float32, x, acc, amax, scale, bias)
    int8_dequant_residual_f32_cuda.launches += 1
    return y


int8_dequant_residual_f32_cuda.launches = 0


def int8_dequant_residual(x, acc, amax, scale, bias) -> torch.Tensor:
    """K11's or K12's last step on the model group's int32 sum ``acc``:
    the block's output in x's dtype, one card's bit for bit."""
    fn = pick(int8_dequant_residual_plain, int8_dequant_residual_cuda,
              int8_dequant_residual_f32_cuda, x, acc, amax)
    return fn(x, acc, amax, scale, bias)


# Every wrapper that launches a form, by the name the card's checks use.
CUDA_WRAPPERS = {
    "fused_outproj_partial": outproj_partial_cuda,
    "fused_outproj_partial_f32": outproj_partial_f32_cuda,
    "fused_mlp_partial": mlp_partial_cuda,
    "fused_mlp_partial_f32": mlp_partial_f32_cuda,
    "fused_ln_qkv_bwd_partial": ln_qkv_bwd_partial_cuda,
    "fused_mlp_bwd_partial": mlp_bwd_partial_cuda,
    "fused_mlp_bwd_partial_f32": mlp_bwd_partial_f32_cuda,
    "int8_row_amax": int8_row_amax_cuda,
    "int8_row_amax_f32": int8_row_amax_f32_cuda,
    "int8_outproj_partial": int8_outproj_partial_cuda,
    "int8_outproj_partial_f32": int8_outproj_partial_f32_cuda,
    "int8_mlp_hidden": int8_mlp_hidden_cuda,
    "int8_mlp_hidden_f32": int8_mlp_hidden_f32_cuda,
    "int8_mlp_partial": int8_mlp_partial_cuda,
    "int8_dequant_residual": int8_dequant_residual_cuda,
    "int8_dequant_residual_f32": int8_dequant_residual_f32_cuda,
}
