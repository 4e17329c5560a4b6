"""Kernel times of two checkouts of the port on one card, taken in turns.

Both checkouts' kernel libraries are built (each under its own ``build/``)
and loaded into one process. For every flagship block kernel whose C entry
point the two share, this checkout's Python wrapper is called on the same
operands (``chip_smoke.py``'s kernel-phase shapes: batch 8 x 1001 tokens,
dim 1024, 8 heads of 64, MLP 2048; the ResNet pool at [8, 90, 45, 45, 64]),
with the library behind it switched between the two in the order other,
this, this, other, ``--rounds`` times; each turn is the median of 10
CUDA-event timings after 2 warm-up launches; K1 and K4 also at dropout
0.1, with K1's row sums and K4's h (the train step's calls), K2 also with
u (the train step's call), and K8 and K9 at dropout 0.1 (the train
step's) and 0 (Grad-CAM's). ``--batch`` sets the batch of the ViT
kernels' operands. Printed per kernel: the median over each checkout's turns,
their ratio, the spread of the other checkout's own turns (the distance
between its quartiles, as a share of its median), the rounds in which
this checkout's two turns took less than the other's two, and the largest
|this - other| of each output of one call on the same operands (0 where
the bits are equal), with the card's name and power limit. K2 is called
through :func:`fused_ln_qkv_call`: an older ``nvt_fused_ln_qkv_fwd`` (one
``wmma`` kernel) takes a null u when serving, this one's u or a scratch.
K4 and K9
are called through each library's own entry point (:func:`fused_mlp_call`,
:func:`fused_mlp_bwd_call`): an older checkout's ``nvt_fused_mlp_fwd``
takes the rows of a block (32 at the flagship) and no scratch, and its
``nvt_fused_mlp_bwd`` its scratch as four tensors; this one's take one
scratch allocation each. K10 likewise (:func:`int8_qkv_call`): an older
``nvt_int8_ln_qkv`` takes no scratch, this one's one allocation; and K11
(:func:`int8_outproj_call`): an older ``nvt_int8_outproj`` (one ``wmma``
kernel) takes no scratch, this one's a8 and the row scales in one
allocation. K7 too
(:func:`fused_ln_qkv_bwd_call`): an older ``nvt_fused_ln_qkv_bwd`` takes
dq, dk and dv apart and its scratch as three tensors, this one's [dq | dk
| dv] and one allocation. K13 goes
through this checkout's wrapper with
either library: an older ``nvt_int8_attention`` (at head dim 64) takes
the same bytes of v8 scratch and s_v at the head of the f32 stats. K8
goes through :func:`fused_outproj_bwd_call`: an older
``nvt_fused_outproj_bwd`` (one ``wmma`` kernel) writes dz at dropout 0
too, this one's reads dy and writes no dz then. K14 and K15 go through
:func:`max_pool3d_call` and :func:`max_pool3d_bwd_call`: an older
``nvt_maxpool3d_fwd`` / ``_bwd`` (a thread a window) takes the shape
alone, this one's also ``pool_plan``'s walk. The f32 forwards K1-K4 and
backwards K5, K7-K9 go through this checkout's wrappers on the same
operands in f32 (K1 also at dropout 0.1 with the row sums, K2 also with
u, K4 also at dropout 0.1 with h; K5, K8 and K9 at dropout 0.1, K5 and K8
also at 0), and so do K6 and its backward at f32 (at dropout 0,
[B, H, N, D]) and the f32 instances of the int8 kernels
K10-K13; but K8 at f32 goes through ``k8_f32_call`` of
``scripts/torch_outproj_device_times.py``: an older
``nvt_fused_outproj_f32_bwd`` (the FFMA design) takes Wout itself, this
one's the weight pre-pass's split transpose; K3 at f32 (also at dropout
0.1) through ``k3_f32_call`` of the same script: an older
``nvt_fused_outproj_f32_fwd`` (the FFMA design) takes Wout itself, this
one's its split by the forwards' pre-pass; and K4 and K2 at f32 through
``k4_f32_call`` of ``scripts/torch_mlp_device_times.py`` and
``k2_f32_call`` of ``scripts/torch_qkv_device_times.py``: an older
``nvt_fused_mlp_f32_fwd`` / ``nvt_fused_ln_qkv_f32_fwd`` (the FFMA
design) takes the weights themselves, this one's their split by the
forwards' pre-pass; and K9 and K7 at f32 through ``k9_f32_call`` of
``scripts/torch_mlp_bwd_device_times.py`` and ``k7_f32_call`` of
``scripts/torch_qkv_bwd_device_times.py`` (K9 also at dropout 0): an
older ``nvt_fused_mlp_f32_bwd`` / ``nvt_fused_ln_qkv_f32_bwd`` (the FFMA
design) takes the weights themselves, this one's their split transposes
by the backwards' pre-pass. A kernel whose entry point the other
checkout lacks is timed in this one alone (the median of 2 x
``--rounds`` turns).

With ``--step``, the flagship's f32 train step at batch 32 is timed too
(``chip_smoke.py``'s (f): its seeded volumes, dropout 0.1, one fixed
batch), with each library behind the kernels in the same turns, each
turn the median of 5 steps after 2 (K3, K8, K4, K2, K9 and K7 at f32
through ``k3_f32_call``, ``k8_f32_call``, ``k4_f32_call``,
``k2_f32_call``, ``k9_f32_call`` and ``k7_f32_call``).

    python scripts/torch_kernel_ab.py --other <checkout> [--rounds 10]
        [--only <substring of a kernel's name>] [--batch 8] [--step]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
from neurovit_tpu_torch import nn  # noqa: E402
from neurovit_tpu_torch.ops import _build  # noqa: E402
from neurovit_tpu_torch.ops import common  # noqa: E402
from neurovit_tpu_torch.ops import flash_attention as fa  # noqa: E402
from neurovit_tpu_torch.ops import (fused_mlp, fused_outproj,  # noqa: E402
                                    fused_qkv, int8_serving, maxpool3d)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mlp_bwd_device_times import k9_f32_call  # noqa: E402
from torch_mlp_device_times import k4_f32_call  # noqa: E402
from torch_outproj_device_times import (k3_f32_call,  # noqa: E402
                                        k8_f32_call)
from torch_qkv_bwd_device_times import k7_f32_call  # noqa: E402
from torch_qkv_device_times import k2_f32_call  # noqa: E402


def other_library(tree: str) -> str:
    """Build the other checkout's kernels in its own tree; their path."""
    out = subprocess.run(
        [sys.executable, "-c", "from neurovit_tpu_torch.ops import _build; "
         "print(_build.build())"], cwd=tree,
        env={**os.environ, "PYTHONPATH": tree}, capture_output=True,
        text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def fused_mlp_call(args: tuple, dropout_rate: float = 0.0, seeds=(0, 0),
                   return_h: bool = False, rows: int = 32):
    """K4 on ``args`` (bf16 x and weights, f32 vectors) through the library
    in use: this checkout's wrapper where the library counts a scratch
    (``nvt_fused_mlp_scratch_bytes``), else the older entry point, which
    takes ``rows`` a block and no scratch."""
    if hasattr(_build.library(), "nvt_fused_mlp_scratch_bytes"):
        return fused_mlp.fused_mlp_block_cuda(
            *args, dropout_rate=dropout_rate, seeds=seeds, return_h=return_h)
    x, gamma, beta, w1, b1, w2, b2 = args
    b, n, dim = x.shape
    hid = w1.shape[0]
    inv_keep, keep_q = common.dropout_args(dropout_rate)
    y = torch.empty_like(x)
    h = x.new_empty(b, n, hid) if return_h else None
    p = common.ptr
    common.launch("nvt_fused_mlp_fwd", (common.VOID,) * 9 + (common.INT,) * 4
                  + (common.FLOAT, common.FLOAT, common.INT, common.U64,
                     common.U64), x, p(x), p(gamma), p(beta), p(w1), p(b1),
                  p(w2), p(b2), p(y), p(h), b * n, dim, hid, rows, nn.LN_EPS,
                  inv_keep, keep_q, int(seeds[0]), int(seeds[1]))
    return (y, h) if return_h else y


def fused_ln_qkv_call(args: tuple, return_u: bool = False):
    """K2 on ``args`` (x, gamma, beta, bf16 w, heads, dim_head) through the
    library in use: this checkout's wrapper where the library counts a
    scratch (``nvt_fused_ln_qkv_fwd_scratch_bytes``), else the older entry
    point, which takes u null when serving and writes no u then."""
    if hasattr(_build.library(), "nvt_fused_ln_qkv_fwd_scratch_bytes"):
        return fused_qkv.fused_ln_qkv_cuda(*args, return_u=return_u)
    x, gamma, beta, w, heads, dim_head = args
    b, n, dim = x.shape
    q, k, v = (x.new_empty(b, n, heads, dim_head) for _ in range(3))
    u = torch.empty_like(x) if return_u else None
    p = common.ptr
    common.launch("nvt_fused_ln_qkv_fwd", (common.VOID,) * 8
                  + (common.INT,) * 3 + (common.FLOAT,), x, p(x), p(gamma),
                  p(beta), p(w), p(q), p(k), p(v), p(u), b * n, dim,
                  heads * dim_head, nn.LN_EPS)
    return (q, k, v, u) if return_u else (q, k, v)


def int8_qkv_call(args: tuple):
    """K10 on ``args`` (x, gamma, beta, w8, scale, heads, dim_head) through
    the library in use: this checkout's wrapper where the library counts a
    scratch (``nvt_int8_qkv_scratch_bytes``), else the older entry point,
    which takes no scratch."""
    if hasattr(_build.library(), "nvt_int8_qkv_scratch_bytes"):
        return int8_serving.int8_ln_qkv_cuda(*args)
    x, gamma, beta, w8, scale, heads, dim_head = args
    b, n, dim = x.shape
    q, k, v = (x.new_empty(b, n, heads, dim_head) for _ in range(3))
    p = common.ptr
    common.launch("nvt_int8_ln_qkv", (common.VOID,) * 8 + (common.INT,) * 3
                  + (common.FLOAT,), x, p(x), p(gamma), p(beta), p(w8),
                  p(scale), p(q), p(k), p(v), b * n, dim, heads * dim_head,
                  nn.LN_EPS)
    return q, k, v


def int8_outproj_call(args: tuple):
    """K11 on ``args`` (x, a, w8, scale, bias) through the library in use:
    this checkout's wrapper where the library counts a scratch
    (``nvt_int8_outproj_scratch_bytes``), else the older entry point, which
    takes no scratch."""
    if hasattr(_build.library(), "nvt_int8_outproj_scratch_bytes"):
        return int8_serving.int8_outproj_residual_cuda(*args)
    x, a, w8, scale, bias = args
    b, n, dim = x.shape
    y = torch.empty_like(x)
    p = common.ptr
    common.launch("nvt_int8_outproj", (common.VOID,) * 6 + (common.INT,) * 3,
                  x, p(a), p(x), p(w8), p(scale), p(bias), p(y), b * n,
                  a.shape[-1], dim)
    return y


def fused_mlp_bwd_call(args: tuple, dropout_rate: float = 0.0,
                       seeds=(0, 0)):
    """K9 on ``args`` (dy, x, h, gamma, beta, w1, w2) through the library
    in use, with the scratch that library counts
    (``nvt_fused_mlp_bwd_scratch_bytes``) in one allocation; a library
    without that count has the older entry point, which takes du [M, dim]
    and the dgamma and dbeta partials [ceil(M / 32), dim] (f32) as separate
    buffers."""
    dy, x, h, gamma, beta, w1, w2 = args
    b, n, dim = x.shape
    hid = w1.shape[0]
    m = b * n
    inv_keep, keep_q = common.dropout_args(dropout_rate)
    dx, u, dz = (torch.empty_like(x) for _ in range(3))
    a, dh = (x.new_empty(m, hid) for _ in range(2))
    f32 = dict(dtype=torch.float32, device=x.device)
    dgb = torch.empty((2, dim), **f32)
    p = common.ptr
    tail = (m, dim, hid, nn.LN_EPS, inv_keep, keep_q, int(seeds[0]),
            int(seeds[1]))
    types = (common.INT,) * 3 + (common.FLOAT, common.FLOAT, common.INT,
                                 common.U64, common.U64)
    lib = _build.library()
    if hasattr(lib, "nvt_fused_mlp_bwd_scratch_bytes"):
        count = lib.nvt_fused_mlp_bwd_scratch_bytes
        count.restype = ctypes.c_longlong
        count.argtypes = [ctypes.c_int] * 3
        scratch = torch.empty(count(m, dim, hid), dtype=torch.uint8,
                              device=x.device)
        bufs = (p(dgb[0]), p(dgb[1]), p(scratch))
    else:
        du = torch.empty((m, dim), **f32)
        parts = torch.empty((2, (m + 31) // 32, dim), **f32)
        bufs = (p(du), p(parts[0]), p(parts[1]), p(dgb[0]), p(dgb[1]))
    common.launch("nvt_fused_mlp_bwd", (common.VOID,) * (12 + len(bufs))
                  + types, x, p(dy), p(x), p(h), p(gamma), p(beta), p(w1),
                  p(w2), p(dx), p(u), p(a), p(dz), p(dh), *bufs, *tail)
    return dx, u, a, dz, dh, dgb[0], dgb[1]


def fused_ln_qkv_bwd_call(dqkv: torch.Tensor, parts: list, x: torch.Tensor,
                          gamma: torch.Tensor, w: torch.Tensor):
    """K7 on dqkv = [dq | dk | dv] (its three [B, N, H, D] ``parts`` made
    beforehand), x, f32 gamma and bf16 w through the library in use: this
    checkout's wrapper where the library counts a scratch
    (``nvt_fused_ln_qkv_bwd_scratch_bytes``), else the older entry point,
    which takes dq, dk and dv apart and du [M, dim] and the dgamma and
    dbeta partials [ceil(M / 32), dim] (f32) as separate buffers."""
    if hasattr(_build.library(), "nvt_fused_ln_qkv_bwd_scratch_bytes"):
        return fused_qkv.fused_ln_qkv_bwd_cuda(dqkv, x, gamma, w)
    b, n, dim = x.shape
    m = b * n
    f32 = dict(dtype=torch.float32, device=x.device)
    du = torch.empty((m, dim), **f32)
    part = torch.empty((2, (m + 31) // 32, dim), **f32)
    dgb = torch.empty((2, dim), **f32)
    dx = torch.empty_like(x)
    p = common.ptr
    common.launch("nvt_fused_ln_qkv_bwd", (common.VOID,) * 12
                  + (common.INT,) * 3 + (common.FLOAT,), x, *map(p, parts),
                  p(x), p(gamma), p(w), p(du), p(part[0]), p(part[1]),
                  p(dx), p(dgb[0]), p(dgb[1]), m, dim, dqkv.shape[-1] // 3,
                  nn.LN_EPS)
    return dx, dgb[0], dgb[1]


def fused_outproj_bwd_call(dy: torch.Tensor, w: torch.Tensor,
                           dropout_rate: float = 0.0, seed: int = 0):
    """K8 on dy and bf16 w through the library in use: this checkout's
    wrapper where the library counts its GEMM's shared memory
    (``nvt_fused_outproj_bwd_smem_bytes``), else the older entry point,
    which writes dz at every rate."""
    if hasattr(_build.library(), "nvt_fused_outproj_bwd_smem_bytes"):
        return fused_outproj.fused_outproj_bwd_cuda(
            dy, w, dropout_rate=dropout_rate, seed=seed)
    b, n, dim = dy.shape
    inner = w.shape[1]
    inv_keep, keep_q = common.dropout_args(dropout_rate)
    dattn, dz = dy.new_empty(b, n, inner), torch.empty_like(dy)
    p = common.ptr
    common.launch("nvt_fused_outproj_bwd", (common.VOID,) * 4
                  + (common.INT,) * 3 + (common.FLOAT, common.INT,
                                          common.U64), dy, p(dy), p(w),
                  p(dattn), p(dz), b * n, inner, dim, inv_keep, keep_q,
                  int(seed))
    return dattn, dz


def _old_pool_launch(name: str, like: torch.Tensor, ptrs, shape) -> None:
    """An older checkout's pool entry point: pointers, the shape and
    is_bf16, no walk."""
    common.launch(name, (common.VOID,) * 3 + (common.INT,) * 6, like,
                  *(common.ptr(t) for t in ptrs), *shape,
                  int(like.dtype == torch.bfloat16))


def max_pool3d_call(x: torch.Tensor):
    """K14 on x through the library in use: this checkout's wrapper where
    the library takes a walk (``nvt_maxpool3d_smem_bytes``), else the
    older entry point."""
    if hasattr(_build.library(), "nvt_maxpool3d_smem_bytes"):
        return maxpool3d.max_pool3d_argmax_cuda(x)
    b, d, h, w, c = x.shape
    shape = (b, *(maxpool3d.out_dim(n) for n in (d, h, w)), c)
    out = x.new_empty(shape)
    codes = torch.empty(shape, dtype=torch.uint8, device=x.device)
    _old_pool_launch("nvt_maxpool3d_fwd", x, (x, out, codes), x.shape)
    return out, codes


def max_pool3d_bwd_call(codes: torch.Tensor, g: torch.Tensor, x_shape):
    """K15 likewise: dx in g's dtype."""
    if hasattr(_build.library(), "nvt_maxpool3d_smem_bytes"):
        return maxpool3d.max_pool3d_argmax_bwd_cuda(codes, g, x_shape,
                                                    g.dtype)
    dx = g.new_empty(tuple(x_shape))
    _old_pool_launch("nvt_maxpool3d_bwd", g, (codes, g, dx), x_shape)
    return dx


def cases(b: int = cs.B) -> dict:
    """name -> (C entry point, call) at the kernel phase's shapes, the ViT
    kernels' operands at batch ``b``."""
    n, dim, h, d, hid = cs.N, cs.DIM, cs.HEADS, cs.DIM_HEAD, cs.MLP
    rng = np.random.default_rng(cs.SEED)

    def t(*shape, scale=1.0, dtype=torch.bfloat16, offset=0.0):
        a = offset + scale * rng.standard_normal(shape)
        return torch.tensor(a, dtype=dtype, device="cuda")

    def w(out_f, in_f):
        a = rng.uniform(-1, 1, (out_f, in_f)) / in_f ** 0.5
        return torch.tensor(a, dtype=torch.float32, device="cuda")

    x, qkv, do = t(b, n, dim), [t(b, n, h, d) for _ in range(3)], t(b, n, h, d)
    ln = (t(dim, scale=0.1, dtype=torch.float32, offset=1.0),
          t(dim, scale=0.1, dtype=torch.float32))
    wqkv, wout = w(3 * h * d, dim), w(dim, h * d)
    w1, w2 = w(hid, dim), w(dim, hid)
    bout, b1 = t(dim, scale=0.03, dtype=torch.float32), t(hid, scale=0.03,
                                                          dtype=torch.float32)
    b2, attn, dy = t(dim, scale=0.02, dtype=torch.float32), t(b, n, h * d), \
        t(b, n, dim, scale=0.1)
    bf = torch.bfloat16
    wqkv16, wout16 = wqkv.to(bf), wout.to(bf)
    dqkv = torch.cat([a.reshape(b, n, -1) for a in qkv], dim=2)
    att = {"scale": d ** -0.5, "n_valid": n, "dropout_rate": cs.DROPOUT,
           "seed": 1234}
    mdrop = {"dropout_rate": cs.DROPOUT, "seeds": (1235, 1236)}
    o, lsum = fa.flash_attention_plain(*qkv, return_stats=True, **att)
    mlp = (x, *ln, w1.to(bf), b1, w2.to(bf), b2)
    _, hh = fused_mlp.fused_mlp_block_plain(*mlp, return_h=True, **mdrop)
    bwd = (dy, x, hh, *ln, w1.to(bf), w2.to(bf))
    tr = [a.transpose(1, 2).contiguous() for a in (*qkv, o, do)]
    q8 = int8_serving
    qkv8, out8 = q8.quantize_weight(wqkv), q8.quantize_weight(wout)
    mlp8 = (*q8.quantize_weight(w1), b1, *q8.quantize_weight(w2), b2)
    pool = t(*cs.POOL_SHAPE)
    _, codes = maxpool3d.max_pool3d_argmax_plain(pool)
    pool_g = t(cs.POOL_SHAPE[0], *(maxpool3d.out_dim(s)
                                  for s in cs.POOL_SHAPE[1:4]),
               cs.POOL_SHAPE[4])
    xf, attnf = x.float(), attn.float()
    qkvf = [a.float() for a in qkv]
    mlpf = (xf, *ln, w1, b1, w2, b2)
    dyf, dqkvf, dof = dy.float(), dqkv.float(), do.float()
    of, lsumf = fa.flash_attention_plain(*qkvf, return_stats=True, **att)
    att0 = dict(att, dropout_rate=0.0)
    of0, lsumf0 = fa.flash_attention_plain(*qkvf, return_stats=True, **att0)
    trf0 = [a.transpose(1, 2).contiguous() for a in (*qkvf, of0, dof)]
    _, hf = fused_mlp.fused_mlp_block_plain(*mlpf, return_h=True, **mdrop)
    bwdf = (dyf, xf, hf, *ln, w1, w2)
    return {
        "flash_attention": ("nvt_flash_attention_fwd", lambda: (
            fa.flash_attention_cuda(*qkv, scale=d ** -0.5, n_valid=n))),
        "flash_attention dropout": ("nvt_flash_attention_fwd", lambda: (
            fa.flash_attention_cuda(*qkv, return_stats=True, **att))),
        "fused_ln_qkv": ("nvt_fused_ln_qkv_fwd", lambda: (
            fused_ln_qkv_call((x, *ln, wqkv16, h, d)))),
        "fused_ln_qkv with u": ("nvt_fused_ln_qkv_fwd", lambda: (
            fused_ln_qkv_call((x, *ln, wqkv16, h, d), return_u=True))),
        "fused_outproj_residual": ("nvt_fused_outproj_fwd", lambda: (
            fused_outproj.fused_outproj_residual_cuda(x, attn, wout.to(bf),
                                                      bout))),
        "fused_mlp_block": ("nvt_fused_mlp_fwd", lambda: (
            fused_mlp_call(mlp))),
        "fused_mlp_block dropout h": ("nvt_fused_mlp_fwd", lambda: (
            fused_mlp_call(mlp, return_h=True, **mdrop))),
        "flash_attention_bwd": ("nvt_flash_attention_bwd", lambda: (
            fa.flash_attention_bwd_cuda(*qkv, o, do, lsum, **att))),
        "flash_attention_bhnd": ("nvt_flash_attention_bhnd_fwd", lambda: (
            fa.flash_attention_bhnd_cuda(*tr[:3], scale=d ** -0.5,
                                         n_valid=n))),
        "flash_attention_bhnd_bwd": ("nvt_flash_attention_bhnd_bwd", lambda: (
            fa.flash_attention_bhnd_bwd_cuda(*tr, lsum, **att))),
        "fused_ln_qkv_bwd": ("nvt_fused_ln_qkv_bwd", lambda: (
            fused_ln_qkv_bwd_call(dqkv, qkv, x, ln[0], wqkv.to(bf)))),
        "fused_outproj_bwd": ("nvt_fused_outproj_bwd", lambda: (
            fused_outproj_bwd_call(dy, wout16, cs.DROPOUT, 1234))),
        "fused_outproj_bwd dropout 0": ("nvt_fused_outproj_bwd", lambda: (
            fused_outproj_bwd_call(dy, wout16))),
        "fused_mlp_bwd": ("nvt_fused_mlp_bwd", lambda: (
            fused_mlp_bwd_call(bwd, **mdrop))),
        "fused_mlp_bwd dropout 0": ("nvt_fused_mlp_bwd", lambda: (
            fused_mlp_bwd_call(bwd))),
        "int8_ln_qkv": ("nvt_int8_ln_qkv", lambda: (
            int8_qkv_call((x, *ln, *qkv8, h, d)))),
        "int8_outproj_residual": ("nvt_int8_outproj", lambda: (
            int8_outproj_call((x, attn, *out8, bout)))),
        "int8_mlp_block": ("nvt_int8_mlp", lambda: (
            q8.int8_mlp_block_cuda(x, *ln, *mlp8))),
        "int8_flash_attention": ("nvt_int8_attention", lambda: (
            q8.int8_flash_attention_cuda(*qkv, scale=d ** -0.5, n_valid=n))),
        "max_pool3d_argmax": ("nvt_maxpool3d_fwd", lambda: (
            max_pool3d_call(pool))),
        "max_pool3d_argmax_bwd": ("nvt_maxpool3d_bwd", lambda: (
            max_pool3d_bwd_call(codes, pool_g, cs.POOL_SHAPE))),
        "flash_attention_f32": ("nvt_flash_attention_f32_fwd", lambda: (
            fa.flash_attention_f32_cuda(*qkvf, scale=d ** -0.5,
                                        n_valid=n))),
        "flash_attention_f32 dropout with stats": (
            "nvt_flash_attention_f32_fwd", lambda: (
                fa.flash_attention_f32_cuda(*qkvf, return_stats=True,
                                            **att))),
        "flash_attention_bhnd_f32": (
            "nvt_flash_attention_bhnd_f32_fwd", lambda: (
                fa.flash_attention_bhnd_f32_cuda(*trf0[:3], scale=d ** -0.5,
                                                 n_valid=n))),
        "fused_ln_qkv_f32": ("nvt_fused_ln_qkv_f32_fwd", lambda: (
            k2_f32_call((xf, *ln, wqkv, h, d)))),
        "fused_ln_qkv_f32 with u": ("nvt_fused_ln_qkv_f32_fwd", lambda: (
            k2_f32_call((xf, *ln, wqkv, h, d), return_u=True))),
        "fused_outproj_residual_f32": ("nvt_fused_outproj_f32_fwd", lambda: (
            k3_f32_call(xf, attnf, wout, bout))),
        "fused_outproj_residual_f32 dropout": (
            "nvt_fused_outproj_f32_fwd", lambda: (
                k3_f32_call(xf, attnf, wout, bout, cs.DROPOUT, 1234))),
        "fused_mlp_block_f32": ("nvt_fused_mlp_f32_fwd", lambda: (
            k4_f32_call(mlpf))),
        "fused_mlp_block_f32 dropout h": ("nvt_fused_mlp_f32_fwd", lambda: (
            k4_f32_call(mlpf, return_h=True, **mdrop))),
        "flash_attention_bwd_f32": ("nvt_flash_attention_f32_bwd", lambda: (
            fa.flash_attention_bwd_f32_cuda(*qkvf, of, dof, lsumf, **att))),
        "flash_attention_bwd_f32 dropout 0": (
            "nvt_flash_attention_f32_bwd", lambda: (
                fa.flash_attention_bwd_f32_cuda(*qkvf, of0, dof, lsumf0,
                                                **att0))),
        "flash_attention_bhnd_bwd_f32": (
            "nvt_flash_attention_bhnd_f32_bwd", lambda: (
                fa.flash_attention_bhnd_bwd_f32_cuda(*trf0, lsumf0,
                                                     **att0))),
        "fused_ln_qkv_bwd_f32": ("nvt_fused_ln_qkv_f32_bwd", lambda: (
            k7_f32_call(dqkvf, xf, ln[0], wqkv))),
        "fused_outproj_bwd_f32": ("nvt_fused_outproj_f32_bwd", lambda: (
            k8_f32_call(dyf, wout, cs.DROPOUT, 1234))),
        "fused_outproj_bwd_f32 dropout 0": (
            "nvt_fused_outproj_f32_bwd", lambda: k8_f32_call(dyf, wout)),
        "fused_mlp_bwd_f32": ("nvt_fused_mlp_f32_bwd", lambda: (
            k9_f32_call(bwdf, **mdrop))),
        "fused_mlp_bwd_f32 dropout 0": ("nvt_fused_mlp_f32_bwd", lambda: (
            k9_f32_call(bwdf))),
        "int8_ln_qkv_f32": ("nvt_int8_ln_qkv_f32", lambda: (
            q8.int8_ln_qkv_f32_cuda(xf, *ln, *qkv8, h, d))),
        "int8_outproj_residual_f32": ("nvt_int8_outproj_f32", lambda: (
            q8.int8_outproj_residual_f32_cuda(xf, attnf, *out8, bout))),
        "int8_mlp_block_f32": ("nvt_int8_mlp_f32", lambda: (
            q8.int8_mlp_block_f32_cuda(xf, *ln, *mlp8))),
        "int8_flash_attention_f32": ("nvt_int8_attention_f32", lambda: (
            q8.int8_flash_attention_f32_cuda(*qkvf, scale=d ** -0.5,
                                             n_valid=n))),
    }


def use(lib: ctypes.CDLL) -> None:
    """Route the wrappers' launches to ``lib``."""
    _build._function.cache_clear()
    _build.library = lambda: lib


def tensors(out) -> list:
    """The tensors of a call's result, in order (None entries dropped)."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for t in out if t is not None]


def output_diffs(libs: dict, call) -> list:
    """The largest |this - other| of each output of one call on the same
    operands, 0.0 where the two are bit-equal."""
    outs = {}
    for side in ("other", "this"):
        use(libs[side])
        outs[side] = tensors(call())
    torch.cuda.synchronize()
    return [0.0 if torch.equal(a, b) else
            float((a.float() - b.float()).abs().max())
            for a, b in zip(outs["this"], outs["other"])]


def f32_step_turns(libs: dict, rounds: int) -> None:
    """Print the flagship's f32 train step at batch 32 with each library
    in turns (other, this, this, other), ``rounds`` times; K3, K8, K4, K2,
    K9 and K7 at f32 go through :func:`k3_f32_call`, :func:`k8_f32_call`,
    :func:`k4_f32_call`, :func:`k2_f32_call`, :func:`k9_f32_call` and
    :func:`k7_f32_call`, this checkout's wrappers where the library has
    their weight pre-pass."""
    import tempfile

    from neurovit_tpu_torch.config import load_config
    from neurovit_tpu_torch.models import NeuroEncoder
    from neurovit_tpu_torch.training import Trainer

    wrapper = fused_outproj.fused_outproj_bwd_f32_cuda

    def routed(dy, w, dropout_rate=0.0, seed=0):
        if hasattr(_build.library(), "nvt_wsplit_f32"):
            return wrapper(dy, w, dropout_rate=dropout_rate, seed=seed)
        return k8_f32_call(dy, w, dropout_rate, seed)

    outproj_wrapper = fused_outproj.fused_outproj_residual_f32_cuda

    def outproj(x, a, w, b, dropout_rate=0.0, seed=0):
        if not hasattr(_build.library(), "nvt_ffma_gemm_smem_bytes"):
            return outproj_wrapper(x, a, w, b, dropout_rate=dropout_rate,
                                   seed=seed)
        return k3_f32_call(x, a, w, b, dropout_rate, seed)

    mlp_wrapper = fused_mlp.fused_mlp_block_f32_cuda
    qkv_wrapper = fused_qkv.fused_ln_qkv_f32_cuda

    def mlp(*args, **kw):
        if hasattr(_build.library(), "nvt_split_f32"):
            return mlp_wrapper(*args, **kw)
        return k4_f32_call(args, **kw)

    def qkv(*args, **kw):
        if hasattr(_build.library(), "nvt_split_f32"):
            return qkv_wrapper(*args, **kw)
        return k2_f32_call(args, **kw)

    mlp_bwd_wrapper = fused_mlp.fused_mlp_bwd_f32_cuda
    qkv_bwd_wrapper = fused_qkv.fused_ln_qkv_bwd_f32_cuda

    def mlp_bwd(*args, **kw):
        if hasattr(_build.library(), "nvt_fused_mlp_f32_bwd_smem_bytes"):
            return mlp_bwd_wrapper(*args, **kw)
        return k9_f32_call(args, **kw)

    def qkv_bwd(*args):
        if hasattr(_build.library(), "nvt_fused_ln_qkv_f32_bwd_smem_bytes"):
            return qkv_bwd_wrapper(*args)
        return k7_f32_call(*args)

    wrappers = ((fused_outproj, "fused_outproj_bwd_f32_cuda", routed),
                (fused_outproj, "fused_outproj_residual_f32_cuda", outproj),
                (fused_mlp, "fused_mlp_block_f32_cuda", mlp),
                (fused_qkv, "fused_ln_qkv_f32_cuda", qkv),
                (fused_mlp, "fused_mlp_bwd_f32_cuda", mlp_bwd),
                (fused_qkv, "fused_ln_qkv_bwd_f32_cuda", qkv_bwd))
    saved = [getattr(module, name) for module, name, _ in wrappers]
    for module, name, fn in wrappers:
        fn.launches = 0          # a wrapper counts on its module's name
        setattr(module, name, fn)
    try:
        with tempfile.TemporaryDirectory() as workdir:
            cfg = cs._train_config(load_config(), workdir,
                                   TRAINING_PRECISION="f32",
                                   TRAINING_NUM_WORKERS=0)
            size = cfg["TRAINING_VIT_INPUT_SIZE"]
            model = NeuroEncoder(cfg, device="cuda", seed=cs.SEED)
            trainer = Trainer(
                cfg, model, cs._SeededVolumes(64, size, cs.SEED + 6, "train"),
                cs._SeededVolumes(32, size, cs.SEED + 7, "val"))
            batch, zyx, _ = next(trainer._device_prefetch(
                trainer.val_dataloader))
            turns = {"other": [], "this": []}
            for _ in range(rounds):
                for side in ("other", "this", "this", "other"):
                    use(libs[side])
                    turns[side].append(cs._timed_steps(
                        trainer, batch, zyx, warmup=2)[0])
    finally:
        for (module, name, _), fn in zip(wrappers, saved):
            setattr(module, name, fn)
    a, b = (float(np.median(turns[s])) for s in ("other", "this"))
    print(f"f32 train step, batch {batch['volume'].shape[0]}: other "
          f"{a:.3f} ms, this {b:.3f} ms, ratio {b / a:.4f}; turns other "
          f"{[round(t, 3) for t in turns['other']]}, this "
          f"{[round(t, 3) for t in turns['this']]}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout (e.g. the parent)")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--only", default="",
                    help="time only the kernels whose name contains this")
    ap.add_argument("--batch", type=int, default=cs.B,
                    help="batch of the ViT kernels' operands (x 1001 tokens)")
    ap.add_argument("--step", action="store_true",
                    help="also time the flagship's f32 train step at batch "
                    "32 in turns")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {"other": ctypes.CDLL(other_library(os.path.abspath(args.other))),
            "this": ctypes.CDLL(str(_build.build()))}
    print(f"card: {cs.card_line()}; batch {args.batch}; {args.rounds} "
          f"rounds of other, this, this, other; each turn the median of 10 "
          f"launches")
    print(f"{'kernel':26s} {'other ms':>9s} {'this ms':>9s} {'ratio':>6s} "
          f"{'other IQR':>9s} {'faster':>7s}  max |this - other| per "
          f"output")
    for name, (symbol, call) in cases(args.batch).items():
        if args.only not in name:
            continue
        if not hasattr(libs["other"], symbol):
            use(libs["this"])
            this = [cs.cuda_ms(call, warmup=2, runs=10)
                    for _ in range(2 * args.rounds)]
            print(f"{name:26s} {'-':>9s} {float(np.median(this)):9.4f}  "
                  f"(no {symbol} in the other checkout: this one's alone)",
                  flush=True)
            continue
        turns = {"other": [], "this": []}
        for _ in range(args.rounds):
            for side in ("other", "this", "this", "other"):
                use(libs[side])
                turns[side].append(cs.cuda_ms(call, warmup=2, runs=10))
        a, b = (float(np.median(turns[s])) for s in ("other", "this"))
        q1, q3 = np.percentile(turns["other"], [25, 75])
        # Rounds in which this checkout's two turns took less in all than
        # the other's two.
        faster = sum(sum(turns["this"][2 * r:2 * r + 2])
                     < sum(turns["other"][2 * r:2 * r + 2])
                     for r in range(args.rounds))
        diffs = ", ".join(f"{d:.3e}" for d in output_diffs(libs, call))
        print(f"{name:26s} {a:9.4f} {b:9.4f} {b / a:6.3f} "
              f"{(q3 - q1) / a:9.3f} {faster:3d}/{args.rounds:<3d}  "
              f"[{diffs}]", flush=True)
    if args.step:
        f32_step_turns(libs, args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
