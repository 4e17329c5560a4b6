"""Functional primitives, with the JAX package's rounding points.

Counterpart of ``neurovit_tpu/nn.py``. Parameters live in ``torch.nn``
modules (``nn.LayerNorm``, ``nn.Linear``) as f32 master weights; these
functions compute with them in the activation dtype the way the JAX package
does, which is not what ``F.layer_norm`` and ``F.linear`` do in bf16:

- ``layer_norm``: statistics and affine in f32, one rounding at the end;
- ``linear``: an f32 sum of the (dtype-rounded) products plus an f32 bias,
  rounded once;
- ``gelu``: exact erf GELU;
- ``full_f32``: f32 products at full f32 (no TF32) inside a block, as JAX
  runs its f32 products at "highest" (``nn.py:28-32``);
- ``dropout``: inverted dropout with the keep probability quantized to
  q/256 (``nn.py:88-114``), its mask drawn from :func:`random_bytes`;
- ``softmax_cross_entropy`` and the trainer's masked mean CE.

**The dropout mask.** The TPU kernels draw masks from a per-program
sequential PRNG stream that no GPU reproduces. Here the mask of every
dropout site (the embedding, and inside the kernels the attention
probabilities, the out-projection and the two MLP sites) is a pure function
of the element's row-major index ``i`` in the site's logical tensor:
byte ``i % 16`` of Philox4x32-10(counter = i // 16, key = the site's 64-bit
seed), and the element is kept where that byte is below q. A CUDA kernel
(``csrc/common.cuh``, ``philox4x32_10``), its backward kernel whatever its
tiling, and the plain versions here regenerate bit-identical masks.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

LN_EPS = 1e-5  # torch nn.LayerNorm default
INV_SQRT2 = 0.7071067811865476
INV_SQRT2PI = 0.3989422804014327

# Philox4x32-10 constants (Salmon et al., SC'11; Random123).
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last dim, computed in f32, returned in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ W^T (+ b) for a torch-layout weight [out, in]. The weight is
    rounded to x's dtype, the products summed in f32 (exact for bf16
    operands), the bias added in f32, and the result rounded once."""
    y = torch.matmul(x.float(), weight.to(x.dtype).float().t())
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


@contextlib.contextmanager
def full_f32(dtype: torch.dtype):
    """Inside the block, with ``dtype`` f32: torch's f32 matmuls at
    "highest" precision (TF32 off) whatever the caller set through
    ``torch.set_float32_matmul_precision`` (or ``allow_tf32``), and the
    caller's setting again after. JAX runs its f32 products at "highest"
    (neurovit_tpu/nn.py:28-32). Other dtypes leave the setting alone."""
    if dtype != torch.float32:
        yield
        return
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch nn.GELU's default."""
    return F.gelu(x, approximate="none")


def gelu_grad(h: torch.Tensor) -> torch.Tensor:
    """d/dh GELU(h) = Phi(h) + h * phi(h), on f32 (fused_mlp.py:82-85)."""
    return (0.5 * (1.0 + torch.erf(h * INV_SQRT2))
            + h * torch.exp(-0.5 * h * h) * INV_SQRT2PI)


# ---------------------------------------------------------------------------
# Dropout: Philox4x32-10 bytes, q/256 keep
# ---------------------------------------------------------------------------

def _mulhilo32(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of a * m for uint32 values held in int64.
    Both operands are split into 16-bit halves, so no partial product or
    partial sum comes near 2^63."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    ll, lh, hl, hh = a_lo * m_lo, a_lo * m_hi, a_hi * m_lo, a_hi * m_hi
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = (ll & 0xFFFF) | ((mid & 0xFFFF) << 16)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def philox4x32(counter: torch.Tensor, key: int) -> torch.Tensor:
    """Philox4x32-10 of counters (int64 tensor [n], as the words
    (lo, hi, 0, 0)) under a 64-bit key; returns the four output words
    [n, 4] as int64 in [0, 2^32)."""
    zero = torch.zeros_like(counter)
    return philox4x32_words((counter & _MASK32, (counter >> 32) & _MASK32,
                             zero, zero), key & _MASK32, (key >> 32) & _MASK32)


def philox4x32_words(c, k0: int, k1: int) -> torch.Tensor:
    """Philox4x32-10 of the counter words ``c`` = (c0, c1, c2, c3), int64
    tensors of uint32 values, under the key words (k0, k1)."""
    c0, c1, c2, c3 = c
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W0) & _MASK32, (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo32(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo32(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def random_bytes(seed: int, start: int, count: int,
                 device=None) -> torch.Tensor:
    """The dropout bytes of elements ``start .. start + count - 1`` of a
    site with key ``seed``: byte ``i % 16`` of Philox(i // 16, seed),
    uint8 [count]."""
    first, last = start // 16, (start + count + 15) // 16
    counters = torch.arange(first, last, dtype=torch.int64, device=device)
    words = philox4x32(counters, int(seed) & _MASK64)
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=device)
    b = ((words[..., None] >> shifts) & 0xFF).to(torch.uint8).reshape(-1)
    off = start - first * 16
    return b[off:off + count]


def keep_threshold(rate: float) -> Tuple[int, float]:
    """(q, keep) of a dropout rate: an element is kept where its random
    byte is below q, and kept values are scaled by 1 / keep with
    keep = q / 256 (flash_attention.py:62-84). Rate 0 gives (256, 1.0).
    Rates that quantize to q of 0 or 256 (rate < 1/512 or > 1 - 1/512),
    where the JAX package switches to 32-bit draws, are refused."""
    if rate == 0.0:
        return 256, 1.0
    q = int(round((1.0 - rate) * 256.0))
    if not 0 < q < 256:
        raise ValueError(f"dropout rate {rate} quantizes to keep {q}/256; "
                         "the port supports 1/512 <= rate <= 1 - 1/512")
    return q, q / 256.0


def keep_mask(seed: int, shape, rate: float, device=None) -> torch.Tensor:
    """Bool mask over a tensor of ``shape``: element i (row-major) is kept
    where byte i of the site's stream is below q."""
    q, _ = keep_threshold(rate)
    numel = 1
    for s in shape:
        numel *= int(s)
    return (random_bytes(seed, 0, numel, device) < q).reshape(tuple(shape))


def mask_scale(seed: int, shape, rate: float, device=None) -> torch.Tensor:
    """mask * (1 / keep) as f32: the factor the JAX kernels multiply a
    dropped activation, or its gradient, by (fused_mlp.py:127,171)."""
    _, keep = keep_threshold(rate)
    return keep_mask(seed, shape, rate, device).float() * (1.0 / keep)


def site_seed(step_seed: int, site: int) -> int:
    """The 64-bit key of dropout site ``site`` in a step seeded
    ``step_seed``: splitmix64 of the pair, so nearby sites and steps get
    unrelated keys."""
    z = (int(step_seed) * 0x9E3779B97F4A7C15 + (site + 1) * 0xBF58476D1CE4E5B9)
    z &= _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Inverted dropout with the q/256 keep (nn.py:88-114): kept values are
    ``x * (1 / keep)`` in x's dtype, dropped ones 0. Differentiable through
    autograd (the embedding dropout runs outside any kernel in JAX too)."""
    if rate == 0.0:
        return x
    _, keep = keep_threshold(rate)
    mask = keep_mask(seed, x.shape, rate, x.device)
    return torch.where(mask, x * (1.0 / keep),
                       torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean CE with integer labels, in f32 (nn.py:117-122)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return (logz - gold).mean()


def masked_ce_sums(logits: torch.Tensor, labels: torch.Tensor,
                   valid: torch.Tensor):
    """(the sum of the valid rows' CE, correct, count) of a padded batch:
    the parts a data-parallel step sums over the ranks before it divides."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    per_sample = logz - gold
    total = (per_sample * valid.float()).sum()
    correct = ((logits.argmax(dim=-1) == labels.long()) & valid.bool()).sum()
    return total, correct, valid.long().sum()


def masked_mean_ce(logits: torch.Tensor, labels: torch.Tensor,
                   valid: torch.Tensor):
    """(loss, correct, count) over the valid rows of a padded batch
    (trainer.py:52-62): the loss is the mean CE of the valid rows."""
    total, correct, count = masked_ce_sums(logits, labels, valid)
    return total / torch.clamp(valid.float().sum(), min=1.0), correct, count
