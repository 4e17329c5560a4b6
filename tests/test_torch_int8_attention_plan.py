"""K13's launch plan (``ops/int8_serving.py`` ``int8_attn_plan``) as a pure
function, and a model in plain torch index arithmetic of how the kernel
(``csrc/int8_attention.cu``) meets P8 and v8 in its s8 ``wgmma``.

The model: thread t of a consumer warpgroup holds the S accumulator's
d[4 j + i] at row 16 (t / 32) + (t % 32) / 4 + 8 (i / 2), key 8 j + 2 (t %
4) + i % 2 (wgmma's m64n64 layout); it quantizes each value to a code in
place and packs a 32-key chunk's 16 codes into the four registers of the
s8 A operand by ``P8_PACK``; the A fragment of m64nNk32 gives register r,
byte i of thread t the row 16 (t / 32) + (t % 32) / 4 + 8 (r % 2) and k 4
(t % 4) + i + 16 (r / 2). The prologue's v8 is V's codes transposed, [D,
n_pad], a key's code at the stored position ``v8_key_order`` gives. The
model builds every 64-row block's A fragments from the plain version's p8
and multiplies them with that v8 as the tensor cores would (int64 sums),
and the result must equal p8 . v8 bit for bit.

The plan: the flagship at batch 1, 8 and 32 and every ``WIDTHS`` head dim:
the instance (64 or 128), the block height (64 rows at head dim 64; at
128, 128 rows where they fill the card's 132 SMs), the three launches, shared
memory within the H100's 227 KiB on 1024-byte boundaries, and the scratch.
The card tests hold the plan's bytes and block rows to the kernel's own.
"""

import numpy as np
import pytest
import torch

from neurovit_tpu_torch.models.vit3d import WIDTHS
from neurovit_tpu_torch.ops import int8_serving as q8
from neurovit_tpu_torch.ops.common import SMEM_LIMIT

N = 1001


def _operands(n_valid: int, d: int):
    """Seeded bf16 q, k, v [1, N, 2, d]: two heads, the flagship's tokens."""
    rng = np.random.default_rng(1000 * d + n_valid)
    return [torch.tensor(rng.standard_normal((1, N, 2, d)),
                         dtype=torch.bfloat16) for _ in range(3)]


def _fragment_maps():
    """(row, k) of the A fragment and (row, key in the chunk) of the
    accumulator value packed there, for thread t, register r, byte i: each
    [128, 4, 4]."""
    t, r, i = torch.meshgrid(torch.arange(128), torch.arange(4),
                             torch.arange(4), indexing="ij")
    base = 16 * (t // 32) + (t % 32) // 4
    a_row = base + 8 * (r % 2)
    a_k = 4 * (t % 4) + i + 16 * (r // 2)
    n = torch.tensor(q8.P8_PACK)[r, i]          # the chunk's acc index
    acc_row = base + 8 * ((n % 4) // 2)
    acc_key = 8 * (n // 4) + 2 * (t % 4) + n % 2
    return a_row, a_k, acc_row, acc_key


def test_fragment_maps_agree():
    """Packing by P8_PACK puts each accumulator value into a register of
    its own row, and the A fragments of a chunk cover the 64 x 32 tile
    once."""
    a_row, a_k, acc_row, acc_key = _fragment_maps()
    assert torch.equal(a_row, acc_row)
    cells = (a_row * 32 + a_k).flatten()
    assert torch.equal(cells.sort().values, torch.arange(64 * 32))
    keys = (acc_row * 32 + acc_key).flatten()
    assert torch.equal(keys.sort().values, torch.arange(64 * 32))


@pytest.mark.parametrize("n_pad", [64, 1024])
def test_v8_key_order_permutes_each_32_keys(n_pad):
    order = q8.v8_key_order(n_pad)
    assert torch.equal(order.view(-1, 32).sort().values,
                       torch.arange(n_pad).view(-1, 32))
    # A thread's keys of a chunk, in its registers' byte order, are the
    # stored positions 4 (t % 4) .. + 3 and 16 + 4 (t % 4) .. + 3.
    _, a_k, _, acc_key = _fragment_maps()
    assert torch.equal(order[a_k], acc_key)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n_valid", [1, 31, 64, 97, 900, 1001])
def test_p8_from_registers_times_permuted_v8_is_p8_v8(n_valid, d):
    q, k, v = _operands(n_valid, d)
    p8, v8, *_ = q8.attn_codes(q, k, v, d ** -0.5, n_valid)
    p8, v8 = p8.long(), v8.long()                 # [1, H, N, N], [1, H, N, D]
    plan = q8.int8_attn_plan(1, N, 2, d)
    n_pad, tiles = plan.n_pad, plan.n_pad // 64
    # The prologue's v8 [H, D, n_pad]: codes of keys below n_valid, moved
    # to their stored positions; the rest 0.
    order = q8.v8_key_order(n_pad)
    vk = torch.zeros(2, n_pad, d, dtype=torch.long)
    vk[:, :n_valid] = v8[0, :, :n_valid]
    v8t = vk[:, order].transpose(1, 2)
    # P8 in the 64-row blocks, keys padded to the tiles; keys past n_valid
    # have p8 = 0 already.
    rows = -(-N // 64) * 64
    pp = torch.zeros(2, rows, n_pad, dtype=torch.float64)
    pp[:, :N, :N] = p8[0].double()
    a_row, a_k, acc_row, acc_key = (m.flatten() for m in _fragment_maps())
    n_chunks = -(-n_valid // 64) * 2             # the tiles n_valid reaches
    assert n_chunks <= 2 * tiles
    # Every 64-row block's A fragment of every 32-key chunk [2, R, G, 64,
    # 32], filled from the accumulator positions its registers pack, times
    # that chunk of v8 [2, G, D, 32]: f64 sums of integers below 2^53,
    # exact.
    blocks = torch.arange(0, rows, 64)
    chunks = torch.arange(n_chunks)
    vals = pp[:, blocks[:, None, None] + acc_row,
              32 * chunks[None, :, None] + acc_key]
    a = torch.zeros(2, len(blocks), n_chunks, 64, 32, dtype=torch.float64)
    a[..., a_row, a_k] = vals
    v8c = v8t[:, :, :32 * n_chunks].double().reshape(2, d, n_chunks, 32)
    out = torch.einsum("hrgik,hdgk->hrid", a, v8c).reshape(2, rows, d)
    want = p8[0] @ v8[0]
    assert torch.equal(out[:, :N].long(), want)


@pytest.mark.parametrize("b", [1, 8, 32])
def test_plan_at_the_flagship(b):
    """One consumer warpgroup a block at head dim 64, at every batch."""
    bq = 64
    plan = q8.int8_attn_plan(b, N, 8, 64)
    assert (plan.d_kernel, plan.bq, plan.n_pad) == (64, bq, 1024)
    names = [name for name, *_ in plan.launches]
    assert names == ["v_amax", "v_quant", "attention"]
    (_, g1, t1, s1), (_, g2, t2, s2), (_, g3, t3, s3) = plan.launches
    assert g1 == g2 == (b * 8, 16) and t1 == t2 == 256 and s1 == s2 == 0
    assert g3 == (-(-N // bq) * b * 8,) and t3 == 128 * (bq // 64) + 32
    # The Q tile, four stages of a K tile (8 KiB) and a v8 tile (4 KiB),
    # nine barriers, 1 KiB of alignment slack.
    assert s3 == 1024 + bq * 128 + 4 * (8192 + 4096) + 9 * 8
    assert plan.offsets == (0, bq * 128, bq * 128 + 4 * 8192,
                            bq * 128 + 4 * 12288)
    assert plan.v8_bytes == b * 8 * 64 * 1024
    assert plan.stats_bytes == b * 8 * 64 * 17 * 4


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("b", [1, 8])
def test_plan_at_every_width(width, b):
    _, heads, dh, _ = WIDTHS[width]
    plan = q8.int8_attn_plan(b, N, heads, dh)
    assert plan.d_kernel == (64 if dh <= 64 else 128)
    fills = b * heads * -(-N // 128) >= 132
    assert plan.bq == (128 if fills and dh > 64 else 64)
    smem = plan.launches[2][3]
    assert smem <= SMEM_LIMIT
    assert all(off % 1024 == 0 for off in plan.offsets[:3])
    assert plan.offsets[3] % 8 == 0
    assert plan.v8_bytes == b * heads * plan.d_kernel * plan.n_pad


def test_plan_refuses():
    with pytest.raises(ValueError, match="head dim <= 128"):
        q8.int8_attn_plan(1, N, 8, 160)
    with pytest.raises(ValueError, match="plain"):
        q8.int8_attn_plan(1, N, 8, 4)
    # B * H past 65535 plans, on the one-dimensional grid.
    plan = q8.int8_attn_plan(8193, 16, 8, 16)
    assert plan.launches[2][1] == (8193 * 8,)


def test_plan_at_head_dim_128():
    """Head dim 128 takes K1's block heights: 128 rows where they fill the
    card (batch 8 x 8 heads x 8 tiles of 128), else 64."""
    big, small = (q8.int8_attn_plan(b, N, 8, 128) for b in (8, 1))
    assert (big.bq, small.bq) == (128, 64)
    assert big.launches[2][1:] == ((8 * 64,), 288, 1024 + 128 * 256
                                   + 4 * (16384 + 8192) + 9 * 8)
    assert small.launches[2][1:] == ((16 * 8,), 160, 1024 + 64 * 256
                                     + 4 * (16384 + 8192) + 9 * 8)
