"""The port's dropout mask: Philox4x32-10 bytes by position, q/256 keep.

The TPU draws its masks from a per-program PRNG stream that no GPU
reproduces, so against JAX the masks agree only in distribution. Inside the
port the mask is a pure function of the element's index, which these tests
pin: the Random123 known-answer vectors, independence from how the index
range is cut, the keep fraction, unbiasedness, and distinct site keys.
"""

import numpy as np
import pytest
import torch

from neurovit_tpu_torch import nn

torch.set_num_threads(1)

# Random123's known-answer vectors for philox4x32-10.
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", KAT)
def test_philox_known_answers(counter, key, want):
    words = nn.philox4x32_words(
        tuple(torch.tensor([c], dtype=torch.int64) for c in counter), *key)
    assert [int(w) for w in words[0]] == list(want)


def test_philox_of_a_64_bit_counter_uses_words_lo_hi_0_0():
    ctr, key = (5 << 32) | 7, (11 << 32) | 13
    got = nn.philox4x32(torch.tensor([ctr]), key)
    want = nn.philox4x32_words(
        tuple(torch.tensor([c]) for c in (7, 5, 0, 0)), 13, 11)
    assert torch.equal(got, want)


def test_mask_is_a_function_of_position_only():
    """The same elements get the same bytes however the range is cut, as a
    forward and a backward kernel tiled differently read them."""
    seed = 0x1234_5678_9ABC
    whole = nn.random_bytes(seed, 0, 1000)
    for start, count in [(0, 16), (3, 29), (17, 500), (999, 1)]:
        assert torch.equal(nn.random_bytes(seed, start, count),
                           whole[start:start + count])
    # Byte i is byte i % 16 of Philox(i // 16), little-endian in the words.
    words = nn.philox4x32(torch.tensor([62]), seed)[0]
    byte = (int(words[(995 % 16) // 4]) >> (8 * (995 % 4))) & 0xFF
    assert int(whole[995]) == byte
    mask = nn.keep_mask(seed, (10, 100), 0.1)
    assert torch.equal(mask.reshape(-1), whole < 230)


def test_keep_fraction_within_4_sigma():
    q, keep = nn.keep_threshold(0.1)
    assert (q, keep) == (230, 230 / 256)
    n = 1 << 20
    frac = float(nn.keep_mask(7, (n,), 0.1).float().mean())
    sigma = (keep * (1 - keep) / n) ** 0.5
    assert abs(frac - keep) < 4 * sigma


def test_dropout_is_unbiased_and_keeps_the_dtype():
    x = torch.full((256, 1024), 3.0)
    y = nn.dropout(x, 0.1, seed=99)
    kept = y != 0
    assert torch.allclose(y[kept], torch.tensor(3.0 * 256 / 230))
    mean = float(y.mean())
    sigma = 3.0 * ((1 - 230 / 256) / (230 / 256) / x.numel()) ** 0.5
    assert abs(mean - 3.0) < 4 * sigma
    assert nn.dropout(x.bfloat16(), 0.1, 99).dtype == torch.bfloat16
    assert nn.dropout(x, 0.0, 99) is x


def test_site_seeds_are_distinct():
    seeds = {nn.site_seed(step, site) for step in range(64)
             for site in range(1 + 4 * 6)}
    assert len(seeds) == 64 * 25
    assert all(0 <= s < 2 ** 64 for s in seeds)
    a = nn.keep_mask(nn.site_seed(1, 1), (4096,), 0.1)
    b = nn.keep_mask(nn.site_seed(1, 2), (4096,), 0.1)
    assert not torch.equal(a, b)


def test_degenerate_rates_are_refused():
    with pytest.raises(ValueError, match="quantizes"):
        nn.keep_threshold(0.001)
    assert nn.keep_threshold(0.0) == (256, 1.0)


def test_masked_mean_ce_counts_only_valid_rows():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32))
    labels = torch.tensor([0, 1, 2, 1, 0])
    valid = torch.tensor([True, True, True, False, False])
    loss, correct, count = nn.masked_mean_ce(logits, labels, valid)
    assert int(count) == 3
    assert torch.allclose(loss, nn.softmax_cross_entropy(logits[:3],
                                                          labels[:3]))
    assert int(correct) == int((logits[:3].argmax(-1) == labels[:3]).sum())
