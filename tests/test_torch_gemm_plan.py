"""K17/K18's launch plan (``ops/int8_gemm.py`` ``gemm_plan``) as a pure
function, at the seven shapes of ``scripts/torch_int8_gemm_bench.py`` and
the card test's shapes (``tests/test_torch_cuda.py`` ``GEMM_CASES``): the
tile is 128 x 128, or 64 x 64 where N <= 64; the grid covers M x N with no
spare row or column of tiles; a block's shared memory fits the H100's 227
KiB; the transposed-B scratch is [N, K]. The card test holds the plan's
bytes against the kernel's own count.
"""

import importlib.util
import os

import pytest
import torch

from neurovit_tpu_torch.ops import int8_gemm as g
from neurovit_tpu_torch.ops.common import SMEM_LIMIT


def _bench_shapes():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "torch_int8_gemm_bench.py")
    spec = importlib.util.spec_from_file_location("torch_int8_gemm_bench",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return [(m, k, n) for _, m, k, n in module.SHAPES]


CARD_CASES = [(128, 128, 128), (128, 256, 128), (512, 256, 256),
              (256, 1024, 64), (144, 80, 48), (128, 64, 1024),
              (144, 80, 320), (256, 4096, 192), (16, 16, 16)]
SHAPES = _bench_shapes() + CARD_CASES


@pytest.mark.parametrize("dtype", g.DTYPES)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_gemm_plan(m, k, n, dtype):
    plan = g.gemm_plan(m, n, k, dtype)
    assert (plan.bm, plan.bn) == ((64, 64) if n <= 64 else (128, 128))
    nt, mt = plan.grid
    assert (nt - 1) * plan.bn < n <= nt * plan.bn
    assert (mt - 1) * plan.bm < m <= mt * plan.bm
    assert plan.smem <= SMEM_LIMIT
    assert plan.scratch == (n, k)


def test_gemm_plan_covers_the_bench_shapes():
    assert len(_bench_shapes()) == 7
    assert g.gemm_plan(8192, 2048, 1024, torch.bfloat16).grid == (16, 64)
    assert g.gemm_plan(8192, 64, 1024, torch.int8).grid == (1, 128)


@pytest.mark.parametrize("m,k,n", [(8, 64, 64), (128, 72, 128),
                                   (128, 64, 40)])
def test_gemm_plan_refuses_widths_off_16(m, k, n):
    with pytest.raises(ValueError, match="multiple of 16"):
        g.gemm_plan(m, n, k, torch.int8)


def test_gemm_plan_refuses_other_dtypes():
    with pytest.raises(TypeError):
        g.gemm_plan(128, 128, 128, torch.float32)
