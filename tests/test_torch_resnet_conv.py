"""The ResNet's CPU plain path gives the same finite gradients on every
call of the same inputs, in bf16 and f32.

oneDNN's bf16 convolution backward on a CPU with AMX-BF16 gave other bits
from call to call (199 of 200 calls of the 64 -> 64 channel 3^3
convolution on [4, 64, 2, 3, 3]) and now and then a NaN in dw, which made
the card test of the ResNet's gradients fail on its CPU side
(``scripts/torch_resnet_nan_repro.py``). ``models/resnet3d.py`` ``_Conv3d``
now runs a CPU bf16 backward in f32 on the bf16 values. These tests call
that convolution, every convolution shape of the card test's model, and
the whole model, again and again, at the card test's seeds and shapes
(depth 10, widen 0.25, volume [4, 1, 16, 40, 40]).
"""

import numpy as np
import pytest
import torch

from neurovit_tpu_torch.models import resnet3d

# (x shape, out channels, kernel, stride): the card test model's
# convolutions that differ in shape, the one that failed first.
CONVS = [((4, 64, 2, 3, 3), 64, 3, 1), ((4, 1, 16, 40, 40), 16, 7, (1, 2, 2)),
         ((4, 16, 8, 10, 10), 16, 3, 1), ((4, 16, 8, 10, 10), 32, 3, 2),
         ((4, 32, 4, 5, 5), 64, 3, 2), ((4, 64, 2, 3, 3), 128, 1, 2),
         ((4, 128, 1, 2, 2), 128, 3, 1)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,out_ch,k,stride", CONVS)
def test_cpu_conv_backward_repeats_bit_for_bit(shape, out_ch, k, stride,
                                               dtype):
    rng = np.random.default_rng(out_ch * k)
    x = torch.tensor(rng.standard_normal(shape), dtype=dtype)
    w = torch.tensor(rng.standard_normal((out_ch, shape[1], k, k, k))
                     * (shape[1] * k ** 3) ** -0.5, dtype=dtype)
    grads = []
    for _ in range(20):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = resnet3d.conv3d(xr, wr, stride=stride, padding=k // 2)
        g = torch.tensor(np.random.default_rng(1).standard_normal(y.shape),
                         dtype=dtype)
        y.backward(g)
        assert xr.grad.dtype == wr.grad.dtype == dtype
        grads.append((xr.grad, wr.grad))
    for dx, dw in grads:
        assert torch.isfinite(dx).all() and torch.isfinite(dw).all()
        assert torch.equal(dx, grads[0][0]) and torch.equal(dw, grads[0][1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_resnet_gradients_repeat_bit_for_bit(dtype):
    cfg = resnet3d.ResNetConfig(depth=10, n_classes=2, widen_factor=0.25)
    init = resnet3d.ResNet3D(cfg)
    init.reset_parameters(torch.Generator().manual_seed(0))
    vol = torch.randn(4, 1, 16, 40, 40,
                      generator=torch.Generator().manual_seed(1))
    runs = []
    for _ in range(8):
        model = resnet3d.ResNet3D(cfg)
        model.load_state_dict(init.state_dict())
        model(vol.to(dtype), train=True).square().sum().backward()
        runs.append({n: p.grad for n, p in model.named_parameters()})
    for grads in runs:
        for name, g in grads.items():
            assert torch.isfinite(g).all(), name
            assert torch.equal(g, runs[0][name]), name
