"""3D ResNet baseline with explicit BatchNorm state, for training, serving
and layer4 CAMs.

Counterpart of ``neurovit_tpu/models/resnet3d.py`` (the reference's
Kensho-Hara ``src/models/resnet_3d.py``):

- ``ResNetConfig`` and ``BLOCK_LAYOUTS`` for depths 10-200 (resnet3d.py:
  38-81): stem Conv3d(k=(7, 7, 7), stride=(1, 2, 2)) + BN + ReLU + the
  k3/s2/p1 max-pool (the reference's defaults, the only stem its encoder
  builds: ``conv1_t_size``, ``conv1_t_stride`` and ``no_max_pool`` are not
  ported), four stages of basic (expansion 1) or bottleneck
  (expansion 4) blocks, shortcut A (strided subsample + channel zero-pad)
  or B (1x1x1 conv + BN), global mean pool and a Linear head;
- init (resnet3d.py:88-100, 395-423): Kaiming-normal (fan_out, relu) convs,
  BN (1, 0) with running stats (0, 1), and the head as ``nn.Linear``'s
  U(+-1/sqrt(in)), drawn from a ``torch.Generator``;
- convs are ``F.conv3d`` (JAX leaves them to XLA outside any Pallas kernel,
  resnet3d.py:103-118) with the weight rounded to the activation dtype. They
  run in ``torch.channels_last_3d``, so the pool's NDHWC view of the stem is
  a permute with no copy. f32 convs run with TF32 off, JAX's
  ``precision="highest"`` (resnet3d.py:117);
- BatchNorm as resnet3d.py:121-161: f32 statistics over (N, D, H, W) in one
  pass (sum and sum of squares, variance clamped at 0), the unbiased
  variance into the running stats at momentum 0.1, eps 1e-5. The batch
  statistics include the padding rows of a trailing batch (the loader
  repeats the last sample, loader.py:147-149), as in JAX. BN follows the
  explicit ``train=`` argument, not ``module.training``; the running stats
  are the ``nn.BatchNorm3d`` buffers, so the state-dict keys are torch's;
- the stem pool is ``ops.maxpool3d.max_pool3d``: K14 forward and K15
  backward on a card (``NEUROVIT_MAXPOOL`` and ``max_pool3d_taps`` are not
  ported: there is one pool);
- ``body`` and ``head`` split the forward at layer4, where the CAM probe
  (``explainability.gradcam_resnet.layer4_acts_grads``, the reference's
  ``capture_features``/``feature_shift``, resnet3d.py:426-482) sits.

Module attribute names follow the reference's, so the state-dict keys are
``state_dict._resnet_entries``' (under the ``NeuroEncoder`` path
``resnet_3d.resnet.``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn as tnn

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.ops.maxpool3d import max_pool3d
from neurovit_tpu_torch.parallel.mesh import current_mesh
from neurovit_tpu_torch.parallel.sharding import global_sum

BN_EPS = 1e-5
BN_MOMENTUM = 0.1

BLOCK_LAYOUTS = {
    # depth: (block kind, per-stage block counts)   resnet_3d.py:210-227
    10: ("basic", (1, 1, 1, 1)),
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
    200: ("bottleneck", (3, 24, 36, 3)),
}

STAGE_PLANES = (64, 128, 256, 512)  # get_inplanes(), resnet_3d.py:7-8


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depth: int = 18
    n_input_channels: int = 1
    shortcut_type: str = "B"
    widen_factor: float = 1.0
    n_classes: int = 400

    def __post_init__(self):
        if self.depth not in BLOCK_LAYOUTS:
            raise ValueError(f"unsupported depth {self.depth} "
                             f"(supported: {sorted(BLOCK_LAYOUTS)})")
        if self.shortcut_type not in ("A", "B"):
            raise ValueError(f"unknown shortcut type {self.shortcut_type!r} "
                             "(supported: 'A', 'B')")

    @property
    def block_kind(self) -> str:
        return BLOCK_LAYOUTS[self.depth][0]

    @property
    def stage_blocks(self) -> Sequence[int]:
        return BLOCK_LAYOUTS[self.depth][1]

    @property
    def expansion(self) -> int:
        return 1 if self.block_kind == "basic" else 4

    @property
    def stage_planes(self) -> Sequence[int]:
        return [int(p * self.widen_factor) for p in STAGE_PLANES]


@contextlib.contextmanager
def _no_tf32():
    """cuDNN's TF32 off inside the block, its previous setting after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _triple(v) -> list:
    return list(v) if isinstance(v, (tuple, list)) else [v] * 3


class _Conv3d(torch.autograd.Function):
    """``F.conv3d`` without bias, forward and backward both run with TF32
    off: cuDNN reads the flag when each runs, so autograd's own backward of
    ``F.conv3d`` would follow the global setting, True by default.

    On the CPU a bf16 backward runs on the operands' values in f32 and
    rounds dx and dw to bf16 once: oneDNN's bf16 convolution backward on a
    CPU with AMX-BF16 gives other bits from call to call on the same
    operands at some shapes, now and then a NaN (the 64 -> 64 channel 3^3
    convolution on [4, 64, 2, 3, 3] differed in 199 of 200 calls;
    ``scripts/torch_resnet_nan_repro.py``). Its f32 backward is
    deterministic there, and it sums in f32 as the bf16 one does."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = _triple(stride), _triple(padding)
        with _no_tf32():
            return F.conv3d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dtype = x.dtype
        if x.device.type == "cpu" and dtype == torch.bfloat16:
            g, x, w = g.float(), x.float(), w.float()
        with _no_tf32():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, ctx.stride, ctx.padding, [1, 1, 1], False,
                [0, 0, 0], 1, [ctx.needs_input_grad[0],
                               ctx.needs_input_grad[1], False])
        return (None if dx is None else dx.to(dtype),
                None if dw is None else dw.to(dtype), None, None)


def conv3d(x: torch.Tensor, weight: torch.Tensor, stride=1,
           padding=0) -> torch.Tensor:
    """``F.conv3d`` with the OIDHW weight rounded to x's dtype, channels-last
    in and out. TF32 is off in the forward and the backward, so an f32 conv
    on a card computes in f32, as JAX's ``precision="highest"``."""
    w = weight.to(x.dtype).contiguous(memory_format=torch.channels_last_3d)
    x = x.contiguous(memory_format=torch.channels_last_3d)
    return _Conv3d.apply(x, w, stride, padding)


def batch_norm(bn: tnn.BatchNorm3d, x: torch.Tensor, *,
               train: bool) -> torch.Tensor:
    """BatchNorm3d over (N, D, H, W) per channel, computed in f32 and
    returned in x's dtype (resnet3d.py:121-161). ``train`` normalizes by the
    batch statistics and moves ``bn``'s running stats in place; otherwise
    the running stats normalize.

    Inside a data-parallel ``parallel.use_mesh``, the statistics are those
    of the global batch (resnet3d.py:121-150 over the data axis): the
    per-channel sums are summed over the ranks in the forward, and their
    gradients in the backward, so every rank normalizes alike, gets the
    global statistics' gradient and moves the same running stats."""
    xf = x.float()
    c = x.shape[1]
    if train:
        n = x.numel() // c
        dims = (0, 2, 3, 4)
        mesh = current_mesh()
        if mesh is None:
            mean = xf.sum(dim=dims) / n
            sq = (xf * xf).sum(dim=dims) / n
        else:
            # The global batch's statistics: the ranks' s1 and s2 summed
            # (their gradients too); every rank's batch has the same shape.
            s = global_sum(torch.cat([xf.sum(dim=dims),
                                      (xf * xf).sum(dim=dims)]), mesh)
            n = n * mesh.data
            mean, sq = s[:c] / n, s[c:] / n
        var = torch.clamp(sq - mean * mean, min=0.0)
        with torch.no_grad():
            unbiased = var * (n / max(n - 1, 1))
            bn.running_mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
            bn.running_var.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * unbiased)
            bn.num_batches_tracked.add_(1)
    else:
        mean, var = bn.running_mean, bn.running_var
    shape = (1, c, 1, 1, 1)
    y = (xf - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + BN_EPS)
    y = y * bn.weight.float().reshape(shape) + bn.bias.float().reshape(shape)
    return y.to(x.dtype)


def _conv(in_ch: int, out_ch: int, ksize, device) -> tnn.Conv3d:
    return tnn.Conv3d(in_ch, out_ch, ksize, bias=False, device=device)


def _bn(ch: int, device) -> tnn.BatchNorm3d:
    return tnn.BatchNorm3d(ch, eps=BN_EPS, momentum=BN_MOMENTUM,
                           device=device)


class BasicBlock(tnn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int,
                 cfg: ResNetConfig, device=None):
        super().__init__()
        self.stride = stride
        self.out_planes = planes
        self.conv1 = _conv(in_planes, planes, 3, device)
        self.bn1 = _bn(planes, device)
        self.conv2 = _conv(planes, planes, 3, device)
        self.bn2 = _bn(planes, device)
        self.downsample = _downsample(in_planes, planes, stride, cfg, device)

    def forward(self, x: torch.Tensor, *, train: bool) -> torch.Tensor:
        out = conv3d(x, self.conv1.weight, self.stride, 1)
        out = torch.relu(batch_norm(self.bn1, out, train=train))
        out = conv3d(out, self.conv2.weight, 1, 1)
        out = batch_norm(self.bn2, out, train=train)
        return torch.relu(out + _shortcut(self, x, train=train))


class Bottleneck(tnn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int,
                 cfg: ResNetConfig, device=None):
        super().__init__()
        self.stride = stride
        self.out_planes = planes * 4
        self.conv1 = _conv(in_planes, planes, 1, device)
        self.bn1 = _bn(planes, device)
        self.conv2 = _conv(planes, planes, 3, device)
        self.bn2 = _bn(planes, device)
        self.conv3 = _conv(planes, planes * 4, 1, device)
        self.bn3 = _bn(planes * 4, device)
        self.downsample = _downsample(in_planes, planes * 4, stride, cfg,
                                      device)

    def forward(self, x: torch.Tensor, *, train: bool) -> torch.Tensor:
        out = conv3d(x, self.conv1.weight)
        out = torch.relu(batch_norm(self.bn1, out, train=train))
        out = conv3d(out, self.conv2.weight, self.stride, 1)
        out = torch.relu(batch_norm(self.bn2, out, train=train))
        out = conv3d(out, self.conv3.weight)
        out = batch_norm(self.bn3, out, train=train)
        return torch.relu(out + _shortcut(self, x, train=train))


def _downsample(in_planes: int, out_planes: int, stride: int,
                cfg: ResNetConfig, device) -> Optional[tnn.Sequential]:
    """Shortcut B's 1x1x1 conv + BN when stride != 1 or the channels change
    (resnet3d.py:339-346); shortcut A has no parameters."""
    if (stride == 1 and in_planes == out_planes) or cfg.shortcut_type != "B":
        return None
    return tnn.Sequential(_conv(in_planes, out_planes, 1, device),
                          _bn(out_planes, device))


def _shortcut(block, x: torch.Tensor, *, train: bool) -> torch.Tensor:
    """resnet3d.py:349-361: B's conv + BN; A's strided subsample with the
    channels zero-padded; else the identity."""
    if block.downsample is not None:
        conv, bn = block.downsample
        return batch_norm(bn, conv3d(x, conv.weight, block.stride),
                          train=train)
    s = block.stride
    if s != 1 or x.shape[1] != block.out_planes:
        r = x[:, :, ::s, ::s, ::s]
        return F.pad(r, (0, 0, 0, 0, 0, 0, 0, block.out_planes - r.shape[1]))
    return x


class ResNet3D(tnn.Module):
    """[B, C, D, H, W] volumes in the compute dtype -> f32 logits."""

    def __init__(self, cfg: ResNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        planes = cfg.stage_planes
        self.conv1 = _conv(cfg.n_input_channels, planes[0], 7, device)
        self.bn1 = _bn(planes[0], device)
        block = BasicBlock if cfg.block_kind == "basic" else Bottleneck
        in_planes = planes[0]
        for s in range(4):
            blocks = []
            for b in range(cfg.stage_blocks[s]):
                stride = 2 if (s > 0 and b == 0) else 1
                blocks.append(block(in_planes, planes[s], stride, cfg,
                                    device))
                in_planes = planes[s] * cfg.expansion
            setattr(self, f"layer{s + 1}", tnn.ModuleList(blocks))
        self.fc = tnn.Linear(planes[3] * cfg.expansion, cfg.n_classes,
                             device=device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Weights from ``gen`` (a CPU generator), copied to the module's
        device: convs N(0, 2 / fan_out), BN (1, 0) with running stats
        (0, 1), the head U(+-1/sqrt(in))."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, tnn.Conv3d):
                    fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                    w = torch.randn(m.weight.shape, generator=gen)
                    m.weight.copy_(w * (2.0 / fan_out) ** 0.5)
                elif isinstance(m, tnn.BatchNorm3d):
                    m.reset_parameters()
            bound = self.fc.in_features ** -0.5
            for p in (self.fc.weight, self.fc.bias):
                p.copy_(torch.rand(p.shape, generator=gen) * 2 * bound
                        - bound)

    def body(self, x: torch.Tensor, *, train: bool) -> torch.Tensor:
        """Stem, pool and the four stages: the layer4 output, [B, C', D',
        H', W'], channels-last."""
        out = conv3d(x, self.conv1.weight, (1, 2, 2), 3)
        out = torch.relu(batch_norm(self.bn1, out, train=train))
        pooled = max_pool3d(out.permute(0, 2, 3, 4, 1).contiguous())
        out = pooled.permute(0, 4, 1, 2, 3)
        for s in range(4):
            for block in getattr(self, f"layer{s + 1}"):
                out = block(out, train=train)
        return out

    def head(self, features: torch.Tensor) -> torch.Tensor:
        """Global mean pool and the Linear head, f32 logits."""
        pooled = features.mean(dim=(2, 3, 4))
        return nn.linear(pooled, self.fc.weight, self.fc.bias).float()

    def forward(self, x: torch.Tensor, *, train: bool = False
                ) -> torch.Tensor:
        return self.head(self.body(x, train=train))
