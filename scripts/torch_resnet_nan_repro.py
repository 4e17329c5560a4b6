"""Loop the CPU plain path's bf16 ResNet gradients of
``tests/test_torch_cuda.py::test_maxpool_autograd_and_resnet_forward_backward``
and count the runs whose gradients are not finite or differ from the first
run's bits.

The test's inputs are seeded (ResNet depth 10, widen 0.25, volume [4, 1,
16, 40, 40], seeds 0 and 1), so every run should give the same gradients.
Two loops: the CPU bf16 half alone (``--alone`` runs), then the test's own
order (``--after-card`` runs), where each CPU bf16 half follows the card's
f32 and bf16 halves in the same process. A run that is not finite is
bisected on the spot: the CPU bf16 half is rerun with hooks on every
module (convolutions, BatchNorms, the stem's max-pool) that name the
first whose output or input gradient is not finite. The loops run the
model as it is (``models/resnet3d.py`` ``_Conv3d``, whose CPU bf16
backward runs in f32).

``--bisect R`` first records the operands of each of the model's
convolutions and reruns ``aten.convolution_backward`` R times on them in
four ways: as oneDNN's bf16 kernel takes them, with oneDNN off, on NCDHW
copies, and in f32 on the bf16 values; and the forward R times. On a CPU
with AMX-BF16, oneDNN's bf16 backward of one of them gave other bits on
almost every call; ``--no-mkldnn`` runs the loops with oneDNN off.

    python scripts/torch_resnet_nan_repro.py [--alone 200] [--after-card 200]
        [--bisect 200] [--no-mkldnn]

Prints the torch build, the CPU thread count and, at the end, one line of
counts; with no card the second loop is skipped and says so.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from neurovit_tpu_torch.models import resnet3d  # noqa: E402


def _setup():
    cfg = resnet3d.ResNetConfig(depth=10, n_classes=2, widen_factor=0.25)
    init = resnet3d.ResNet3D(cfg)
    init.reset_parameters(torch.Generator().manual_seed(0))
    vol = torch.randn(4, 1, 16, 40, 40, generator=torch.Generator(
        ).manual_seed(1))
    return cfg, init.state_dict(), vol


def grads(cfg, state, vol, device, dtype) -> dict:
    """Train-mode gradients of square().sum() of the logits, as the test
    takes them."""
    model = resnet3d.ResNet3D(cfg, device=device)
    model.load_state_dict(state)
    model(vol.to(device, dtype), train=True).square().sum().backward()
    return {n: p.grad.float().cpu() for n, p in model.named_parameters()}


def bad_params(g: dict) -> list:
    return [n for n, t in g.items() if not torch.isfinite(t).all()]


def bisect(cfg, state, vol) -> str:
    """Rerun the CPU bf16 forward and backward with hooks that flag the
    first module whose output or input gradient is not finite."""
    model = resnet3d.ResNet3D(cfg, device="cpu")
    model.load_state_dict(state)
    seen = []

    def fwd_hook(name):
        def hook(_, __, out):
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for o in outs:
                if torch.is_tensor(o) and not torch.isfinite(o).all():
                    seen.append(f"forward {name}")
        return hook

    def bwd_hook(name):
        def hook(_, grad_in, __):
            for gi in grad_in:
                if torch.is_tensor(gi) and not torch.isfinite(gi).all():
                    seen.append(f"backward {name}")
        return hook

    for name, mod in model.named_modules():
        if name:
            mod.register_forward_hook(fwd_hook(name))
            mod.register_full_backward_hook(bwd_hook(name))
    model(vol.to(torch.bfloat16), train=True).square().sum().backward()
    return ", ".join(seen[:6]) or "no module output was non-finite on rerun"


def record_convs(cfg, state, vol) -> list:
    """The operands of every convolution's forward and backward in one CPU
    bf16 run: [(x, w, stride, padding, g)] in forward order."""
    calls, fwd, bwd = [], resnet3d._Conv3d.forward, resnet3d._Conv3d.backward

    def forward(ctx, x, w, stride, padding):
        ctx.index = len(calls)
        calls.append([x.clone(), w.clone(), stride, padding, None])
        return fwd(ctx, x, w, stride, padding)

    def backward(ctx, g):
        calls[ctx.index][4] = g.clone()
        return bwd(ctx, g)

    resnet3d._Conv3d.forward = staticmethod(forward)
    resnet3d._Conv3d.backward = staticmethod(backward)
    try:
        grads(cfg, state, vol, "cpu", torch.bfloat16)
    finally:
        resnet3d._Conv3d.forward = staticmethod(fwd)
        resnet3d._Conv3d.backward = staticmethod(bwd)
    return calls


def conv_bwd(x, w, stride, padding, g, variant: str) -> tuple:
    """(dx, dw) of one convolution: "as is" (the model's call), "no
    mkldnn" (oneDNN off), "contiguous" (NCDHW operands) or "f32" (the bf16
    operands in f32, rounded once)."""
    import contextlib
    if variant == "contiguous":
        x, w, g = (t.contiguous() for t in (x, w, g))
    if variant == "f32":
        x, w, g = (t.float() for t in (x, w, g))
    flags = (torch.backends.mkldnn.flags(enabled=False)
             if variant == "no mkldnn" else contextlib.nullcontext())
    with flags:
        dx, dw, _ = torch.ops.aten.convolution_backward(
            g, x, w, None, resnet3d._triple(stride),
            resnet3d._triple(padding), [1, 1, 1], False, [0, 0, 0], 1,
            [True, True, False])
    return dx.to(torch.bfloat16), dw.to(torch.bfloat16)


def bisect_convs(cfg, state, vol, runs: int) -> None:
    """Each convolution's backward (and forward), rerun ``runs`` times on
    its recorded operands, by variant: how many results are not finite
    and how many differ from the first bit for bit."""
    calls = record_convs(cfg, state, vol)
    for variant in ("as is", "no mkldnn", "contiguous", "f32"):
        for i, (x, w, stride, padding, g) in enumerate(calls):
            first, bad, differ = None, 0, 0
            for _ in range(runs):
                out = conv_bwd(x, w, stride, padding, g, variant)
                if not all(torch.isfinite(t).all() for t in out):
                    bad += 1
                elif first is None:
                    first = out
                elif not all(torch.equal(a, b) for a, b in zip(out, first)):
                    differ += 1
            fwd_differ = 0
            if variant == "as is":
                def fwd():
                    return torch.nn.functional.conv3d(x, w, stride=stride,
                                                      padding=padding)
                y0 = fwd()
                fwd_differ = sum(not torch.equal(y0, fwd())
                                 for _ in range(runs))
            layout = ("channels-last" if x.is_contiguous(
                memory_format=torch.channels_last_3d)
                and not x.is_contiguous() else "contiguous")
            print(f"conv {i} {variant}: x {list(x.shape)} {layout}"
                  f", w {list(w.shape)}, stride {stride}: backward "
                  f"{bad} non-finite, {differ} not bit-equal of {runs}"
                  + (f"; forward {fwd_differ} not bit-equal"
                     if variant == "as is" else ""), flush=True)


def loop(label: str, runs: int, cfg, state, vol, card: bool) -> tuple:
    first, nonfinite, differ = None, 0, 0
    t0 = time.perf_counter()
    for i in range(runs):
        if card:
            grads(cfg, state, vol, "cuda", torch.float32)
            grads(cfg, state, vol, "cuda", torch.bfloat16)
        g = grads(cfg, state, vol, "cpu", torch.bfloat16)
        bad = bad_params(g)
        if bad:
            nonfinite += 1
            print(f"{label} run {i}: non-finite gradients in {bad[:4]}; "
                  f"bisect: {bisect(cfg, state, vol)}", flush=True)
            continue
        if first is None:
            first = g
        elif any(not torch.equal(g[n], first[n]) for n in g):
            differ += 1
    print(f"{label}: {runs} runs in {time.perf_counter() - t0:.1f} s, "
          f"{nonfinite} non-finite, {differ} finite but not bit-equal to "
          "the first", flush=True)
    return nonfinite, differ


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--alone", type=int, default=200)
    ap.add_argument("--after-card", type=int, default=200)
    ap.add_argument("--bisect", type=int, default=0,
                    help="rerun each convolution's backward this many times")
    ap.add_argument("--no-mkldnn", action="store_true",
                    help="run the loops with oneDNN off")
    args = ap.parse_args(argv)
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.get_num_threads()} CPU threads, "
          f"{torch.backends.cpu.get_cpu_capability()}, oneDNN "
          f"{torch.backends.mkldnn.is_available()}", flush=True)
    cfg, state, vol = _setup()
    if args.bisect:
        bisect_convs(cfg, state, vol, args.bisect)
    if args.no_mkldnn:
        torch.backends.mkldnn.enabled = False
    counts = {"alone": loop("alone", args.alone, cfg, state, vol, False)}
    if torch.cuda.is_available():
        counts["after card"] = loop("after card", args.after_card, cfg,
                                    state, vol, True)
    else:
        print("after card: skipped (no card)")
    print("counts (non-finite, not bit-equal): " + ", ".join(
        f"{k} {v}" for k, v in counts.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
