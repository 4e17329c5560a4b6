"""Integrated Gradients for the volume classifier.

Counterpart of ``neurovit_tpu/explainability/integrated_gradients.py``:

    IG(x) = (x - baseline) * mean_{a} dF_c(baseline + a (x - baseline))/dx

over the midpoints a = (i + 0.5) / steps, c the argmax class of x. Each
step is one forward and one backward of the model with respect to its
input: on a card the block kernels K1-K4 and their backwards K5, K7, K8,
K9, without dropout.

Baseline caveat (the JAX module's): the ViT LayerNorms each input patch,
so the network is nearly scale-invariant in x; with a zero baseline the
path F(a x) is flat for a > 0 and completeness cannot hold. Use another
volume or noise as the baseline; zeros stay the default.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from neurovit_tpu_torch.explainability.gradcam_vit3d import as_batch


def _ig(model, x: torch.Tensor, baseline: torch.Tensor, steps: int):
    """(attributions like x, class_idx, logits of x)."""
    with torch.no_grad():
        logits = model(x)
    class_idx = logits.argmax(dim=1)
    delta = x - baseline
    total = torch.zeros_like(x)
    for i in range(steps):
        alpha = (i + 0.5) / steps
        inp = (baseline + alpha * delta).requires_grad_(True)
        with torch.enable_grad():
            score = model(inp).gather(1, class_idx[:, None]).sum()
            (grads,) = torch.autograd.grad(score, inp)
        total += grads
    return delta * total / steps, class_idx, logits


def _baseline(x: torch.Tensor, baseline) -> torch.Tensor:
    if baseline is None:
        return torch.zeros_like(x)
    b = torch.as_tensor(np.asarray(baseline, np.float32), device=x.device)
    return b.expand_as(x)


def integrated_gradients(model, x, *, baseline: Optional[np.ndarray] = None,
                         steps: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """x: [H, W, D] or [B, H, W, D] -> (attributions like x, class_idx
    [B]) as numpy."""
    x, squeeze = as_batch(model, x)
    attr, cls, _ = _ig(model, x, _baseline(x, baseline), steps)
    attr = attr.cpu().numpy()
    return (attr[0] if squeeze else attr), cls.cpu().numpy()


def completeness_gap(model, x, *, steps: int = 64,
                     baseline: Optional[np.ndarray] = None) -> float:
    """Relative completeness error |sum(IG) - (F_c(x) - F_c(b))| / |...|,
    the IG sanity metric (it falls with the step count)."""
    x, _ = as_batch(model, x)
    base = _baseline(x, baseline)
    attr, cls, logits = _ig(model, x, base, steps)
    with torch.no_grad():
        base_logits = model(base)
    idx = cls[:, None]
    diff = float((logits.gather(1, idx) - base_logits.gather(1, idx)).sum())
    return float(abs(float(attr.sum()) - diff) / (abs(diff) + 1e-8))
