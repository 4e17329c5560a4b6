"""B-cos networks and their dynamic-linear explanations.

Counterpart of ``neurovit_tpu/explainability/bcos.py``, in plain PyTorch
(no kernel):

1. **B-cos layers** (Böhle et al., CVPR 2022): ``out_j = |cos(x, w_j)|^(B-1)
   * (x . w_hat_j)`` with unit-norm rows w_hat and no bias. A stack is
   exactly dynamic-linear, f(x) = W(x) x, so the contribution map
   ``W(x)^T e_c * x`` sums to the logit (``explain_exact``). Parameters are
   a list of ``{"kernel": [in, out]}``, JAX's layout, so the two packages
   take the same arrays.
2. ``explain``: grad x input on the stock model (K1-K4 forward and the
   backward kernels K5, K7, K8, K9 on a card, without dropout).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from neurovit_tpu_torch.explainability.gradcam_vit3d import as_batch

_EPS = 1e-12


def bcos_linear_init(gen: torch.Generator, in_dim: int, out_dim: int,
                     dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Weight-only, U(-1/sqrt(in), 1/sqrt(in)); rows are normalized at
    apply time, so the scale does not matter."""
    bound = (1.0 / in_dim) ** 0.5
    kernel = torch.empty(in_dim, out_dim, dtype=dtype).uniform_(
        -bound, bound, generator=gen)
    return {"kernel": kernel}


def bcos_linear(params: Dict[str, torch.Tensor], x: torch.Tensor,
                b: float = 2.0, frozen_scale: bool = False) -> torch.Tensor:
    """out_j = |cos(x, w_j)|^(B-1) * (x . w_hat_j). ``frozen_scale`` stops
    gradients through the alignment scales: the layer is then the linear
    map ``diag(s(x)) W_hat^T`` of the dynamic-linear view."""
    w = params["kernel"]
    w_hat = w / (torch.linalg.norm(w, dim=0, keepdim=True) + _EPS)
    lin = x @ w_hat
    x_norm = torch.linalg.norm(x, dim=-1, keepdim=True) + _EPS
    scale = torch.abs(lin / x_norm) ** (b - 1.0)
    if frozen_scale:
        scale = scale.detach()
    return scale * lin


def init_bcos_mlp(gen: torch.Generator, dims: Sequence[int],
                  dtype=torch.float32) -> List[Dict[str, torch.Tensor]]:
    """Bias-free B-cos stack: dims = [in, hidden..., out]."""
    return [bcos_linear_init(gen, d_in, d_out, dtype)
            for d_in, d_out in zip(dims[:-1], dims[1:])]


def bcos_mlp_apply(params: List[Dict[str, torch.Tensor]], x: torch.Tensor,
                   b: float = 2.0, frozen_scale: bool = False
                   ) -> torch.Tensor:
    """f(x) = W(x) x exactly; inputs of more than two dims are flattened
    per sample."""
    h = x.reshape(x.shape[0], -1) if x.ndim > 2 else x
    for layer in params:
        h = bcos_linear(layer, h, b=b, frozen_scale=frozen_scale)
    return h


def explain_exact(params: List[Dict[str, torch.Tensor]], x: torch.Tensor,
                  b: float = 2.0, class_idx: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact contribution map [W(x)^T e_c] * x of a B-cos stack: the
    gradient of the frozen-scale forward (same value) times x, so
    sum(contrib) == f_c(x). Returns (contributions shaped like x,
    class_idx, logits)."""
    x2d = x.reshape(x.shape[0], -1) if x.ndim > 2 else x
    with torch.no_grad():
        logits = bcos_mlp_apply(params, x2d, b=b)
    if class_idx is None:
        class_idx = logits.argmax(dim=1)
    inp = x2d.detach().requires_grad_(True)
    with torch.enable_grad():
        lg = bcos_mlp_apply(params, inp, b=b, frozen_scale=True)
        (grads,) = torch.autograd.grad(
            lg.gather(1, class_idx[:, None]).sum(), inp)
    return (grads * x2d).reshape(x.shape), class_idx, logits


def explain(model, x) -> Tuple[np.ndarray, np.ndarray]:
    """Dynamic-linear contribution map (grad x input) of the stock model
    for the argmax class. x: [H, W, D] or [B, H, W, D] -> (contributions
    like x, class_idx) as numpy."""
    x, squeeze = as_batch(model, x)
    with torch.no_grad():
        class_idx = model(x).argmax(dim=1)
    inp = x.clone().requires_grad_(True)
    with torch.enable_grad():
        score = model(inp).gather(1, class_idx[:, None]).sum()
        (grads,) = torch.autograd.grad(score, inp)
    contrib = (grads * x).cpu().numpy()
    return (contrib[0] if squeeze else contrib), class_idx.cpu().numpy()
