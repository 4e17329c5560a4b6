"""ResNet CAM plotting driver (LayerCAM/GradCAM over validation samples).

Counterpart of ``neurovit_tpu/explainability/driver_resnet.py``, which
re-implements the reference's pytorch_grad_cam driver scripts
(``explainability/xAi_gradcam_Resnet3D/gradcam.py`` — per-subject CAM overlay
grid, NIfTI export of heatmaps) against our 3D ResNet volume encoder
(MODEL_VOLUME_ENCODER: resnet). Run as a module, with the root CLI's flags
plus ``--device``:

    python -m neurovit_tpu_torch.explainability.driver_resnet [--config PATH]
        [--cuda N] [--device cuda|cpu]

It runs on ``cuda:N`` and raises without a card; ``--device cpu`` runs the
plain PyTorch path on purpose. The model holds its weights and BN state,
so the functions take no ``variables``. matplotlib is imported only to
plot.
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import List, Sequence

import numpy as np

from neurovit_tpu_torch.data import nifti
from neurovit_tpu_torch.explainability.gradcam_resnet import resnet_cam


def create_resnet_cam_plot(model, dataset, ids: Sequence[int],
                           config, method: str = "layercam",
                           save_nifti: bool = False) -> str:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    slice_dim = config["GRADCAM_SLICE_DIM"]
    slice_idx = config["GRADCAM_SLICE_IDX"]
    out_dir = config["GRADCAM_OUTPUT_DIR"]
    os.makedirs(out_dir, exist_ok=True)

    n = len(ids)
    cols = 4
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(20, 5 * rows))
    fig.suptitle(f"ResNet {method} Results", fontsize=16)
    axes = np.atleast_2d(axes)

    for idx, sid in enumerate(ids):
        sample = dataset.sample(sid)
        volume = sample["volume"]
        cam, cls = resnet_cam(model, volume, method=method)
        sl = [slice(None)] * 3
        sl[slice_dim] = slice_idx
        img, attn = volume[tuple(sl)], cam[tuple(sl)]
        ax = axes[idx // cols, idx % cols]
        ax.imshow(img, cmap="gray")
        heat = ax.imshow(attn, cmap="jet", alpha=0.4)
        fig.colorbar(heat, ax=ax, fraction=0.046, pad=0.04)
        ax.set_title(f"Subject {sample['subject']} (Class {int(cls[0])})")
        ax.axis("off")
        if save_nifti:
            nifti.save(os.path.join(out_dir, f"resnet_{method}_heatmap{sid}.nii"),
                       cam)
            nifti.save(os.path.join(out_dir, f"resnet_{method}_fmri{sid}.nii"),
                       volume)
    for idx in range(n, rows * cols):
        axes[idx // cols, idx % cols].axis("off")

    file_name = (f"resnet_{method}_results_"
                 f"{datetime.now().strftime('%Y%m%d_%H%M%S')}")
    path = os.path.join(out_dir, f"{file_name}.png")
    plt.tight_layout()
    plt.savefig(path, dpi=150)
    plt.close()
    print(f"All results saved to {file_name}.png")
    return path


def main(argv: List[str] = None) -> None:
    from neurovit_tpu_torch.config import get_config
    from neurovit_tpu_torch.data import get_datasets
    from neurovit_tpu_torch.main import parse_args, resolve_device
    from neurovit_tpu_torch.models import NeuroEncoder
    from neurovit_tpu_torch.training.checkpoint import load_checkpoint

    args = parse_args(argv)
    config = get_config(args)
    config["MODEL_VOLUME_ENCODER"] = "resnet"
    device = resolve_device(args)
    config["DEVICE"] = str(device)
    model = NeuroEncoder(config, device=device)
    best = os.path.join(config["GLOBAL_BASE_PATH"], config["BEST_MODEL_PATH"])
    if os.path.exists(best):
        # The reference's resnet checkpoint layout (conv OIDHW + BN running
        # stats) is the model's own state-dict layout.
        load_checkpoint(model, best, strict=False)
    _, dataset = get_datasets(config)
    create_resnet_cam_plot(model, dataset, list(range(12)), config,
                           save_nifti=config["GRADCAM_SAVE_ATTENTION"])


if __name__ == "__main__":
    main()
