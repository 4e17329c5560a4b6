"""G3D-ViT Grad-CAM plotting and export driver.

Counterpart of ``neurovit_tpu/explainability/driver.py``
(``explainability/xAi_gradcam_ViT3D/gradcam3DViT_fmris.py``): per-sample
CAM and slice, the combined jet-overlay grid PNG, and with
``GRADCAM_SAVE_ATTENTION`` a per-sample 3D scatter PNG and the map as
NIfTI. Run as a module, with the root CLI's flags plus ``--device``:

    python -m neurovit_tpu_torch.explainability.driver [--config PATH]
        [--cuda N] [--device cuda|cpu]

It runs on ``cuda:N`` and raises without a card; ``--device cpu`` runs the
plain PyTorch path on purpose. ``GRADCAM_METHOD`` picks the menu method
(``gradcam-ref`` by default). matplotlib is imported only to plot.
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import Dict, List, Sequence

import numpy as np

from neurovit_tpu_torch.data import nifti


def get_sample_gradcam(model, dataset, sample_id: int, config: Dict,
                       save_sample_attention: bool = False):
    """(sample_id, image slice, attention slice, class_idx, sample) of one
    dataset sample."""
    sample = dataset.sample(sample_id)
    volume = sample["volume"]
    print(f"ID: {sample_id} - Label: {sample['subject']}")
    method = config.get("GRADCAM_METHOD", "gradcam-ref")
    if method != "gradcam-ref":
        from neurovit_tpu_torch.explainability.cam_methods import compute_cam
        attention_map, class_idx = compute_cam(model, volume, method=method)
    else:
        attention_map, class_idx = model.get_attention_map(volume)
    img, attn = model.visualize_slice(attention_map, volume)
    if save_sample_attention:
        save_gradcam_3d(attention_map, sample_id, sample, config)
    return sample_id, img, attn, int(np.asarray(class_idx).ravel()[0]), sample


def create_gradcam_plot(model, dataset, ids: Sequence[int], config: Dict,
                        save_sample_attention: bool = False) -> str:
    """Combined 4-column jet-overlay grid across samples; returns the PNG
    path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    results = [get_sample_gradcam(model, dataset, i, config,
                                  save_sample_attention) for i in ids]
    n = len(results)
    cols = 4
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(20, 5 * rows))
    fig.suptitle(f"ADNI GradCAM Results "
                 f"{config['TRAINING_VIT_PATCH_SIZE']}patch", fontsize=16)
    axes = np.atleast_2d(axes)
    for idx, (sid, image, attention, class_idx, _) in enumerate(results):
        ax = axes[idx // cols, idx % cols]
        # Inverse brightness on dark backgrounds (gradcam3DViT_fmris.py:51).
        shown = (-image + 1 if config["GRADCAM_BACKGROUND_NOISE"] < 1
                 else image)
        ax.imshow(shown, cmap="gray")
        heatmap = ax.imshow(attention, cmap="jet", alpha=0.4)
        fig.colorbar(heatmap, ax=ax, fraction=0.046, pad=0.04)
        ax.set_title(f"Subject {sid} (Class {class_idx})")
        ax.axis("off")
    for idx in range(n, rows * cols):
        axes[idx // cols, idx % cols].axis("off")

    out_dir = config["GRADCAM_OUTPUT_DIR"]
    os.makedirs(out_dir, exist_ok=True)
    file_name = (f"ADNI_{config['TRAINING_VIT_PATCH_SIZE']}patch_results_"
                 f"{datetime.now().strftime('%Y%m%d_%H%M%S')}").replace(".", "p")
    path = os.path.join(out_dir, f"{file_name}.png")
    plt.tight_layout()
    plt.savefig(path, dpi=150)
    plt.close()
    print(f"All results saved to {file_name}.png")
    return path


def _stem(sample_id: int, config: Dict) -> str:
    return (f"ADNI_{config['TRAINING_VIT_PATCH_SIZE']}patch_"
            f"3Dattention_{sample_id}").replace(".", "p")


def save_gradcam_nifti(attention_map, sample_id: int, config: Dict) -> str:
    """Write one map as NIfTI into GRADCAM_OUTPUT_DIR; returns the path."""
    out_dir = config["GRADCAM_OUTPUT_DIR"]
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{_stem(sample_id, config)}.nii")
    nifti.save(path, np.asarray(attention_map))
    return path


def save_gradcam_3d(attention_map, sample_id: int, sample: Dict,
                    config: Dict) -> None:
    """3D scatter of the above-threshold attention and the NIfTI export
    (gradcam3DViT_fmris.py:69-94)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    attention_map = np.asarray(attention_map)
    threshold = config["GRADCAM_THRESHOLD_3D"]
    coords = np.argwhere(attention_map > threshold)
    values = attention_map[attention_map > threshold]

    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection="3d")
    if coords.size > 0:
        sc = ax.scatter(coords[:, 0], coords[:, 1], coords[:, 2], c=values,
                        cmap="jet", marker="s", alpha=0.6, s=50)
        fig.colorbar(sc, ax=ax, shrink=0.5, aspect=10, label="Attention Value")
    else:
        print(f"No attention values above threshold {threshold} "
              f"for sample {sample_id}")
    ax.set(xlim=(0, attention_map.shape[0]), ylim=(0, attention_map.shape[1]),
           zlim=(0, attention_map.shape[2]))
    ax.set(xlabel="X axis", ylabel="Y axis", zlabel="Z axis")

    out_dir = config["GRADCAM_OUTPUT_DIR"]
    os.makedirs(out_dir, exist_ok=True)
    plt.title(f"3D GradCAM (Label: {sample['subject']})")
    plt.tight_layout()
    plt.savefig(os.path.join(out_dir, f"{_stem(sample_id, config)}.png"),
                dpi=150)
    plt.close()
    save_gradcam_nifti(attention_map, sample_id, config)


def main(argv: List[str] = None) -> None:
    from neurovit_tpu_torch.config import get_config
    from neurovit_tpu_torch.data import get_datasets
    from neurovit_tpu_torch.main import parse_args, resolve_device
    from neurovit_tpu_torch.models import NeuroEncoder
    from neurovit_tpu_torch.training.checkpoint import load_checkpoint

    args = parse_args(argv)
    config = get_config(args)
    device = resolve_device(args)
    config["DEVICE"] = str(device)
    model = NeuroEncoder(config, device=device)
    best = os.path.join(config["GLOBAL_BASE_PATH"], config["BEST_MODEL_PATH"])
    if os.path.exists(best):
        load_checkpoint(model, best, strict=False)
    _, dataset = get_datasets(config)
    create_gradcam_plot(model, dataset, list(range(12)), config,
                        save_sample_attention=config["GRADCAM_SAVE_ATTENTION"])


if __name__ == "__main__":
    main()
