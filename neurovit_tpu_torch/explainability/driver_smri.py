"""sMRI (structural) CAM driver — the gradcam_sMRI.py analog.

Counterpart of ``neurovit_tpu/explainability/driver_smri.py``, which
re-implements the reference's structural-volume Grad-CAM script
(``explainability/xAi_gradcam_Resnet3D/gradcam_sMRI.py``): read a subject's
structural MRI (the ``Path_sMRI_brain`` manifest column the fMRI pipeline
never touches), crop the z axis (``:34-56``: ``fmri_data[:, :, 8:168]``),
z-score over the WHOLE volume (``:57``, no eps), run the resnet CAM, and
save the normalized volume + heatmap as NIfTI plus a slice-overlay image
(``:60-93``). Differences from the reference, by design:

- samples come from the ADNI manifest CSV instead of a hardcoded
  ``/mnt/.../structural/s{ID}.nii`` pattern (``:37``) — same files, no
  site-specific absolute paths;
- matplotlib writes the overlay (the environment has no cv2), same content.

Run as a module, with the root CLI's flags plus ``--device``:

    python -m neurovit_tpu_torch.explainability.driver_smri [--config PATH]
        [--cuda N] [--device cuda|cpu]

It runs on ``cuda:N`` and raises without a card; ``--device cpu`` runs the
plain PyTorch path on purpose. The model holds its weights and BN state,
so the functions take no ``variables``.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from neurovit_tpu_torch.data import nifti
from neurovit_tpu_torch.explainability.gradcam_resnet import resnet_cam


def smri_manifest(config) -> List[Tuple[str, str]]:
    """(subject, Path_sMRI_brain) rows from the ADNI manifest CSV."""
    import pandas as pd
    df = pd.read_csv(config["ADNI_CSV_PATH"])
    col = "Path_sMRI_brain"
    if col not in df.columns:
        raise KeyError(f"manifest {config['ADNI_CSV_PATH']} has no {col} "
                       f"column (schema: src/data/README.md)")
    return [(str(r["Subject"]), str(r[col])) for _, r in df.iterrows()
            if isinstance(r[col], str) and r[col]]


def load_smri(path: str, z_crop: Sequence[int] = (8, 168)) -> np.ndarray:
    """Structural volume, z-cropped + globally z-scored (gradcam_sMRI.py:
    54-57). 4D inputs take timepoint 0; the crop clamps to the volume."""
    img = nifti.load(path)
    data = np.asarray(img.dataobj[..., 0] if len(img.shape) == 4
                      else img.dataobj, dtype=np.float32)
    z0, z1 = int(z_crop[0]), int(z_crop[1])
    if z0 < data.shape[2]:
        data = data[:, :, z0:min(z1, data.shape[2])]
    return (data - data.mean()) / data.std()


def create_smri_cam(model, config, ids: Sequence[int] = None,
                    method: str = "layercam") -> List[str]:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_dir = os.path.join(config["GRADCAM_OUTPUT_DIR"], "structural")
    os.makedirs(out_dir, exist_ok=True)
    rows = smri_manifest(config)
    if ids is not None:
        rows = [rows[i] for i in ids if i < len(rows)]
    z_crop = config.get("GRADCAM_SMRI_Z_CROP", (8, 168))
    outputs = []
    for subject, path in rows:
        volume = load_smri(path, z_crop)
        cam, cls = resnet_cam(model, volume, method=method)
        print(f"Target: {int(cls[0])}")
        # NIfTI exports, reference names (gradcam_sMRI.py:63,81).
        nifti.save(os.path.join(out_dir, f"gradcam_fmri{subject}.nii"),
                   volume)
        nifti.save(os.path.join(out_dir, f"gradcam_heatmap{subject}.nii"),
                   cam)
        # Coronal overlay (the reference slices [:, 172, :]; clamp to shape).
        y = min(config.get("GRADCAM_SMRI_SLICE_IDX", 172),
                volume.shape[1] - 1)
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.imshow(volume[:, y, :], cmap="gray")
        ax.imshow(cam[:, y, :], cmap="jet", alpha=0.4)
        ax.set_title(f"Subject {subject} (Class {int(cls[0])})")
        ax.axis("off")
        png = os.path.join(out_dir, f"gradcam_age{subject}.png")
        fig.savefig(png, dpi=150)
        plt.close(fig)
        outputs.append(png)
        print(f"Completed {subject}")
    print("GradCAM completed.")
    return outputs


def main(argv: List[str] = None) -> None:
    from neurovit_tpu_torch.config import get_config
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
        load_checkpoint(model, best, strict=False)
    create_smri_cam(model, config, ids=list(range(12)))


if __name__ == "__main__":
    main()
