"""Synthetic Grad-CAM cube dataset (label-verifiable 3D volumes).

The port's copy of ``neurovit_tpu/data/synthetic.py``, which re-implements the reference's ``src/data/DatasetGradCAM.py``: volumes of
``grid_size^3`` filled with GRADCAM_BACKGROUND_NOISE containing one
``cube_size^3`` cube of 1s at a grid-aligned random position; the label is the
linearized cube cell index ``tx/c + ty/c*n + tz/c*n^2`` (DatasetGradCAM.py:
100-119); fixed 0.8 train split (DatasetGradCAM.py:128).

TPU-first change: the reference materializes all ``num_samples`` float64
volumes and pickles them (~23 GB at grid 90); we store only the cube
coordinates per sample and materialize volumes lazily in ``sample`` —
bit-identical data, O(1) memory. Pickle save/load of the coordinate index is
kept for the GRADCAM_TRAIN_PATH / GRADCAM_VAL_PATH config surface (fixing the
reference's lowercase-key KeyError, SURVEY §2.1.6).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import numpy as np


class GradCAMDataset:
    def __init__(self, config: Dict[str, Any], mode: str = "train",
                 generate_data: bool = False):
        self.mode = mode
        self.config = config
        self.grid_size = config["TRAINING_VIT_INPUT_SIZE"]
        self.cube_size = config["GRADCAM_CUBE_SIZE"]
        self.grid_noise = config["GRADCAM_BACKGROUND_NOISE"]
        self.num_samples = config["GRADCAM_NUM_SAMPLES"]
        self.dataset_path = (config.get("GRADCAM_TRAIN_PATH")
                             if mode == "train"
                             else config.get("GRADCAM_VAL_PATH"))

        if generate_data or not (self.dataset_path
                                 and os.path.exists(self.dataset_path)):
            self._generate()
            if generate_data and self.dataset_path:
                self._save()
        else:
            with open(self.dataset_path, "rb") as f:
                index = pickle.load(f)
            self.coords = np.asarray(index["coords"], dtype=np.int64)
            self.labels = np.asarray(index["labels"], dtype=np.int64)

        if config.get("DATASET_VISUALIZE_SAMPLES"):
            # Visualize samples 1-5 on init (DatasetGradCAM.py:75-80).
            for i in range(1, min(6, len(self))):
                self.visualize_sample_3d(i)

        print(f"Dataset initialized: {len(self)} {mode} samples")

    def _generate(self) -> None:
        """Sample grid-aligned cube positions (DatasetGradCAM.py:100-119).

        Seeded from TRAINING_SEED so train/val draws are reproducible; the
        val split takes the tail 20% of the same stream (DatasetGradCAM.py:128).
        """
        rng = np.random.RandomState(self.config.get("TRAINING_SEED", 42))
        num_cubes = self.grid_size // self.cube_size
        coords = rng.randint(0, num_cubes, size=(self.num_samples, 3)) * self.cube_size
        cells = coords // self.cube_size
        labels = (cells[:, 0] + cells[:, 1] * num_cubes
                  + cells[:, 2] * num_cubes * num_cubes)
        train_size = int(0.8 * self.num_samples)
        sl = slice(0, train_size) if self.mode == "train" else slice(train_size, None)
        self.coords = coords[sl].astype(np.int64)
        self.labels = labels[sl].astype(np.int64)

    def _save(self) -> None:
        os.makedirs(os.path.dirname(self.dataset_path) or ".", exist_ok=True)
        with open(self.dataset_path, "wb") as f:
            pickle.dump({"coords": self.coords, "labels": self.labels}, f)
        print("Datasets saved!")

    def __len__(self) -> int:
        return len(self.labels)

    def sample(self, idx: int) -> Dict[str, Any]:
        """Materialize one volume. Returns the framework's canonical sample
        dict; 'label' is what the trainer optimizes (the reference edits its
        loop by hand per dataset, README.md:120 — we dispatch instead)."""
        tx, ty, tz = self.coords[idx]
        c = self.cube_size
        volume = np.full((self.grid_size,) * 3, self.grid_noise, dtype=np.float32)
        volume[tx:tx + c, ty:ty + c, tz:tz + c] = 1.0
        return {
            "volume": volume,
            "label": int(self.labels[idx]),
            "coordinates": np.array([tx, ty, tz], dtype=np.float32),
            "subject": f"synthetic_{self.mode}_{idx}",
            "timepoint": 0,
        }

    # torch-Dataset-style access for API familiarity
    __getitem__ = sample

    def visualize_sample_3d(self, idx: int) -> None:
        """3D scatter of the cube + NIfTI export (DatasetGradCAM.py:175-227)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from neurovit_tpu_torch.data import nifti

        out_dir = self.config.get("GRADCAM_OUTPUT_DIR", "./results")
        os.makedirs(out_dir, exist_ok=True)
        s = self.sample(idx)
        volume = s["volume"]
        fig = plt.figure(figsize=(10, 8))
        ax = fig.add_subplot(111, projection="3d")
        ax.scatter(*np.where(volume == 1), c="red", marker="s", alpha=0.5, s=50)
        ax.set(xlim=(0, volume.shape[0]), ylim=(0, volume.shape[1]),
               zlim=(0, volume.shape[2]))
        ax.set(xlabel="X axis", ylabel="Y axis", zlabel="Z axis")
        file_name = (f"DatasetGradCAM_{self.grid_size}grid_{self.cube_size}cube_"
                     f"{self.grid_noise}noise_{idx}").replace(".", "p")
        plt.title(f"3D Visualization of Target Cube (Label: {s['label']}, "
                  f"coordinates: {s['coordinates']})")
        plt.tight_layout()
        nifti.save(os.path.join(out_dir, file_name + ".nii"), volume)
        plt.savefig(os.path.join(out_dir, f"{file_name}.png"), dpi=150)
        plt.close()
        print(f"3D visualization saved to {os.path.join(out_dir, file_name)}")
