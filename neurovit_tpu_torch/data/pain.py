"""Pain-study fMRI dataset: per-timepoint pain-distraction classification.

The port's copy of ``neurovit_tpu/data/pain.py``, which re-implements ``src/data/DatasetPain.py``: index = pickled per-timepoint
tuples (subject, timepoint, fmri_path, gender, age, age_group, pain_group)
(DatasetPain.py:163-180); subject-level shuffled split (DatasetPain.py:41-55);
``generate_folds`` 5-fold writer (DatasetPain.py:83-161).

Fixes vs reference:
- the constructor accepts ``generate_data`` (the reference's doesn't, so
  ``DATASET_NAME: pain`` crashed from main.py — SURVEY §2.1.4),
- ``sample`` slices one timepoint from the memmapped NIfTI instead of
  eagerly reading the whole 4D series per sample (the reference's known I/O
  hot spot, DatasetPain.py:186-188, SURVEY §2.1.12),
- z-score keeps the reference's *no-epsilon* divide semantics
  (DatasetPain.py:193) but guards exact-zero std.

Label: the trainer consumes ``pain_group`` — the quantity the reference
actually optimizes in its Pain runs (its positional "age_group" slot carries
pain_group, DatasetPain.py:212, SURVEY §2.1).

Volumes are read through numpy (``nifti.py``): the JAX package's native
C++ reader (pain.py:130-173) is not ported, and ``DATA_NATIVE_IO: true``
raises.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import pandas as pd

from neurovit_tpu_torch.data import check_numpy_io, nifti

PAIN_COLS = ["Subject", "Path_fMRI", "Gender", "Age", "Age_Group",
             "Pain_Distraction_Group"]


class PainDataset:
    def __init__(self, config: Dict[str, Any], mode: str = "train",
                 generate_data: bool = False):
        check_numpy_io(config)
        self.mode = mode
        self.config = config
        self.csv_path = config["PAIN_CSV_PATH"]
        self.split_ratio = config["DATASET_SPLIT_RATIO"]
        self.dataset_path = (config["PAIN_TRAIN_PKL_PATH"] if mode == "train"
                             else config["PAIN_VAL_PKL_PATH"])

        if generate_data:
            self.generate_data(config["PAIN_TRAIN_PKL_PATH"],
                               config["PAIN_VAL_PKL_PATH"])
        try:
            with open(self.dataset_path, "rb") as f:
                self.data = pickle.load(f)
        except FileNotFoundError as e:
            raise FileNotFoundError(
                f"Dataset index {self.dataset_path} not found. Generate it "
                f"first: set DATASET_GENERATE: True (requires the CSV "
                f"manifest, see src/data/README.md).") from e
        print(f"Dataset initialized: {len(self.data)} {mode} samples")

    def generate_data(self, train_path: str, val_path: str) -> None:
        df = pd.read_csv(self.csv_path, usecols=PAIN_COLS)
        subjects = np.random.permutation(df["Subject"].unique())
        print(f"Total unique subjects: {len(subjects)}")
        train_size = int(self.split_ratio * len(subjects))
        train_subjects = subjects[:train_size]
        val_subjects = subjects[train_size:]
        print(f"Training subjects: {len(train_subjects)}")
        print(f"Validation subjects: {len(val_subjects)}")

        for path, subset in ((train_path, train_subjects),
                             (val_path, val_subjects)):
            rows = df[df["Subject"].isin(subset)]
            samples = self._expand_rows(rows)
            print(f"Processed {len(samples)} samples -> {path}")
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "wb") as f:
                pickle.dump(samples, f)
        print("Datasets saved!")

    def generate_folds(self, base_path: str, k_folds: int = 5) -> None:
        df = pd.read_csv(self.csv_path, usecols=PAIN_COLS)
        subjects = np.random.permutation(df["Subject"].unique())
        fold_size = len(subjects) // k_folds
        os.makedirs(base_path, exist_ok=True)
        for fold in range(k_folds):
            lo = fold * fold_size
            hi = lo + fold_size if fold < k_folds - 1 else len(subjects)
            val_subjects = subjects[lo:hi]
            train_subjects = np.concatenate([subjects[:lo], subjects[hi:]])
            fold_dir = os.path.join(base_path, f"fold_{fold + 1}")
            os.makedirs(fold_dir, exist_ok=True)
            for name, subset in (("train_data.pkl", train_subjects),
                                 ("val_data.pkl", val_subjects)):
                rows = df[df["Subject"].isin(subset)]
                with open(os.path.join(fold_dir, name), "wb") as f:
                    pickle.dump(self._expand_rows(rows), f)
            print(f"Fold {fold + 1} datasets saved!")

    def _expand_rows(self, df: pd.DataFrame):
        samples = []
        for row in df.itertuples(index=False):
            try:
                img = nifti.load(row.Path_fMRI)
                n_t = img.shape[-1] if len(img.shape) == 4 else 1
                for t in range(n_t):
                    samples.append((row.Subject, t, row.Path_fMRI, row.Gender,
                                    row.Age, row.Age_Group,
                                    row.Pain_Distraction_Group))
            except Exception as e:
                print(f"Error processing subject {row.Subject}: {e}")
        return samples

    def __len__(self) -> int:
        return len(self.data)

    def sample_meta(self, idx: int) -> Dict[str, Any]:
        """Everything ``sample`` returns except the volume — no file read."""
        (subject, timepoint, _fmri_path, gender, age, age_group,
         pain_group) = self.data[idx]
        return {
            "label": int(pain_group),
            "subject": subject,
            "timepoint": int(timepoint),
            "gender": 0 if gender == "F" else 1,
            "age": int(age),
            "age_group": int(age_group) - 1,   # 1,2 -> 0,1
            "pain_group": int(pain_group),
        }

    def sample(self, idx: int) -> Optional[Dict[str, Any]]:
        (subject, timepoint, fmri_path, gender, age, age_group,
         pain_group) = self.data[idx]
        try:
            # Timepoint select then crop [1:, 10:-9, 1:] (DatasetPain.py:
            # 188-192) — one lazy memmap read instead of the full series.
            # z-major memory exposed as the [X, Y, Z] transpose view (see
            # ADNIDataset._read_volume); Pain keeps its own normalization
            # semantics (std>0 guard instead of +eps, DatasetPain.py:192).
            img = nifti.load(nifti.readable_path(fmri_path))
            raw = np.asarray(img.dataobj[1:, 10:-9, 1:, timepoint]
                             .transpose(2, 1, 0), dtype=np.float32)
            std = raw.std()
            vol = ((raw - raw.mean()) / (std if std > 0 else 1.0)
                   ).transpose(2, 1, 0)
            return {
                "volume": vol,
                **self.sample_meta(idx),
            }
        except Exception as e:
            print(f"Error loading fMRI for subject {subject}: {e}")
            return None

    __getitem__ = sample
