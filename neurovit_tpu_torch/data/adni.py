"""ADNI 3D dataset: per-timepoint fMRI volume classification.

The port's copy of ``neurovit_tpu/data/adni.py``, which re-implements the reference's ``src/data/DatasetADNI.py``:

- index = pickled list of per-timepoint tuples
  (subject, timepoint, fmri_path, group, gender, age) (DatasetADNI.py:199-200),
- ``generate_data``: CSV manifest -> subject-level split — Q1/Q4 age filter
  for the age task (young = Age < q25, old = Age > q75, split-ratio subject
  split, DatasetADNI.py:93-110) or a plain shuffled subject split otherwise
  (DatasetADNI.py:50-55) — then one sample per fMRI timepoint,
- ``sample``: lazy NIfTI slice ``dataobj[1:, 10:-9, 1:, t]``
  ((91,109,91,T) -> (90,90,90), DatasetADNI.py:211-212) via memmap, per-volume
  z-score (+1e-8), optional random spatial crop, label encodings
  (group CN=0 else 1; gender F=0/M=1; age_group = age<69 -> 0 else 1,
  DatasetADNI.py:221-224),
- ``generate_folds``: subject-level 5-fold CV index writer
  (DatasetADNI.py:112-190).

Framework change vs reference: the trainer consumes ``sample()['label']``,
selected by DATASET_TASK (age -> age_group, gender -> gender, ad -> group)
instead of requiring a hand-edited loop (the reference always trains on the
positional age_group slot, Trainer.py:65,70; its gender/ad results required
editing — SURVEY §2.1.2).

Volumes are read through numpy (``nifti.py``): the JAX package's native
C++ reader and its whole-batch ``read_batch_volumes`` (adni.py:181-211)
are not ported, and ``DATA_NATIVE_IO: true`` raises.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Optional

import numpy as np
import pandas as pd

from neurovit_tpu_torch.data import check_numpy_io, nifti
from neurovit_tpu_torch.data.transforms import rand_spatial_crop, zscore

TASK_LABEL = {"age": "age_group", "gender": "gender", "ad": "group"}


class ADNIDataset:
    def __init__(self, config: Dict[str, Any], mode: str = "train",
                 generate_data: bool = False):
        check_numpy_io(config)
        self.mode = mode
        self.config = config
        self.csv_path = config["ADNI_CSV_PATH"]
        self.split_ratio = config["DATASET_SPLIT_RATIO"]
        self.dataset_path = (config["ADNI_TRAIN_PATH"] if mode == "train"
                             else config["ADNI_VAL_PATH"])
        self.task = config.get("DATASET_TASK", "age")
        self.label_key = TASK_LABEL.get(self.task, "age_group")
        self.transforms = bool(config.get("DATASET_TRANSFORMS", False))
        self.crop_size = config["TRAINING_VIT_INPUT_SIZE"]
        self._rng = np.random.RandomState(config.get("TRAINING_SEED", 42))

        if generate_data:
            self.generate_data()
        try:
            with open(self.dataset_path, "rb") as f:
                self.data = pickle.load(f)
        except FileNotFoundError as e:
            raise FileNotFoundError(
                f"Dataset index {self.dataset_path} not found. Generate it "
                f"first: set DATASET_GENERATE: True (requires the CSV "
                f"manifest, see src/data/README.md).") from e
        print(f"Dataset initialized: {len(self.data)} {mode} samples")

    # ------------------------------------------------------------------
    # index generation
    # ------------------------------------------------------------------

    def generate_data(self) -> None:
        df = pd.read_csv(self.csv_path,
                         usecols=["ID", "Subject", "Group", "Sex", "Age",
                                  "Path_sMRI_brain", "Path_fMRI_brain"])
        print(f"Total rows in CSV: {len(df)}")
        print(f"Total unique subjects: {len(df['Subject'].unique())}")

        if self.config.get("DATASET_TASK", "age") == "age":
            train_subjects, val_subjects = self.age_q1_q4_filter(df)
        else:
            all_subjects = df["Subject"].unique()
            np.random.shuffle(all_subjects)
            train_split = int(self.split_ratio * len(all_subjects))
            train_subjects = all_subjects[:train_split]
            val_subjects = all_subjects[train_split:]
        print(f"Training subjects: {len(train_subjects)}")
        print(f"Validation subjects: {len(val_subjects)}")
        assert not set(train_subjects) & set(val_subjects)

        train_df = df[df["Subject"].isin(train_subjects)]
        val_df = df[df["Subject"].isin(val_subjects)]
        train_samples = self._expand_rows(train_df)
        val_samples = self._expand_rows(val_df)
        print(f"Processed {len(train_samples)} train samples")
        print(f"Processed {len(val_samples)} validation samples")

        for path, samples in ((self.config["ADNI_TRAIN_PATH"], train_samples),
                              (self.config["ADNI_VAL_PATH"], val_samples)):
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "wb") as f:
                pickle.dump(samples, f)
        print("Datasets saved!")

    def age_q1_q4_filter(self, df: pd.DataFrame):
        """Q1/Q4 age split at the subject level (DatasetADNI.py:93-110)."""
        q25 = df["Age"].quantile(0.25)
        q75 = df["Age"].quantile(0.75)
        young = df[df["Age"] < q25]["Subject"].unique()
        old = df[df["Age"] > q75]["Subject"].unique()
        young = np.random.permutation(young)
        old = np.random.permutation(old)
        n_young = int(self.split_ratio * len(young))
        n_old = int(self.split_ratio * len(old))
        train = np.concatenate([young[:n_young], old[:n_old]])
        val = np.concatenate([young[n_young:], old[n_old:]])
        return train, val

    def _expand_rows(self, df: pd.DataFrame) -> List[tuple]:
        """One sample per fMRI timepoint (process_subject_data,
        DatasetADNI.py:192-205); subjects with unreadable files are skipped."""
        samples = []
        for row in df.itertuples(index=False):
            try:
                img = nifti.load(row.Path_fMRI_brain)
                n_t = img.shape[-1] if len(img.shape) == 4 else 1
                for t in range(n_t):
                    samples.append((row.Subject, t, row.Path_fMRI_brain,
                                    row.Group, row.Sex, row.Age))
            except Exception as e:
                print(f"Error processing subject {row.Subject}: {e}")
        return samples

    def generate_folds(self, base_path: str, k_folds: int = 5) -> None:
        """Subject-level k-fold index writer (DatasetADNI.py:112-190; uses
        the ADNI CSV schema — the reference's version had gone stale on Pain
        columns, SURVEY §2.1)."""
        df = pd.read_csv(self.csv_path,
                         usecols=["ID", "Subject", "Group", "Sex", "Age",
                                  "Path_sMRI_brain", "Path_fMRI_brain"])
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

    # ------------------------------------------------------------------
    # sample access
    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.data)

    def sample_meta(self, idx: int) -> Dict[str, Any]:
        """Everything ``sample`` returns except the volume — no file read."""
        subject, timepoint, fmri_path, group, gender, age = self.data[idx]
        labels = {
            "group": 0 if group == "CN" else 1,
            "gender": 0 if gender == "F" else 1,
            "age": int(age),
            "age_group": 0 if age < 69 else 1,
        }
        return {
            "label": labels[self.label_key],
            "subject": subject,
            "timepoint": int(timepoint),
            **labels,
        }

    def sample(self, idx: int) -> Optional[Dict[str, Any]]:
        subject, timepoint, fmri_path, group, gender, age = self.data[idx]
        try:
            vol = self._read_volume(fmri_path, timepoint)
            if self.transforms:
                vol = rand_spatial_crop(vol, self.crop_size, self._rng)
            return {
                "volume": vol,
                **self.sample_meta(idx),
            }
        except Exception as e:
            print(f"Error loading fMRI for subject {subject}: {e}")
            return None

    def _read_volume(self, fmri_path: str, timepoint: int) -> np.ndarray:
        """(91,109,91,T) -> cropped (90,90,90) z-scored single timepoint.

        The array is z-major: memory is C-ordered [Z, Y, X] (x-contiguous
        like the NIfTI file itself, so the read is sequential row copies),
        exposed as the zero-copy [X, Y, Z] transpose view with exactly the
        reference's values (DatasetADNI.py:211-213). The loader's collate
        and the trainer keep the raw buffer zero-copy all the way to the
        device, where the layout transpose happens.
        """
        fmri_path = nifti.readable_path(fmri_path)  # .gz -> cached .nii
        img = nifti.load(fmri_path)
        raw = np.asarray(img.dataobj[1:, 10:-9, 1:, timepoint]
                         .transpose(2, 1, 0), dtype=np.float32)
        return zscore(raw).transpose(2, 1, 0)

    __getitem__ = sample
