"""ADNI 4D dataset: whole fMRI time-series classification.

The port's copy of ``neurovit_tpu/data/adni4d.py``, which re-implements ``src/data/DatasetADNI_4D.py``: index = pickled raw CSV rows
(id, subject, group, sex, age, sMRI_path, fMRI_path) (DatasetADNI_4D.py:71-78,
82); post-load filter keeps age < 69 or > 78 (DatasetADNI_4D.py:29);
``generate_data`` does the same Q1/Q4 subject split plus the "double
verification" row-level age re-filter (DatasetADNI_4D.py:44-67).

``sample``: crop ``dataobj[1:, 10:-9, 1:, :]`` -> (90, 90, 90, T), z-score
over the entire 4D array (DatasetADNI_4D.py:86-87), labels as ADNI 3D plus
group AD=1 / CN=0 / else -1 (DatasetADNI_4D.py:91-94).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import pandas as pd

from neurovit_tpu_torch.data import nifti

EPS = 1e-8


class ADNIDataset4D:
    def __init__(self, config: Dict[str, Any], mode: str = "train",
                 generate_data: bool = False):
        self.mode = mode
        self.config = config
        self.csv_path = config["ADNI_CSV_PATH"]
        self.split_ratio = config["DATASET_SPLIT_RATIO"]
        self.dataset_path = (config["ADNI_4D_TRAIN_PATH"] if mode == "train"
                             else config["ADNI_4D_VAL_PATH"])

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
        # Q1/Q4 band filter on the age column (DatasetADNI_4D.py:29).
        self.data = [s for s in self.data if s[4] < 69 or s[4] > 78]
        print(f"Dataset initialized: {len(self.data)} {mode} samples")

    def generate_data(self) -> None:
        df = pd.read_csv(self.csv_path,
                         usecols=["ID", "Subject", "Group", "Sex", "Age",
                                  "Path_sMRI_brain", "Path_fMRI_brain"])
        print(f"Total rows in CSV: {len(df)}")
        q25 = df["Age"].quantile(0.25)
        q75 = df["Age"].quantile(0.75)
        young = np.random.permutation(df[df["Age"] < q25]["Subject"].unique())
        old = np.random.permutation(df[df["Age"] > q75]["Subject"].unique())
        n_young = int(self.split_ratio * len(young))
        n_old = int(self.split_ratio * len(old))
        train_subjects = np.concatenate([young[:n_young], old[:n_old]])
        val_subjects = np.concatenate([young[n_young:], old[n_old:]])
        print(f"Training subjects: {len(train_subjects)}")
        print(f"Validation subjects: {len(val_subjects)}")

        band = (df["Age"] < q25) | (df["Age"] > q75)  # "double verification"
        train_df = df[df["Subject"].isin(train_subjects) & band]
        val_df = df[df["Subject"].isin(val_subjects) & band]
        print(f"Training samples: {len(train_df)}")
        print(f"Validation samples: {len(val_df)}")

        for path, rows in ((self.config["ADNI_4D_TRAIN_PATH"], train_df),
                           (self.config["ADNI_4D_VAL_PATH"], val_df)):
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "wb") as f:
                pickle.dump(rows.values.tolist(), f)
        print("Datasets saved!")

    def __len__(self) -> int:
        return len(self.data)

    def sample(self, idx: int) -> Optional[Dict[str, Any]]:
        id_, subject, group, gender, age, smri_path, fmri_path = self.data[idx]
        try:
            img = nifti.load(fmri_path)
            series = np.asarray(img.dataobj[1:, 10:-9, 1:, :], dtype=np.float32)
            series = (series - series.mean()) / (series.std() + EPS)
            return {
                "volume": series,                       # [90, 90, 90, T]
                "label": 0 if age < 69 else 1,          # age_group task
                "subject": subject,
                "timepoint": 0,
                "group": 0 if group == "CN" else 1 if group == "AD" else -1,
                "gender": 0 if gender == "F" else 1,
                "age": int(age),
                "age_group": 0 if age < 69 else 1,
            }
        except Exception as e:
            print(f"Error loading fMRI for subject {subject}: {e}")
            return None

    __getitem__ = sample
