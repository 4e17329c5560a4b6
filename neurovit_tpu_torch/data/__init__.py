"""Data layer: dataset dispatch and the host batch loader.

The port's own copy of ``neurovit_tpu/data`` (``get_datasets``,
neurovit_tpu/data/__init__.py:16-39, the reference's dispatch on
DATASET_NAME, ``main.py:91-114``) over adni / adni4D / pain / gradcam, with
the same names and behaviour. The datasets read NIfTI files through numpy
(``nifti.py``). The JAX package's native C++ reader (``native_io.py``) is
not ported: ``DATA_NATIVE_IO: true`` raises, naming its ROADMAP item.
``correlation.py`` waits for the same item.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from neurovit_tpu_torch.data.loader import DataLoader  # noqa: F401
from neurovit_tpu_torch.data.synthetic import GradCAMDataset  # noqa: F401


def get_datasets(config: Dict[str, Any]) -> Tuple[Any, Any]:
    name = config["DATASET_NAME"]
    if name == "gradcam":
        train = GradCAMDataset(config, mode="train",
                               generate_data=config["DATASET_GENERATE"])
        val = GradCAMDataset(config, mode="val", generate_data=False)
    elif name == "adni":
        from neurovit_tpu_torch.data.adni import ADNIDataset
        train = ADNIDataset(config, mode="train",
                            generate_data=config["DATASET_GENERATE"])
        val = ADNIDataset(config, mode="val", generate_data=False)
    elif name == "adni4D":
        from neurovit_tpu_torch.data.adni4d import ADNIDataset4D
        train = ADNIDataset4D(config, mode="train",
                              generate_data=config["DATASET_GENERATE"])
        val = ADNIDataset4D(config, mode="val", generate_data=False)
    elif name == "pain":
        from neurovit_tpu_torch.data.pain import PainDataset
        train = PainDataset(config, mode="train",
                            generate_data=config["DATASET_GENERATE"])
        val = PainDataset(config, mode="val", generate_data=False)
    else:
        raise ValueError(f"Unknown DATASET_NAME: {name}")
    return train, val


def check_numpy_io(config: Dict[str, Any]) -> None:
    """Raise when the config asks for the native C++ NIfTI reader, which
    the port does not have (the copies read through numpy, which gives the
    same volumes: neurovit_tpu/data/adni.py:239-242)."""
    if config.get("DATA_NATIVE_IO", False):
        from neurovit_tpu_torch.models.neuro_encoder import not_ported
        raise not_ported("the native NIfTI reader (DATA_NATIVE_IO)",
                         "odds and ends")
