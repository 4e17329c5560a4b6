"""NeuroViT on PyTorch and CUDA for NVIDIA Hopper (H100).

The port of ``neurovit_tpu`` (JAX on a TPU, which stays the reference).
This package covers the 3D ViT in training and serving and the 3D ResNet
(``MODEL_VOLUME_ENCODER: resnet``): the models, the trainer and its CLI
(``python -m neurovit_tpu_torch.main``), checkpoints, the batch CLI
(``python -m neurovit_tpu_torch.serving``) and the HTTP server
(``python -m neurovit_tpu_torch.serving_http``), in bf16 and, for the ViT's
serving, int8 (``--quant int8``), and the CAMs of both. The Pallas kernels
of each ViT block, forward, backward and int8, and of the ResNet's stem
max-pool are CUDA C++ kernels for sm_90a under ``csrc/``, built at first
use; each has a plain PyTorch version beside it that CPU tensors run.

It imports torch and never jax, and nothing of ``neurovit_tpu``: the
config (``config.py``) and the data layer (``data/``) are its own copies.
"""

__version__ = "0.1.0"
