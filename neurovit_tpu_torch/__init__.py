"""NeuroViT on PyTorch and CUDA for NVIDIA Hopper (H100).

The port of ``neurovit_tpu`` (JAX on a TPU, which stays the reference).
This package covers the 3D ViT in training and serving: the model, the
trainer and its CLI (``python -m neurovit_tpu_torch.main``), checkpoints,
the batch CLI (``python -m neurovit_tpu_torch.serving``) and the HTTP
server (``python -m neurovit_tpu_torch.serving_http``). The Pallas kernels
of each ViT block, forward and backward, are CUDA C++ kernels for sm_90a
under ``csrc/``, built at first use; each has a plain PyTorch version
beside it that CPU tensors run.

It imports torch and never jax. From ``neurovit_tpu`` it imports only
jax-free modules: ``neurovit_tpu.config``, ``neurovit_tpu.data`` (the
datasets and the DataLoader) and ``neurovit_tpu.data.nifti``.
"""

__version__ = "0.1.0"
