"""The kernels of the ViT block, each with its plain PyTorch version.

One module per kernel: ``flash_attention``, ``fused_qkv``,
``fused_outproj``, ``fused_mlp``. Every public op dispatches on its
operands: CPU tensors run the plain version, CUDA tensors the hand-written
Hopper kernel (or raise). There is no switch that routes CUDA tensors
elsewhere.
"""
