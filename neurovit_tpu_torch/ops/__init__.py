"""The kernels of the ViT block, each with its plain PyTorch version.

One module per fused op: ``flash_attention``, ``fused_qkv``,
``fused_outproj``, ``fused_mlp``, each with its forward kernel, its
backward kernel and the ``torch.autograd.Function`` that joins them; and
``int8_serving``, the four serving-only int8 ops and the weight
quantization of ``Predictor(quant="int8")``. Every
public op dispatches on its operands: CPU tensors run the plain versions,
CUDA tensors the hand-written Hopper kernels (or raise). There is no switch
that routes CUDA tensors elsewhere. The public ops are imported from
their modules (``from neurovit_tpu_torch.ops.fused_mlp import
fused_mlp_block``); re-exported here, ``flash_attention`` would shadow its
module.
"""

