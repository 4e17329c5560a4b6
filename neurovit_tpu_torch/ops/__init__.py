"""The kernels of the ViT block, of the ResNet's stem pool and of the
probes, each with its plain PyTorch version.

One module per fused op: ``flash_attention``, ``fused_qkv``,
``fused_outproj``, ``fused_mlp``, each with its forward kernel, its
backward kernel and the ``torch.autograd.Function`` that joins them;
``int8_serving``, the four serving-only int8 ops and the weight
quantization of ``Predictor(quant="int8")``; ``maxpool3d``, the
ResNet stem's max-pool with its argmax codes and its backward; and the
probes' kernels, ``dropout`` (K16, the fused dropout with its 32-bit
threshold) and ``int8_gemm`` (K17 and K18, the GEMM probes), which
``scripts/torch_dropout_bench.py`` and ``scripts/torch_int8_gemm_bench.py``
run; and ``tf32x3``, the weight pre-pass of the f32 GEMM that K8 at f32
runs in 3xTF32 on ``wgmma``. Every public op dispatches on its operands:
CPU tensors run the plain versions, CUDA tensors the hand-written Hopper
kernels (or raise; the
attention's head dims below 8 take the plain version on either device, by
shape). There is no switch that routes CUDA tensors elsewhere. The public
ops are imported from
their modules (``from neurovit_tpu_torch.ops.fused_mlp import
fused_mlp_block``); re-exported here, ``flash_attention`` would shadow its
module.
"""

