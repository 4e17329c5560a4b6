"""Explainability: Grad-CAM of the 3D ViT and its method menu, integrated
gradients, Kernel SHAP and B-cos, with the plotting driver; the 3D
ResNet's layer4 CAMs with their two drivers; the 2D ViT CAM tutorial.

Counterpart of ``neurovit_tpu/explainability`` (``gradcam_vit3d``,
``cam_methods``, ``integrated_gradients``, ``shap_values``, ``bcos``,
``driver``, ``gradcam_resnet``, ``driver_resnet``, ``driver_smri``,
``vit_cam_2d``). The functions take the port's ``NeuroEncoder`` (or
``vit_cam_2d.ViT2D``), which holds its weights (and the ResNet's
BatchNorm state), in place of JAX's ``(model, variables)`` pair, and run
on the model's device: on a card the ViT's probe path launches the block
kernels and K6, at bf16 or f32, and a ResNet CAM the stem's pool K14.
"""
