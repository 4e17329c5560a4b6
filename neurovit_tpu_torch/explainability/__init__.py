"""Explainability of the 3D ViT: Grad-CAM and its method menu, integrated
gradients, Kernel SHAP and B-cos, with the plotting driver.

Counterpart of ``neurovit_tpu/explainability`` for the ViT (``gradcam_vit3d``,
``cam_methods``, ``integrated_gradients``, ``shap_values``, ``bcos``,
``driver``). The functions take the port's ``NeuroEncoder``, which holds its
weights, in place of JAX's ``(model, variables)`` pair, and run on the
model's device: on a card the probe path launches the block kernels and K6.
The ResNet CAMs, their drivers and the 2D tutorial workflow (``vit_cam_2d``)
are not ported yet (ROADMAP.md, Queue 1).
"""
