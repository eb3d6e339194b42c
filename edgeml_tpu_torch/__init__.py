"""PyTorch/CUDA port of the edge-offloading detection framework.

A package of its own beside the JAX reference package: plain tensor code is
PyTorch, and every Pallas kernel of the reference is a kernel written by hand
for Hopper (``csrc/``, built at first use by ``_build.py``). This package
imports torch and numpy only — never JAX, and nothing of the JAX package.

Ported so far: detection serving, from an image directory to per-image
detection files, for YOLOv5 (slice 1), SSDLite320-MobileNetV3-Large and
RetinaNet-ResNet50-FPN-v2 (slice 2), with both greedy-NMS suppressors (up to
1024 and up to 2048 candidates) as CUDA kernels (``ops/nms_fused.py``).
Entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""

__all__ = ["data", "models", "ops"]
