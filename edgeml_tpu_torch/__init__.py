"""PyTorch/CUDA port of the edge-offloading detection framework.

A package of its own beside the JAX reference package: plain tensor code is
PyTorch, and every Pallas kernel of the reference is a kernel written by hand
for Hopper (``csrc/``, built at first use by ``_build.py``). This package
imports torch and numpy only — never JAX, and nothing of the JAX package.

Ported so far: detection serving, from an image directory to per-image
detection files, for all five detector families, with every Pallas kernel
of the reference as a CUDA kernel; the reward path (ORIE/DCSB rewards,
``reward/``) and the offloading-policy evaluation (``eval.py``); and the
reward-estimator path (output features, the dataset split, the ten
regression families and the two baselines, ``estimators/``), all with
their CLIs.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""

__all__ = ["data", "dataprep", "estimators", "models", "ops", "reward",
           "utils"]
