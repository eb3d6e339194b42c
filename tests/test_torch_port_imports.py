"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points refuse to run on the CPU unless asked to."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "edgeml_tpu_torch")


def _port_modules():
    import edgeml_tpu_torch

    names = ["edgeml_tpu_torch"]
    for info in pkgutil.walk_packages(edgeml_tpu_torch.__path__,
                                      "edgeml_tpu_torch."):
        names.append(info.name)
    return names


def test_import_pulls_in_no_jax():
    """A fresh interpreter imports the package and every module of it; no
    jax* module and no module of the JAX package may be loaded."""
    mods = _port_modules()
    for m in ("ops.nms_fused", "ops.nms_seq", "ops.gather",
              "models.mobilenetv3", "models.ssdlite", "models.ssd_loss",
              "models.resnet", "models.retinanet", "models.faster_rcnn",
              "data.coco_labelmap", "ops.metrics", "ops.map_kernel",
              "data.io", "data.fastio", "reward.orie", "eval",
              "cli.reward", "cli.test", "data.fastresize", "utils.paths",
              "dataprep.split", "ops.sgd", "estimators.common",
              "estimators.linear", "estimators.trees", "estimators.nn",
              "estimators.train_cnn", "estimators.plotting",
              "estimators.baselines", "cli.dataset_split",
              "cli.extract_feature", "cli.regression", "cli.baseline",
              "dataprep.labels", "dataprep.coco_dataset", "ops.roi",
              "coco_matching", "eval_coco", "cli.label", "models.loss",
              "models.train", "models.engine", "parallel.meters",
              "data.fastaug", "data.yolo_aug", "data.transforms",
              "ops.color", "cli.train", "models.rcnn_loss", "models.quant",
              "models.quant_ssd", "parallel.mesh", "utils.profiling"):
        assert "edgeml_tpu_torch." + m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib')) or m == 'edgeml_tpu' "
        "or m.startswith('edgeml_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", res.stdout


# import statements and dynamic imports of jax or of the JAX package (a name
# that merely starts with "edgeml_tpu" must be followed by "_torch")
_BAD = re.compile(
    r"^\s*(?:import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|from\s+jaxlib\b"
    r"|import\s+edgeml_tpu(?!_torch)\b|from\s+edgeml_tpu(?!_torch)\b)"
    r"|(?:import_module|__import__)\(\s*[\"'](?:jax|edgeml_tpu(?!_torch))",
    re.MULTILINE,
)


def _sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_source_scan_rejects_jax_imports():
    files = _sources()
    assert len(files) >= 10 and os.path.isfile(files[0])
    for path in files:
        with open(path) as f:
            hits = _BAD.findall(f.read())
        assert not hits, f"{path}: {hits}"
    # the scan itself catches what it is meant to catch
    for bad in ("import jax\n", "from jax import numpy\n",
                "import edgeml_tpu.ops\n", "from edgeml_tpu import x\n",
                "importlib.import_module('edgeml_tpu.models')\n"):
        assert _BAD.search(bad), bad
    for ok in ("import edgeml_tpu_torch\n",
               "from edgeml_tpu_torch.ops import nms\n"):
        assert not _BAD.search(ok), ok


def test_run_detection_without_device_needs_cuda(tmp_path, monkeypatch):
    """With no CUDA device and no device asked for, run_detection raises
    instead of running on the CPU."""
    from edgeml_tpu_torch.models.infer import resolve_device, run_detection
    from edgeml_tpu_torch.models.yolov5 import YoloV5

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = YoloV5(num_classes=8, img_size=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_detection(net, str(tmp_path), str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert not (tmp_path / "out").exists()
    assert resolve_device("cpu") == torch.device("cpu")


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches on CUDA tensors only; it never computes a
    result for CPU tensors itself (that is the plain version's job)."""
    from edgeml_tpu_torch.ops.nms_fused import (
        MAX_K, MAX_K_BLOCKED, greedy_keep_mask_blocked_cuda,
        greedy_keep_mask_cuda,
    )

    for wrapper in (greedy_keep_mask_cuda, greedy_keep_mask_blocked_cuda):
        before = wrapper.launches
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(torch.zeros(1, 8, 4),
                    torch.zeros(1, 8, dtype=torch.bool), 0.5)
        assert wrapper.launches == before
    assert MAX_K == 1024 and MAX_K_BLOCKED == 2048
