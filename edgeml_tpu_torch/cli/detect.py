"""Collect the detection outputs of a detector over an image directory.

    python -m edgeml_tpu_torch.cli.detect IMG_DIR SAVE_DIR --model yolov5n

The same positional arguments and flags as the reference package's
``tpu_models/detect.py``, plus ``--device`` (default ``cuda``). Writes one
``{image stem}.npy`` (or ``.txt``) per image of normalised
(cls, x, y, w, h, conf) rows. Ported: YOLOv5 n/s/m/l/x (native label space)
and the torchvision trio ``ssd`` (SSDLite320-MobileNetV3-Large),
``retinanet`` (RetinaNet-ResNet50-FPN-v2) and ``faster_rcnn``
(Faster R-CNN-ResNet50-FPN-v2), whose COCO (91) or VOC (21) label ids are
remapped to the compact YOLO ids; their weights load from torchvision
state_dicts by key. ``--model-path`` also takes a native training
checkpoint (the pickle that either package's train CLI writes, its model
in the reference package's tree layout), preferring its EMA shadow when it
has one. ``--int8`` serves the int8 post-training-quantized trunk of a
YOLOv5 or ``ssd`` model, calibrated on the first images of IMG_DIR; for
YOLOv5 ``--int8 --bf16`` adds the bf16 score tail. Directory (orbax)
checkpoints are not read and exit with a message.

``--data-parallel`` under several processes (``torchrun --nproc-per-node N
-m edgeml_tpu_torch.cli.detect ... --data-parallel``) serves each global
batch (``--batch-size``, a multiple of N) by rows, one device a rank, each
rank writing its own images' files; in one process it runs the
one-process path on its device.
"""

from __future__ import annotations

import argparse
import os
import zipfile

import numpy as np
import torch

from ..data.coco_labelmap import coco_to_yolov5

YOLO_MODELS = ("yolov5n", "yolov5s", "yolov5m", "yolov5l", "yolov5x")
TORCHVISION_MODELS = ("ssd", "retinanet", "faster_rcnn")


def load_state_dict(path: str):
    """A state_dict from an ``.npz`` of arrays or a ``torch.save`` archive
    (a state_dict, or a checkpoint holding a module under ``model``)."""
    if os.path.isdir(path):
        raise SystemExit(f"{path}: directory checkpoints (native JAX) are "
                         f"not yet ported")
    if path.endswith(".npz"):
        data = np.load(path, allow_pickle=False)
        return {k: data[k] for k in data.files}
    if not zipfile.is_zipfile(path):
        raise SystemExit(f"{path}: not a torch archive, an .npz or a native "
                         f"training checkpoint")
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, dict) and "model" in obj \
            and hasattr(obj["model"], "state_dict"):
        obj = obj["model"].float().state_dict()
    return obj


def load_torchvision_state_dict(net, sd):
    """Load a torchvision state_dict (tensors or arrays) by key, strictly;
    a missing BatchNorm ``num_batches_tracked`` counter is filled with 0."""
    sd = {k: v.detach().cpu() if torch.is_tensor(v)
          else torch.as_tensor(np.asarray(v)) for k, v in sd.items()}
    for key in net.state_dict():
        if key.endswith("num_batches_tracked") and key not in sd:
            sd[key] = torch.tensor(0, dtype=torch.long)
    net.load_state_dict(sd, strict=True)
    return net


def _reduced_tail(sd) -> bool:
    """An SSDLite state_dict with the reduced MobileNet tail (torchvision's
    released COCO checkpoint) holds the (480, 80, 1, 1) last-conv weight."""
    return any(tuple(getattr(v, "shape", ())) == (480, 80, 1, 1)
               for v in sd.values())


def native_weights(payload):
    """(params, stats) of a native training checkpoint's payload: the EMA
    shadow when it has one (the shipped model of the ultralytics recipe),
    else the live weights."""
    src = payload.get("ema") or payload["model"]
    which = "EMA" if "ema" in payload else "live"
    print(f"loading native checkpoint ({which} weights, epoch "
          f"{payload.get('epoch', '?')})")
    return src["params"], src.get("stats")


def load_detector(model_name: str, model_path: str, num_class: int):
    """Build a detector and load weights (random init, seed 0, with a
    warning when no path is given)."""
    if model_name not in YOLO_MODELS + TORCHVISION_MODELS:
        raise SystemExit(
            f"Model '{model_name}' is not yet ported to edgeml_tpu_torch "
            f"(ported: {', '.join(YOLO_MODELS + TORCHVISION_MODELS)}).")
    from ..models.train import load_jax_tree, read_payload

    native = read_payload(model_path) \
        if model_path and os.path.isfile(model_path) else None
    sd = load_state_dict(model_path) if model_path and native is None \
        else None
    gen = torch.Generator().manual_seed(0)
    if model_name in YOLO_MODELS:
        from ..models.yolov5 import YoloV5

        net = YoloV5(variant=model_name[-1], num_classes=num_class,
                     generator=gen)
        if sd is not None:
            net.load_ultralytics_state_dict(sd)
    elif model_name == "ssd":
        from ..models.ssdlite import SSDLite

        net = SSDLite(num_classes=num_class,
                      reduced_tail=sd is not None and _reduced_tail(sd),
                      generator=gen)
    elif model_name == "retinanet":
        from ..models.retinanet import RetinaNet

        net = RetinaNet(num_classes=num_class, generator=gen)
    else:
        from ..models.faster_rcnn import FasterRCNN

        net = FasterRCNN(num_classes=num_class, generator=gen)
    if native is not None:
        load_jax_tree(net, *native_weights(native))
    elif sd is None:
        print("WARNING: no --model-path given; using random weights.")
    elif model_name in TORCHVISION_MODELS:
        load_torchvision_state_dict(net, sd)
    return net


def main(opts):
    if opts.model in YOLO_MODELS:
        # YOLOv5 operates natively in the compact label space.
        num_class = 80 if opts.dataset == "coco" else 20
        class_map = None
    else:
        num_class = 91 if opts.dataset == "coco" else 21
        class_map = (coco_to_yolov5 if opts.dataset == "coco"
                     else {i: i - 1 for i in range(1, 21 + 1)})
    if opts.data_parallel:
        from ..parallel.mesh import initialize_distributed

        initialize_distributed(opts.device)
    net = load_detector(opts.model, opts.model_path, num_class)

    dtype = torch.bfloat16 if opts.bf16 else None
    if opts.int8:
        # --int8 --bf16 composes: the int8 trunk with the bf16 score tail
        dtype = "int8-bf16" if dtype is not None else "int8"

    from ..models.infer import run_detection

    run_detection(
        net,
        opts.img_dir,
        opts.save_dir,
        batch_size=opts.batch_size,
        conf_thres=opts.conf_thres,
        iou_thres=opts.iou_thres,
        fmt=opts.format,
        class_map=class_map,
        dtype=dtype,
        device=opts.device,
        data_parallel=opts.data_parallel,
    )


def getargs(argv=None):
    """Parse command line arguments."""
    args = argparse.ArgumentParser()
    args.add_argument('img_dir', help="Image directory to run detection over.")
    args.add_argument('save_dir', help="Output directory for per-image detection files.")
    args.add_argument('--dataset', type=str, default="coco", help="Label space: 'coco' or 'voc'.")
    args.add_argument('--model', type=str, default="ssd",
                      help="The object detector. Ported: 'yolov5n'..'yolov5x' "
                           "(native), 'ssd', 'retinanet', 'faster_rcnn' "
                           "(COCO or VOC label space, remapped).")
    args.add_argument("--model-path", type=str, default="",
                      help="Weights file (.pt state_dict, .npz, or a native training "
                           "checkpoint); empty = random init (smoke tests only).")
    args.add_argument('--batch-size', type=int, default=16, help="Inference batch size.")
    args.add_argument('--conf-thres', type=float, default=0.001, help="Confidence threshold.")
    args.add_argument('--iou-thres', type=float, default=0.6, help="NMS IoU threshold.")
    args.add_argument('--format', type=str, default="npy", choices=["npy", "txt"],
                      help="Per-image output format.")
    args.add_argument('--data-parallel', action="store_true",
                      help="Under torchrun, serve each global batch by rows "
                           "over the ranks (one device a rank); in one "
                           "process, the one-process path.")
    args.add_argument('--bf16', action="store_true",
                      help="bfloat16 serving (trunk + scores; boxes stay f32).")
    args.add_argument('--int8', action="store_true",
                      help="int8 post-training-quantized serving trunk "
                           "(YOLO and ssd; calibrated on the first batch of "
                           "img_dir). Accuracy knob: see models/quant.py "
                           "and models/quant_ssd.py. For YOLO composes "
                           "with --bf16 (int8 trunk + bf16 score tail).")
    args.add_argument('--device', type=str, default="cuda",
                      help="'cuda' (default) or 'cpu'.")
    return args.parse_args(argv)


if __name__ == '__main__':
    main(getargs())
