"""Train a detector from scratch.

    python -m edgeml_tpu_torch.cli.train IMG_DIR SAVE_DIR --label-dir LABELS \
        --model yolov5n --dataset voc

The same positional arguments and flags as the reference package's
``tpu_models/train.py``, plus ``--device`` (default ``cuda``; without a
CUDA device it raises unless ``--device cpu`` is given). Families:
``yolov5n``..``yolov5x``, ``ssd`` (SSDLite320-MobileNetV3-Large),
``retinanet`` (RetinaNet-ResNet50-FPN-v2) and ``faster_rcnn`` (Faster
R-CNN-ResNet50-FPN-v2, its RoI sampling drawn from a generator seeded with
``--seed``). Trains on one device.

Data: images plus YOLO-format label files (``--label-dir``), or a raw
VOCdevkit tree (``--voc-root``, 07+12 trainval). Images stream from disk
per batch in prefetching worker threads; the epoch's shuffle is
``np.random.default_rng(seed).permutation``. ``--augment``: none, flip,
ssd (photometric + zoom-out + IoU crop + flip) or yolo (mosaic-4 +
scale/translate + HSV + flip, the jitter on the device, on the host or off
by ``--yolo-hsv``). ``--preset yolo`` takes the ultralytics optimiser
recipe, ``--ema`` keeps a decay-ramped shadow of the model, ``--bf16``
trains in bfloat16 mixed precision.

Writes ``checkpoint.pth`` every epoch and ``model_{epoch}.pth`` every 10th:
pickles of {model, optimizer, lr_scheduler, args, epoch[, ema]} with the
model in the reference package's tree layout, so either package's detect
CLI serves them.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

def _build_augment(name: str):
    """The host augmentation of ``--augment`` none, flip or ssd."""
    if name in ("", "none"):
        return None
    from ..data.transforms import (
        Compose, RandomHorizontalFlip, RandomIoUCrop,
        RandomPhotometricDistort, RandomZoomOut,
    )

    if name == "flip":
        return Compose([RandomHorizontalFlip(0.5)])
    if name == "ssd":
        return Compose([
            RandomPhotometricDistort(),
            RandomZoomOut(),
            RandomIoUCrop(),
            RandomHorizontalFlip(0.5),
        ])
    raise ValueError(f"unknown --augment '{name}' (none | flip | ssd | yolo)")


def main(opts):
    """Train; returns {"epoch_loss": per-epoch mean losses, "state": the
    net, "ema": the EMA (or None), "loggers": each epoch's MetricLogger}."""
    from ..data.io import list_image_names, load_data
    from ..data.loader import iter_batches, list_images, resize_bilinear
    from ..device import exact_f32_cuda, resolve_device
    from ..models.common import letterbox_batch
    from ..models.engine import (
        make_detector, make_family_train_step, train_one_epoch,
    )
    from ..models.train import (
        ModelEMA, TrainConfig, load_checkpoint, load_jax_tree, lr_at,
        pad_targets, save_checkpoint, yolo_recipe_config,
    )

    dev = resolve_device(opts.device)
    if dev.type == "cuda":
        exact_f32_cuda()
    if opts.preset == "yolo":
        cfg = yolo_recipe_config(epochs=opts.epochs)
        print(f"--preset yolo: using the ultralytics optimizer recipe {cfg}")
    else:
        cfg = TrainConfig(
            opt=opts.opt,
            lr=opts.lr,
            momentum=opts.momentum,
            weight_decay=opts.weight_decay,
            lr_scheduler=opts.lr_scheduler,
            lr_steps=tuple(opts.lr_steps),
            lr_gamma=opts.lr_gamma,
            epochs=opts.epochs,
        )
    num_classes = 20 if opts.dataset == "voc" else 80
    net = make_detector(opts.model, num_classes, opts.img_size,
                        generator=torch.Generator().manual_seed(0))
    net.to(dev).train()
    is_yolo = opts.model.startswith("yolov5")
    size = net.img_size if is_yolo else net.image_size
    opt, step = make_family_train_step(
        net, cfg, dtype=torch.bfloat16 if opts.bf16 else None,
        seed=opts.seed)

    ema = None
    ema_payload = None
    if opts.resume:
        params, stats, opt_state, payload = load_checkpoint(opts.resume)
        load_jax_tree(net, params, stats)
        opt.load_state_dict(opt_state)
        opts.start_epoch = payload["epoch"] + 1
        ema_payload = payload.get("ema")
    if opts.ema:
        ema = ModelEMA(net)
        if ema_payload is not None:
            ema.n_updates = int(ema_payload["n_updates"])
            load_jax_tree(ema.module, ema_payload["params"],
                          ema_payload.get("stats"))

    if opts.voc_root:
        # raw VOC XML annotations, 07+12 trainval, no label conversion
        from ..dataprep.labels import voc_examples

        files, raw_labels = voc_examples(
            opts.voc_root, splits=(("2007", "trainval"), ("2012", "trainval")))
        img_dir = ""  # the files are absolute paths
    else:
        if not opts.label_dir:
            raise SystemExit("--label-dir is required without --voc-root")
        img_dir = opts.img_dir
        names = list_image_names(opts.label_dir)
        by_stem = {".".join(f.split(".")[:-1]) or f: f
                   for f in list_images(opts.img_dir)}
        missing = [n for n in names if n not in by_stem]
        if missing:
            raise SystemExit(f"labels without images: {missing[:5]}...")
        files = [by_stem[n] for n in names]
        raw_labels = load_data(opts.label_dir, names, with_conf=False)

    def rows_for(lab, img, meta_i=None):
        cls, xyxy = lab
        if len(cls) == 0:
            return np.zeros((0, 5), np.float32)
        if meta_i is None:  # a plain square resize keeps normalised coords
            x1, y1, x2, y2 = xyxy.T
        else:  # remap into letterbox space
            r, dw, dh = meta_i
            h, w = img.shape[:2]
            x1 = (xyxy[:, 0] * w * r + dw) / size
            y1 = (xyxy[:, 1] * h * r + dh) / size
            x2 = (xyxy[:, 2] * w * r + dw) / size
            y2 = (xyxy[:, 3] * h * r + dh) / size
        return np.stack(
            [cls, (x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], 1
        ).astype(np.float32)

    yolo_aug = opts.augment == "yolo"
    if yolo_aug and not is_yolo:
        raise SystemExit("--augment yolo is the YOLOv5 training recipe; "
                         "use it with a yolov5* model")
    hsv_arg = "device" if opts.yolo_hsv == "device" \
        else opts.yolo_hsv == "host"
    augment = None if yolo_aug else _build_augment(opts.augment)
    epoch_state = {"epoch": 0}  # read by loader threads between epochs
    file_index = {f: i for i, f in enumerate(files)}
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    empty = (np.zeros(0, np.float32), np.zeros((0, 4), np.float32))

    def example(i, im):
        """(image, (cls, xyxy normalised)) for sample i, augmented if
        asked, seeded per (seed, epoch, image)."""
        lab = raw_labels[i]
        cls, xyxy = lab if len(lab) else empty
        if augment is None:
            return im, (cls, xyxy)
        h, w = im.shape[:2]
        arng = np.random.default_rng([opts.seed, epoch_state["epoch"], i])
        im2, tgt = augment(
            im, {"boxes": xyxy * np.array([w, h, w, h], np.float32),
                 "labels": cls}, arng)
        h2, w2 = im2.shape[:2]
        return im2, (tgt["labels"],
                     tgt["boxes"] / np.array([w2, h2, w2, h2], np.float32))

    def make_batch(items):
        """Loader thread: augment, preprocess, remap labels, pad."""
        if yolo_aug:
            from ..data.yolo_aug import yolo_augment_batch

            ex = []
            for f, im in items:
                lab = raw_labels[file_index[f]]
                ex.append((im, lab if len(lab) else empty))
            res = yolo_augment_batch(
                ex, size,
                [opts.seed, epoch_state["epoch"], file_index[items[0][0]]],
                hsv=hsv_arg)
            targets, valid = pad_targets(res[1], opts.max_targets)
            # device-mode HSV: the per-image gains ride along
            return (res[0], targets, valid) + tuple(res[2:])
        pairs = [example(file_index[f], im) for f, im in items]
        imgs = [im for im, _ in pairs]
        labs = [lab for _, lab in pairs]
        if is_yolo:
            lb, meta = letterbox_batch(imgs, size)
            rows = [rows_for(la, im, m) for la, im, m in zip(labs, imgs, meta)]
        else:
            lb = np.stack([(resize_bilinear(im, size, size) - mean) / std
                           for im in imgs])
            rows = [rows_for(la, im) for la, im in zip(labs, imgs)]
        targets, valid = pad_targets(rows, opts.max_targets)
        return lb, targets, valid

    hsv_apply = None
    if yolo_aug and opts.yolo_hsv == "device":
        from ..ops.color import hsv_jitter as hsv_apply

    n = len(files)
    bs = opts.batch_size
    steps_per_epoch = max(n // bs, 1)

    class EpochBatches:
        """An epoch's batches on the device, in the order ``perm``, with
        the device HSV jitter applied; sized for the logger."""

        def __init__(self, perm):
            self.perm = perm

        def __len__(self):
            return n // bs

        def __iter__(self):
            for batch in iter_batches(img_dir, files, bs, make_batch,
                                      order=self.perm, prefetch=opts.prefetch,
                                      drop_last=True):
                imgs = torch.from_numpy(batch[0]).to(dev)
                if len(batch) == 4:  # device-mode HSV jitter (ops/color.py)
                    imgs = hsv_apply(imgs, torch.from_numpy(batch[3]).to(dev))
                yield (imgs, torch.from_numpy(batch[1]).to(dev),
                       torch.from_numpy(batch[2]).to(dev))

    rng = np.random.default_rng(opts.seed)
    epoch_losses, loggers = [], []
    print("Start training")
    for epoch in range(opts.start_epoch, opts.epochs):
        epoch_state["epoch"] = epoch
        logger = train_one_epoch(
            step, EpochBatches(rng.permutation(n)), epoch,
            lambda it: lr_at(cfg, epoch, it, steps_per_epoch),
            print_freq=opts.print_freq,
            after_step=None if ema is None else lambda: ema.update(net))
        if opts.save_dir:
            os.makedirs(opts.save_dir, exist_ok=True)
            if epoch % 10 == 0:
                save_checkpoint(
                    os.path.join(opts.save_dir, f"model_{epoch}.pth"),
                    net, opt, cfg, epoch, ema=ema)
            save_checkpoint(os.path.join(opts.save_dir, "checkpoint.pth"),
                            net, opt, cfg, epoch, ema=ema)
        epoch_losses.append(logger.meters["loss"].global_avg)
        loggers.append(logger)
        print(f"Epoch {epoch} finished")
    return {"epoch_loss": epoch_losses, "state": net, "ema": ema,
            "loggers": loggers}


def getargs(argv=None):
    """Parse command line arguments."""
    args = argparse.ArgumentParser()
    args.add_argument('img_dir', help="Directory of training images.")
    args.add_argument('save_dir', help="Directory to save the trained model weights.")
    args.add_argument('--label-dir', default="",
                      help="Directory of YOLO-format label .txt files (from the label CLI). "
                           "Not needed with --voc-root.")
    args.add_argument('--voc-root', default="",
                      help="Path to a VOCdevkit tree (or its parent): train directly from raw "
                           "VOC XML annotations (07+12 trainval), no label conversion stage. "
                           "Overrides img_dir/--label-dir.")
    args.add_argument('--model', type=str, default="ssd",
                      help="The object detector: 'ssd', 'faster_rcnn', "
                           "'retinanet' or 'yolov5n'..'yolov5x'.")
    args.add_argument('--dataset', type=str, default="voc", help="'voc' (20 classes) or 'coco' (80).")
    args.add_argument('-b', '--batch-size', default=32, type=int, help="Training batch size.")
    args.add_argument('--epochs', type=int, default=30, help="Total training epochs.")
    args.add_argument('--opt', default="sgd", type=str, help="'sgd' or 'adamw'.")
    args.add_argument('--lr', default=0.02, type=float, help="Base learning rate.")
    args.add_argument('--momentum', default=0.9, type=float, help="SGD momentum.")
    args.add_argument('-wd', '--weight-decay', default=1e-4, type=float, help="L2 weight decay.")
    args.add_argument('--lr-scheduler', default="multisteplr", type=str,
                      help="'multisteplr' or 'cosineannealinglr'.")
    args.add_argument('--lr-steps', default=[16, 22], nargs="+", type=int,
                      help="Epochs at which MultiStep drops the learning rate.")
    args.add_argument('--lr-gamma', default=0.1, type=float,
                      help="MultiStep decay factor per milestone.")
    args.add_argument("--resume", default="", type=str, help="Checkpoint to resume from.")
    args.add_argument("--start-epoch", default=0, type=int, help="First epoch index (with --resume).")
    args.add_argument("--img-size", default=640, type=int, help="train image size")
    args.add_argument("--max-targets", default=64, type=int, help="padded targets per image")
    args.add_argument("--print-freq", default=100, type=int, help="log every N iterations")
    args.add_argument("--prefetch", default=2, type=int,
                      help="batches decoded ahead of the device (host RAM bound: prefetch+1 batches)")
    args.add_argument("--augment", default="none",
                      choices=["none", "flip", "ssd", "yolo"],
                      help="train-time augmentation: none, flip, the ssd preset "
                           "(photometric + zoom-out + IoU crop + flip), or yolo "
                           "(mosaic-4 + scale/translate affine + HSV jitter + flip; "
                           "yolov5 models only)")
    args.add_argument("--yolo-hsv", default="device",
                      choices=["device", "host", "off"],
                      help="where --augment yolo applies its HSV jitter: on the "
                           "training device (default), on the loader host, or "
                           "disabled")
    args.add_argument("--seed", default=0, type=int,
                      help="shuffle, augmentation and RoI sampling seed")
    args.add_argument("--preset", default="", choices=["", "yolo"],
                      help="'yolo': the ultralytics optimizer recipe "
                           "(nesterov SGD 0.937, one_cycle cosine lrf=0.01, "
                           "3-epoch warmup, masked weight decay 5e-4); "
                           "overrides --opt/--lr/--momentum/-wd/"
                           "--lr-scheduler. Pair with --augment yolo --ema.")
    args.add_argument("--ema", action="store_true",
                      help="keep a decay-ramped EMA shadow of the model "
                           "(params + BN stats), checkpointed under 'ema' "
                           "and preferred by the detect CLI")
    args.add_argument("--bf16", action="store_true",
                      help="bfloat16 mixed-precision training (f32 master "
                           "weights, optimizer state, BN stats and loss)")
    args.add_argument('--device', type=str, default="cuda",
                      help="'cuda' (default) or 'cpu'.")
    return args.parse_args(argv)


if __name__ == '__main__':
    main(getargs())
