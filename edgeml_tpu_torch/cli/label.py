"""Convert a dataset's annotations into YOLO-format label files.

    python -m edgeml_tpu_torch.cli.label DATA_DIR SAVE_DIR [--dataset coco|voc]

The same positional arguments and flag as the JAX package's
``data_processing/label.py``, and the same files, byte for byte:
``{SAVE_DIR}/{split}{year}/{image}.txt`` with one "cls x y w h" row per
object (normalised xywh-center). COCO reads
``annotations/instances_{train,val}2017.json`` under DATA_DIR; VOC reads
``VOCdevkit/VOC{2007,2012}``. Host-only: no device is involved.
"""

from __future__ import annotations

import argparse

from ..dataprep import coco_label, voc_label


def main(opts):
    if opts.dataset == 'coco':
        coco_label(opts.data_dir, opts.save_dir)
    else:
        voc_label(opts.data_dir, opts.save_dir)


def getargs(argv=None):
    """Parse command line arguments."""
    args = argparse.ArgumentParser()
    args.add_argument('data_dir', help="Dataset root (COCO with annotations/, or VOC with VOCdevkit/).")
    args.add_argument('save_dir', help="Output root for per-split label directories.")
    args.add_argument('--dataset', type=str, default="coco", help="Annotation format: 'coco' or 'voc'.")
    return args.parse_args(argv)


if __name__ == '__main__':
    main(getargs())
