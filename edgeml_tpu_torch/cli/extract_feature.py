"""Extract Adaptive-Feeding output features from weak-detector files.

    python -m edgeml_tpu_torch.cli.extract_feature OUTPUT_DIR SAVE_DIR LABEL_DIR [--k 25] [--dataset coco]

The same positional arguments and flags as the JAX package's
``data_processing/extract_feature.py``, plus ``--device`` (default
``cuda``; the features are built on the host). Writes
``{img}/stage24_output_features.npy`` (float64, num_class + 5k) for every
image of LABEL_DIR, byte-equal to the JAX CLI's.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

from ..data.io import extract_output_feature
from ..device import resolve_device


def main(opts):
    resolve_device(opts.device)
    num_class = 20 if opts.dataset == "voc" else 80
    img_names = ['.'.join(f.split('.')[:-1]) for f in sorted(os.listdir(opts.label_dir))]
    for img_name in img_names:
        Path(os.path.join(opts.save_dir, img_name)).mkdir(parents=True, exist_ok=True)
    new_names = sorted(
        f for f in os.listdir(opts.save_dir)
        if not os.path.isfile(os.path.join(opts.save_dir, f))
    )
    assert len(img_names) == len(new_names) and all(
        i == n for i, n in zip(img_names, new_names)
    ), "Save directory contains unexpected image sub-directories."
    extract_output_feature(opts.output_dir, opts.save_dir, num_class, opts.k)


def getargs(argv=None):
    """Parse command line arguments."""
    args = argparse.ArgumentParser()
    args.add_argument('output_dir', help="Weak-detector per-image detection files.")
    args.add_argument('save_dir', help="Feature-tree root ({img}/stage24_output_features.npy).")
    args.add_argument('label_dir', help="Label files defining the image universe.")
    args.add_argument('--k', type=int, default=25, help="Number of top boxes per feature vector.")
    args.add_argument('--dataset', type=str, default="coco", help="'coco' (80 classes) or 'voc' (20).")
    args.add_argument('--device', type=str, default="cuda",
                      help="'cuda' (default) or 'cpu'.")
    return args.parse_args(argv)


if __name__ == '__main__':
    main(getargs())
