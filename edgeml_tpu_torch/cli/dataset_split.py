"""Split a dataset into K folds for cross validation.

    python -m edgeml_tpu_torch.cli.dataset_split IMG_DIR SAVE_PATH [--num-split 5]

The same positional arguments and flags as the JAX package's
``data_processing/dataset_split.py``, plus ``--device`` (default ``cuda``;
the split itself is a host-side NumPy shuffle). Writes the (K, N) boolean
fold masks as .npy, bit-equal to the JAX CLI's for the same image count.
"""

from __future__ import annotations

import argparse
import os

from ..dataprep import split_dataset
from ..device import resolve_device


def main(opts):
    resolve_device(opts.device)
    num_img = len(os.listdir(opts.img_dir))
    split_dataset(num_img, opts.num_split, opts.save_path)


def getargs(argv=None):
    """Parse command line arguments."""
    args = argparse.ArgumentParser()
    args.add_argument('img_dir', help="Image directory whose file count sizes the split.")
    args.add_argument('save_path', help="Output .npy path for the fold masks.")
    args.add_argument('--num-split', type=int, default=5, help="Number of cross-validation folds.")
    args.add_argument('--device', type=str, default="cuda",
                      help="'cuda' (default) or 'cpu'.")
    return args.parse_args(argv)


if __name__ == '__main__':
    main(getargs())
