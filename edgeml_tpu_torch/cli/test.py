"""Test reward estimates: realized mAP against offloading ratio.

    python -m edgeml_tpu_torch.cli.test WEAK_DIR STRONG_DIR LABEL_DIR SPLIT SAVE_DIR --estimates DIR [DIR ...]

The same positional arguments and flags as the JAX package's ``test.py``,
plus ``--device`` (default ``cuda``). Writes ``test_map.npy`` of shape
(n_estimates, 11): the mAP at offloading ratios 0, 0.1, ..., 1.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np

from ..data.io import set_data
from ..device import exact_f32_cuda, resolve_device
from ..eval import test_map


def main(opts):
    dev = resolve_device(opts.device)
    if dev.type == "cuda":
        exact_f32_cuda()
    iouv = np.linspace(0.5, 0.95, 10) if opts.map_range else None
    weak_data, strong_data, labels = set_data(
        opts.weak_dir, opts.strong_dir, opts.label_dir, iouv=iouv, device=dev)
    dataset_split = np.load(opts.split_path)
    map_result = test_map(weak_data, strong_data, labels,
                          opts.estimates or [], dataset_split, device=dev)
    Path(opts.save_dir).mkdir(parents=True, exist_ok=True)
    np.save(os.path.join(opts.save_dir, "test_map.npy"), map_result)


def getargs(argv=None):
    """Parse command line arguments."""
    args = argparse.ArgumentParser()
    args.add_argument('weak_dir', help="Per-image detection files of the weak detector.")
    args.add_argument('strong_dir', help="Per-image detection files of the strong detector.")
    args.add_argument('label_dir', help="Per-image ground-truth label files.")
    args.add_argument('split_path', help="Cross-validation split .npy (from dataset_split.py).")
    args.add_argument('save_dir', help="Output directory for test_map.npy.")
    args.add_argument('--estimates', nargs='+', type=str,
                      help="One or more estimate{k}.npz directories to evaluate.")
    args.add_argument('--map-range', action='store_true',
                      help="Score with mAP@0.5:0.95 instead of mAP@0.5.")
    args.add_argument('--device', type=str, default="cuda",
                      help="'cuda' (default) or 'cpu'.")
    return args.parse_args(argv)


if __name__ == '__main__':
    main(getargs())
