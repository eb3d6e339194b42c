"""Calculate the offloading reward of each image of a dataset.

    python -m edgeml_tpu_torch.cli.reward WEAK_DIR STRONG_DIR LABEL_DIR SAVE_DIR --method orie

The same positional arguments and flags as the JAX package's ``reward.py``,
plus ``--device`` (default ``cuda``). Writes ``orie{E}.npz`` (float32
rewards) or ``dcsb.npz`` (integer rewards) with the keys ``reward`` and
``time``. The ensemble draw is the port's own (deterministic in ``--seed``;
see ``reward/orie.py``). ORIE deals its images over every visible CUDA
card when there are several (one card or the CPU: one device).
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np

from ..data.io import set_data
from ..device import exact_f32_cuda, resolve_device
from ..reward import compute_rewards


def main(opts):
    dev = resolve_device(opts.device)
    if dev.type == "cuda":
        exact_f32_cuda()
    iouv = np.linspace(0.5, 0.95, 10) if opts.map_range else None
    weak_data, strong_data, labels = set_data(
        opts.weak_dir, opts.strong_dir, opts.label_dir, iouv=iouv, device=dev)
    reward, execution_time = compute_rewards(
        weak_data, strong_data, labels, method=opts.method,
        num_ensemble=opts.num_ensemble, seed=opts.seed, verbose=opts.verbose,
        batch=opts.batch, device=dev, mesh="auto")
    print(f"Program takes {execution_time:.1f} seconds "
          f"({execution_time / 60:.1f}m/{execution_time / 3600:.2f}h).")
    Path(opts.save_dir).mkdir(parents=True, exist_ok=True)
    file_name = (f"orie{opts.num_ensemble}.npz" if opts.method == "orie"
                 else "dcsb.npz")
    np.savez(os.path.join(opts.save_dir, file_name), reward=reward,
             time=execution_time)


def getargs(argv=None):
    """Parse command line arguments."""
    args = argparse.ArgumentParser()
    args.add_argument('weak_dir', help="Per-image detection files of the weak (edge) detector.")
    args.add_argument('strong_dir', help="Per-image detection files of the strong (cloud) detector.")
    args.add_argument('label_dir', help="Per-image ground-truth label files.")
    args.add_argument('save_dir', help="Output directory for the reward .npz file.")
    args.add_argument('--method', type=str, default="orie", choices=['orie', 'dcsb'],
                      help="Reward definition to compute.")
    args.add_argument('--num-ensemble', type=int, default=1000,
                      help="Monte-Carlo ensemble size for 'orie' (0 computes plain ORI).")
    args.add_argument('--seed', type=int, default=0,
                      help="Seed of the ensemble draw (deterministic).")
    args.add_argument('--verbose', action='store_true', help="Print per-image rewards.")
    args.add_argument('--map-range', action='store_true',
                      help="Score with mAP@0.5:0.95 instead of mAP@0.5.")
    args.add_argument('--batch', type=int, default=None,
                      help="Images per device batch (default: sized from free device "
                           "memory, at most 1024). The rewards do not depend on it.")
    args.add_argument('--device', type=str, default="cuda",
                      help="'cuda' (default) or 'cpu'.")
    return args.parse_args(argv)


if __name__ == '__main__':
    main(getargs())
