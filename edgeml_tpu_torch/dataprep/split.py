"""K-fold dataset splitter (a copy of the JAX package's ``dataprep/split.py``).

The split is a NumPy ``RandomState(seed)`` shuffle and stays on the host on
purpose: split files are bit-equal to the JAX package's and interchange.
"""

from __future__ import annotations

import numpy as np


def split_dataset(n_img: int, n_split: int, save_path: str | None = None,
                  seed: int = 0):
    """Split n_img images into n_split boolean fold masks (n_split, n_img).

    Fold s holds the shuffled indices [s::n_split]; the masks are disjoint
    and cover the dataset. Saved as .npy when save_path is given.
    """
    assert n_split >= 1, "Please split the dataset into at least 2 folds."
    assert n_img >= n_split, "Please set a smaller number of splits."
    rstate = np.random.RandomState(seed)
    order = np.arange(n_img)
    rstate.shuffle(order)
    split = np.zeros((n_split, n_img), dtype=bool)
    for s in range(n_split):
        split[s, order[s::n_split]] = True
    if save_path is not None:
        np.save(save_path, split)
    return split
