"""Training-curve figure of the CNN estimator (a copy of the JAX package's
``estimators/plotting.py``)."""

from __future__ import annotations

import numpy as np


def cnn_plot(train_loss, test_loss, test_epoch, lr_schedule, index, out_dir="."):
    """Save cnn_training{index}.pdf with train/val loss curves, the minimum
    validation point, and the LR-drop epochs."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(15, 10))
    ax.grid(True, color="#C0C0C0")
    ax.set_xlabel("Number of Epochs", labelpad=25, color="#333333", size=40)
    ax.set_ylabel("Model Loss", labelpad=30, color="#333333", size=35)
    ax.tick_params(axis="both", labelsize=35)
    epochs = np.arange(len(train_loss)) + 1
    ax.plot(epochs, train_loss, linewidth=3, color="red", marker="o",
            markersize=15, label="train error")
    if len(test_loss):
        te = np.arange(1, len(train_loss) + 1, test_epoch)[: len(test_loss)]
        ax.plot(te, test_loss, linewidth=3, color="blue", marker="o",
                markersize=15, label="test error")
        mi = int(np.argmin(test_loss))
        ax.scatter(test_epoch * mi + 1, test_loss[mi], c="orange", s=200,
                   zorder=3, label="min test error")
    lo = min(np.min(train_loss), np.min(test_loss)) if len(test_loss) else np.min(train_loss)
    hi = max(np.max(train_loss), np.max(test_loss)) if len(test_loss) else np.max(train_loss)
    for i, m in enumerate(lr_schedule):
        (line,) = ax.plot([m, m], [lo, hi], linewidth=3, color="black")
        if i == 0:
            line.set_label("lr schedule")
    ax.legend(fontsize=20)
    fig.tight_layout()
    fig.savefig(f"{out_dir}/cnn_training{index}.pdf", bbox_inches="tight")
    plt.close(fig)
