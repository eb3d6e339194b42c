"""The two packages' train and detect CLIs on Faster R-CNN, each on the
other's checkpoints, as ``test_torch_port_train_cli_retina.py`` runs them
for RetinaNet (VOC, 64 px, batch 2 over 2 images, 2 steps, --ema). The
port's CLI draws its RoI sampling ranks as the JAX train CLI does: its key
``PRNGKey(--seed)`` split once a step, the step's key spent by
``faster_rcnn_loss`` (``test_torch_port_rcnn_loss.jax_draws``).

Both CLIs resume (--resume) the same weights at epoch 0, each from its own
package's checkpoint: the JAX init with its frozen statistics and biases
spread from a seed (``test_torch_port_faster_rcnn._spread``). An untrained
box head scores every proposal alike (within 1e-5 of one value, about 1e-7
apart, where the two packages' scores differ by 1e-6), so the final
suppression's near-ties decide rows at the 100-row cap. From the seed-0
init two steps leave one near-duplicate pair 0.8 px apart, which the
cross test's pairing takes for one row; from the spread weights the ties
only swap rows at the cap: 4 of 100 unpaired measured, each direction,
under the 5% the rule allows, the paired rows' conf within 7.9e-7 and
boxes within 1.2e-5 px.

Tolerances as that file's (losses 1e-5 relative: 0 and 6.6e-8 measured;
detections paired by the cross test's rule). About 95 s on one thread:
the JAX package's train step compiles for 30 s of it.
"""

import jax
import numpy as np
import pytest
import torch

import edgeml_tpu.models.faster_rcnn as jfr
from edgeml_tpu.models import train as jtrain
from edgeml_tpu_torch.models import train as ttrain
from edgeml_tpu_torch.models.engine import make_detector
from test_torch_port_faster_rcnn import _numpy_tree, _spread
from test_torch_port_rcnn_loss import jax_draws
from test_torch_port_train_cli_retina import (
    EPOCHS, IMG, check_files, check_losses, detect_both, run_both,
)

torch.set_num_threads(1)


def jax_cli_draws():
    """A draw_fn replaying the JAX train CLI's keys at seed 0."""
    state = {"key": jax.random.PRNGKey(0)}

    def draw(b, n_rpn, n_roi, device):
        state["key"], sub = jax.random.split(state["key"])
        return jax_draws(sub, b, n_rpn, n_roi)

    return draw


def start_checkpoints(root):
    """The spread weights at epoch 0 as each package's checkpoint."""
    params = _spread(jfr.FasterRCNN(num_classes=21, image_size=IMG).init(
        jax.random.PRNGKey(0)), np.random.default_rng(9))
    cfg = jtrain.TrainConfig(epochs=EPOCHS + 1)
    jpath, tpath = root / "start_jax.pth", root / "start_port.pth"
    jtrain.save_checkpoint(str(jpath), params, None,
                           jtrain.make_optimizer(cfg).init(params), cfg, 0)
    net = make_detector("faster_rcnn", 20, IMG).from_jax_params(
        _numpy_tree(params))
    tcfg = ttrain.TrainConfig(epochs=EPOCHS + 1)
    ttrain.save_checkpoint(str(tpath), net, ttrain.make_optimizer(tcfg, net),
                           tcfg, 0)
    return jpath, tpath


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("frcnn_cli")
    return root, run_both(root, "faster_rcnn", port_draws=jax_cli_draws,
                          resume=start_checkpoints(root))


def test_losses_match_jax_cli(runs):
    check_losses("faster_rcnn", runs[1])


def test_same_files_and_trees(runs):
    check_files(runs[0], names=("checkpoint.pth",))


def test_port_detect_serves_jax_checkpoint(runs, capsys):
    root, (_, _, img_dir) = runs
    detect_both(root, "jax", "faster_rcnn", img_dir, capsys)


def test_jax_detect_serves_port_checkpoint(runs, capsys):
    root, (_, _, img_dir) = runs
    detect_both(root, "port", "faster_rcnn", img_dir, capsys)
