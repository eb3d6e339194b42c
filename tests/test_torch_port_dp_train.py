"""Training under two processes, YOLOv5 and SSDLite320: the two-rank step on
the ranks' rows of a global batch against the one-process step on the
whole batch and the two-rank train CLI against the one-process CLI, on
the CPU over gloo (RetinaNet and Faster R-CNN:
``test_torch_port_dp_train_frozen.py``).

One spawn of two ranks (``torch_mp_worker.py train``) runs, per family,
SGD steps of ``TrainStep`` (YOLOv5n two, SSDLite one) from the same seeded
net on 2 of the 4 rows of a 64-px batch, then the train CLI (``--augment yolo --ema``, global
batch 4 over 8 images: two steps) with a save directory of each rank's
own. Here the same steps run in one process on all 4 rows, and the CLI on
the same data.

Tolerances and why. The two ranks compute the whole-batch step in another
rounding: BatchNorm moments from float64 sums of the ranks' parts against
one f32 two-pass reduction, loss normalisers summed over the ranks, and
gradients summed over two halves. Each set of tensors (statistics,
parameters, updates, optimiser trace) is held to the largest value of the
set, not tensor by tensor: BatchNorm shifts whose exact gradient is 0 hold
rounding noise (~1e-9) and nothing else.
  * loss and parts, both families: 1e-5 relative (measured 2e-6);
  * BatchNorm running statistics, both families: 1e-4 (measured 2e-6);
  * YOLOv5n over two steps: parameters 1e-4 (measured 9e-7), the update
    (parameters minus their start) and the momentum trace 1e-3 (measured
    6e-5 and 1.1e-4);
  * SSDLite, one step: the update in norm, all tensors at once, within 2x
    the one-process step's own spread, its change when the images are
    scaled by 1 + 1e-7 (measured: both 4.8%). At 64 px its BatchNorms on
    1x1 maps over 4 images make the step chaotic: a ReLU6 kink crossed by
    one rounding moves the gradient (``test_torch_port_train_step_ssd.py``
    finds the same against the JAX package);
  * the CLI's checkpoint (YOLOv5n, model and EMA): 1e-4 (measured 6e-6).
"""

import os
import pickle

import numpy as np
import pytest
import torch

from edgeml_tpu_torch.cli import train as train_cli

from test_torch_port_train_cli import write_dataset
from torch_mp_worker import NPROC, TRAIN_STEPS, run_steps, spawn, \
    train_cli_args, train_nets

torch.set_num_threads(1)

BATCH = 4
LOSS_TOL = 1e-5
STATE_TOL = 1e-4
UPDATE_TOL = 1e-3
SSD_SPREAD = 2.0


def _batch(seed, nc=4, t=5, s=64):
    rng = np.random.default_rng(seed)
    x = rng.random((BATCH, s, s, 3)).astype(np.float32)
    tg = np.zeros((BATCH, t, 5), np.float32)
    tg[..., 0] = rng.integers(0, nc, (BATCH, t))
    tg[..., 1:3] = rng.uniform(0.2, 0.8, (BATCH, t, 2))
    tg[..., 3:5] = rng.uniform(0.1, 0.5, (BATCH, t, 2))
    valid = np.ones((BATCH, t), bool)
    valid[1, -1] = valid[3, -2:] = False
    return x, tg, valid


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_train")
    batches = {"yolo": _batch(1), "ssd": _batch(2)}
    for family, (x, tg, valid) in batches.items():
        np.savez(root / f"batch_{family}.npz", x=x, tg=tg, valid=valid)
    write_dataset(root)
    outs = spawn("train", root)
    ranks = []
    for r in range(NPROC):
        with open(root / f"train_{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    start, one = {}, {}
    for family, net in train_nets():
        start[family] = {k: v.detach().numpy().copy()
                         for k, v in net.state_dict().items()}
        one[family] = run_steps(net, *batches[family], TRAIN_STEPS[family])
    # SSDLite's own spread: the one-process step on the images scaled by
    # 1 + 1e-7
    x, tg, valid = batches["ssd"]
    nudged = run_steps(train_nets()[1][1], x * np.float32(1 + 1e-7), tg,
                       valid, TRAIN_STEPS["ssd"])
    one["ssd_spread"] = _update_err(nudged["state"], one["ssd"]["state"],
                                    start["ssd"])
    cli_one = train_cli.main(train_cli.getargs(train_cli_args(
        root, str(root / "cli_one"), ("--augment", "yolo", "--ema"))))
    return root, outs, ranks, start, one, cli_one


def _update_err(got, want, w0):
    """|update(got) - update(want)| / |update(want)| over every trained
    tensor at once (the update: the state minus ``w0``)."""
    keys = [k for k in want if np.issubdtype(want[k].dtype, np.floating)
            and not k.endswith(("running_mean", "running_var"))]
    d_got = np.concatenate([(got[k] - w0[k]).ravel() for k in keys])
    d_want = np.concatenate([(want[k] - w0[k]).ravel() for k in keys])
    return float(np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want))


def _close_all(pairs, tol, what):
    """Every (name, got, want) within ``tol`` of the largest |want| of the
    set: tensors whose exact value is 0 (a BatchNorm shift with no
    gradient) hold rounding noise only."""
    scale = max(float(np.abs(w).max()) for _, _, w in pairs)
    name, err = max(((n, float(np.abs(g - w).max())) for n, g, w in pairs),
                    key=lambda t: t[1])
    assert err <= tol * scale, f"{what} {name}: {err:.3g} > {tol} x {scale:.3g}"


@pytest.mark.parametrize("family", ["yolo", "ssd"])
def test_loss_parts_match_the_whole_batch_step(trained, family):
    _, _, ranks, _, one, _ = trained
    for rank in ranks:
        for got, want in zip(rank[family]["losses"], one[family]["losses"]):
            assert set(got) == set(want)
            for k in want:
                assert got[k] == pytest.approx(want[k], rel=LOSS_TOL), k


@pytest.mark.parametrize("family", ["yolo", "ssd"])
def test_weights_and_statistics_match_the_whole_batch_step(trained, family):
    _, _, ranks, start, one, _ = trained
    want, w0 = one[family]["state"], start[family]
    for rank in ranks:
        got = rank[family]["state"]
        assert set(got) == set(want)
        stats = [k for k in want if k.endswith(("running_mean",
                                                 "running_var"))]
        params = [k for k in want if k not in stats
                  and np.issubdtype(want[k].dtype, np.floating)]
        assert len(stats) > 20 and len(params) > 20
        _close_all([(k, got[k], want[k]) for k in stats], STATE_TOL,
                   "statistics")
        if family == "ssd":
            spread = one["ssd_spread"]
            assert 0 < _update_err(got, want, w0) <= SSD_SPREAD * spread
            continue
        _close_all([(k, got[k], want[k]) for k in params], STATE_TOL,
                   "parameters")
        _close_all([(k, got[k] - w0[k], want[k] - w0[k]) for k in params],
                   UPDATE_TOL, "update")
        trace = one[family]["trace"]
        _close_all([(k, rank[family]["trace"][k], v)
                    for k, v in trace.items()], UPDATE_TOL, "trace")
    # the two ranks hold the same weights, bit for bit
    for k in want:
        np.testing.assert_array_equal(ranks[0][family]["state"][k],
                                      ranks[1][family]["state"][k])


def test_cli_rank_zero_alone_writes_the_checkpoint(trained):
    root, outs, _, _, _, _ = trained
    assert sorted(os.listdir(root / "cli_rank0")) == ["checkpoint.pth",
                                                      "model_0.pth"]
    assert not os.path.exists(root / "cli_rank1")
    assert sum("[distributed] backend=gloo" in o for o in outs) == 1


def test_cli_two_ranks_match_one_process(trained):
    root, _, _, _, _, cli_one = trained
    with open(root / "cli_0.pkl", "rb") as f:
        got = pickle.load(f)
    assert got["ema_n"] == cli_one["ema"].n_updates == 2
    assert got["epoch_loss"][0] == pytest.approx(cli_one["epoch_loss"][0],
                                                 rel=LOSS_TOL)
    with open(root / "cli_rank0" / "checkpoint.pth", "rb") as f:
        two = pickle.load(f)
    with open(root / "cli_one" / "checkpoint.pth", "rb") as f:
        one_ck = pickle.load(f)
    for part in ("model", "ema"):
        for tree in ("params", "stats"):
            flat_two = _flatten(two[part][tree])
            flat_one = _flatten(one_ck[part][tree])
            assert flat_two.keys() == flat_one.keys()
            assert len(flat_one) > 50
            _close_all([(k, flat_two[k], w) for k, w in flat_one.items()],
                       STATE_TOL, f"{part}.{tree}")


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix: np.asarray(tree)}
