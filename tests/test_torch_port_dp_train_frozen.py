"""Training under two processes, RetinaNet and Faster R-CNN (ResNet50-FPN-v2,
full width): the two-rank step on the ranks' rows of a global batch against
the one-process step on the whole batch, and the two-rank Faster R-CNN
train CLI against the one-process CLI, on the CPU over gloo.

One start of two ranks (``torch_mp_worker.py train_frozen``) runs:

  * RetinaNet's ``retina_loss`` on each rank's 2 of 4 rows of seeded head
    outputs over a 64-px image's 774 anchors (4 classes + background). Each
    rank's value is its share of the global mean, so the ranks' values add
    up to the JAX package's ``retina_loss`` on all 4 rows. The JAX function
    runs op by op: compiled with ``jax.jit`` at these shapes, its
    ``retina_match`` drops 3 of image 1's low-quality matches (an equality
    of IoUs, ``iou == gt_best``, that the compiled code rounds apart), and
    the batch's loss reads 13.543 where op by op and the port give 12.946
    (image 1 alone: 15.281 compiled, 12.893 op by op and in the port);
  * two f32 SGD steps of each family (64 px, 4 classes + background, Faster
    R-CNN keeping 64 proposals an image) on 2 of the 4 rows of one batch.
    Faster R-CNN's sampling draws are the JAX package's own for the whole
    batch (``test_torch_port_rcnn_loss.jax_draws``, one key a step): the
    step asks for the global batch's draws and keeps its rank's rows;
  * the Faster R-CNN train CLI (VOC labels, global ``-b 4`` over 8 images:
    two steps, its draws from ``--seed``) with a save directory of each
    rank's own, then, on rank 0, the detect CLI on its checkpoint.

Beside them one process runs the same train CLI without a process group
(``frcnn_cli_one``), and this process runs the same steps on all 4 rows
(``TrainStep`` in one process, which ``test_torch_port_train_step_retina.py``
and ``_train_step_frcnn.py`` hold against the JAX package).

Tolerances, those of ``test_torch_port_dp_train.py``; the ranks compute the
whole-batch step in another rounding (the batch mean as a sum over two
halves, the gradients summed over two halves):
  * RetinaNet's loss shares summed, against the JAX package: 1e-6
    relative;
  * loss and parts of each step: 1e-5 relative;
  * parameters 1e-4, the update (parameters minus their start) and the
    momentum trace 1e-3, each set of tensors held to its largest value;
  * the two ranks' weights and traces bit-equal (SHA-256 digests);
  * the CLI: per-step losses 1e-5 relative, the checkpoint's parameters
    1e-4 of their largest value; rank 0 alone writes.
Measured: the loss shares 0 and 3.8e-8 from the JAX values; parameters
and update 1.2e-7 (RetinaNet) and 1.0e-7 (Faster R-CNN) off, the traces
5.2e-6 of 6.8 and 1.0e-5 of 1.3; the CLI's losses 6.1e-8 and 0 apart,
its checkpoint 3.7e-9 off. About 75 s: the one-process CLI (the box
head over 512 sampled RoIs an image at the CLI's 1000 proposals, about
55 s on one thread) runs beside the two ranks and sets the file's time.
"""

import os
import pickle
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgeml_tpu.models import retinanet as jretina
from edgeml_tpu_torch.models import retinanet as tretina
from edgeml_tpu_torch.models.engine import _to_xyxy_px
from edgeml_tpu_torch.models.faster_rcnn import PRE_NMS, rpn_anchors
from edgeml_tpu_torch.models.rcnn_loss import Draws

from test_torch_port_dp_train import (
    LOSS_TOL, STATE_TOL, UPDATE_TOL, _batch, _flatten,
)
from test_torch_port_rcnn_loss import jax_draws
from test_torch_port_train_cli import write_dataset
from torch_mp_worker import (
    FROZEN_LR, FROZEN_POST_NMS, FROZEN_STEPS, NPROC, frozen_nets,
    load_draws, run_steps, solo, start, wait,
)

torch.set_num_threads(1)

SIZE, NC = 64, 5  # 4 classes + background
RETINA_LOSS_TOL = 1e-6
FAMILIES = ["retina", "frcnn"]
TIMEOUT = 300


def retina_loss_inputs(seed, b=4, a=774):
    """Seeded head outputs over the 64-px anchors and the batch's targets
    as the engine converts them (pixel xyxy, 1-based classes)."""
    rng = np.random.default_rng(seed)
    _, tg, valid = _batch(seed)
    boxes, labels = _to_xyxy_px(torch.from_numpy(tg), SIZE)
    return {"cls": rng.normal(-3.0, 2.0, (b, a, NC)).astype(np.float32),
            "reg": rng.normal(0, 0.4, (b, a, 4)).astype(np.float32),
            "boxes": boxes.numpy(), "labels": labels.numpy(),
            "valid": valid}


def jax_retina_loss(d):
    """The JAX package's ``retina_loss`` on the whole batch, op by op (see
    the module's docstring for why not compiled)."""
    anchors = tretina.retina_anchors(SIZE)
    assert len(anchors) == d["cls"].shape[1]
    total, parts = jretina.retina_loss(
        jretina.RetinaNet(num_classes=NC, image_size=SIZE),
        *(jnp.asarray(d[k]) for k in ("cls", "reg")), jnp.asarray(anchors),
        *(jnp.asarray(d[k]) for k in ("boxes", "labels", "valid")))
    return {"total": float(total), **{k: float(v) for k, v in parts.items()}}


def frcnn_draws(t):
    """The JAX package's draws for the whole batch, one key a step."""
    anchors = rpn_anchors(SIZE)
    n_rpn = sum(len(a) for a in anchors)
    n_roi = min(FROZEN_POST_NMS,
                sum(min(PRE_NMS, len(a)) for a in anchors)) + t
    return [jax_draws(jax.random.PRNGKey(200 + k), 4, n_rpn, n_roi)
            for k in range(FROZEN_STEPS)]


def _worst(pairs):
    """(name, largest |got - want|, largest |want|) over (name, got, want)
    triples: a set of tensors held to its largest value."""
    scale = max(float(np.abs(w).max()) for _, _, w in pairs)
    name, err = max(((n, float(np.abs(g - w).max())) for n, g, w in pairs),
                    key=lambda t: t[1])
    return name, err, scale


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_train_frozen")
    x, tg, valid = _batch(5)
    np.savez(root / "batch_frozen.npz", x=x, tg=tg, valid=valid)
    loss_in = retina_loss_inputs(6)
    np.savez(root / "retina_loss.npz", **loss_in)
    draws = frcnn_draws(tg.shape[1])
    for k, d in enumerate(draws):
        np.savez(root / f"draws_{k}.npz",
                 **{f: v.numpy() for f, v in d._asdict().items()})
    write_dataset(root)
    (root / "serve").mkdir()
    first = sorted(os.listdir(root / "images"))[0]
    shutil.copy(root / "images" / first, root / "serve")

    ranks, one_cli = start("train_frozen", root), solo("frcnn_cli_one", root)
    procs = ranks + one_cli
    try:
        # beside the ranks: the JAX loss and the one-process steps
        want_loss = jax_retina_loss(loss_in)
        one, w0, errs = {}, {}, {}
        for family, net in frozen_nets():
            w0[family] = {k: v.detach().numpy().copy()
                          for k, v in net.state_dict().items()}
            one[family] = run_steps(
                net, x, tg, valid, FROZEN_STEPS, FROZEN_LR[family],
                [load_draws(root / f"draws_{k}.npz")
                 for k in range(FROZEN_STEPS)]
                if family == "frcnn" else None)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    outs = wait(ranks, TIMEOUT)
    wait(one_cli, TIMEOUT)

    ranks = []
    for r in range(NPROC):
        with open(root / f"train_frozen_{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    for family in FAMILIES:
        start0 = w0.pop(family)
        want, trace = one[family]["state"], one[family]["trace"]
        with np.load(root / f"state_{family}.npz") as d:
            got = dict(d)
        with np.load(root / f"trace_{family}.npz") as d:
            got_trace = dict(d)
        assert got.keys() == want.keys() and got_trace.keys() == trace.keys()
        params = [k for k in want
                  if np.issubdtype(want[k].dtype, np.floating)]
        errs[family] = {
            "params": _worst([(k, got[k], want[k]) for k in params]),
            "update": _worst([(k, got[k] - start0[k], want[k] - start0[k])
                              for k in params]),
            "trace": _worst([(k, got_trace[k], v)
                             for k, v in trace.items()]),
            "n_params": len(params), "n_trace": len(trace)}
        print(family, {k: v for k, v in errs[family].items()
                       if k in ("params", "update", "trace")})
        os.remove(root / f"state_{family}.npz")
        os.remove(root / f"trace_{family}.npz")
        one[family] = {"losses": one[family]["losses"]}

    # the CLI's checkpoints against each other; then the large files go
    ck = []
    for d in ("cli_rank0", "cli_one"):
        with open(root / d / "checkpoint.pth", "rb") as f:
            ck.append(_flatten(pickle.load(f)["model"]["params"]))
    assert ck[0].keys() == ck[1].keys() and len(ck[1]) > 100
    cli = {"checkpoint": _worst([(k, ck[0][k], w)
                                 for k, w in ck[1].items()]),
           "written": sorted(os.listdir(root / "cli_rank0"))}
    print("frcnn cli checkpoint", cli["checkpoint"])
    del ck
    for d in ("cli_rank0", "cli_one"):
        shutil.rmtree(root / d)
    return dict(root=root, outs=outs, ranks=ranks, one=one, errs=errs,
                want_loss=want_loss, draws=draws, cli=cli)


def test_retina_loss_shares_sum_to_jax(trained):
    want = trained["want_loss"]
    shares = [r["retina_loss"] for r in trained["ranks"]]
    assert set(want) == {"total", "classification", "bbox_regression"}
    for k, w in want.items():
        got = sum(s[k] for s in shares)
        print(f"retina_loss {k}: {abs(got - w) / w:.2e}")
        assert w > 0.01 and got == pytest.approx(w, rel=RETINA_LOSS_TOL), k
        # each rank holds a share, not the whole
        assert all(0 < s[k] < w for s in shares), k


def test_frcnn_draws_are_the_whole_batch(trained):
    # the injected draws were asked for at the global batch size (the
    # worker's draw_fn asserts the shape) and differ between the halves,
    # so a rank that kept the wrong rows would not match one process
    for d in trained["draws"]:
        assert isinstance(d, Draws) and d.rpn_pos.shape[0] == 4
        assert not torch.equal(d.roi_pos[:2], d.roi_pos[2:])


@pytest.mark.parametrize("family", FAMILIES)
def test_loss_parts_match_the_whole_batch_step(trained, family):
    want = trained["one"][family]["losses"]
    assert len(want) == FROZEN_STEPS
    for rank in trained["ranks"]:
        got = rank[family]["losses"]
        assert len(got) == FROZEN_STEPS
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                assert g[k] == pytest.approx(w[k], rel=LOSS_TOL), (k, g, w)


@pytest.mark.parametrize("family", FAMILIES)
def test_weights_and_trace_match_the_whole_batch_step(trained, family):
    errs = trained["errs"][family]
    assert errs["n_params"] > 100 and errs["n_trace"] > 100
    for what, tol in (("params", STATE_TOL), ("update", UPDATE_TOL),
                      ("trace", UPDATE_TOL)):
        name, err, scale = errs[what]
        assert err <= tol * scale, f"{what} {name}: {err:.3g} > {tol} x " \
                                   f"{scale:.3g}"
    # the two ranks hold the same weights and trace, bit for bit
    digests = [r[family]["digests"] for r in trained["ranks"]]
    assert digests[0] == digests[1] and len(digests[0]) == NPROC
    assert digests[0][0] == digests[0][1]


def test_frcnn_cli_two_ranks_match_one_process(trained):
    root = trained["root"]
    runs = []
    for name in ("cli_0", "cli_1", "cli_one"):
        with open(root / f"{name}.pkl", "rb") as f:
            runs.append(pickle.load(f))
    want = runs[2]["losses"]
    assert len(want) == 2  # 8 images at a global batch of 4
    for run in runs[:2]:
        print("frcnn cli losses", run["losses"], want)
        assert run["losses"] == pytest.approx(want, rel=LOSS_TOL)
    assert runs[0]["digest"] == runs[1]["digest"]
    name, err, scale = trained["cli"]["checkpoint"]
    assert err <= STATE_TOL * scale, name


def test_frcnn_cli_rank_zero_alone_writes(trained):
    root, outs = trained["root"], trained["outs"]
    assert trained["cli"]["written"] == ["checkpoint.pth", "model_0.pth"]
    assert not os.path.exists(root / "cli_rank1")
    assert sum("[distributed] backend=gloo" in o for o in outs) == 1


def test_detect_cli_serves_the_two_rank_checkpoint(trained):
    root = trained["root"]
    files = os.listdir(root / "served")
    assert files == os.listdir(root / "serve")
    rows = np.load(root / "served" / files[0])
    assert rows.ndim == 2 and rows.shape[1] == 6 and np.isfinite(rows).all()
    assert ((rows[:, 0] >= 0) & (rows[:, 0] < 20)).all()
    assert ((rows[:, 5] > 0) & (rows[:, 5] <= 1)).all()
