"""Rank worker of the port's several-process tests, and their launcher.

``spawn(scenario, out_dir)`` starts two ranks of this file on the CPU with
the environment ``torchrun`` would give them (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``),
waits for both within a timeout, kills them in any case, and returns each
rank's output (``start`` and ``wait`` apart let the caller work while the
ranks run; each rank writes its output to a log file in ``out_dir``); a
rank that fails or prints no ``TORCH_MP_OK rank=<r>`` line
fails the calling test. The ranks bring the group up with
``parallel.mesh.initialize_distributed("cpu")`` (gloo on ``127.0.0.1``),
run one scenario's checks, write what the launcher compares into
``out_dir`` and print the OK line. Scenarios:

  * ``surface``: the process layer (initialisation, ragged
    ``allgather_object``, ``all_sum``, ``shard_along``, ``replicate``), the
    meter sum, and the evaluator merge;
  * ``detect``: ``run_detection(data_parallel=True)`` in f32 and int8 on
    the weights in ``out_dir/yolo.pt``, and the detect CLI with
    ``--data-parallel``;
  * ``train``: YOLOv5 and SSDLite train steps on the ranks' rows of the
    global batch in ``out_dir/batch_*.npz`` and the train CLI;
  * ``train_frozen``: RetinaNet's loss on the ranks' rows of the head
    outputs in ``out_dir/retina_loss.npz``, RetinaNet and Faster R-CNN
    train steps on the ranks' rows of ``out_dir/batch_frozen.npz`` (Faster
    R-CNN's sampling draws for the whole batch from
    ``out_dir/draws_*.npz``), the Faster R-CNN train CLI, and (rank 0)
    the detect CLI on its checkpoint;
  * ``frcnn_cli_one`` (one process, ``solo``): the same train CLI without
    a process group, the reference of the two ranks' run.

Imports torch, numpy and ``edgeml_tpu_torch`` only: never JAX.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROC = 2
# SGD steps a family: SSDLite's 64-px trajectories part after one step in
# any two roundings (its 1x1 BatchNorms over 4 images), so it takes one
TRAIN_STEPS = {"yolo": 2, "ssd": 1}
TRAIN_LR = 0.01
# the train_frozen scenario: SGD steps, learning rates (RetinaNet's loss
# climbs from a seeded init at 0.01), Faster R-CNN's proposals an image
FROZEN_STEPS = 2
FROZEN_LR = {"retina": 1e-3, "frcnn": 0.01}
FROZEN_POST_NMS = 64
# the detect scenario's run_detection arguments
DETECT_KW = dict(batch_size=8, conf_thres=0.2, iou_thres=0.5, img_size=64)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(scenario, out_dir, env, log_name):
    """One process of this file on ``scenario``, its output to
    ``out_dir/log_name``."""
    log = os.path.join(str(out_dir), log_name)
    with open(log, "w") as f:
        p = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), scenario,
             str(out_dir)], env=env, cwd=REPO, stdout=f,
            stderr=subprocess.STDOUT)
    p.log = log
    return p


def start(scenario: str, out_dir, nproc: int = NPROC):
    """Start ``scenario`` on ``nproc`` ranks, each writing its output to
    ``out_dir/<scenario>_rank<r>.log``; ``wait`` collects them, so the
    caller may work beside them."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(nproc), LOCAL_WORLD_SIZE=str(nproc),
               OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    return [_launch(scenario, out_dir,
                    dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                    f"{scenario}_rank{r}.log") for r in range(nproc)]


def solo(scenario: str, out_dir):
    """Start ``scenario`` in one process without a launcher's environment
    (no process group); ``wait`` collects it as rank 0."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    return [_launch(scenario, out_dir, env, f"{scenario}_solo.log")]


def spawn(scenario: str, out_dir, nproc: int = NPROC, timeout: int = 240):
    """Run ``scenario`` on ``nproc`` ranks; returns their outputs."""
    return wait(start(scenario, out_dir, nproc), timeout)


def wait(procs, timeout: int = 240):
    """Each started rank's output, within ``timeout`` s; every rank is
    killed in any case."""
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for p in procs:
        with open(p.log) as f:
            outs.append(f.read())
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
        assert f"TORCH_MP_OK rank={r}" in out, out[-2000:]
    return outs


# ---------------------------------------------------------------------------
# shared by the launcher tests and the ranks


def eval_image(i):
    """Image i's (detections, ground truth) for the evaluator merge."""
    import numpy as np

    rng = np.random.default_rng(100 + i)
    n, m = 4 + i % 3, 3
    det = (rng.integers(0, 3, n).astype(np.float32),
           np.sort(rng.random((n, 4)) * 50, axis=1).astype(np.float32),
           rng.random(n).astype(np.float32))
    gt = (rng.integers(0, 3, m).astype(np.float32),
          np.sort(rng.random((m, 4)) * 50, axis=1).astype(np.float32))
    return det, gt


def eval_images_of(rank: int):
    """Rank r's images for the merge: ragged, r + 2 of them, consecutive."""
    start = sum(k + 2 for k in range(rank))
    return [eval_image(start + j) for j in range(rank + 2)]


def train_nets():
    """(family, net) pairs of the train scenario, from fixed seeds: YOLOv5n
    and SSDLite at 64 px, 4 / 5 classes."""
    import torch

    from edgeml_tpu_torch.models.engine import make_detector

    return [(f, make_detector(name, 4, 64,
                              generator=torch.Generator().manual_seed(s)))
            for f, name, s in (("yolo", "yolov5n", 3), ("ssd", "ssd", 4))]


def frozen_nets():
    """(family, net) pairs of the train_frozen scenario, full width from
    fixed seeds at 64 px, 4 classes + background: RetinaNet, and Faster
    R-CNN keeping 64 proposals an image."""
    import torch

    from edgeml_tpu_torch.models.engine import make_detector
    from edgeml_tpu_torch.models.faster_rcnn import FasterRCNN

    return [("retina", make_detector(
                "retinanet", 4, 64,
                generator=torch.Generator().manual_seed(6))),
            ("frcnn", FasterRCNN(
                num_classes=5, image_size=64, rpn_post_nms=FROZEN_POST_NMS,
                generator=torch.Generator().manual_seed(7)))]


def load_draws(path):
    """The ``Draws`` saved at ``path`` (an npz of its four fields)."""
    import numpy as np
    import torch

    from edgeml_tpu_torch.models.rcnn_loss import Draws

    with np.load(path) as d:
        return Draws(*(torch.from_numpy(d[k]) for k in Draws._fields))


def run_steps(net, images, targets, valid, steps, lr=TRAIN_LR, draws=None):
    """``steps`` SGD steps of the family's TrainStep on one batch: per step
    the loss and its parts (floats), then the net's parameters and
    BatchNorm statistics and the optimiser's trace, as NumPy arrays.
    ``draws``: Faster R-CNN's sampling draws of each step, for the whole
    global batch (the step keeps this rank's rows)."""
    import torch

    from edgeml_tpu_torch.models.engine import make_family_train_step
    from edgeml_tpu_torch.models.train import TrainConfig

    _, step = make_family_train_step(net, TrainConfig(lr=lr))
    if draws is not None:
        queue = list(draws)

        def draw_fn(b, n_rpn, n_roi, device):
            d = queue.pop(0)
            assert d.rpn_pos.shape == (b, n_rpn), (d.rpn_pos.shape, b)
            assert d.roi_pos.shape == (b, n_roi), (d.roi_pos.shape, b)
            return d

        step.draw_fn = draw_fn
    args = [torch.from_numpy(a) for a in (images, targets, valid)]
    losses = []
    for _ in range(steps):
        loss, parts = step(*args, lr)
        losses.append({"loss": float(loss),
                       **{k: float(v) for k, v in parts.items()}})
    state = {k: v.detach().numpy().copy()
             for k, v in net.state_dict().items()}
    return {"losses": losses, "state": state,
            "trace": step.opt.state_dict()["trace"]}


def train_cli_args(root, save_dir, extra=(), model="yolov5n"):
    return [os.path.join(root, "images"), save_dir, "--label-dir",
            os.path.join(root, "labels"), "--model", model,
            "--img-size", "64", "-b", "4", "--epochs", "1", "--device",
            "cpu", "--print-freq", "1", "--seed", "5", *extra]


def state_digest(state):
    """One SHA-256 over a state's arrays, key by key: equal digests are
    equal bits."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(np.ascontiguousarray(state[k]).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# the ranks


def _surface(out_dir, me):
    import numpy as np
    import torch

    from edgeml_tpu_torch.eval_coco import DetectionEvaluator
    from edgeml_tpu_torch.parallel import mesh
    from edgeml_tpu_torch.parallel.meters import MetricLogger, SmoothedValue

    mesh.initialize_distributed("cpu")  # a second call: a no-op
    n = mesh.world_size()
    assert mesh.is_primary() == (me == 0)
    assert torch.distributed.get_backend() == "gloo"
    assert mesh.local_device("cpu") == torch.device("cpu")

    # ragged objects, ordered by rank
    objs = mesh.allgather_object({"rank": me, "data": list(range(me + 2))})
    assert [o["rank"] for o in objs] == list(range(n)), objs
    assert objs[-1]["data"] == list(range(n + 1)), objs

    # sums: a tensor, a number, a flat list of tensors
    assert torch.equal(mesh.all_sum(torch.tensor([me, 1.0])),
                       torch.tensor([n * (n - 1) / 2, n]))
    assert mesh.all_sum(3) == 3 * n
    a, b = mesh.all_sum([torch.full((2,), float(me)), torch.ones(3)])
    assert torch.equal(a, torch.full((2,), n * (n - 1) / 2))
    assert torch.equal(b, torch.full((3,), float(n)))

    # rows and replication
    rows = mesh.shard_along(torch.arange(12).reshape(2, 6), dim=1)
    assert torch.equal(rows, torch.arange(12).reshape(2, 6)[:, 3 * me:
                                                            3 * me + 3])
    assert mesh.shard_along(list("abcd")) == list("abcd")[2 * me:2 * me + 2]
    lin = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(lin.weight, float(me))
    mesh.replicate(lin)
    assert float(lin.weight.abs().sum()) == 0.0
    assert mesh.replicate({"from": me}) == {"from": 0}

    # the meter sum: rank r adds value r + 1 with weight r + 1
    v = SmoothedValue()
    v.update(float(me + 1), n=me + 1)
    v.synchronize_between_processes()
    want_count = sum(r + 1 for r in range(n))
    want_total = sum(float(r + 1) * (r + 1) for r in range(n))
    assert v.count == want_count and abs(v.total - want_total) < 1e-9, \
        (v.count, v.total)
    log = MetricLogger()
    log.update(loss=2.0 * (me + 1))
    log.synchronize_between_processes()
    assert log.loss.count == n and log.loss.global_avg == n + 1.0

    # the evaluator merge: every rank's images, in rank order
    mine = eval_images_of(me)
    ev = DetectionEvaluator(device="cpu")
    ev.update([d for d, _ in mine], [g for _, g in mine])
    ev.synchronize_between_processes()
    got = ev.summarize(verbose=False)
    coco = DetectionEvaluator(style="coco")
    coco.update([d for d, _ in mine], [g for _, g in mine])
    coco.synchronize_between_processes()
    with open(os.path.join(out_dir, f"surface_{me}.pkl"), "wb") as f:
        pickle.dump({"greedy": got, "coco": coco.summarize(verbose=False),
                     "n_dets": len(ev.dets),
                     "first": [float(d[2][0]) for d in ev.dets]}, f)
    assert np.isfinite(got["map"])


def _detect(out_dir, me):
    import torch

    from edgeml_tpu_torch.cli import detect as detect_cli
    from edgeml_tpu_torch.models.infer import run_detection
    from edgeml_tpu_torch.models.yolov5 import YoloV5
    from edgeml_tpu_torch.parallel import mesh

    img_dir = os.path.join(out_dir, "images")
    kw = dict(DETECT_KW, device="cpu", data_parallel=True)
    for dtype in (None, "int8"):
        net = YoloV5(variant="n", num_classes=8, img_size=64)
        net.load_state_dict(torch.load(os.path.join(out_dir, "yolo.pt")))
        if me:  # replicate() must hand every rank rank 0's weights
            with torch.no_grad():
                for p in net.parameters():
                    p.add_(1.0)
        run_detection(net, img_dir, os.path.join(out_dir, f"dp_{dtype}"),
                      dtype=dtype, **kw)
    with open(os.path.join(out_dir, "cli_args.pkl"), "rb") as f:
        argv = pickle.load(f)
    detect_cli.main(detect_cli.getargs(argv + ["--data-parallel"]))


def _train(out_dir, me):
    import numpy as np

    from edgeml_tpu_torch.cli import train as train_cli
    from edgeml_tpu_torch.parallel import mesh

    result = {}
    for family, net in train_nets():
        data = np.load(os.path.join(out_dir, f"batch_{family}.npz"))
        rows = [mesh.shard_along(data[k]) for k in ("x", "tg", "valid")]
        result[family] = run_steps(net, *rows, TRAIN_STEPS[family])
        # the optimiser state and the weights agree on every rank
        sums = mesh.allgather_object(
            [float(np.abs(v).sum()) for v in result[family]["trace"].values()]
            + [float(np.abs(v).sum())
               for v in result[family]["state"].values()])
        assert sums[0] == sums[-1], family
    with open(os.path.join(out_dir, f"train_{me}.pkl"), "wb") as f:
        pickle.dump(result, f)

    # the CLI, each rank given its own save_dir: only rank 0's is written
    res = train_cli.main(train_cli.getargs(train_cli_args(
        out_dir, os.path.join(out_dir, f"cli_rank{me}"),
        ("--augment", "yolo", "--ema"))))
    with open(os.path.join(out_dir, f"cli_{me}.pkl"), "wb") as f:
        pickle.dump({"epoch_loss": res["epoch_loss"],
                     "ema_n": res["ema"].n_updates}, f)
    # the weights and the EMA agree on every rank, bit for bit
    sums = mesh.allgather_object(
        [float(t.double().abs().sum()) for m in (res["state"],
                                                  res["ema"].module)
         for t in m.state_dict().values()])
    assert sums[0] == sums[-1], "the ranks' weights or EMA differ"


def _train_frozen(out_dir, me):
    import numpy as np
    import torch

    from edgeml_tpu_torch.cli import detect as detect_cli
    from edgeml_tpu_torch.models import retinanet as tretina
    from edgeml_tpu_torch.parallel import mesh

    nets = frozen_nets()
    # RetinaNet's loss on this rank's rows: its share of the global mean
    with np.load(os.path.join(out_dir, "retina_loss.npz")) as d:
        rows = {k: torch.from_numpy(mesh.shard_along(d[k])) for k in d}
    total, parts = tretina.retina_loss(
        nets[0][1], rows["cls"], rows["reg"],
        torch.from_numpy(tretina.retina_anchors(64)), rows["boxes"],
        rows["labels"], rows["valid"])
    result = {"retina_loss": {"total": float(total),
                              **{k: float(v) for k, v in parts.items()}}}
    # the train steps on this rank's rows of the global batch
    with np.load(os.path.join(out_dir, "batch_frozen.npz")) as d:
        batch = [mesh.shard_along(d[k]) for k in ("x", "tg", "valid")]
    draws = [load_draws(os.path.join(out_dir, f"draws_{k}.npz"))
             for k in range(FROZEN_STEPS)]
    for family, net in nets:
        got = run_steps(net, *batch, FROZEN_STEPS, FROZEN_LR[family],
                        draws if family == "frcnn" else None)
        digests = mesh.allgather_object(
            [state_digest(got["state"]), state_digest(got["trace"])])
        result[family] = {"losses": got["losses"], "digests": digests}
        if me == 0:
            np.savez(os.path.join(out_dir, f"state_{family}.npz"),
                     **got["state"])
            np.savez(os.path.join(out_dir, f"trace_{family}.npz"),
                     **got["trace"])
    with open(os.path.join(out_dir, f"train_frozen_{me}.pkl"), "wb") as f:
        pickle.dump(result, f)

    # the Faster R-CNN train CLI, each rank given its own save_dir: only
    # rank 0's is written
    _frcnn_cli(out_dir, f"cli_rank{me}", f"cli_{me}.pkl")
    if me == 0:  # the port's detect CLI serves rank 0's checkpoint
        detect_cli.main(detect_cli.getargs(
            [os.path.join(out_dir, "serve"), os.path.join(out_dir, "served"),
             "--model", "faster_rcnn", "--dataset", "voc", "--model-path",
             os.path.join(out_dir, "cli_rank0", "checkpoint.pth"),
             "--batch-size", "1", "--device", "cpu"]))


def _frcnn_cli(out_dir, save, result):
    """The Faster R-CNN train CLI into ``out_dir/save``; its per-step
    losses and its weights' digest into ``out_dir/result``."""
    from edgeml_tpu_torch.cli import train as train_cli

    res = train_cli.main(train_cli.getargs(train_cli_args(
        out_dir, os.path.join(out_dir, save), model="faster_rcnn")))
    with open(os.path.join(out_dir, result), "wb") as f:
        pickle.dump({"losses": list(res["loggers"][0].meters["loss"].deque),
                     "digest": state_digest(
                         {k: v.detach().numpy()
                          for k, v in res["state"].state_dict().items()})},
                    f)


def _frcnn_cli_one(out_dir, me):
    _frcnn_cli(out_dir, "cli_one", "cli_one.pkl")


def main():
    import torch

    from edgeml_tpu_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)
    scenario, out_dir = sys.argv[1], sys.argv[2]
    me = int(os.environ.get("RANK", "0"))
    initialize_distributed("cpu")  # a no-op in a process started by solo()
    {"surface": _surface, "detect": _detect, "train": _train,
     "train_frozen": _train_frozen, "frcnn_cli_one": _frcnn_cli_one}[
        scenario](out_dir, me)
    print(f"TORCH_MP_OK rank={me}", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
