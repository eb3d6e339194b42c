"""Rank worker of the port's several-process tests, and their launcher.

``spawn(scenario, out_dir)`` starts two ranks of this file on the CPU with
the environment ``torchrun`` would give them (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``),
waits for both within a timeout, kills them in any case, and returns each
rank's output; a rank that fails or prints no ``TORCH_MP_OK rank=<r>`` line
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
    global batch in ``out_dir/batch_*.npz``, the train CLI, and the
    frozen-norm families' refusal.

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
# the detect scenario's run_detection arguments
DETECT_KW = dict(batch_size=8, conf_thres=0.2, iou_thres=0.5, img_size=64)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(scenario: str, out_dir, nproc: int = NPROC, timeout: int = 240):
    """Run ``scenario`` on ``nproc`` ranks; returns their outputs."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(nproc), LOCAL_WORLD_SIZE=str(nproc),
               OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), scenario,
             str(out_dir)],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
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


def run_steps(net, images, targets, valid, steps):
    """``steps`` SGD steps of the family's TrainStep on one batch: per step
    the loss and its parts (floats), then the net's parameters and
    BatchNorm statistics and the optimiser's trace, as NumPy arrays."""
    import torch

    from edgeml_tpu_torch.models.engine import make_family_train_step
    from edgeml_tpu_torch.models.train import TrainConfig

    _, step = make_family_train_step(net, TrainConfig(lr=TRAIN_LR))
    args = [torch.from_numpy(a) for a in (images, targets, valid)]
    losses = []
    for _ in range(steps):
        loss, parts = step(*args, TRAIN_LR)
        losses.append({"loss": float(loss),
                       **{k: float(v) for k, v in parts.items()}})
    state = {k: v.detach().numpy().copy()
             for k, v in net.state_dict().items()}
    return {"losses": losses, "state": state,
            "trace": step.opt.state_dict()["trace"]}


def train_cli_args(root, save_dir, extra=()):
    return [os.path.join(root, "images"), save_dir, "--label-dir",
            os.path.join(root, "labels"), "--model", "yolov5n",
            "--img-size", "64", "-b", "4", "--epochs", "1", "--device",
            "cpu", "--print-freq", "1", "--seed", "5", *extra]


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
    from edgeml_tpu_torch.models.engine import make_detector, \
        make_family_train_step
    from edgeml_tpu_torch.models.train import TrainConfig
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

    # RetinaNet and Faster R-CNN refuse several processes
    for name in ("retinanet", "faster_rcnn"):
        try:
            make_family_train_step(make_detector(name, 2, 64), TrainConfig())
        except NotImplementedError as e:
            assert "ROADMAP" in str(e), e
        else:
            raise AssertionError(f"{name} trained under two ranks")


def main():
    import torch

    from edgeml_tpu_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)
    scenario, out_dir = sys.argv[1], sys.argv[2]
    me = int(os.environ["RANK"])
    initialize_distributed("cpu")
    {"surface": _surface, "detect": _detect, "train": _train}[scenario](
        out_dir, me)
    print(f"TORCH_MP_OK rank={me}", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
