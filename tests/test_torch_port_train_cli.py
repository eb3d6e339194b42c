"""The port's train CLI (``python -m edgeml_tpu_torch.cli.train ... --device
cpu``) on 8 images of 64 px: the checkpoint files and payload, --resume,
every --augment, --preset yolo --ema --bf16, the ssd family, --voc-root,
a step of RetinaNet and of Faster R-CNN, and the refusal (no CUDA device
without --device cpu). The JAX package's CLIs on the same data:
``test_torch_port_train_cli_cross.py``.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from edgeml_tpu_torch.cli import train as train_cli
from edgeml_tpu_torch.models import train as ttrain

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 64
N_IMG = 8
COLORS = ((0.95, 0.2, 0.1), (0.1, 0.35, 0.95), (0.2, 0.9, 0.2))
PAYLOAD_KEYS = {"model", "optimizer", "lr_scheduler", "args", "epoch"}


def write_dataset(root, seed=3, n=N_IMG, size=IMG):
    """Images with coloured rectangles on a dark background (the objects
    are visible, so training has signal) and their YOLO label files."""
    img_dir, lab_dir = root / "images", root / "labels"
    img_dir.mkdir(parents=True)
    lab_dir.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        img = rng.random((size, size, 3)).astype(np.float32) * 0.15
        rows = []
        for _ in range(int(rng.integers(1, 3))):
            c = int(rng.integers(0, len(COLORS)))
            w, h = rng.uniform(0.25, 0.45, 2)
            x = rng.uniform(w / 2 + 0.02, 1 - w / 2 - 0.02)
            y = rng.uniform(h / 2 + 0.02, 1 - h / 2 - 0.02)
            img[int((y - h / 2) * size):int((y + h / 2) * size),
                int((x - w / 2) * size):int((x + w / 2) * size)] = COLORS[c]
            rows.append(f"{c} {x:.4f} {y:.4f} {w:.4f} {h:.4f}")
        np.save(img_dir / f"im{i:02d}.npy", img)
        (lab_dir / f"im{i:02d}.txt").write_text("\n".join(rows) + "\n")
    return str(img_dir), str(lab_dir)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("train_cli"))


def args(img_dir, lab_dir, save_dir, *extra):
    return train_cli.getargs(
        [img_dir, str(save_dir), "--label-dir", lab_dir, "--model",
         "yolov5n", "-b", "4", "--img-size", str(IMG), "--max-targets", "16",
         "--print-freq", "100", "--device", "cpu", *map(str, extra)])


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_yolo_checkpoint_files_payload_and_resume(dataset, tmp_path):
    img_dir, lab_dir = dataset
    save = tmp_path / "run"
    res = train_cli.main(args(img_dir, lab_dir, save, "--epochs", 2))
    assert len(res["epoch_loss"]) == 2
    assert all(np.isfinite(res["epoch_loss"]))
    assert sorted(os.listdir(save)) == ["checkpoint.pth", "model_0.pth"]
    ck = load(save / "checkpoint.pth")
    assert set(ck) == PAYLOAD_KEYS and ck["epoch"] == 1
    assert load(save / "model_0.pth")["epoch"] == 0
    assert ck["args"] == dict(vars(ttrain.TrainConfig(epochs=2)))
    assert ck["lr_scheduler"] == {"name": "multisteplr", "steps": [16, 22],
                                  "gamma": 0.1}
    params, stats = ck["model"]["params"], ck["model"]["stats"]
    assert set(params) == {f"l{i}" for i in (0, 1, 2, 3, 4, 5, 6, 7, 8, 9,
                                             10, 13, 14, 17, 18, 20, 21,
                                             23)} | {"detect"}
    assert params["l0"]["w"].shape == (6, 6, 3, 16)  # HWIO
    assert params["l0"]["w"].dtype == np.float32
    assert set(stats["l0"]) == {"m", "v"}
    trace = ck["optimizer"]["trace"]
    assert len(trace) == len(list(res["state"].parameters()))
    assert any(np.abs(t).max() > 0 for t in trace.values())
    net = res["state"]
    got = net.to_jax_params()
    assert np.array_equal(got[0]["l0"]["w"], params["l0"]["w"])

    # resume at the end: nothing to train, the weights are the checkpoint's
    again = train_cli.main(args(img_dir, lab_dir, save, "--epochs", 2,
                                "--resume", save / "checkpoint.pth"))
    assert again["epoch_loss"] == []
    for a, b in zip(again["state"].parameters(), net.parameters()):
        assert torch.equal(a, b)
    # resume and train on: one more epoch, numbered 2
    more = train_cli.main(args(img_dir, lab_dir, save, "--epochs", 3,
                               "--resume", save / "checkpoint.pth"))
    assert len(more["epoch_loss"]) == 1
    assert load(save / "checkpoint.pth")["epoch"] == 2


@pytest.mark.parametrize("augment", [
    ("--augment", "none"), ("--augment", "flip"), ("--augment", "ssd"),
    ("--augment", "yolo", "--yolo-hsv", "device"),
    ("--augment", "yolo", "--yolo-hsv", "host"),
    ("--augment", "yolo", "--yolo-hsv", "off")])
def test_every_augment_trains(dataset, tmp_path, augment):
    img_dir, lab_dir = dataset
    res = train_cli.main(args(img_dir, lab_dir, tmp_path, "--epochs", 1,
                              *augment))
    assert len(res["epoch_loss"]) == 1 and np.isfinite(res["epoch_loss"][0])
    assert os.path.isfile(tmp_path / "checkpoint.pth")


def test_yolo_augment_refuses_ssd(dataset, tmp_path):
    img_dir, lab_dir = dataset
    with pytest.raises(SystemExit, match="yolov5"):
        train_cli.main(train_cli.getargs(
            [img_dir, str(tmp_path), "--label-dir", lab_dir, "--model",
             "ssd", "--augment", "yolo", "--device", "cpu"]))


def test_preset_yolo_ema_bf16(dataset, tmp_path):
    img_dir, lab_dir = dataset
    res = train_cli.main(args(img_dir, lab_dir, tmp_path, "--epochs", 2,
                              "--preset", "yolo", "--augment", "yolo",
                              "--ema", "--bf16"))
    ck = load(tmp_path / "checkpoint.pth")
    assert set(ck) == PAYLOAD_KEYS | {"ema"}
    assert ck["args"] == dict(vars(ttrain.yolo_recipe_config(2)))
    ema = ck["ema"]
    assert set(ema) == {"params", "stats", "n_updates"}
    assert int(ema["n_updates"]) == 2 * (N_IMG // 4) == res["ema"].n_updates
    assert not np.array_equal(ema["params"]["l0"]["w"],
                              ck["model"]["params"]["l0"]["w"])
    # resuming carries the EMA and its ramp position
    more = train_cli.main(args(img_dir, lab_dir, tmp_path, "--epochs", 3,
                               "--preset", "yolo", "--augment", "yolo",
                               "--ema", "--resume",
                               tmp_path / "checkpoint.pth"))
    assert more["ema"].n_updates == 3 * (N_IMG // 4)


def test_ssd_family_adamw(dataset, tmp_path):
    img_dir, lab_dir = dataset
    res = train_cli.main(train_cli.getargs(
        [img_dir, str(tmp_path), "--label-dir", lab_dir, "--model", "ssd",
         "-b", "4", "--img-size", str(IMG), "--epochs", "1", "--opt",
         "adamw", "--lr", "1e-3", "--augment", "ssd", "--device", "cpu"]))
    assert np.isfinite(res["epoch_loss"][0])
    net = res["state"]
    assert net.num_classes == 21 and net.image_size == IMG
    assert not net.reduced_tail
    ck = load(tmp_path / "checkpoint.pth")
    assert set(ck["optimizer"]) == {"count", "mu", "nu"}
    assert int(ck["optimizer"]["count"]) == N_IMG // 4
    assert ck["model"]["params"]["backbone"]["last"]["w"].shape == \
        (1, 1, 160, 960)


def write_voc(root, size=IMG):
    """A VOCdevkit tree: 2007 and 2012 trainval, two JPEG images each."""
    from PIL import Image

    rng = np.random.default_rng(5)
    for year in ("2007", "2012"):
        base = root / "VOCdevkit" / f"VOC{year}"
        for sub in ("Annotations", "JPEGImages", "ImageSets/Main"):
            (base / sub).mkdir(parents=True)
        ids = [f"{year}_{i:03d}" for i in range(2)]
        (base / "ImageSets/Main/trainval.txt").write_text("\n".join(ids))
        for img_id in ids:
            img = (rng.random((size, size, 3)) * 255).astype(np.uint8)
            Image.fromarray(img).save(base / "JPEGImages" / f"{img_id}.jpg")
            (base / "Annotations" / f"{img_id}.xml").write_text(
                f"<annotation><size><width>{size}</width><height>{size}"
                "</height></size><object><name>dog</name><difficult>0"
                "</difficult><bndbox><xmin>8</xmin><ymin>10</ymin>"
                "<xmax>40</xmax><ymax>50</ymax></bndbox></object>"
                "</annotation>")


def test_voc_root(tmp_path):
    write_voc(tmp_path / "voc")
    res = train_cli.main(train_cli.getargs(
        ["", str(tmp_path / "out"), "--voc-root", str(tmp_path / "voc"),
         "--model", "yolov5n", "-b", "2", "--img-size", str(IMG),
         "--epochs", "1", "--device", "cpu"]))
    assert len(res["epoch_loss"]) == 1 and np.isfinite(res["epoch_loss"][0])


def test_refusals(dataset, tmp_path, monkeypatch):
    """RetinaNet and Faster R-CNN, once refused, train a step each (two
    images, batch 2) into a checkpoint without statistics; without a CUDA
    device and without --device cpu the CLI raises."""
    img_dir, lab_dir = dataset
    small = tmp_path / "two"
    two_img, two_lab = write_dataset(small, n=2)
    for model in ("retinanet", "faster_rcnn"):
        res = train_cli.main(train_cli.getargs(
            [two_img, str(small / model), "--label-dir", two_lab, "--model",
             model, "-b", "2", "--img-size", str(IMG), "--epochs", "1",
             "--device", "cpu"]))
        assert len(res["epoch_loss"]) == 1
        assert np.isfinite(res["epoch_loss"][0])
        ck = load(small / model / "checkpoint.pth")
        assert ck["model"]["stats"] is None and ck["epoch"] == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(train_cli.getargs(
            [img_dir, str(tmp_path), "--label-dir", lab_dir, "--model",
             "yolov5n"]))
    assert not os.path.exists(tmp_path / "checkpoint.pth")


def test_module_entry_point(dataset, tmp_path):
    """python -m edgeml_tpu_torch.cli.train runs as a program."""
    img_dir, lab_dir = dataset
    res = subprocess.run(
        [sys.executable, "-m", "edgeml_tpu_torch.cli.train", img_dir,
         str(tmp_path), "--label-dir", lab_dir, "--model", "yolov5n", "-b",
         "4", "--img-size", str(IMG), "--epochs", "1", "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "Epoch 0 finished" in res.stdout
    assert os.path.isfile(tmp_path / "checkpoint.pth")
