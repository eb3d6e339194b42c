"""The port's RetinaNet against the benchmark's frozen plain reference
(``benchmark/reference/retinanet.py``) on the CPU at 128 px, where 3,069
anchors take the raw-logit prefilter, with 7 classes and the reference's
seeded weights: the head's outputs, the served rows, ``forward`` as the
composition of ``features`` and ``head_outputs``, the spans of one serving
step, the reference's FLOP count by hand, and the reference's imports. Of
the benchmark only the frozen reference is imported."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.reference import retinanet as reference
from edgeml_tpu_torch.models import retinanet as rn
from edgeml_tpu_torch.models.infer import _detect_generic, square_batch
from edgeml_tpu_torch.utils import profiling

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {"family": "retinanet", "num_classes": 7, "image_size": 128, "prefilter_top_n": 2048,
       "detections_per_img": 300, "conf_thres": 0.001, "iou_thres": 0.6}
SHAPES = [[48, 64], [64, 43], [64, 64], [50, 38]]
CPU = torch.device("cpu")


def make_frames(seed, shapes):
    """(H, W, 3) f32 frames in [0, 1]: a coarse random field upsampled 32x
    plus noise, so that the seeded detector finds structure to score."""
    rng = np.random.default_rng(seed)
    out = []
    for h, w in shapes:
        coarse = rng.random((h // 32 + 1, w // 32 + 1, 3))
        field = coarse.repeat(32, 0).repeat(32, 1)[:h, :w]
        out.append(np.clip(field * 200.0 + rng.normal(0, 20, (h, w, 3)), 0, 255)
                   .astype(np.uint8).astype(np.float32) / 255.0)
    return out


def pair_rows(prog, ref, hw):
    """Rows (cls, x, y, w, h, conf) of one image, normalised to it, paired
    closest first by class and corners within 1 px, each row at most once.
    Returns (rows left unpaired, largest confidence gap, largest corner gap
    in pixels) of the pairs."""
    def corners(rows):
        h, w = hw
        x, y, bw, bh = rows[:, 1] * w, rows[:, 2] * h, rows[:, 3] * w, rows[:, 4] * h
        return np.stack([x - bw / 2, y - bh / 2, x + bw / 2, y + bh / 2], 1).astype(np.float64)

    if len(prog) == 0 or len(ref) == 0:
        return len(prog) + len(ref), 0.0, 0.0
    dist = np.abs(corners(prog)[:, None] - corners(ref)[None]).max(-1)
    dist[prog[:, 0][:, None] != ref[:, 0][None]] = np.inf
    ii, jj = np.nonzero(dist <= 1.0)
    used_i, used_j, conf_gap, box_gap = set(), set(), 0.0, 0.0
    for k in np.argsort(dist[ii, jj], kind="stable"):
        i, j = int(ii[k]), int(jj[k])
        if i in used_i or j in used_j:
            continue
        used_i.add(i)
        used_j.add(j)
        conf_gap = max(conf_gap, abs(float(prog[i, 5]) - float(ref[j, 5])))
        box_gap = max(box_gap, float(dist[i, j]))
    return len(prog) + len(ref) - 2 * len(used_i), conf_gap, box_gap


@pytest.fixture(scope="module", params=[7, 2147483659])
def served(request):
    """(frames, reference state dict, the port's net holding it)."""
    gen = torch.Generator().manual_seed(request.param)
    frames = make_frames(request.param, SHAPES[:2])
    sd = reference.seeded_state(CFG, gen, CPU, frames)
    net = rn.RetinaNet(num_classes=CFG["num_classes"], image_size=CFG["image_size"])
    net.load_state_dict(sd, strict=False)
    own = {k for k in net.state_dict() if not k.endswith("num_batches_tracked")}
    assert own == set(sd)
    return frames, sd, net.eval()


def test_head_matches_the_reference(served):
    """Logits and deltas within 1e-4 of each output's largest value (the
    port's tolerance for heads: the same convolutions may sum in another
    order)."""
    frames, sd, net = served
    x = torch.from_numpy(square_batch(frames, CFG["image_size"]))
    with torch.no_grad():
        cls, reg = net.head_outputs(net.features(x))
        want_cls, want_reg = reference.head(sd, reference.features(sd, x.permute(0, 3, 1, 2)))
    assert cls.shape == (2, 3069, 7) and reg.shape == (2, 3069, 4)
    for got, want in ((cls, want_cls), (reg, want_reg)):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_forward_is_features_then_head_exactly(served):
    frames, _, net = served
    x = torch.from_numpy(square_batch(frames, CFG["image_size"]))
    with torch.no_grad():
        whole = net(x)
        parts = net.head_outputs(net.features(x))
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


def test_served_rows_match_the_reference(served):
    """``_detect_generic``'s rows against the reference's ``detect`` at the
    same batch, paired by class and corners."""
    frames, sd, net = served
    x = torch.from_numpy(square_batch(frames, CFG["image_size"]))
    dets, valid = _detect_generic(net, x, CFG["conf_thres"], CFG["iou_thres"])
    prog = [d[v].numpy() for d, v in zip(dets, valid)]
    refs = reference.detect(sd, CFG, frames, CPU)
    for p, r, f in zip(prog, refs, frames):
        r = np.asarray(r, np.float32).reshape(-1, 6)
        assert len(r) >= 1
        unpaired, conf_gap, box_gap = pair_rows(p, r, f.shape[:2])
        assert unpaired == 0
        assert conf_gap <= 1e-6 and box_gap <= 1e-3


def test_a_serving_step_records_head_and_prefilter(served):
    frames, _, net = served
    x = torch.from_numpy(square_batch(frames, CFG["image_size"]))
    profiling.reset()
    profiling.enable()
    try:
        _detect_generic(net, x, CFG["conf_thres"], CFG["iou_thres"])
        recs = profiling.records()
    finally:
        profiling.enable(False)
        profiling.reset()
    ids = {r.id: r for r in recs}
    parents = {r.name: ids[r.parent].name if r.parent else None for r in recs}
    assert {k: parents[k] for k in ("detect", "detect.trunk", "detect.head", "detect.tail",
                                    "nms.prefilter")} == {
        "detect": None, "detect.trunk": "detect", "detect.head": "detect",
        "detect.tail": "detect", "nms.prefilter": "detect.tail"}
    order = [r.name for r in sorted(recs, key=lambda r: r.start_ns)
             if ids.get(r.parent) is not None and ids[r.parent].name == "detect"]
    assert order == ["detect.trunk", "detect.head", "detect.tail"]


def test_no_prefilter_below_its_width():
    """At 64 px (774 anchors) every row goes to the NMS: no prefilter span."""
    net = rn.RetinaNet(num_classes=3, image_size=64,
                       generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (1, 64, 64, 3))
                         .astype(np.float32))
    profiling.reset()
    profiling.enable()
    try:
        _detect_generic(net, x, 0.001, 0.6)
        names = {r.name for r in profiling.records()}
    finally:
        profiling.enable(False)
        profiling.reset()
    assert "nms.prefilter" not in names and "detect.head" in names


def test_reference_head_flops_by_hand():
    """At 640, 8,525 locations over P3..P7; a location's head is 8 tower
    convs of 3 x 3 x 256 x 256, the class conv 3 x 3 x 256 x 819 and the box
    conv 3 x 3 x 256 x 36 multiply-adds: 6,688,512, 2 FLOPs each."""
    cfg = dict(CFG, num_classes=91, image_size=640)
    f = reference.flops(cfg)
    per_loc = 8 * 9 * 256 * 256 + 9 * 256 * 819 + 9 * 256 * 36
    assert per_loc == 6_688_512
    assert f["head"] == {"conv": 2 * 8525 * per_loc, "linear": 0}
    assert f["head"]["conv"] == 114_039_129_600
    assert 75e9 < f["trunk"]["conv"] < 90e9 and f["trunk"]["linear"] == 0


def test_reference_keys_are_the_ports():
    net = rn.RetinaNet(num_classes=91, image_size=640)
    own = {k: tuple(v.shape) for k, v in net.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert own == {k: tuple(s) for k, s in reference.param_shapes({"num_classes": 91}).items()}


def test_reference_imports_neither_the_port_nor_jax(tmp_path):
    path = reference.__file__
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert not {n.split(".")[0] for n in names} & {"jax", "jaxlib", "flax", "edgeml_tpu",
                                                   "edgeml_tpu_torch"}
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.retinanet\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'edgeml_tpu', 'edgeml_tpu_torch'}))\n") % ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
