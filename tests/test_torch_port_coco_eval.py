"""The port's COCOeval scorer and DetectionEvaluator against the JAX
package's.

Tolerances: ``evaluate_coco`` (bbox, segm, keypoints) on the cases of
``tests/test_coco_matching.py`` (copied) and seeded scenes: every summary
number, the precision and recall arrays and the categories exactly equal.
``DetectionEvaluator``: style="coco" exactly equal; style="greedy" (the
device path: box matching and the mAP core) each AP within 3e-5 of the JAX
package's, the repository's mAP tolerance.
"""

import numpy as np
import pytest
import torch

from edgeml_tpu import coco_matching as jcm
from edgeml_tpu.eval_coco import COCO_IOUV as JCOCO_IOUV
from edgeml_tpu.eval_coco import DetectionEvaluator as JEvaluator
from edgeml_tpu_torch import coco_matching as tcm
from edgeml_tpu_torch.dataprep.coco_dataset import rle_encode
from edgeml_tpu_torch.eval_coco import COCO_IOUV, DetectionEvaluator

torch.set_num_threads(1)
MAP_TOL = 3e-5


def box(x, y, w, h):
    return [x, y, x + w, y + h]


def rect_mask(h, w, x, y, bw, bh):
    m = np.zeros((h, w), bool)
    m[y: y + bh, x: x + bw] = True
    return m


def kp(xy_v):
    return np.array(xy_v, float)


def _bbox_cases():
    a = np.array
    return {
        "perfect": ([(a([0, 1]), a([box(0, 0, 10, 10), box(20, 20, 5, 5)]),
                      a([0.9, 0.8]))],
                    [(a([0, 1]), a([box(0, 0, 10, 10), box(20, 20, 5, 5)]))],
                    {}),
        "fp_then_tp": ([(a([0, 0]), a([box(50, 50, 10, 10),
                                       box(0, 0, 10, 10)]), a([0.9, 0.3]))],
                       [(a([0]), a([box(0, 0, 10, 10)]))], {}),
        "score_order_50": ([(a([0, 0]), a([box(0, 0, 10, 6.0),
                                           box(0, 0, 10, 9.0)]),
                             a([0.9, 0.5]))],
                           [(a([0]), a([box(0, 0, 10, 10)]))],
                           {"iouv": a([0.5])}),
        "score_order_75": ([(a([0, 0]), a([box(0, 0, 10, 6.0),
                                           box(0, 0, 10, 9.0)]),
                             a([0.9, 0.5]))],
                           [(a([0]), a([box(0, 0, 10, 10)]))],
                           {"iouv": a([0.75])}),
        "crowd": ([(a([0, 0]), a([box(100, 110, 20, 20), box(0, 0, 10, 10)]),
                    a([0.95, 0.9]))],
                  [(a([0, 0]), a([box(0, 0, 10, 10), box(100, 100, 50, 50)]),
                    a([0, 1]))], {}),
        "area_ranges": ([(a([0, 0]), a([box(0, 0, 4, 4),
                                        box(50, 50, 200, 200)]),
                          a([0.9, 0.8]))],
                        [(a([0, 0]), a([box(0, 0, 4, 4),
                                        box(50, 50, 200, 200)]))], {}),
        "absent_category": ([(a([0, 7]), a([box(0, 0, 10, 10),
                                            box(30, 30, 5, 5)]),
                              a([0.9, 0.8]))],
                            [(a([0]), a([box(0, 0, 10, 10)]))], {}),
    }


def _segm_cases():
    H = W = 64
    gb = [box(4, 4, 10, 10), box(30, 30, 8, 8)]
    db = [box(4, 4, 10, 10), box(31, 31, 8, 8), box(50, 2, 6, 6)]
    gm = np.stack([rect_mask(H, W, 4, 4, 10, 10),
                   rect_mask(H, W, 30, 30, 8, 8)])
    dm = np.stack([rect_mask(H, W, 4, 4, 10, 10),
                   rect_mask(H, W, 31, 31, 8, 8),
                   rect_mask(H, W, 50, 2, 6, 6)])
    b = box(0, 0, 16, 16)
    big = box(0, 0, 90, 90)
    small = rect_mask(96, 96, 0, 0, 10, 10)
    return {
        "full_box_masks": (
            [(np.array([0, 1, 1]), np.array(db), np.array([0.9, 0.8, 0.7]),
              dm)],
            [(np.array([0, 1]), np.array(gb), np.zeros(2, bool), gm)],
            {"iou_type": "segm"}),
        "mask_overrides_box": (
            [(np.array([0]), np.array([b]), np.array([0.9]),
              rect_mask(32, 32, 0, 8, 16, 8)[None])],
            [(np.array([0]), np.array([b]), np.zeros(1, bool),
              rect_mask(32, 32, 0, 0, 16, 8)[None])],
            {"iou_type": "segm"}),
        "mask_area_ranges": (
            [(np.array([0]), np.array([big]), np.array([0.9]), small[None])],
            [(np.array([0]), np.array([big]), np.zeros(1, bool),
              small[None])],
            {"iou_type": "segm"}),
        "rle_dicts": (
            [(np.array([0]), np.array([box(2, 2, 10, 10)]), np.array([0.9]),
              [rle_encode(rect_mask(24, 24, 2, 2, 10, 10))])],
            [(np.array([0]), np.array([box(2, 2, 10, 10)]), np.zeros(1, bool),
              [rle_encode(rect_mask(24, 24, 3, 2, 10, 10))])],
            {"iou_type": "segm"}),
    }


def _kpt_cases():
    K = 17
    gk17 = np.stack([np.arange(K) * 3.0, np.arange(K) * 2.0,
                     np.full(K, 2.0)], axis=1)
    gk = kp([(0, 0, 2), (5, 5, 2)])
    far = gk.copy()
    far[:, 0] += 20.0
    sig = {"iou_type": "keypoints", "kpt_sigmas": np.array([0.5, 0.5])}
    b10 = np.array([box(0, 0, 10, 10)])
    return {
        "perfect": ([(np.array([0]), np.array([box(0, 0, 48, 32)]),
                      np.array([0.9]), gk17[None])],
                    [(np.array([0]), np.array([box(0, 0, 48, 32)]),
                      np.zeros(1, bool), gk17[None])],
                    {"iou_type": "keypoints"}),
        "far_fp": ([(np.array([0]), b10, np.array([0.9]), far[None])],
                   [(np.array([0]), b10, np.zeros(1, bool), gk[None],
                     np.array([100.0]))], sig),
        "unlabeled_gt": ([(np.array([0]), b10, np.array([0.9]),
                           kp([(1, 1, 0), (5, 5, 0)])[None])],
                         [(np.array([0]), b10, np.zeros(1, bool),
                           kp([(0, 0, 0), (5, 5, 0)])[None])], sig),
        "area_payload": ([(np.array([0]), np.array([box(0, 0, 200, 200)]),
                           np.array([0.9]),
                           kp([(10, 10, 2), (30, 30, 2)])[None])],
                         [(np.array([0]), np.array([box(0, 0, 200, 200)]),
                           np.zeros(1, bool),
                           kp([(10, 10, 2), (30, 30, 2)])[None],
                           np.array([50.0 ** 2]))], sig),
    }


def make_scene(rng, n_img=12, n_cls=4, scale=200.0, with_crowd=False):
    """tests/test_eval_coco.py's scene generator, in pixels, with a crowd
    flag per ground truth."""
    dets, gts = [], []
    for _ in range(n_img):
        m = int(rng.integers(1, 6))
        g_cls = rng.integers(0, n_cls, m)
        g_xy = rng.uniform(0.05, 0.6, (m, 2))
        g_wh = rng.uniform(0.02, 0.35, (m, 2))
        g_boxes = np.concatenate([g_xy, g_xy + g_wh], 1) * scale
        gt = (g_cls, g_boxes)
        if with_crowd:
            gt += (rng.random(m) < 0.15,)
        gts.append(gt)
        n = int(rng.integers(0, 9))
        d_boxes, d_cls = [], []
        for j in range(n):
            if j < m and rng.random() < 0.7:
                d_boxes.append(g_boxes[j] + rng.normal(0, 0.02 * scale, 4))
                d_cls.append(g_cls[j])
            else:
                xy = rng.uniform(0.05, 0.6, 2)
                wh = rng.uniform(0.02, 0.35, 2)
                d_boxes.append(np.concatenate([xy, xy + wh]) * scale)
                d_cls.append(rng.integers(0, n_cls))
        dets.append((np.array(d_cls, np.int64),
                     np.array(d_boxes, np.float64).reshape(-1, 4),
                     rng.uniform(0.05, 1.0, n)))
    return dets, gts


def assert_summary_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v)
        elif isinstance(v, float) and np.isnan(v):
            assert np.isnan(got[k]), k
        else:
            assert got[k] == v, k


CASES = {f"bbox_{k}": v for k, v in _bbox_cases().items()}
CASES.update({f"segm_{k}": v for k, v in _segm_cases().items()})
CASES.update({f"kpt_{k}": v for k, v in _kpt_cases().items()})


@pytest.mark.parametrize("name", sorted(CASES))
def test_evaluate_coco_cases_equal(name):
    dets, gts, kw = CASES[name]
    assert_summary_equal(tcm.evaluate_coco(dets, gts, **kw),
                         jcm.evaluate_coco(dets, gts, **kw))


@pytest.mark.parametrize("seed", range(3))
def test_evaluate_coco_seeded_scenes_equal(seed):
    dets, gts = make_scene(np.random.default_rng(seed), with_crowd=True)
    got = tcm.evaluate_coco(dets, gts)
    assert_summary_equal(got, jcm.evaluate_coco(dets, gts))
    assert 0 < got["map"] < 1


def test_matching_helpers_equal():
    rng = np.random.default_rng(4)
    dt = np.sort(rng.uniform(0, 50, (6, 4)), axis=1)[:, [0, 2, 1, 3]]
    gt = np.sort(rng.uniform(0, 50, (5, 4)), axis=1)[:, [0, 2, 1, 3]]
    crowd = np.array([0, 1, 0, 0, 1], bool)
    np.testing.assert_array_equal(tcm.iou_xyxy(dt, gt, crowd),
                                  jcm.iou_xyxy(dt, gt, crowd))
    dm, gm = rng.random((6, 9, 9)) < 0.4, rng.random((5, 9, 9)) < 0.4
    np.testing.assert_array_equal(tcm.mask_iou(dm, gm, crowd),
                                  jcm.mask_iou(dm, gm, crowd))
    dk = rng.uniform(0, 50, (6, 3, 3))
    gk = np.concatenate([rng.uniform(0, 50, (5, 3, 2)),
                         rng.integers(0, 3, (5, 3, 1))], 2)
    areas = rng.uniform(10, 500, 5)
    sig = np.array([0.3, 0.5, 0.7])
    np.testing.assert_array_equal(tcm.oks_matrix(dk, gk, areas, gt, sig),
                                  jcm.oks_matrix(dk, gk, areas, gt, sig))
    for rng_ in jcm.AREA_RNG.values():
        got = tcm.match_image(dt, gt, crowd, JCOCO_IOUV, rng_)
        want = jcm.match_image(dt, gt, crowd, JCOCO_IOUV, rng_)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    masks = [rle_encode(m) for m in dm]
    np.testing.assert_array_equal(tcm._as_mask_array(masks, 6),
                                  jcm._as_mask_array(masks, 6))


@pytest.mark.parametrize("seed", range(3))
def test_evaluator_both_styles_match_jax(seed):
    np.testing.assert_array_equal(COCO_IOUV, JCOCO_IOUV)
    dets, gts = make_scene(np.random.default_rng(10 + seed), n_img=16,
                           with_crowd=True)
    ours = DetectionEvaluator(device="cpu")
    theirs = JEvaluator()
    ours.update(dets, gts)
    theirs.update(dets, gts)
    got, want = ours.summarize(verbose=False), theirs.summarize(
        verbose=False)
    assert got["per_iou"].shape == (10,)
    np.testing.assert_allclose(got["per_iou"], want["per_iou"], rtol=0,
                               atol=MAP_TOL)
    for k in ("map", "map50", "map75"):
        assert abs(got[k] - want[k]) <= MAP_TOL, k
    assert 0 < got["map"] <= got["map50"] <= 1
    ours = DetectionEvaluator(style="coco")
    theirs = JEvaluator(style="coco")
    ours.update(dets, gts)
    theirs.update(dets, gts)
    assert_summary_equal(ours.summarize(verbose=False),
                         theirs.summarize(verbose=False))


def test_evaluator_dispatch_and_printing(capsys):
    """test_coco_matching.py's style dispatch: a perfect detection scores
    1.0 in coco style and ~0.995 greedy (the trapezoid-free 101-point
    interpolation of the mAP core); a crowd flag does not break greedy;
    segm/keypoints need style="coco"; the summaries print."""
    gts = [(np.array([0]), np.array([box(0, 0, 10, 10)]))]
    dets = [(np.array([0]), np.array([box(0, 0, 10, 10)]), np.array([0.9]))]
    ev = DetectionEvaluator(style="coco")
    ev.update(dets, gts)
    assert ev.summarize()["map"] == pytest.approx(1.0)
    assert "maxDets=100" in capsys.readouterr().out
    ev = DetectionEvaluator(device="cpu")
    ev.update(dets, gts)
    greedy = ev.summarize()["map"]
    assert greedy == pytest.approx(0.995, abs=2e-3)
    assert "IoU=0.50:0.95" in capsys.readouterr().out
    ev = DetectionEvaluator(device="cpu")
    ev.update(dets, [gts[0] + (np.array([0]),)])
    assert ev.summarize(verbose=False)["map"] == greedy
    for iou_type in ("segm", "keypoints"):
        with pytest.raises(ValueError):
            DetectionEvaluator(style="greedy", iou_type=iou_type,
                               device="cpu")


def test_evaluator_needs_cuda_unless_asked_and_one_process(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DetectionEvaluator()
    DetectionEvaluator(style="coco")  # host only: no device needed
    ev = DetectionEvaluator(device="cpu")
    ev.synchronize_between_processes()  # one process: a no-op
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    # two ranks: every rank's images are gathered, in rank order
    import edgeml_tpu_torch.eval_coco as port_eval

    box = np.array([[0.1, 0.1, 0.5, 0.5]], np.float32)
    ev.update([(np.array([0]), box, np.array([0.9]))], [(np.array([0]), box)])
    other = ([(np.array([1]), box, np.array([0.8]))], [(np.array([1]), box)])
    monkeypatch.setattr(port_eval, "allgather_object",
                        lambda obj: [obj, other])
    ev.synchronize_between_processes()
    assert [int(d[0][0]) for d in ev.dets] == [0, 1]
    assert [int(g[0][0]) for g in ev.gts] == [0, 1]
