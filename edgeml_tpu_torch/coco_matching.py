"""COCOeval-compatible matching and accumulation for bbox, segm and
keypoints (host NumPy).

A copy of the JAX package's ``coco_matching.py`` (host-only code; the port
keeps its own so that it never imports the JAX package), reading the port's
own RLE codec. Its summaries equal the JAX package's exactly. The semantics
are pycocotools' COCOeval, written from the published algorithm:

  * per-category evaluation, detections visited in descending score order;
  * each detection takes the not-yet-matched ground truth with the highest
    IoU above the threshold, preferring non-ignored ground truths; crowd
    ground truths can absorb any number of detections;
  * crowd IoU divides by the DETECTION area (intersection-over-foreground);
  * ground truths outside the area range are "ignored": they neither count
    toward recall nor turn their matched detections into false positives;
    unmatched detections outside the area range are ignored too;
  * per (category, area-range, maxDets): detections capped per image at
    maxDets by score, PR curve at 101 recall points with the running-max
    precision envelope, AP = mean over the grid; categories with no
    ground truth are excluded (not zero).

``eval_coco.DetectionEvaluator(style="coco")`` runs it; the greedy style
there is the throughput path on the device.
"""

from __future__ import annotations

import numpy as np

from .dataprep.coco_dataset import rle_decode

AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
REC_THRS = np.linspace(0.0, 1.0, 101)

# COCO 17-keypoint OKS falloff constants (published COCOeval defaults).
KPT_OKS_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72,
     .62, .62, 1.07, 1.07, .87, .87, .89, .89]
) / 10.0
# COCOeval keypoints params: no "small" range, maxDets capped at 20
KPT_AREA_NAMES = ("all", "medium", "large")
KPT_MAX_DETS = (20,)


def iou_xyxy(dt: np.ndarray, gt: np.ndarray, crowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU matrix; for crowd gt columns the denominator is the
    detection's own area (pycocotools `iscrowd` convention)."""
    dt = dt.reshape(-1, 4)
    gt = gt.reshape(-1, 4)
    lo = np.maximum(dt[:, None, :2], gt[None, :, :2])
    hi = np.minimum(dt[:, None, 2:], gt[None, :, 2:])
    inter = np.prod(np.clip(hi - lo, 0.0, None), axis=-1)
    d_area = np.prod(np.clip(dt[:, 2:] - dt[:, :2], 0.0, None), axis=-1)
    g_area = np.prod(np.clip(gt[:, 2:] - gt[:, :2], 0.0, None), axis=-1)
    union = np.where(
        crowd[None, :].astype(bool),
        d_area[:, None],
        d_area[:, None] + g_area[None, :] - inter,
    )
    return inter / np.maximum(union, 1e-12)


def mask_iou(dt_masks: np.ndarray, gt_masks: np.ndarray,
             crowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU of binary masks; crowd columns use the DETECTION area as
    the denominator (pycocotools maskUtils.iou `iscrowd` convention)."""
    dm = np.asarray(dt_masks, bool).reshape(len(dt_masks), -1)
    gm = np.asarray(gt_masks, bool).reshape(len(gt_masks), -1)
    inter = dm.astype(np.float64) @ gm.astype(np.float64).T
    d_area = dm.sum(axis=1).astype(np.float64)
    g_area = gm.sum(axis=1).astype(np.float64)
    union = np.where(
        np.asarray(crowd, bool)[None, :],
        d_area[:, None],
        d_area[:, None] + g_area[None, :] - inter,
    )
    return inter / np.maximum(union, 1e-12)


def oks_matrix(
    dt_kpts: np.ndarray,  # (D, K, 3) x, y, [score/vis — unused for dets]
    gt_kpts: np.ndarray,  # (G, K, 3) x, y, visibility
    gt_areas: np.ndarray,  # (G,) object areas (COCO gt 'area')
    gt_boxes: np.ndarray,  # (G, 4) xyxy — fallback extent when no kpt labeled
    sigmas: np.ndarray | None = None,
) -> np.ndarray:
    """(D, G) object-keypoint-similarity matrix, COCOeval computeOks
    semantics: per-keypoint Gaussian falloff with variance (2*sigma)^2 scaled
    by the ground truth's area, averaged over the gt's LABELED keypoints
    (visibility > 0); a gt with no labeled keypoints instead penalizes
    detection keypoints by their distance outside the gt box expanded by 2x
    its size on each side."""
    sig = np.asarray(sigmas if sigmas is not None else KPT_OKS_SIGMAS, float)
    var = (2.0 * sig) ** 2  # (K,)
    d, g = len(dt_kpts), len(gt_kpts)
    out = np.zeros((d, g))
    if not (d and g):
        return out
    dt_kpts = np.asarray(dt_kpts, float)
    gt_kpts = np.asarray(gt_kpts, float)
    xd, yd = dt_kpts[:, :, 0], dt_kpts[:, :, 1]  # (D, K)
    for gi in range(g):
        xg, yg, vg = gt_kpts[gi, :, 0], gt_kpts[gi, :, 1], gt_kpts[gi, :, 2]
        labeled = vg > 0
        if labeled.any():
            dx, dy = xd - xg[None, :], yd - yg[None, :]
        else:
            bx0, by0, bx1, by1 = gt_boxes[gi]
            w, h = bx1 - bx0, by1 - by0
            x0, x1 = bx0 - w, bx1 + w
            y0, y1 = by0 - h, by1 + h
            dx = np.clip(x0 - xd, 0.0, None) + np.clip(xd - x1, 0.0, None)
            dy = np.clip(y0 - yd, 0.0, None) + np.clip(yd - y1, 0.0, None)
        e = (dx**2 + dy**2) / var[None, :] / (
            float(gt_areas[gi]) + np.spacing(1)) / 2.0
        if labeled.any():
            e = e[:, labeled]
        out[:, gi] = np.exp(-e).sum(axis=1) / e.shape[1]
    return out


def _as_mask_array(masks, n: int):
    """Normalize a per-image mask payload to an (n, H, W) bool array.
    Accepts an array, a list of dense masks, or a list of COCO RLE dicts."""
    if masks is None:
        raise ValueError("segm evaluation requires masks for every image")
    if isinstance(masks, np.ndarray):
        out = masks.astype(bool)
    else:
        out = np.stack(
            [
                rle_decode(m) if isinstance(m, dict) else np.asarray(m, bool)
                for m in masks
            ]
        ) if len(masks) else np.zeros((0, 1, 1), bool)
    assert len(out) == n, (len(out), n)
    return out


def match_image(
    dt_boxes: np.ndarray,  # (D, 4) xyxy, ALREADY sorted by descending score
    gt_boxes: np.ndarray,  # (G, 4) xyxy
    gt_crowd: np.ndarray,  # (G,) bool
    iouv: np.ndarray,  # (T,) thresholds
    area_rng: tuple,
    ious: np.ndarray | None = None,  # optional precomputed (D, G) IoU
    gt_areas: np.ndarray | None = None,  # override box areas (segm: mask area)
    dt_areas: np.ndarray | None = None,
    gt_force_ignore: np.ndarray | None = None,  # (G,) extra ignores (kpts)
) -> tuple:
    """One (image, category) matching pass.

    :return: (dt_matched (T, D) bool, dt_ignored (T, D) bool,
        gt_ignored (G,) bool).
    """
    d, g = len(dt_boxes), len(gt_boxes)
    t = len(iouv)
    if gt_areas is not None:
        g_area = np.asarray(gt_areas, float).reshape(-1)
    else:
        g_area = np.prod(
            np.clip(gt_boxes[:, 2:] - gt_boxes[:, :2], 0.0, None), -1
        ) if g else np.zeros((0,))
    gt_ig = gt_crowd.astype(bool) | (g_area < area_rng[0]) | (g_area > area_rng[1])
    if gt_force_ignore is not None:
        gt_ig = gt_ig | np.asarray(gt_force_ignore, bool).reshape(-1)
    # visit non-ignored ground truths first (stable)
    g_order = np.argsort(gt_ig, kind="stable")
    dtm = np.zeros((t, d), dtype=np.int64) - 1
    dt_ig_flag = np.zeros((t, d), bool)
    if d and g:
        if ious is None:
            ious = iou_xyxy(dt_boxes, gt_boxes, gt_crowd)
        for ti, thr in enumerate(iouv):
            gtm = np.zeros(g, dtype=np.int64) - 1
            for di in range(d):
                # iou >= thr matches; the cap lets thr=1.0 accept exact overlap
                best = min(thr, 1.0 - 1e-10)
                m = -1
                for gi in g_order:
                    if gtm[gi] >= 0 and not gt_crowd[gi]:
                        continue
                    # past all non-ignored gts with a real match in hand:
                    # never trade it for an ignored gt
                    if m > -1 and not gt_ig[m] and gt_ig[gi]:
                        break
                    if ious[di, gi] < best:
                        continue
                    best = ious[di, gi]
                    m = gi
                if m == -1:
                    continue
                dtm[ti, di] = m
                gtm[m] = di
                dt_ig_flag[ti, di] = gt_ig[m]
    # unmatched detections outside the area range are ignored
    if d:
        if dt_areas is not None:
            d_area = np.asarray(dt_areas, float).reshape(-1)
        else:
            d_area = np.prod(
                np.clip(dt_boxes[:, 2:] - dt_boxes[:, :2], 0.0, None), -1
            )
        out = (d_area < area_rng[0]) | (d_area > area_rng[1])
        dt_ig_flag |= (dtm < 0) & out[None, :]
    return dtm >= 0, dt_ig_flag, gt_ig


def evaluate_coco(
    dets: list,  # per image: (cls (n,), boxes xyxy (n, 4), scores (n,))
    gts: list,  # per image: (cls (m,), boxes xyxy (m, 4)[, iscrowd (m,)])
    iouv: np.ndarray | None = None,
    max_dets: tuple | None = None,
    area_names: tuple | None = None,
    iou_type: str = "bbox",
    kpt_sigmas: np.ndarray | None = None,  # per-keypoint OKS falloffs
) -> dict:
    """Full COCO-style evaluation over the dataset.

    iou_type="bbox" (default) matches on box IoU. iou_type="segm" matches on
    MASK IoU with mask areas driving the area ranges (torchvision's
    CocoEvaluator segm dispatch); each det tuple then carries masks as a
    4th element and each gt as a 4th element after iscrowd — an (n, H, W)
    bool array or a list of COCO RLE dicts (dataprep.coco_dataset.rle_encode
    format).

    iou_type="keypoints" matches on OKS (torchvision's CocoEvaluator
    keypoints dispatch): each det tuple carries keypoints as a 4th element
    ((n, K, 3) x/y/score rows) and each gt as a 4th element after iscrowd
    ((m, K, 3) x/y/vis), optionally followed by (m,) object areas (COCO gt
    'area'; defaults to box area). Ground truths with zero labeled keypoints are ignored, area
    ranges default to all/medium/large and maxDets to (20,), and detection
    areas follow pycocotools loadRes: the keypoint-extent box.

    max_dets / area_names default per iou_type: (1, 10, 100) over
    all/small/medium/large for bbox and segm, COCOeval's keypoint params
    otherwise.

    Returns the 12-number COCO summary plus the raw precision array
    ap[T, R, C, A, M] (R = 101 recall points), with -1 marking absent
    ground truth (excluded from means), exactly like COCOeval.accumulate.
    """
    assert iou_type in ("bbox", "segm", "keypoints"), iou_type
    if max_dets is None:
        max_dets = KPT_MAX_DETS if iou_type == "keypoints" else (1, 10, 100)
    if area_names is None:
        area_names = (
            KPT_AREA_NAMES if iou_type == "keypoints"
            else ("all", "small", "medium", "large")
        )
    iouv = np.asarray(iouv if iouv is not None else np.round(
        np.linspace(0.5, 0.95, 10), 2))
    if iou_type == "segm":
        # decode every image's masks ONCE (shared across categories)
        dt_masks_all = [
            _as_mask_array(d[3] if len(d) > 3 else None,
                           len(np.asarray(d[0]).reshape(-1)))
            for d in dets
        ]
        gt_masks_all = [
            _as_mask_array(g[3] if len(g) > 3 else None,
                           len(np.asarray(g[0]).reshape(-1)))
            for g in gts
        ]
    cats = sorted(
        {int(c) for d in dets for c in np.asarray(d[0]).reshape(-1)}
        | {int(c) for g in gts for c in np.asarray(g[0]).reshape(-1)}
    )
    t, r = len(iouv), len(REC_THRS)
    c_n, a_n, m_n = len(cats), len(area_names), len(max_dets)
    precision = -np.ones((t, r, c_n, a_n, m_n))
    recall = -np.ones((t, c_n, a_n, m_n))
    max_cap = max(max_dets)

    for ci, cat in enumerate(cats):
        # per-image per-category slices, score-sorted, capped at max(max_dets)
        per_img = []
        areas_per_img = []  # (dt_areas, gt_areas) overrides; None for bbox
        ious_per_img = []
        ignore_per_img = []  # extra gt ignores (keypoints: nothing labeled)
        for ii, (d, g) in enumerate(zip(dets, gts)):
            d_cls = np.asarray(d[0]).reshape(-1)
            d_box = np.asarray(d[1]).reshape(-1, 4)
            d_sc = np.asarray(d[2]).reshape(-1)
            sel = d_cls == cat
            order = np.argsort(-d_sc[sel], kind="mergesort")[:max_cap]
            g_cls = np.asarray(g[0]).reshape(-1)
            g_box = np.asarray(g[1]).reshape(-1, 4)
            g_cr = (
                np.asarray(g[2]).reshape(-1).astype(bool)
                if len(g) > 2 else np.zeros(len(g_cls), bool)
            )
            gsel = g_cls == cat
            db, gb, gc = d_box[sel][order], g_box[gsel], g_cr[gsel]
            per_img.append((db, d_sc[sel][order], gb, gc))
            # IoU matrices do not depend on the area range — compute once per
            # (image, category), reuse across all ranges (as COCOeval does)
            if iou_type == "segm":
                dm = dt_masks_all[ii][sel][order]
                gm = gt_masks_all[ii][gsel]
                areas_per_img.append(
                    (dm.sum(axis=(1, 2)), gm.sum(axis=(1, 2)))
                )
                ious_per_img.append(
                    mask_iou(dm, gm, gc) if len(dm) and len(gm) else None
                )
                ignore_per_img.append(None)
            elif iou_type == "keypoints":
                if len(d) <= 3 or len(g) <= 3:
                    raise ValueError(
                        "keypoints evaluation requires keypoint payloads on "
                        "every detection and ground-truth tuple"
                    )
                dk = np.asarray(d[3], float).reshape(len(d_cls), -1, 3)[sel][order]
                gk = np.asarray(g[3], float).reshape(len(g_cls), -1, 3)[gsel]
                g_area = (
                    np.asarray(g[4], float).reshape(-1)[gsel]
                    if len(g) > 4 else np.prod(
                        np.clip(gb[:, 2:] - gb[:, :2], 0.0, None), -1)
                )
                # detection area per pycocotools loadRes: keypoint extent box
                if len(dk):
                    ext = dk[:, :, :2].max(axis=1) - dk[:, :, :2].min(axis=1)
                    d_area = ext[:, 0] * ext[:, 1]
                else:
                    d_area = np.zeros((0,))
                areas_per_img.append((d_area, g_area))
                ious_per_img.append(
                    oks_matrix(dk, gk, g_area, gb, sigmas=kpt_sigmas)
                    if len(dk) and len(gk) else None
                )
                # gts with no labeled keypoint never count (COCOeval sets
                # ignore when num_keypoints == 0)
                ignore_per_img.append(
                    (gk[:, :, 2] > 0).sum(axis=1) == 0
                    if len(gk) else np.zeros((0,), bool)
                )
            else:
                areas_per_img.append((None, None))
                ious_per_img.append(
                    iou_xyxy(db, gb, gc) if len(db) and len(gb) else None
                )
                ignore_per_img.append(None)
        for ai, aname in enumerate(area_names):
            rng = AREA_RNG[aname]
            matched = [
                match_image(db, gb, gc, iouv, rng, ious=iou,
                            dt_areas=da, gt_areas=ga, gt_force_ignore=fi)
                for (db, ds, gb, gc), iou, (da, ga), fi in zip(
                    per_img, ious_per_img, areas_per_img, ignore_per_img
                )
            ]
            for mi, md in enumerate(max_dets):
                scores = np.concatenate([ds[:md] for _, ds, _, _ in per_img])
                dtm = np.concatenate(
                    [m[0][:, :md] for m in matched], axis=1)  # (T, D)
                dtig = np.concatenate([m[1][:, :md] for m in matched], axis=1)
                npig = int(sum((~m[2]).sum() for m in matched))
                if npig == 0:
                    continue
                order = np.argsort(-scores, kind="mergesort")
                dtm, dtig = dtm[:, order], dtig[:, order]
                tps = dtm & ~dtig
                fps = ~dtm & ~dtig
                tp_cum = np.cumsum(tps, axis=1).astype(float)
                fp_cum = np.cumsum(fps, axis=1).astype(float)
                for ti in range(t):
                    tpc, fpc = tp_cum[ti], fp_cum[ti]
                    rc = tpc / npig
                    pr = tpc / np.maximum(tpc + fpc, np.spacing(1))
                    recall[ti, ci, ai, mi] = rc[-1] if len(rc) else 0.0
                    # precision envelope (running max from the right)
                    q = np.zeros(r)
                    if len(pr):
                        pr = np.maximum.accumulate(pr[::-1])[::-1]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        ok = inds < len(pr)
                        q[ok] = pr[inds[ok]]
                    precision[ti, :, ci, ai, mi] = q

    def _mean(arr):
        v = arr[arr > -1]
        return float(np.mean(v)) if v.size else float("nan")

    ai_all = area_names.index("all")
    mi_100 = max_dets.index(max(max_dets))
    stats = {
        "map": _mean(precision[:, :, :, ai_all, mi_100]),
        "map50": _mean(precision[0, :, :, ai_all, mi_100]),
        "map75": _mean(precision[5, :, :, ai_all, mi_100])
        if t > 5 else float("nan"),
        "mar": _mean(recall[:, :, ai_all, mi_100]),
        "precision": precision,
        "recall": recall,
        "categories": cats,
    }
    for aname in ("small", "medium", "large"):
        if aname in area_names:
            ai = area_names.index(aname)
            stats[f"map_{aname}"] = _mean(precision[:, :, :, ai, mi_100])
            stats[f"mar_{aname}"] = _mean(recall[:, :, ai, mi_100])
    for mi, md in enumerate(max_dets):
        stats[f"mar_{md}"] = _mean(recall[:, :, ai_all, mi])
    return stats
