"""Dataset mAP over a fixed detection pool, for many subsets at once.

The port of the JAX package's ``ops/map_kernel.py``. ORIE's Monte-Carlo
draws and the offloading evaluation both need the mAP of a masked subset of
one fixed set of detections. All detections of the dataset (the weak and
the strong stream of every image) are laid out once, on the host, into
per-class confidence-sorted padded arrays (``DetectionPool``); each
evaluation is then a function of per-image inclusion masks:

  * a masked detection never advances its class's TP/FP cumsums, so it
    repeats the previous precision-recall point and drops out of the
    101-point interpolation exactly;
  * per-class label counts come from one (N,) x (N, C) product with the
    label histogram;
  * every function takes a leading batch axis of draws, (B, C, T, K) with
    the cumsums along K; the confidence order of any subset of a sorted
    pool is the sorted order, so nothing is sorted again.

Plain torch ops, as the reference leaves all of it to XLA. Its TPU layouts
of the same values are not ported: ``BucketedPool`` (off by default there),
the blocked triangular-matmul cumsums (``torch.cumsum`` of 0/1 values in f32
is exact below 2^24) and the one-hot row gather.

Exactness: ``ap_interp101`` keeps the reference's scaled-integer recall grid
op for op (``100 * tpc`` against ``k * n_labels``, exact integers in f32).
The label counts ``label_sel @ hist`` are sums of 0/1 times small integers;
the product runs in f64, where they are exact in any order and whatever the
TF32 setting (f32 would be exact below 2^24 only with TF32 off).
The float sums whose order could change the last bit (over K and over the
(C, T) classes) are pairwise sums written as elementwise adds of halves
(``_tree_sum``): their order depends on the row length alone, so a draw's
mAP does not depend on how many draws share its batch, nor on the device
(CUDA's reductions and scans pick their thread layout from the number of
rows). Every other step is exact or rounds once, elementwise, so the card
and the CPU give the same bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

EPS = 1e-16  # the reference's ap_per_class eps


@dataclasses.dataclass(frozen=True)
class DetectionPool:
    """Fixed, per-class confidence-sorted detection pool of a dataset.

    Shapes: C = classes with a detection or a label, K = the most
    detections of one class (both streams, rounded up to 128), T = IoU
    thresholds, N = images.
    """

    tp: torch.Tensor  # (C, K, T) bool: TP flags in conf-descending order
    img: torch.Tensor  # (C, K) int64: source image of each detection
    strong: torch.Tensor  # (C, K) bool: from the strong detector's stream
    valid: torch.Tensor  # (C, K) bool: padding mask
    hist: torch.Tensor  # (N, C) f32: per-image label-class histogram
    class_ids: tuple  # (C,): original class id of each row

    @property
    def num_images(self) -> int:
        return self.hist.shape[0]

    @property
    def num_iou_thresholds(self) -> int:
        return self.tp.shape[2]

    @property
    def device(self) -> torch.device:
        return self.hist.device


def build_pool(weak_data, strong_data, labels, num_classes: int | None = None,
               device=None) -> DetectionPool:
    """Lay out a DetectionPool on the host and move it to ``device``.

    :param weak_data: per image (tp (n, T) bool, conf (n,), cls (n,)), as
        ``set_data`` gives them; strong_data the same for the strong
        detector; labels per image (m,) integer classes (possibly empty).
    :param num_classes: the total class count; inferred when None.
    :param device: where the pool's tensors live (the CPU when None).
    """
    n_img = len(labels)
    if not (len(weak_data) == n_img and len(strong_data) == n_img):
        raise ValueError("weak_data, strong_data and labels differ in length")
    streams = list(weak_data) + list(strong_data)
    all_cls = [np.asarray(c, np.int64).reshape(-1) for _, _, c in streams]
    all_cls += [np.asarray(l, np.int64).reshape(-1) for l in labels]
    observed = np.unique(np.concatenate(all_cls)) if all_cls \
        else np.zeros(0, np.int64)
    class_ids = observed if num_classes is None \
        else np.arange(num_classes, dtype=np.int64)
    c_n = max(len(class_ids), 1)

    def positions(cls):
        """Row of each class id in class_ids (sorted); KeyError if absent."""
        pos = np.searchsorted(class_ids, cls)
        bad = (pos >= len(class_ids)) | (class_ids[np.minimum(
            pos, len(class_ids) - 1)] != cls) if len(class_ids) else \
            np.ones(cls.shape, bool)
        if bad.any():
            raise KeyError(int(cls[bad][0]))
        return pos

    n_thresh = next((np.asarray(tp).shape[1] for tp, _, _ in streams
                     if np.asarray(tp).size), 1)

    rows = [(np.asarray(cls, np.int64).reshape(-1), conf, tp, i, s)
            for s, stream in enumerate((weak_data, strong_data))
            for i, (tp, conf, cls) in enumerate(stream)
            if np.asarray(cls).size]
    if rows:
        f_cls = positions(np.concatenate([r[0] for r in rows]))
        f_conf = np.concatenate([np.asarray(r[1], np.float64).reshape(-1)
                                 for r in rows])
        f_tp = np.concatenate([np.asarray(r[2], bool).reshape(r[0].size, -1)
                               for r in rows])
        f_img = np.concatenate([np.full(r[0].size, r[3], np.int64)
                                for r in rows])
        f_strong = np.concatenate([np.full(r[0].size, bool(r[4]))
                                   for r in rows])
    else:
        f_cls = np.zeros(0, np.int64)
        f_conf = np.zeros(0)
        f_tp = np.zeros((0, n_thresh), bool)
        f_img = np.zeros(0, np.int64)
        f_strong = np.zeros(0, bool)

    counts = np.bincount(f_cls, minlength=c_n)
    k = max(int(counts.max()) if counts.size else 1, 1)
    k = -(-k // 128) * 128  # the reference's shapes, array for array

    # class ascending, then confidence descending; stable, so equal
    # confidences keep row order (the reference's per-class stable argsort)
    order = np.lexsort((-f_conf, f_cls))
    sc = f_cls[order]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(order.size) - starts[sc]
    tp_a = np.zeros((c_n, k, n_thresh), bool)
    img_a = np.zeros((c_n, k), np.int64)
    strong_a = np.zeros((c_n, k), bool)
    valid_a = np.zeros((c_n, k), bool)
    tp_a[sc, rank] = f_tp[order]
    img_a[sc, rank] = f_img[order]
    strong_a[sc, rank] = f_strong[order]
    valid_a[sc, rank] = True

    hist = np.zeros((n_img, c_n), np.float32)
    lab = [np.asarray(l, np.int64).reshape(-1) for l in labels]
    if any(l.size for l in lab):
        lab_img = np.concatenate([np.full(l.size, i) for i, l in
                                  enumerate(lab)])
        np.add.at(hist, (lab_img, positions(np.concatenate(lab))), 1.0)

    dev = torch.device("cpu") if device is None else torch.device(device)
    return DetectionPool(
        tp=torch.from_numpy(tp_a).to(dev),
        img=torch.from_numpy(img_a).to(dev),
        strong=torch.from_numpy(strong_a).to(dev),
        valid=torch.from_numpy(valid_a).to(dev),
        hist=torch.from_numpy(hist).to(dev),
        class_ids=tuple(int(c) for c in class_ids),
    )


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum along the last axis in an order fixed by its length alone: the
    halves added elementwise until one column is left (an odd length gets
    a zero column first)."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.nn.functional.pad(x, (0, 1))
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def ap_interp101(tpc: torch.Tensor, fpc: torch.Tensor,
                 n_labels: torch.Tensor) -> torch.Tensor:
    """AP by the 101-point COCO interpolation from masked TP/FP cumsums.

    :param tpc: (..., K) cumulative true positives along the conf-sorted
        pool axis (masked rows repeat the previous value); fpc the same for
        false positives.
    :param n_labels: (...) ground-truth objects of the class.
    :return: (...) AP, 0 where the class has no prediction, with the
        reference's sentinels and precision envelope.
    """
    n_pred = tpc + fpc
    precision = tpc / torch.clamp_min(n_pred, EPS)
    # reverse running max: the precision envelope, forward-filled through
    # masked rows
    env = torch.flip(torch.cummax(torch.flip(precision, [-1]), dim=-1).values,
                     [-1])
    # rows before the first real point carry the leading sentinel 1.0
    y_curve = torch.where(n_pred > 0, env, 1.0)

    # the scaled-integer recall axis: 100 * tpc against k * n_labels, exact
    # integers in f32; each segment [x_j, x_j+1) owns the grid points
    # ceil(x_j / nl) <= k < ceil(x_j+1 / nl), an arithmetic series
    nl = torch.clamp_min(n_labels, 1.0)[..., None]
    zero = torch.zeros_like(tpc[..., :1])
    x = torch.cat([zero, tpc * 100.0, nl * 100.0], dim=-1)  # (..., K + 2)
    y = torch.cat([zero + 1.0, y_curve, zero], dim=-1)
    x0, x1 = x[..., :-1], x[..., 1:]
    y0, y1 = y[..., :-1], y[..., 1:]
    klo = torch.ceil(x0 / nl)
    khi = torch.clamp_max(torch.ceil(x1 / nl), 100.0)
    m = torch.clamp_min(khi - klo, 0.0)
    has = (m > 0.0) & (x1 > x0)
    slope = torch.where(has, (y1 - y0) / torch.clamp_min(x1 - x0, 1.0), 0.0)
    sum_k = (klo + khi - 1.0) * m * 0.5
    seg = y0 * m + slope * (nl * sum_k - x0 * m)
    total = _tree_sum(torch.where(m > 0.0, seg, 0.0))
    # y at grid point 0, for the trapezoid's end correction: one segment
    # at most owns it, so this sum is exact in any order
    owns0 = (klo == 0.0) & (m > 0.0)
    y_at_0 = torch.where(owns0, y0 - slope * x0, 0.0).sum(dim=-1)
    ap = (total - 0.5 * y_at_0) * 0.01
    return torch.where(n_pred[..., -1] > 0, ap, 0.0)


def _ap_from_sel(pool: DetectionPool, sel: torch.Tensor,
                 nt: torch.Tensor) -> torch.Tensor:
    """AP (B, C, T) from per-detection inclusion masks sel (B, C, K) and
    label counts nt (B, C)."""
    m = (sel & pool.valid).to(torch.float32)  # (B, C, K)
    tp_t = pool.tp.permute(0, 2, 1).to(torch.float32)  # (C, T, K)
    tpc = torch.cumsum(tp_t * m[:, :, None, :], dim=-1)  # (B, C, T, K)
    npred = torch.cumsum(m, dim=-1)  # (B, C, K)
    fpc = npred[:, :, None, :] - tpc
    return ap_interp101(tpc, fpc, nt[:, :, None].expand(tpc.shape[:-1]))


def _label_counts(pool: DetectionPool, label_sel: torch.Tensor):
    """Per-class label counts (B, C) of label_sel (B, N): exact integers."""
    return (label_sel.to(torch.float64) @ pool.hist.to(torch.float64)).to(
        torch.float32)


def _ap_sums(pool, weak_sel, strong_sel, label_sel):
    """(sum over classes of AP * has (B, T), labelled classes (B,)) for
    masks (B, N)."""
    nt = _label_counts(pool, label_sel)
    sel = torch.where(pool.strong, strong_sel[:, pool.img],
                      weak_sel[:, pool.img])
    ap = _ap_from_sel(pool, sel, nt)
    has = (nt > 0).to(torch.float32)
    sum_ap = _tree_sum((ap * has[:, :, None]).transpose(1, 2))
    return sum_ap, has.sum(dim=1)


def map_from_masks(pool: DetectionPool, weak_sel: torch.Tensor,
                   strong_sel: torch.Tensor,
                   label_sel: torch.Tensor) -> torch.Tensor:
    """Dataset mAP of each subset selection.

    :param weak_sel: (B, N) bool, images contributing their weak
        detections; strong_sel the same for strong detections; label_sel
        (B, N) images contributing their labels.
    :return: (B,) mean AP over (labelled classes) x (IoU thresholds); NaN
        where no selected image has labels.
    """
    sum_ap, n_has = _ap_sums(pool, weak_sel, strong_sel, label_sel)
    return _tree_sum(sum_ap) / (n_has * sum_ap.shape[1])


def map_per_threshold(pool: DetectionPool, weak_sel: torch.Tensor,
                      strong_sel: torch.Tensor,
                      label_sel: torch.Tensor) -> torch.Tensor:
    """Per-IoU-threshold mAP (B, T) of each subset selection."""
    sum_ap, n_has = _ap_sums(pool, weak_sel, strong_sel, label_sel)
    return sum_ap / n_has[:, None]


def orie_map_pair(pool: DetectionPool, in_ens: torch.Tensor,
                  target: torch.Tensor):
    """(weak_map, strong_map) of ORIE draws, sharing the mask gather and the
    label counts between the two evaluations.

    Equivalent to map_from_masks(pool, lmask, 0, lmask) and
    map_from_masks(pool, in_ens, is_target, lmask) with lmask = in_ens |
    is_target; the target counts as excluded from the ensemble either way.

    :param in_ens: (B, N) bool ensemble membership.
    :param target: (B,) int target image of each draw.
    :return: two (B,) f32 tensors.
    """
    n = pool.num_images
    target = target.to(torch.int64)
    lmask = in_ens | (torch.arange(n, device=in_ens.device)[None, :]
                      == target[:, None])
    nt = _label_counts(pool, lmask)
    lm_rows = lmask[:, pool.img]  # (B, C, K), the one gather
    is_t = pool.img[None] == target[:, None, None]
    sel_weak = lm_rows & ~pool.strong
    sel_strong = torch.where(pool.strong, is_t, lm_rows & ~is_t)
    has = (nt > 0).to(torch.float32)

    def ap_sum(sel):
        ap = _ap_from_sel(pool, sel, nt) * has[:, :, None]
        return _tree_sum(ap.flatten(1))

    denom = has.sum(dim=1) * pool.num_iou_thresholds
    return ap_sum(sel_weak) / denom, ap_sum(sel_strong) / denom


def dataset_map(pool: DetectionPool, offload_mask: torch.Tensor
                ) -> torch.Tensor:
    """mAP (B,) when the images of ``offload_mask`` (B, N) use their strong
    detections and the others their weak ones."""
    ones = torch.ones_like(offload_mask)
    return map_from_masks(pool, ~offload_mask, offload_mask, ones)
