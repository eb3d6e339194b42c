"""Frozen least-time (roofline) bounds of the port's hand-written NMS and
gather kernels, from their inputs: operations over the card's f32 rate
against bytes over its HBM rate. Copied unchanged in arithmetic from the
kernel bring-up's smoke script so that later per-kernel roofline metrics
(``<kernel>_roofline``) read a yardstick that the program cannot move. Not
used by any metric yet."""

import torch

H100_F32_OPS = 67e12  # non-tensor f32 FLOP/s, H100 SXM data sheet
H100_BYTES = 3.35e12  # HBM3 bytes/s
OPS_PER_PAIR = 15  # IoU + compare per (suppressor, target) pair, as in the kernel
OPS_PER_BOX = 5  # area per box
# sequential suppressor, per live candidate per step: IoU + compare (15) and
# the argmax's compare and select (2)
OPS_PER_LIVE = 17


def suppressor_bound_ms(boxes, scores):
    """Least time for the greedy mask on these inputs: each input byte read
    once and each output byte written once over the HBM rate, against the
    f32 operations the data needs (every pair of valid candidates, plus box
    areas) over the non-tensor f32 rate. Returns (ms, "bytes"|"operations")."""
    b, k, _ = boxes.shape
    v = (scores > 0).sum(dim=1).double()
    pairs = float((v * (v - 1) / 2).sum())
    ops = OPS_PER_PAIR * pairs + OPS_PER_BOX * b * k
    nbytes = b * k * 16 + b * k + b * k  # f32 boxes + bool valid + bool out
    t_ops, t_bytes = ops / H100_F32_OPS, nbytes / H100_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")




def seq_bound_ms(boxes, scores, picks, thr):
    """Least time for the sequential suppressor on these inputs: the bytes
    (boxes and scores read once, kept and picks written once) over the HBM
    rate, against the f32 operations this data needs over the non-tensor
    f32 rate: OPS_PER_LIVE for every (step, candidate still live at that
    step) and the areas. A candidate is live from step 0 up to the step
    that picks or suppresses it. Returns (ms, "bytes"|"operations", live
    pairs, picks, most picks of a segment)."""
    s_, k = scores.shape
    p = picks.shape[1]
    n_picks = (picks >= 0).sum(dim=1)
    pb = boxes.gather(1, picks.clamp_min(0).long()[..., None].expand(
        s_, p, 4))  # (S, P, 4)
    x1, y1, x2, y2 = (boxes[:, None, :, i] for i in range(4))
    area = (x2 - x1) * (y2 - y1)
    px1, py1, px2, py2 = (pb[:, :, None, i] for i in range(4))
    parea = (px2 - px1) * (py2 - py1)
    inter = torch.clamp_min(torch.minimum(px2, x2) - torch.maximum(px1, x1),
                            0) * torch.clamp_min(
        torch.minimum(py2, y2) - torch.maximum(py1, y1), 0)
    iou = inter / torch.clamp_min(parea + area - inter, 1e-12)
    step = torch.arange(p, device=boxes.device)
    lane = torch.arange(k, device=boxes.device)
    done = (step[None, :] < n_picks[:, None])[..., None]  # (S, P, 1)
    hit = ((iou > thr) | (picks.long()[..., None] == lane)) & done
    # live steps: up to and including the first hit, else every step
    first = torch.where(hit.any(dim=1), hit.int().argmax(dim=1) + 1,
                        n_picks[:, None].expand(s_, k))
    live = float(torch.where(scores > 0, first, 0).sum())
    ops = OPS_PER_LIVE * live + OPS_PER_BOX * s_ * k
    nbytes = s_ * k * (16 + 4 + 1) + s_ * p * 4
    t_ops, t_bytes = ops / H100_F32_OPS, nbytes / H100_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", int(live),
            int(n_picks.sum()), int(n_picks.max()))




def gather_bound_ms(src, idx, scale, out):
    """Least time for the row gather: the distinct source rows (and scales)
    it needs and the indices read once, the output written once, over the
    HBM rate (a multiply per element at most: bytes bound it)."""
    b = idx.shape[0]
    rows = sum(int(torch.unique(idx[i]).numel()) for i in range(b))
    nbytes = rows * src.shape[2] * src.element_size() \
        + idx.numel() * idx.element_size() \
        + out.numel() * out.element_size() \
        + (0 if scale is None else rows * scale.element_size())
    return nbytes / H100_BYTES * 1e3, "bytes"
