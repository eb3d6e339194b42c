"""The comparison that decides ``correct``: detection rows of the program
against the reference's, image by image.

Rows are (cls, x, y, w, h, conf), x/y/w/h normalised to the image. Within an
image, a program row and a reference row of the same class pair when every
corner coordinate lies within ``PAIR_PX`` pixels of the image; pairs are
taken closest first, each row at most once. The numbers compared:

- ``unpaired``: the share of all rows, the program's and the reference's,
  that found no partner (a row missing, extra, moved or of another class);
- ``conf_gap``: the largest confidence gap of a pair;
- ``box_gap_px``: the largest corner gap of a pair, in pixels;
- ``ref_rows``: the reference's rows per image, which must be at least its
  limit, so that a comparison of nothing cannot pass.
"""

from __future__ import annotations

import numpy as np

PAIR_PX = 1.0


def _px(rows, hw):
    h, w = hw
    x, y, bw, bh = rows[:, 1] * w, rows[:, 2] * h, rows[:, 3] * w, rows[:, 4] * h
    return np.stack([x - bw / 2, y - bh / 2, x + bw / 2, y + bh / 2], 1).astype(np.float64)


def pair(prog, ref, hw):
    """Pairs (i, j) of program row i and reference row j, closest first,
    and their corner distances in pixels."""
    if len(prog) == 0 or len(ref) == 0:
        return [], []
    a, b = _px(prog, hw), _px(ref, hw)
    dist = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
    dist[prog[:, 0][:, None] != ref[:, 0][None, :]] = np.inf
    ii, jj = np.nonzero(dist <= PAIR_PX)
    order = np.argsort(dist[ii, jj], kind="stable")
    used_i, used_j, pairs, dists = set(), set(), [], []
    for k in order:
        i, j = int(ii[k]), int(jj[k])
        if i in used_i or j in used_j:
            continue
        used_i.add(i)
        used_j.add(j)
        pairs.append((i, j))
        dists.append(float(dist[i, j]))
    return pairs, dists


def compare(progs, refs, hws) -> dict:
    """The numbers compared over lists of per-image rows."""
    total = unpaired = 0
    conf_gap = box_gap = 0.0
    for prog, ref, hw in zip(progs, refs, hws):
        prog = np.asarray(prog, np.float32).reshape(-1, 6)
        ref = np.asarray(ref, np.float32).reshape(-1, 6)
        pairs, dists = pair(prog, ref, hw)
        total += len(prog) + len(ref)
        unpaired += len(prog) + len(ref) - 2 * len(pairs)
        for (i, j), d in zip(pairs, dists):
            conf_gap = max(conf_gap, abs(float(prog[i, 5]) - float(ref[j, 5])))
            box_gap = max(box_gap, d)
    n_ref = sum(len(np.asarray(r).reshape(-1, 6)) for r in refs)
    return {"unpaired": unpaired / max(total, 1), "conf_gap": conf_gap,
            "box_gap_px": box_gap, "ref_rows": n_ref / max(len(refs), 1)}


def judge(numbers: dict, limits: dict) -> dict:
    """{name: (number, limit, passed)}: ``ref_rows`` is a least value, every
    other limit a most."""
    out = {}
    for name, limit in limits.items():
        v = numbers[name]
        ok = v >= limit if name == "ref_rows" else v <= limit
        out[name] = (v, limit, bool(ok))
    return out
