"""COCO 91-id -> YOLO 80-id class map (the reference's static table, built
from the 11 category ids absent from the 2017 annotations instead of a
literal dict). Unmapped ids map to -1."""

# Ids in [0, 90] that have no category in COCO-2017 (id 0 is background).
_MISSING = (0, 12, 26, 29, 30, 45, 66, 68, 69, 71, 83)


def _build():
    mapping = {}
    nxt = 0
    for coco_id in range(91):
        if coco_id in _MISSING:
            mapping[coco_id] = -1
        else:
            mapping[coco_id] = nxt
            nxt += 1
    if nxt != 80:
        raise AssertionError(f"COCO map has {nxt} classes, not 80")
    return mapping


coco_to_yolov5 = _build()
