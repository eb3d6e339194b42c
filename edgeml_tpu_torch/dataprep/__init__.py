from .labels import (
    COCO_SPLITS, VOC_CLASS_NAMES, VOC_SPLITS, coco_label, parse_voc_xml,
    voc_examples, voc_label,
)
from .split import split_dataset

__all__ = ["split_dataset", "coco_label", "voc_label", "parse_voc_xml",
           "voc_examples", "VOC_CLASS_NAMES", "COCO_SPLITS", "VOC_SPLITS"]
