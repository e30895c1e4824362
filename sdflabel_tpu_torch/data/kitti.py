"""KITTI annotation selection.

Counterpart of the annotation filters of sdflabel_tpu/data/kitti.py
(reference utils/refinement.py:15-57, 565-583). Frame loading, normals and
depth maps are not ported yet.
"""

from __future__ import annotations


def is_anno_easy(anno) -> bool:
    """refinement.py:15-27."""
    height = anno["bbox"][3] - anno["bbox"][1]
    return not (anno["occluded"] > 0 or anno["truncated"] > 0.15
                or height < 40)


def is_anno_moderate(anno) -> bool:
    """refinement.py:30-41."""
    height = anno["bbox"][3] - anno["bbox"][1]
    return not (anno["occluded"] > 1 or anno["truncated"] > 0.30
                or height < 25)


def is_anno_hard(anno) -> bool:
    """refinement.py:44-57."""
    height = anno["bbox"][3] - anno["bbox"][1]
    return not (anno["occluded"] > 2 or anno["truncated"] > 0.5
                or height < 25)


def get_annos(diff_annos: str, sample: dict) -> list[dict]:
    """Annotations up to a difficulty, sorted by depth
    (refinement.py:565-583)."""
    if diff_annos == "hard":
        annos = (sample["annos"]["easy"] + sample["annos"]["medium"]
                 + sample["annos"]["hard"])
    elif diff_annos == "medium":
        annos = sample["annos"]["easy"] + sample["annos"]["medium"]
    else:
        annos = sample["annos"]["easy"]
    return sorted(annos, key=lambda a: a["location"][2])
