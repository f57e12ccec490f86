"""COCO captions for the text-to-image task (port of
``eda_dm_tpu/data/coco.py``)."""

from __future__ import annotations

import json
import random
from typing import List, Optional


def load_coco_prompts(json_path: str, shuffle: bool = True, seed: int = 1234,
                      limit: Optional[int] = None) -> List[str]:
    """Captions from a COCO annotations JSON (``annotations[*].caption``),
    or from a plain file of one prompt a line; shuffled by ``seed``."""
    with open(json_path) as f:
        head = f.read(1)
        f.seek(0)
        if head == "{":
            prompts = [a["caption"].strip() for a in json.load(f)["annotations"]]
        else:
            prompts = [ln.strip() for ln in f if ln.strip()]
    if shuffle:
        random.Random(seed).shuffle(prompts)
    return prompts[:limit] if limit is not None else prompts
