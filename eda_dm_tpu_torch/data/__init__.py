"""Dataset readers and pixel transforms (port of ``eda_dm_tpu/data``)."""

from .coco import load_coco_prompts
from .datasets import (data_transform, inverse_data_transform, iter_image_folder,
                       load_cifar10, load_lsun, logit_transform)

__all__ = ["load_cifar10", "iter_image_folder", "load_lsun", "data_transform",
           "inverse_data_transform", "logit_transform", "load_coco_prompts"]
