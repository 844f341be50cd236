"""Domain-classified tile datasets, the JAX package's `data/classified.py`
(the reference's `classified_dataloader.py`).

Tiles grouped into one subdirectory per domain: `get_categories` lists the
domains in sorted order (`classified_dataloader.py:14-19`),
`ClassifiedTileDataset` serves one of them (`:22-66`, the main loader's id
and watermark rules), and `category_loaders` gives each domain its own
loader with the few-shot batch size (`:72-94`).
"""

from __future__ import annotations

import os
from typing import List, Optional

from semisupervisedobjectdetection_torch.core.config import DataConfig
from semisupervisedobjectdetection_torch.data.loader import TileLoader
from semisupervisedobjectdetection_torch.data.tiles import TileDataset


def _root(cfg: DataConfig, flag: str) -> Optional[str]:
    return (cfg.unlabeled_classified if flag == "unlabeled"
            else cfg.labeled_classified)


def get_categories(cfg: DataConfig, flag: str = "labeled") -> List[str]:
    """The domain directories under the labeled or unlabeled root, sorted;
    none when the root is unset or missing."""
    root = _root(cfg, flag)
    if root is None or not os.path.isdir(root):
        return []
    return sorted(d for d in os.listdir(root)
                  if os.path.isdir(os.path.join(root, d)))


class ClassifiedTileDataset(TileDataset):
    """One domain-category directory of tiles."""

    def __init__(self, root: str, category: str,
                 mask_dir: Optional[str] = None, canvas: int = 512,
                 cache_mb: float = 0.0):
        super().__init__(os.path.join(root, category), mask_dir,
                         canvas=canvas, has_mask=mask_dir is not None,
                         cache_mb=cache_mb)
        self.category = category


def category_loaders(cfg: DataConfig, flag: str = "labeled",
                     seed: int = 0) -> List[TileLoader]:
    """One loader per domain, in `get_categories` order, with
    `few_shot_batch_size` and seed `seed * 1000 + i` (`:85-91`); the
    labeled domains read their masks from `cfg.maskdir`."""
    root = _root(cfg, flag)
    mask_dir = cfg.maskdir if flag == "labeled" else None
    loaders = []
    for i, cat in enumerate(get_categories(cfg, flag)):
        ds = ClassifiedTileDataset(root, cat, mask_dir, canvas=cfg.canvas,
                                   cache_mb=cfg.cache_mb)
        loaders.append(TileLoader(ds, cfg.few_shot_batch_size,
                                  shuffle=cfg.shuffle,
                                  drop_last=cfg.drop_last,
                                  seed=seed * 1000 + i,
                                  on_bad_tile=cfg.bad_tile_policy))
    return loaders
