"""Batching host loader.

Replaces the reference's torch `DataLoader` subclasses
(`archaeological_georgia_biostyle_dataloader.py:118-138`,
`classified_dataloader.py:72-94`) with a simple deterministic numpy batcher:
shuffle ids per epoch, drop the remainder batch (reference drop_last=True,
`config.py:42`), and optionally stride the id list by a shard index so each
of several processes reads a disjoint shard of the dataset.

(The port's own copy of the JAX package's numpy-only `data/loader.py`: the
same batches in the same order for the same seed.)
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from semisupervisedobjectdetection_torch.data.tiles import TileDataset


class TileLoader:
    """Iterates (images uint8 (B,H,W,3), masks uint8 (B,H,W) | None)."""

    def __init__(self, dataset: TileDataset, batch_size: int,
                 shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, num_shards: int = 1, shard_index: int = 0,
                 on_bad_tile: str = "raise"):
        if on_bad_tile not in ("raise", "substitute"):
            raise ValueError(f"on_bad_tile must be 'raise' or "
                             f"'substitute', got {on_bad_tile!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.on_bad_tile = on_bad_tile
        self._bad: set = set()      # indices that failed to decode

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx[self.shard_index::self.num_shards]

    def __len__(self) -> int:
        n = len(range(self.shard_index, len(self.dataset), self.num_shards))
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def reshuffle(self) -> None:
        """Parity with the classified loader's in-place reshuffle
        (`classified_dataloader.py:92-94`); epochs reshuffle automatically."""
        pass

    def _get_item(self, i: int, pool: np.ndarray):
        """dataset[i], or — under on_bad_tile='substitute' — the first
        readable tile from `pool` when item i fails to decode. Keeps batch
        shapes fixed (dropping an item would change the batch) and warns
        once per bad index; a run where
        EVERY tile is unreadable still raises. The reference crashes on
        the first bad file (skimage.io inside __getitem__,
        `archaeological_georgia_biostyle_dataloader.py:59-69`)."""
        try:
            return self.dataset[int(i)]
        except Exception as e:
            if self.on_bad_tile == "raise":
                raise
            if i not in self._bad:
                self._bad.add(int(i))
                name = (self.dataset.ids[int(i)]
                        if int(i) < len(getattr(self.dataset, "ids", []))
                        else int(i))
                print(f"WARNING: bad tile {name!r} "
                      f"({type(e).__name__}: {e}); substituting a "
                      f"readable tile", flush=True)
        for j in pool:
            if int(j) in self._bad or int(j) == int(i):
                continue
            try:
                return self.dataset[int(j)]
            except Exception:
                self._bad.add(int(j))
        raise RuntimeError(
            f"no readable tile left to substitute for bad index {i} "
            f"({len(self._bad)} bad of {len(self.dataset)})")

    def __iter__(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
        idx = self._epoch_indices()
        nb = len(idx) // self.batch_size if self.drop_last else -(
            -len(idx) // self.batch_size)
        for b in range(nb):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            imgs, masks = [], []
            for i in sel:
                img, mask = self._get_item(int(i), idx)
                imgs.append(img)
                if mask is not None:
                    masks.append(mask)
            images = np.stack(imgs)
            yield images, (np.stack(masks) if masks else None)


def split_dataset(dataset: TileDataset, frac: float = 0.8, seed: int = 0
                  ) -> Tuple[TileDataset, TileDataset]:
    """80/20 random split mirroring `torch.utils.data.random_split` usage
    (`main_segformer/segFormer_main.py:107-109`)."""
    import copy
    import math

    n = len(dataset)
    n_train = math.floor(n * frac)
    perm = np.random.default_rng(seed).permutation(n)
    train = copy.copy(dataset)
    val = copy.copy(dataset)
    train.ids = [dataset.ids[i] for i in perm[:n_train]]
    val.ids = [dataset.ids[i] for i in perm[n_train:]]
    return train, val
