"""Host-side tile dataset: decode, watermark-crop, id-parsing.

Reproduces the semantics of the reference loader
(`archaeological_georgia_biostyle_dataloader.py`):

- glob `*.png` in the data dir; files whose basename contains 'mask' are
  skipped; basenames longer than 8 chars are labeled ids (strip the
  'bing.png' suffix), shorter ones mark the directory as unlabeled
  (strip '.png') — ref `:42-48`.
- image = `{id}bing.png` (labeled) / `{id}.png` (unlabeled), with the
  bottom 23-pixel Bing watermark strip removed and alpha dropped — ref
  `:59-60`. Book scans crop 75 px (ref `:66`) — supported via `book=True`.
- mask = `{maskdir}/{id}bing_mask.png`, channel 0, watermark-cropped — ref
  `:62-63,85`.

Instead of returning ragged arrays to a collate, decoded tiles are resized
on the host to a fixed uint8 canvas (`DataConfig.canvas`), so batches have
one shape and the random crop/flip/normalise runs on the device
(`data/augment.py`).

(The port's own copy of the JAX package's numpy/PIL-only `data/tiles.py`.)
"""

from __future__ import annotations

import glob
import os
import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image

BING_WATERMARK_PX = 23
BOOK_WATERMARK_PX = 75


class _DecodedCache:
    """Byte-budgeted LRU of decoded items, keyed by file path.

    The reference re-decodes every tile every epoch
    (`archaeological_georgia_biostyle_dataloader.py:59-69` runs inside
    `__getitem__`); on hosts with few CPU cores, PNG
    decode dominates epoch wall time once the compiled step is fast.
    Cached values are the POST-resize canvas arrays (decode + watermark
    crop + resize all amortized) and are marked read-only — consumers
    stack them into fresh batch arrays, never mutate in place. Path keys
    (not indices) keep `split_dataset`'s shallow copies — which share
    this object — correct. Thread-safe for the prefetch thread
    (`data/prefetch.py`) iterating while the main thread runs eval."""

    def __init__(self, budget_mb: float):
        self.budget = int(budget_mb * 2 ** 20)
        self._items: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key, sig=None):
        """Cached value for `key`, or None. `sig` is the keyed file's
        CURRENT `_file_sig`: an entry stored under a different sig is
        stale (the file was rewritten in-process) and misses, forcing a
        re-decode. sig=None (file vanished, or caller doesn't track
        identity) serves whatever is cached — tile files being deleted
        mid-run must not break epoch 2+ (test_tile_cache.py documents
        that the cache makes later epochs filesystem-free)."""
        with self._lock:
            hit = self._items.get(key)
            if hit is None or (sig is not None and hit[2] is not None
                               and hit[2] != sig):
                self.misses += 1
                return None
            self._items.move_to_end(key)
            self.hits += 1
            return hit[0]

    def put(self, key, value, sig=None) -> None:
        nbytes = sum(a.nbytes for a in value if a is not None)
        if nbytes > self.budget:
            return
        for a in value:
            if a is not None:
                a.flags.writeable = False
        with self._lock:
            old = self._items.pop(key, None)   # replace a stale entry
            if old is not None:
                self._bytes -= old[1]
            while self._bytes + nbytes > self.budget and self._items:
                _, (_, old_b, _) = self._items.popitem(last=False)
                self._bytes -= old_b
            self._items[key] = (value, nbytes, sig)
            self._bytes += nbytes

    def set_budget(self, budget_mb: float) -> None:
        """Adopt a new byte budget, evicting LRU entries if it shrank —
        an explicit lower `--cache-tiles` must actually cap RAM, not be
        silently overridden by an earlier larger run in the process."""
        with self._lock:
            self.budget = int(budget_mb * 2 ** 20)
            while self._bytes > self.budget and self._items:
                _, (_, old_b, _) = self._items.popitem(last=False)
                self._bytes -= old_b


def _file_sig(path: str):
    """(mtime_ns, size) identity of a file, or None if unreadable — part
    of the decoded-tile cache key so in-process rewrites invalidate."""
    try:
        st = os.stat(path)
        return (st.st_mtime_ns, st.st_size)
    except OSError:
        return None


_SHARED_CACHE: Optional[_DecodedCache] = None


def shared_cache(budget_mb: float) -> _DecodedCache:
    """The process-wide decoded-tile cache: every dataset constructed with
    `cache_mb>0` shares ONE byte budget. A CLI run builds several datasets
    (train/eval/unlabeled/pseudo, one per few-shot domain) and
    `--cache-tiles MB` promises a single RAM budget — per-dataset caches
    would multiply it by the dataset count and OOM the small hosts the
    flag targets. Path-keyed entries make sharing collision-free; the
    most recent requested budget wins (evicting down when it shrank, so
    an explicit lower `--cache-tiles` later in the process actually caps
    RAM instead of being overridden by an earlier larger run)."""
    global _SHARED_CACHE
    if _SHARED_CACHE is None:
        _SHARED_CACHE = _DecodedCache(budget_mb)
    else:
        _SHARED_CACHE.set_budget(budget_mb)
    return _SHARED_CACHE


def list_tile_ids(data_dir: str) -> Tuple[List[str], bool]:
    """Return (ids, unlabeled) following the reference's basename-length
    heuristic (`archaeological_georgia_biostyle_dataloader.py:42-48`)."""
    ids: List[str] = []
    unlabeled = False
    for fp in sorted(glob.glob(os.path.join(data_dir, "*.png"))):
        name = os.path.basename(fp)
        if "mask" in name:
            continue
        if len(name) > 8:
            ids.append(name[:-8])       # strip 'bing.png'
        else:
            ids.append(name[:-4])       # strip '.png'
            unlabeled = True
    return ids, unlabeled


def _decode_rgb(path: str, watermark_px: int) -> np.ndarray:
    img = np.asarray(Image.open(path))
    if img.ndim == 2:  # greyscale book scans -> 3 channels (ref `:72-77`)
        if img.dtype == bool:
            img = img.astype(np.uint8) * 255     # ref `:75-77` (bool*255)
        elif np.issubdtype(img.dtype, np.integer):
            # 16-bit scans: rescale by the dtype max (a raw *255 would
            # wrap modulo 65536 before any clip could catch it).
            img = (img.astype(np.float64) / np.iinfo(img.dtype).max
                   * 255.0).astype(np.uint8)
        elif img.dtype != np.uint8:
            # float images: *255 as the reference does (`:80`)
            img = np.clip(img.astype(np.float64) * 255.0,
                          0, 255).astype(np.uint8)
        img = np.stack([img] * 3, axis=-1)
    img = img[:-watermark_px, :, 0:3]
    return np.ascontiguousarray(img)


def _resize_u8(img: np.ndarray, hw: Tuple[int, int],
               nearest: bool = False) -> np.ndarray:
    pil = Image.fromarray(img)
    resample = Image.NEAREST if nearest else Image.BILINEAR
    return np.asarray(pil.resize((hw[1], hw[0]), resample))


class TileDataset:
    """Fixed-canvas tile dataset (images uint8 HWC, masks uint8 HW).

    `pair=True` reproduces the reference's simultaneous bing+book item: the
    4-tuple (bing, bing_mask, book, book_mask) per id with `{id}book.jpg` /
    `{maskdir}/{id}book_mask.png` companions cropped 75 px
    (`archaeological_georgia_biostyle_dataloader.py:51-112`) — consumed by
    the feature-matching workflow (`feature_points_matching_main.py`)."""

    def __init__(self, data_dir: str, mask_dir: Optional[str] = None,
                 canvas: int = 512, has_mask: bool = True,
                 book: bool = False, pair: bool = False,
                 cache_mb: float = 0.0,
                 cache: Optional[_DecodedCache] = None):
        self.data_dir = data_dir
        self.mask_dir = mask_dir
        self.canvas = canvas
        self.has_mask = has_mask and mask_dir is not None
        self.book = book
        self.pair = pair
        # cache_mb>0 joins the PROCESS-WIDE cache (one budget across all
        # datasets — see shared_cache); pass `cache` for an isolated one.
        self.cache = cache if cache is not None else (
            shared_cache(cache_mb) if cache_mb > 0 else None)
        self.ids, self.unlabeled = list_tile_ids(data_dir)

    def __len__(self) -> int:
        return len(self.ids)

    def image_path(self, idx: int) -> str:
        file_id = self.ids[idx]
        name = f"{file_id}.png" if self.unlabeled else f"{file_id}bing.png"
        return os.path.join(self.data_dir, name)

    def mask_path(self, idx: int) -> str:
        return os.path.join(self.mask_dir, f"{self.ids[idx]}bing_mask.png")

    def book_path(self, idx: int) -> str:
        return os.path.join(self.data_dir, f"{self.ids[idx]}book.jpg")

    def book_mask_path(self, idx: int) -> str:
        return os.path.join(self.mask_dir, f"{self.ids[idx]}book_mask.png")

    def _load_mask(self, path: str, wm: int) -> np.ndarray:
        m = np.asarray(Image.open(path))
        if m.ndim == 3:
            m = m[:-wm, :, 0]           # channel 0 (ref `:85,96`)
        else:
            m = m[:-wm, :]
        return _resize_u8(m, (self.canvas, self.canvas), nearest=True)

    def __getitem__(self, idx: int):
        if self.cache is None:
            return self._load_item(idx)
        # keyed by the image path (+ the mask dir and the mode flags that
        # change the decoded value for the same file), so datasets sharing
        # one cache object after split_dataset's shallow copy can't
        # collide. The file's (mtime, size) identity rides ALONGSIDE the
        # entry: a tile rewritten at the same path in-process (tune
        # sweeps, notebooks regenerating tiles) re-decodes instead of
        # serving stale pixels (the stat is ~µs vs the ~15ms decode),
        # while a DELETED file still serves from cache — later epochs
        # stay filesystem-free (test_tile_cache.py).
        key = (self.image_path(idx), self.canvas,
               self.mask_dir if self.has_mask else None,
               self.book, self.pair)
        sig = _file_sig(self.image_path(idx))
        hit = self.cache.get(key, sig=sig)
        if hit is not None:
            return hit
        item = self._load_item(idx)
        self.cache.put(key, item, sig=sig)
        return item

    def _load_item(self, idx: int):
        if self.pair:
            bing = _resize_u8(
                _decode_rgb(self.image_path(idx), BING_WATERMARK_PX),
                (self.canvas, self.canvas))
            book = _resize_u8(
                _decode_rgb(self.book_path(idx), BOOK_WATERMARK_PX),
                (self.canvas, self.canvas))
            bing_mask = book_mask = None
            if self.has_mask:
                bing_mask = self._load_mask(self.mask_path(idx),
                                            BING_WATERMARK_PX)
                book_mask = self._load_mask(self.book_mask_path(idx),
                                            BOOK_WATERMARK_PX)
            return bing, bing_mask, book, book_mask
        wm = BOOK_WATERMARK_PX if self.book else BING_WATERMARK_PX
        img = _decode_rgb(self.image_path(idx), wm)
        img = _resize_u8(img, (self.canvas, self.canvas))
        mask = None
        if self.has_mask:
            mask = self._load_mask(self.mask_path(idx), wm)
        return img, mask
