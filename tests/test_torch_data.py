"""The port's host data path against the JAX package's, on the CPU:
synthetic tiles and their files byte for byte, `TileDataset` items,
`TileLoader` batches in order for one seed, `split_dataset`; and the
port's prefetcher: order, errors, an early break, the paired wrap rule,
and the same staged batches at every depth."""

import os
import threading

import numpy as np
import pytest
import torch

from semisupervisedobjectdetection_tpu.data import loader as jloader
from semisupervisedobjectdetection_tpu.data import synthetic as jsynthetic
from semisupervisedobjectdetection_tpu.data import tiles as jtiles
from semisupervisedobjectdetection_torch.core.config import DataConfig
from semisupervisedobjectdetection_torch.data import loader, synthetic, tiles
from semisupervisedobjectdetection_torch.data.prefetch import (
    DevicePrefetcher,
    paired_host_batches,
    prefetch_paired_batches,
)
from test_torch_segformer import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def tile_dirs(tmp_path_factory):
    """A labeled set with masks and an unlabeled set, written by the JAX
    package's writer, and the same labeled set written by the port's."""
    root = tmp_path_factory.mktemp("tiles")
    jsynthetic.write_synthetic_dataset(str(root / "train"),
                                       str(root / "masks"), n=6, size=40,
                                       seed=3)
    jsynthetic.write_synthetic_dataset(str(root / "unl"), None, n=5,
                                       size=40, seed=4, unlabeled=True)
    synthetic.write_synthetic_dataset(str(root / "port_train"),
                                      str(root / "port_masks"), n=6, size=40,
                                      seed=3)
    return root


def test_synthetic_tiles_are_byte_equal(tile_dirs):
    for seed, size in ((0, 33), (7, 64)):
        for a, b in zip(synthetic.synthetic_tile(seed, size),
                        jsynthetic.synthetic_tile(seed, size)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(synthetic.synthetic_batch(2, 3, 32),
                    jsynthetic.synthetic_batch(2, 3, 32)):
        np.testing.assert_array_equal(a, b)
    for ours, theirs in (("port_train", "train"), ("port_masks", "masks")):
        names = sorted(os.listdir(tile_dirs / theirs))
        assert sorted(os.listdir(tile_dirs / ours)) == names
        for n in names:
            assert (tile_dirs / ours / n).read_bytes() == \
                (tile_dirs / theirs / n).read_bytes(), n


@pytest.mark.parametrize("cache_mb", [0.0, 8.0])
def test_tile_dataset_items_are_equal(tile_dirs, cache_mb):
    for sub, mask_dir in (("train", "masks"), ("unl", None)):
        md = None if mask_dir is None else str(tile_dirs / mask_dir)
        ours = tiles.TileDataset(str(tile_dirs / sub), md, canvas=48,
                                 cache_mb=cache_mb,
                                 cache=tiles._DecodedCache(cache_mb)
                                 if cache_mb else None)
        theirs = jtiles.TileDataset(str(tile_dirs / sub), md, canvas=48)
        assert ours.ids == theirs.ids and ours.unlabeled == theirs.unlabeled
        assert tiles.list_tile_ids(str(tile_dirs / sub)) == \
            jtiles.list_tile_ids(str(tile_dirs / sub))
        for _ in range(2):          # twice: the second from the cache
            for i in range(len(ours)):
                for a, b in zip(ours[i], theirs[i]):
                    if b is None:
                        assert a is None
                    else:
                        assert a.dtype == b.dtype == np.uint8
                        np.testing.assert_array_equal(a, b)
        assert ours[0][0].shape == (48, 48, 3)


def test_tile_loader_batches_and_split_are_equal(tile_dirs):
    args = (str(tile_dirs / "train"), str(tile_dirs / "masks"))
    ours = loader.TileLoader(tiles.TileDataset(*args, canvas=32), 4,
                             seed=11)
    theirs = jloader.TileLoader(jtiles.TileDataset(*args, canvas=32), 4,
                                seed=11)
    assert len(ours) == len(theirs) == 1
    for _ in range(3):               # epochs reshuffle the same way
        got = list(ours)
        want = list(theirs)
        assert len(got) == len(want)
        for (a, am), (b, bm) in zip(got, want):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(am, bm)
    both = loader.TileLoader(tiles.TileDataset(*args, canvas=32), 4,
                             seed=11, drop_last=False, shuffle=False)
    assert [x[0].shape[0] for x in both] == [4, 2]
    tr, va = loader.split_dataset(tiles.TileDataset(*args), 0.8, seed=5)
    jtr, jva = jloader.split_dataset(jtiles.TileDataset(*args), 0.8, seed=5)
    assert (tr.ids, va.ids) == (jtr.ids, jva.ids)


def test_prefetcher_keeps_order_and_raises_errors():
    stage_threads = set()

    def stage(idx, x):
        stage_threads.add(threading.current_thread().name)
        return idx, x * 2

    pf = DevicePrefetcher(list(range(7)), stage, depth=2)
    assert len(pf) == 7
    for _ in range(2):               # re-iterable, a fresh worker each time
        assert list(pf) == [(i, 2 * i) for i in range(7)]
    assert stage_threads == {"sso-prefetch"}

    def broken():
        yield 1
        raise OSError("bad tile")

    got = []
    with pytest.raises(OSError, match="bad tile"):
        for x in DevicePrefetcher(broken(), lambda i, x: x):
            got.append(x)
    assert got == [1]
    with pytest.raises(ValueError):
        DevicePrefetcher([], lambda i, x: x, depth=0)


def test_prefetcher_stops_its_worker_on_break():
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    it = iter(DevicePrefetcher(endless(), lambda i, x: x, depth=1))
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()                        # what a `break` out of a for does
    n = len(produced)
    assert not any(t.name == "sso-prefetch" and t.is_alive()
                   for t in threading.enumerate())
    assert len(produced) == n and n <= 6


def _fake(n, tag, masks=True):
    """A re-iterable loader of n batches of one (2, 8, 8, 3) uint8 image
    pair each, marked by value."""
    class L:
        def __iter__(self):
            for i in range(n):
                img = np.full((2, 8, 8, 3), tag + i, np.uint8)
                yield img, (np.full((2, 8, 8), 255, np.uint8)
                            if masks else None)

        def __len__(self):
            return n
    return L()


def test_paired_batches_wrap_the_shorter_unlabeled_loader():
    pairs = list(paired_host_batches(_fake(5, 0), _fake(2, 100, False)))
    assert [p[0][0, 0, 0, 0] for p in pairs] == [0, 1, 2, 3, 4]
    assert [p[2][0, 0, 0, 0] for p in pairs] == [100, 101, 100, 101, 100]
    pairs = list(paired_host_batches(_fake(2, 0), _fake(0, 100, False)))
    assert all(p[2] is None for p in pairs)


@pytest.mark.parametrize("unlabeled", [3, 0])
def test_prefetched_batches_do_not_depend_on_depth(unlabeled):
    """Depth 0 (inline) and 1 (a worker thread) stage the same augmented
    batches from one seed; an empty unlabeled loader makes the labeled
    images stand in."""
    dcfg = DataConfig(img_h=8, img_w=8, canvas=8, crop=6)
    cpu = torch.device("cpu")
    runs = [list(prefetch_paired_batches(_fake(3, 0), _fake(unlabeled, 50,
                                                            False),
                                         21, dcfg, cpu, depth=d))
            for d in (0, 1)]
    assert len(runs[0]) == len(runs[1]) == 3
    for a, b in zip(*runs):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        imgs, masks, u_imgs = a
        assert imgs.shape == (2, 8, 8, 3) and masks.shape == (2, 8, 8)
        if unlabeled == 0:
            assert u_imgs is imgs
        else:
            assert float(u_imgs.mean()) > float(imgs.mean())
