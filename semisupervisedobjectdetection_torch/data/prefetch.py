"""Background staging of train batches: overlap host decode, the upload and
the augmentation with the running step, the JAX package's
`data/prefetch.py` in PyTorch.

A worker thread iterates the host loader (PNG decode, mostly outside the
GIL), pins each uint8 batch, starts its non-blocking upload and queues the
augmentation (`data/augment.py`) on the card, while the training loop runs
the current step. The card runs its work in the order it was queued, so a
staged batch is ready by the time the step that reads it starts.

    pf = DevicePrefetcher(loader, stage_fn, depth=1)
    for staged in pf:            # staged = stage_fn(idx, *host_item)
        ...

`stage_fn(idx, *item)` runs on the worker thread. The order of the loader is
kept, exceptions raised by the loader or `stage_fn` surface in the consuming
thread, the prefetcher is re-iterable (a fresh worker per epoch), and an
early `break` stops the worker and drains the queue.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

_SENTINEL = object()


def _as_args(item) -> tuple:
    """A loader item as `stage_fn(idx, *args)` arguments: a tuple or list
    unpacks, anything else is one argument. The worker and the inline
    (depth < 1) paths share it, so both stage the same batches."""
    return tuple(item) if isinstance(item, (tuple, list)) else (item,)


class DevicePrefetcher:
    """Wrap a re-iterable host loader with `depth` batches of lookahead
    staged on a background thread."""

    def __init__(self, loader: Iterable, stage_fn: Callable[..., Any],
                 depth: int = 1):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.loader = loader
        self.stage_fn = stage_fn
        self.depth = depth

    def __len__(self) -> int:
        return len(self.loader)  # type: ignore[arg-type]

    def __iter__(self) -> Iterator[Any]:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        err: list = [None]

        def worker() -> None:
            try:
                for idx, item in enumerate(self.loader):
                    if stop.is_set():
                        return
                    staged = self.stage_fn(idx, *_as_args(item))
                    # a bounded put that notices a consumer that broke out
                    # of its loop (a plain put on a full queue would block)
                    while not stop.is_set():
                        try:
                            q.put(staged, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # surfaced in the consumer
                err[0] = e
            q.put(_SENTINEL)

        t = threading.Thread(target=worker, daemon=True,
                             name="sso-prefetch")
        t.start()
        try:
            while True:
                staged = q.get()
                if staged is _SENTINEL:
                    t.join()
                    if err[0] is not None:
                        raise err[0]
                    return
                yield staged
        finally:
            stop.set()
            # drain, so that a worker blocked on a full queue can exit
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=10.0)


def fold_in(seed: int, idx: int) -> int:
    """A seed derived from (`seed`, `idx`) alone, the counterpart of
    `jax.random.fold_in`: batch `idx` of a stream draws from it whatever the
    prefetch depth, and epoch `idx` of a run whatever it resumed from."""
    return int(np.random.SeedSequence((seed, idx)).generate_state(1)[0])


def upload(x: Optional[np.ndarray], device: torch.device
           ) -> Optional[torch.Tensor]:
    """A host array on `device`: pinned and copied without blocking the
    host when `device` is a CUDA device."""
    if x is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def paired_host_batches(train_loader: Iterable, pseudo_loader: Iterable
                        ) -> Iterator[tuple]:
    """(images_u8, masks_u8, unlabeled_u8 | None) per labeled batch, with
    the unlabeled loader re-iterated when the labeled one is longer (the
    EMA loop's pairing rule: re-iterated, not `itertools.cycle`, so decoded
    batches are not held in host RAM for the whole epoch). An empty
    unlabeled loader gives None."""
    pseudo_iter = iter(pseudo_loader)
    for images_u8, masks_u8 in train_loader:
        try:
            u_images_u8, _ = next(pseudo_iter)
        except StopIteration:
            pseudo_iter = iter(pseudo_loader)
            u_images_u8 = next(pseudo_iter, (None, None))[0]
        yield images_u8, masks_u8, u_images_u8


def prefetch_paired_batches(train_loader: Iterable, pseudo_loader: Iterable,
                            seed: int, dcfg, device: torch.device,
                            depth: int = 1):
    """Staged (imgs, masks, u_imgs) triples on `device` for the EMA step:
    the labeled batch through the train augmentation, the paired unlabeled
    batch likewise, or the labeled images in its place when the unlabeled
    loader is empty. Batch `idx` draws its choices from seeds
    `fold_in(seed, 2 * idx)` and `fold_in(seed, 2 * idx + 1)`, so every
    depth stages the same batches."""
    from semisupervisedobjectdetection_torch.cli.common import (
        device_train_batch,
    )

    def stage(idx, images_u8, masks_u8, u_images_u8):
        g1 = torch.Generator().manual_seed(fold_in(seed, 2 * idx))
        imgs, masks = device_train_batch(g1, images_u8, masks_u8, dcfg,
                                         device)
        if u_images_u8 is None:
            return imgs, masks, imgs
        g2 = torch.Generator().manual_seed(fold_in(seed, 2 * idx + 1))
        u_imgs, _ = device_train_batch(g2, u_images_u8, None, dcfg, device)
        return imgs, masks, u_imgs

    pairs = paired_host_batches(train_loader, pseudo_loader)
    if depth < 1:
        return (stage(i, *_as_args(item)) for i, item in enumerate(pairs))
    return iter(DevicePrefetcher(pairs, stage, depth=depth))
