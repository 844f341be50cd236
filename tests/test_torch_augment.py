"""The port's augmentation (`data/augment.py`) against the JAX package's on
the CPU: `eval_batch` with the canvas equal to, larger than (antialiased
shrink) and smaller than the output size, and `augment_batch` with every
crop/op choice fixed against the JAX package's own pieces composed on the
same choices; and the frequency of each op."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semisupervisedobjectdetection_tpu.data import augment as jaugment
from semisupervisedobjectdetection_torch.data.augment import (
    AugmentChoices,
    augment_batch,
    draw_choices,
    eval_batch,
)
from test_torch_segformer import one_torch_thread  # noqa: F401


def _batch(b, size, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)
    masks = np.where(rng.uniform(size=(b, size, size)) > 0.6, 255,
                     0).astype(np.uint8)
    masks[0] = 255                 # a constant mask binarises to zeros
    return imgs, masks


@pytest.mark.parametrize("canvas,out", [(64, 64), (64, 32), (48, 64)],
                         ids=["equal", "shrink", "grow"])
def test_eval_batch_matches_jax(canvas, out):
    """Images to 1e-5 (float32 resize weights summed in another order),
    masks exactly."""
    imgs, masks = _batch(3, canvas)
    ji, jm = jaugment.eval_batch(jnp.asarray(imgs), jnp.asarray(masks),
                                 out_h=out, out_w=out)
    ti, tm = eval_batch(torch.from_numpy(imgs), torch.from_numpy(masks),
                        out_h=out, out_w=out)
    assert ti.shape == (3, out, out, 3) and tm.shape == (3, out, out)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-5)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert not tm[0].any()
    assert eval_batch(torch.from_numpy(imgs), out_h=out, out_w=out)[1] \
        is None


def _jax_augment(img_u8, mask, oy, ox, branch, k, crop, out):
    """The JAX package's `_augment_sample` with its draws replaced by the
    given choices, from its own pieces."""
    img = img_u8[oy:oy + crop, ox:ox + crop]
    m = mask[oy:oy + crop, ox:ox + crop]
    ops = [lambda a: a, lambda a: jnp.flip(a, axis=1),
           lambda a: jnp.flip(a, axis=0),
           lambda a: jaugment._rot90_k(a, jnp.asarray(k))]
    img, m = ops[branch](jnp.asarray(img)), ops[branch](jnp.asarray(m))
    img = jaugment._resize_img(img.astype(jnp.float32) / 255.0, (out, out))
    m = jaugment._resize_mask(m.astype(jnp.float32), (out, out))
    mn, mx = jnp.min(m), jnp.max(m)
    m = jnp.where(mx > mn, (m - mn) / jnp.maximum(mx - mn, 1e-8),
                  jnp.zeros_like(m))
    return np.asarray(img), np.asarray(m)


def test_augment_batch_with_fixed_choices_matches_jax():
    """Every op (identity, hflip, vflip, rot90 by 1, 2, 3) at its own crop
    corner, canvas 64, crop 62, out 64 (the CLI's 64x64 point): images to
    1e-5, masks exactly."""
    canvas, crop, out = 64, 62, 64
    choices = AugmentChoices(oy=torch.tensor([0, 2, 1, 0, 2, 1]),
                             ox=torch.tensor([2, 0, 1, 1, 2, 0]),
                             branch=torch.tensor([0, 1, 2, 3, 3, 3]),
                             k=torch.tensor([3, 1, 2, 1, 2, 3]))
    imgs, masks = _batch(6, canvas, seed=1)
    ti, tm = augment_batch(torch.from_numpy(imgs), torch.from_numpy(masks),
                           crop=crop, out_h=out, out_w=out, choices=choices)
    assert ti.shape == (6, out, out, 3) and ti.dtype == torch.float32
    for s in range(6):
        ji, jm = _jax_augment(imgs[s], masks[s], *(int(c[s])
                                                   for c in choices),
                              crop, out)
        np.testing.assert_allclose(ti[s].numpy(), ji, atol=1e-5, err_msg=s)
        np.testing.assert_array_equal(tm[s].numpy(), jm, err_msg=str(s))
    # the unlabeled call takes the same images without masks
    ui, um = augment_batch(torch.from_numpy(imgs), None, crop=crop,
                           out_h=out, out_w=out, choices=choices)
    assert um is None and torch.equal(ui, ti)


def test_op_frequencies_and_crop_range():
    """Over 4000 draws at prob 0.75: identity / hflip / vflip / rot90 at
    0.3125 / 0.25 / 0.25 / 0.1875 within 4 standard deviations, rot90's k
    uniform over {1, 2, 3}, crop corners over their whole range; a seed
    fixes the draws."""
    n = 4000
    c = draw_choices(n, 64, 60, 50, 0.75, torch.Generator().manual_seed(0))
    freq = np.bincount(c.branch.numpy(), minlength=4) / n
    p = np.array([0.3125, 0.25, 0.25, 0.1875])
    assert np.all(np.abs(freq - p) <= 4 * np.sqrt(p * (1 - p) / n)), freq
    k = c.k[c.branch == 3].numpy()
    assert set(np.unique(k)) == {1, 2, 3}
    assert set(c.oy.tolist()) == set(range(15))
    assert set(c.ox.tolist()) == set(range(11))
    again = draw_choices(n, 64, 60, 50, 0.75,
                         torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(c, again))
    none = draw_choices(200, 8, 8, 8, 0.0, torch.Generator().manual_seed(1))
    assert not none.branch.any() and not none.oy.any()
