"""The port's eval metrics (`eval/metrics.py`), `losses.segmentation_loss`
and `train/supervised.py::eval_step` against the JAX package's on the CPU,
including images where a class is absent from both the prediction and the
ground truth."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semisupervisedobjectdetection_tpu import losses as jlosses
from semisupervisedobjectdetection_tpu.core.config import (
    MiTConfig as JCfg,
    TrainConfig as JTrainConfig,
)
from semisupervisedobjectdetection_tpu.eval import metrics as jmetrics
from semisupervisedobjectdetection_tpu.train.state import (
    TrainState as JTrainState,
)
from semisupervisedobjectdetection_tpu.train.supervised import (
    eval_step as jax_eval_step,
)
from semisupervisedobjectdetection_torch import losses
from semisupervisedobjectdetection_torch.checkpoint.convert import (
    train_state_from_flax,
)
from semisupervisedobjectdetection_torch.core.config import MiTConfig
from semisupervisedobjectdetection_torch.eval import metrics
from semisupervisedobjectdetection_torch.train.supervised import eval_step
from test_torch_segformer import (  # noqa: F401 (autouse fixture)
    SIZE,
    jax_variables,
    one_torch_thread,
)


def _preds():
    """Four 16x16 images: mixed, all-background on both sides (foreground
    absent), all-foreground on both sides (background absent), and a
    prediction of nothing against a ground truth of some foreground; some
    scores exactly at the 0.5 threshold."""
    rng = np.random.default_rng(0)
    pred = rng.uniform(size=(4, 16, 16)).astype(np.float32)
    gt = (rng.uniform(size=(4, 16, 16)) > 0.5).astype(np.float32)
    pred[0, :2] = 0.5
    pred[1], gt[1] = 0.1, 0.0
    pred[2], gt[2] = 0.9, 1.0
    pred[3] = 0.2
    return pred, gt


@pytest.mark.parametrize("name", ["dice_score", "binary_miou",
                                  "per_image_miou", "pixel_accuracy"])
def test_metrics_match_jax(name):
    pred, gt = _preds()
    for sl in (slice(0, 4), slice(1, 2), slice(3, 4)):
        ours = getattr(metrics, name)(torch.from_numpy(pred[sl]),
                                      torch.from_numpy(gt[sl]))
        theirs = getattr(jmetrics, name)(jnp.asarray(pred[sl]),
                                         jnp.asarray(gt[sl]))
        np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6,
                                   err_msg=f"{name} {sl}")
    ours = metrics.segmentation_metrics(torch.from_numpy(pred),
                                        torch.from_numpy(gt))
    theirs = jmetrics.segmentation_metrics(jnp.asarray(pred),
                                           jnp.asarray(gt))
    assert set(ours) == set(theirs)


def test_segmentation_loss_branches():
    pred, gt = _preds()
    for kind in ("dice", "dice_argmax", "argmax", "mse"):
        np.testing.assert_allclose(
            float(losses.segmentation_loss(torch.from_numpy(pred),
                                           torch.from_numpy(gt), kind)),
            float(jlosses.segmentation_loss(jnp.asarray(pred),
                                            jnp.asarray(gt), kind)),
            rtol=1e-6)
    # the reference's 1 - CE branch, ported since (one class: CE is 0)
    np.testing.assert_allclose(
        float(losses.segmentation_loss(torch.from_numpy(pred),
                                       torch.from_numpy(gt),
                                       "cross_entropy")),
        float(jlosses.segmentation_loss(jnp.asarray(pred), jnp.asarray(gt),
                                        "cross_entropy")), rtol=1e-6)
    with pytest.raises(ValueError):
        losses.segmentation_loss(torch.from_numpy(pred),
                                 torch.from_numpy(gt), "l1")


def test_eval_step_matches_jax():
    """An eval-mode forward and the binarised dice loss on the tiny config
    (float32; a classifier scaled 50 times spreads the scores over both
    sides of the 0.5 threshold with none within 1e-5 of it, checked below,
    so no pixel's side hangs on a rounding): predictions to 1e-5, the loss
    to 1e-6."""
    tiny = dict(depths=(1, 1, 1, 1), hidden_sizes=(8, 16, 32, 64),
                num_heads=(1, 2, 4, 8), decoder_hidden=32)
    jcfg, cfg = JCfg(**tiny), MiTConfig(**tiny)
    v = jax_variables(jcfg, seed=9)
    head = v["params"]["decode_head"]["classifier"]
    head["kernel"] *= 50.0
    head["bias"][:] = -5.0
    js = JTrainState.create(v, JTrainConfig())
    rng = np.random.default_rng(10)
    x = rng.uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    gt = (rng.uniform(size=(2, SIZE, SIZE)) > 0.5).astype(np.float32)
    jl, jp = jax_eval_step(js, jnp.asarray(x), jnp.asarray(gt), jcfg)
    tl, tp = eval_step(train_state_from_flax(cfg, js), torch.from_numpy(x),
                       torch.from_numpy(gt))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    assert float(np.abs(np.asarray(jp) - 0.5).min()) > 1e-5
    assert 0.1 < float((tp >= 0.5).float().mean()) < 0.9
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-6)
