"""The binary and softmax cross-entropy losses of the port (`losses.py`)
against the JAX package's, eagerly (no `jax.jit`): `bce_with_logits_loss`
with and without the valid mask, `cross_entropy_loss` with probability
targets (a class axis, and the one-class trailing axis of a (B, H, W)
input), the dispatcher's `cross_entropy` branch that returns 1 - CE, and
`SegFormerModel.predict(use_loss="bce")` against the JAX formula on the
port's logits. `--loss bce` is refused by the supervised CLI for the JAX
package's own reason: its CLI offers the flag, but the JAX train step's
dispatcher has no "bce" branch, so the step raises (traced abstractly here
with `jax.eval_shape`, nothing compiled)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semisupervisedobjectdetection_tpu import losses as jlosses
from semisupervisedobjectdetection_tpu.core.config import (
    MiTConfig as JCfg,
    TrainConfig as JTrainConfig,
)
from semisupervisedobjectdetection_tpu.train import supervised as jsup
from semisupervisedobjectdetection_tpu.train.state import (
    TrainState as JTrainState,
)
from semisupervisedobjectdetection_torch import losses
from semisupervisedobjectdetection_torch.api import SegFormerModel
from semisupervisedobjectdetection_torch.cli import supervised
from semisupervisedobjectdetection_torch.core.config import mit_b0
from semisupervisedobjectdetection_torch.models.segformer import (
    forward_logits,
)
from test_torch_segformer import TINY, jax_variables  # noqa: F401
from test_torch_segformer import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-6


def _logits_labels(seed=0, shape=(2, 16, 16)):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 3.0, shape).astype(np.float32)
    labels = (rng.uniform(size=shape) > 0.6).astype(np.float32)
    labels[0, 0, :4] = 255.0          # ignore_index pixels
    return logits, labels


@pytest.mark.parametrize("masked", [False, True])
def test_bce_with_logits_matches_jax(masked):
    logits, labels = _logits_labels()
    valid = (labels >= 0) & (labels != 255)
    want = jlosses.bce_with_logits_loss(
        jnp.asarray(logits), jnp.asarray(labels),
        valid_mask=jnp.asarray(valid) if masked else None)
    got = losses.bce_with_logits_loss(
        torch.from_numpy(logits), torch.from_numpy(labels),
        valid_mask=torch.from_numpy(valid) if masked else None)
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL, atol=0)


@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (2, 8, 8)])
def test_cross_entropy_and_its_dispatch_match_jax(shape):
    """Probability targets over a class axis; a (B, H, W) input gets the
    one-class axis (CE 0, so the dispatcher's 1 - CE is 1)."""
    rng = np.random.default_rng(1)
    pred = rng.normal(size=shape).astype(np.float32)
    gt = rng.uniform(size=shape).astype(np.float32)
    gt /= gt.sum(-1, keepdims=True) if len(shape) == 4 else 1.0
    tp, tg = torch.from_numpy(pred), torch.from_numpy(gt)
    jp, jg = jnp.asarray(pred), jnp.asarray(gt)
    np.testing.assert_allclose(losses.cross_entropy_loss(tp, tg).item(),
                               float(jlosses.cross_entropy_loss(jp, jg)),
                               rtol=TOL, atol=TOL)
    got = losses.segmentation_loss(tp, tg, "cross_entropy").item()
    want = float(jlosses.segmentation_loss(jp, jg, "cross_entropy"))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if len(shape) == 3:
        assert got == 1.0


def test_predict_bce_is_the_jax_formula_on_its_logits():
    """predict(use_loss="bce"): BCE on the raw logits (upsampled to the
    image) over the target's valid pixels, as the JAX package computes it,
    beside the sigmoid masks of the same forward."""
    model = SegFormerModel(config=mit_b0(**TINY), device="cpu", seed=4)
    rng = np.random.default_rng(2)
    x = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    target = (rng.uniform(size=(2, 64, 64)) > 0.5).astype(np.float32)
    target[1, :3] = 255.0
    loss, masks = model.predict(x, target, use_loss="bce")
    with torch.no_grad():
        logits = forward_logits(model.model, torch.from_numpy(x))[0]
    lg = logits[..., 0].numpy()
    want = jlosses.bce_with_logits_loss(
        jnp.asarray(lg), jnp.asarray(target),
        valid_mask=jnp.asarray((target >= 0) & (target != 255)))
    np.testing.assert_allclose(float(loss), float(want), rtol=TOL, atol=0)
    np.testing.assert_array_equal(masks, model.predict(x))


def test_loss_bce_refused_as_the_jax_step_raises():
    """The JAX supervised step with loss_type "bce" raises in its
    dispatcher (traced with `jax.eval_shape`, no compile), so the port's
    CLI refuses --loss bce before building anything, naming that reason."""
    with pytest.raises(ValueError, match="unknown loss_type: bce"):
        jlosses.segmentation_loss(jnp.zeros((1, 4, 4)), jnp.zeros((1, 4, 4)),
                                  "bce")
    jcfg = JCfg(**TINY)
    state = jax.eval_shape(
        lambda v: JTrainState.create(v, JTrainConfig()),
        jax_variables(jcfg, seed=0))
    step = functools.partial(jsup.train_step, cfg=jcfg, loss_type="bce")
    with pytest.raises(ValueError, match="unknown loss_type: bce"):
        jax.eval_shape(step, state,
                       jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32),
                       jax.ShapeDtypeStruct((1, 64, 64), jnp.float32),
                       jax.random.PRNGKey(0))
    with pytest.raises(SystemExit, match="no 'bce' branch"):
        supervised.main(["--loss", "bce", "--device", "cpu"])
