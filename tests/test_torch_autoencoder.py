"""The port's autoencoder pretraining (`semisupervisedobjectdetection_torch/
train/autoencoder.py`, `losses.mse_loss`, `SegFormerModel`'s autoencoder
methods and `cli/autoencoder.py`) on the CPU:

- `mse_loss` with a divisor and with a sample weight against the JAX
  package's;
- a 3-step float32 `ae_train_step` trajectory at accum 1 and 2 (train mode,
  drop rates 0, `num_labels=3`) and `ae_eval_step` against the JAX steps,
  with the same weights and numpy inputs, on a tiny config of two stages of
  one layer;
- `SegFormerModel.train_one_epoch_without_mask`,
  `eval_one_epoch_without_mask` and `predict(use_loss="mse")`;
- `cli.autoencoder` for 2 epochs with --resume, then `cli.transfer
  --pretrain-weight` from its best checkpoint: the transfer model's
  encoder starts as the checkpoint's and its 1-label classifier as the
  reconstruction head's channel 0.
"""

import contextlib
import csv
import io
import os
import tempfile

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
from semisupervisedobjectdetection_tpu.train import autoencoder as jae
from semisupervisedobjectdetection_tpu.train.state import (
    TrainState as JTrainState,
)
from semisupervisedobjectdetection_torch import losses
from semisupervisedobjectdetection_torch.api import SegFormerModel
from semisupervisedobjectdetection_torch.checkpoint.convert import (
    state_dict_from_flax,
    train_state_from_flax,
)
from semisupervisedobjectdetection_torch.cli import autoencoder, transfer
from semisupervisedobjectdetection_torch.core.config import MiTConfig
from semisupervisedobjectdetection_torch.models.segformer import (
    forward_logits,
)
from semisupervisedobjectdetection_torch.train.autoencoder import (
    ae_eval_step,
    ae_train_step,
)
from test_torch_segformer import (  # noqa: F401 (autouse fixture)
    SIZE,
    jax_variables,
    one_torch_thread,
)
from test_torch_teacher_student import SHIFT_ONLY, SMALL

AE = dict(SMALL, num_labels=3)
LR = 3e-5
CLS = ("decode_head.classifier.weight", "decode_head.classifier.bias")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(port, ref, **kw):
    np.testing.assert_allclose(np.asarray(port.detach(), np.float32),
                               np.asarray(ref, np.float32), **kw)


@pytest.mark.parametrize("case", ["divisor", "weighted"])
def test_mse_loss_matches_jax(case):
    """Per-sample sums of squared errors over 64x64x3 in float32 in another
    order: 1e-6 relative."""
    rng = np.random.default_rng(40)
    pred = rng.uniform(size=(3, SIZE, SIZE, 3)).astype(np.float32)
    gt = rng.uniform(size=(3, SIZE, SIZE, 3)).astype(np.float32)
    kw = dict(divisor=9) if case == "divisor" else {}
    w = np.array([1.0, 0.0, 2.0], np.float32) if case == "weighted" else None
    ours = losses.mse_loss(_t(pred), _t(gt), sample_weight=(
        None if w is None else _t(w)), **kw)
    theirs = jlosses.mse_loss(jnp.asarray(pred), jnp.asarray(gt),
                              sample_weight=(None if w is None
                                             else jnp.asarray(w)), **kw)
    _close(ours, theirs, rtol=1e-6)
    # the reference's divisor is B*C of a (B, C, H, W) tensor
    if case == "divisor":
        sse = ((pred - gt) ** 2).reshape(3, -1).sum(1)
        np.testing.assert_allclose(float(ours), (sse / 9).mean(), rtol=1e-5)


def _states(seed):
    jcfg, cfg = JCfg(**AE), MiTConfig(**AE)
    v = jax_variables(jcfg, seed=seed)
    js = JTrainState.create(v, JTrainConfig(), lr=LR)
    return jcfg, cfg, js, train_state_from_flax(cfg, js)


# In train mode the decode head's BatchNorm on batch statistics removes
# any per-channel constant added before it: the per-stage projection biases
# and, since the last stage's output reaches nothing but the decode head,
# that stage's final LayerNorm bias. Their gradients are 0 in exact
# arithmetic and rounding noise on both sides; under the MSE's large
# gradients Adam turns that noise into a move of about lr per step either
# way, so the two sides may drift 2 lr apart per step (the bound of
# tests/test_torch_supervised.py::_check_params; 3 lr over 3 steps, the
# bound of tests/test_torch_train_mode.py, was exceeded: 4.9 lr seen).
AE_SHIFT_ONLY = SHIFT_ONLY | {"segformer.encoder.layer_norm.1.bias"}


def _check_ae_state(cfg, state, js, steps, accum):
    """Parameters to 2e-6 (lr 3e-5), the shift-only ones to 2 lr per step.
    The BatchNorm running variances to 1e-5; the running means take 0.1 of
    each forward's batch mean, into which the shift-only differences pass
    through the fuse rows (and, for the LayerNorm bias, the projection):
    1e-5 plus 0.1 x that shift, bounded a priori by 2 lr per earlier step,
    summed over every forward (`accum` per step)."""
    ref = state_dict_from_flax(cfg, jax.tree.map(np.asarray, js.params),
                               jax.tree.map(np.asarray, js.batch_stats))
    for n, p in state.params.items():
        tol = 2 * LR * steps if n in AE_SHIFT_ONLY else 2e-6
        _close(p, ref[n], atol=tol, rtol=1e-6, err_msg=n)
    d, n_st = cfg.decoder_hidden, cfg.num_stages
    fuse = ref["decode_head.linear_fuse.weight"][:, :, 0, 0].abs()
    last_proj = ref[f"decode_head.linear_c.{n_st - 1}.proj.weight"].abs()
    gain = 0.0
    for i in range(n_st):
        rows = fuse[:, (n_st - 1 - i) * d:(n_st - i) * d].sum(1)
        gain = gain + rows * (1.0 + (last_proj.sum(1).max()
                                     if i == n_st - 1 else 0.0))
    drift = sum(2 * LR * k for k in range(steps))   # before step k+1
    bn = "decode_head.batch_norm."
    tol = {bn + "running_mean": 1e-5 + 0.1 * accum * drift * gain,
           bn + "running_var": torch.full((d,), 1e-5)}
    for n, b in state.batch_stats.items():
        assert torch.all((b - ref[n]).abs() <= tol[n] + 1e-5 * ref[n].abs()
                         ), (n, (b - ref[n]).abs().max().item())


@pytest.mark.parametrize("accum", [1, 2])
def test_ae_train_step_matches_jax(accum):
    """3 float32 reconstruction steps in train mode (drop rates 0) from one
    state, fresh images each step, against the JAX `ae_train_step`: the MSE
    loss (sums over 64x64x3 per sample, ~250) to 1e-5 relative, the
    reconstructions to 1e-5, the parameters and BatchNorm statistics, which
    thread through the microbatches, as `_check_ae_state` says."""
    jcfg, cfg, js, state = _states(41)
    rng = np.random.default_rng(42)
    for step in range(3):
        x = rng.uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
        js, jloss, jrecon = jae.ae_train_step(js, jnp.asarray(x),
                                              jax.random.PRNGKey(step), jcfg,
                                              accum=accum)
        _, loss, recon = ae_train_step(
            state, _t(x), torch.Generator().manual_seed(step), accum=accum)
        assert recon.shape == (2, SIZE, SIZE, 3)
        _close(loss, jloss, atol=2e-6, rtol=1e-5)
        _close(recon, jrecon, atol=1e-5)
    assert int(state.count) == 3
    _check_ae_state(cfg, state, js, 3, accum)


def test_ae_eval_step_matches_jax():
    """The eval-mode reconstruction and its MSE (divisor B*3) against the
    JAX `ae_eval_step`: 1e-5 and 1e-5 relative."""
    jcfg, cfg, js, state = _states(43)
    x = np.random.default_rng(44).uniform(
        size=(3, SIZE, SIZE, 3)).astype(np.float32)
    jloss, jrecon = jae.ae_eval_step(js, jnp.asarray(x), jcfg)
    loss, recon = ae_eval_step(state, _t(x))
    _close(recon, jrecon, atol=1e-5)
    _close(loss, jloss, rtol=1e-5)


def test_autoencoder_methods_of_the_model():
    """`train_one_epoch_without_mask` takes one train-mode step (Adam's
    count 1, weights moved) and returns the reconstruction;
    `eval_one_epoch_without_mask` is `ae_eval_step`; `predict(use_loss=
    "mse")` gives the reference's MSE of the images against the raw
    upsampled logits of the serving copy (divisor B*3) and the sigmoid
    masks, without a target."""
    m = SegFormerModel(config=MiTConfig(**AE), num_labels=3, device="cpu",
                       seed=1, lr=1e-3)
    x = np.random.default_rng(45).uniform(
        size=(2, SIZE, SIZE, 3)).astype(np.float32)
    w0 = m.state.params["decode_head.linear_fuse.weight"].detach().clone()
    loss, recon = m.train_one_epoch_without_mask(x)
    assert recon.shape == (2, SIZE, SIZE, 3) and np.isfinite(float(loss))
    assert int(m.state.count) == 1
    assert not torch.equal(m.state.params["decode_head.linear_fuse.weight"],
                           w0)
    loss, recon = m.eval_one_epoch_without_mask(x, lazy=True)
    ref_loss, ref_recon = ae_eval_step(m.state, _t(x))
    assert torch.equal(recon, ref_recon) and torch.equal(loss, ref_loss)
    loss, masks = m.predict(x, use_loss="mse")
    logits, _ = forward_logits(m.model, _t(x))
    assert masks.shape == (2, SIZE, SIZE, 3)
    np.testing.assert_array_equal(masks, torch.sigmoid(logits).numpy())
    sse = ((x - logits.numpy()) ** 2).reshape(2, -1).sum(1)
    np.testing.assert_allclose(float(loss), (sse / 6).mean(), rtol=1e-5)


CLI = ["--synthetic", "--device", "cpu", "--variant", "b0", "--img-size",
       "64", "--synthetic-n", "8", "--batch-size", "4", "--grad-accum", "2"]


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return result, out.getvalue()


def test_autoencoder_cli_then_transfer(tmp_path, monkeypatch):
    """2 epochs of `cli.autoencoder` (labeled then unlabeled tiles, 2 + 2
    steps per epoch) write the CSV, the best checkpoint (train + eval gate)
    and `_last`; a third epoch resumes from it. `cli.transfer
    --pretrain-weight <best>` then starts from the checkpoint's encoder and
    decoder, and its 1-label classifier from channel 0 of the 3-label
    one."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the tiles
    ck = str(tmp_path / "ae")
    reports, out = _run(autoencoder.main, CLI + [
        "--epochs", "2", "--resume", "--checkpoint-dir", ck,
        "--metrics-csv", str(tmp_path / "ae.csv")])
    with open(tmp_path / "ae.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["step"] for r in rows] == ["0", "1"]
    assert list(rows[0]) == ["step", "wall_s", "train_loss", "eval_loss",
                             "sec_per_batch"]
    assert [(r["epoch"], r["train_steps"],
             [p["steps"] for p in r["phases"].values()])
            for r in reports] == [(0, 4, [2, 2]), (1, 4, [2, 2])]
    best = reports[-1]["best_path"]
    assert best and os.path.isfile(best)
    assert os.path.basename(best).startswith("segformer_autoencoder_epoch_")
    assert "segformer_autoencoder_last.pt" in os.listdir(ck)
    reports, out = _run(autoencoder.main, CLI + [
        "--epochs", "3", "--resume", "--checkpoint-dir", ck])
    assert "resumed from epoch 2" in out and [r["epoch"] for r in reports] \
        == [2]

    saved = torch.load(best, map_location="cpu", weights_only=True)["model"]
    assert saved[CLS[0]].shape[0] == 3
    seen = {}

    def first_state(model, *a, **k):
        seen.update({n: t.clone()
                     for n, t in model.state.model.state_dict().items()})
        return []

    monkeypatch.setattr(transfer, "train_loop", first_state)
    _run(transfer.main, CLI + ["--pretrain-weight", best,
                               "--checkpoint-dir", str(tmp_path / "tr")])
    assert seen[CLS[0]].shape[0] == 1
    for n in CLS:
        assert torch.equal(seen[n], saved[n][:1]), n
    carried = [n for n in saved if n not in CLS]
    assert any(n.startswith("segformer.encoder.block.3.") for n in carried)
    for n in carried:
        assert torch.equal(seen[n], saved[n]), n
