"""`SegFormerModel`'s training surface (`semisupervisedobjectdetection_torch/
api.py`) on the CPU at the tiny config of tests/test_torch_segformer.py:
the structural rebuilds keep the old weights, `save`/`load` warm-start or
restore the full state, a 3-label checkpoint restores into 1 label through
channel 0, `predict` with a target equals `eval_one_epoch`, the serving
copy follows the trained state and `resume`, a model that only serves holds
no train state, and what is not ported raises. (The autoencoder's methods
are held in tests/test_torch_autoencoder.py, `output_cls_token` in
tests/test_torch_fewshot.py.)"""

import numpy as np
import pytest
import torch

from semisupervisedobjectdetection_torch.api import SegFormerModel
from semisupervisedobjectdetection_torch.core.config import (
    MiTConfig,
    TrainConfig,
)
from semisupervisedobjectdetection_torch.models.segformer import (
    forward_masks,
)
from semisupervisedobjectdetection_torch.ops import sr_attention as sra
from test_torch_segformer import (  # noqa: F401 (autouse fixture)
    SIZE,
    TINY,
    one_torch_thread,
)

CLS = "decode_head.classifier."


def _batch(seed=0, n=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, SIZE, SIZE, 3)).astype(np.float32)
    gt = (rng.uniform(size=(n, SIZE, SIZE)) > 0.6).astype(np.float32)
    return x, gt


def _model(seed=0, **kw):
    return SegFormerModel(config=MiTConfig(**TINY), device="cpu", seed=seed,
                          lr=1e-3, **kw)


def _weights(model):
    return {n: t.detach().clone()
            for n, t in model.state.model.state_dict().items()}


def test_rebuilds_keep_weights_and_reset_adam():
    """`add_prompt_token` and `frozen_encoder` rebuild the state: every old
    tensor is kept, the new prompt tokens come from the seeded init (the
    same for one seed), Adam starts afresh, and the frozen stages' layers
    have no moments and no `requires_grad`."""
    m = _model(seed=3)
    x, gt = _batch(1)
    m.train_one_epoch(x, gt)
    before = _weights(m)
    assert int(m.state.count) == 1
    m.add_prompt_token((2, 0, 3, 1))
    after = _weights(m)
    for n, t in before.items():
        assert torch.equal(after[n], t), n
    new = set(after) - set(before)
    assert new == {f"segformer.encoder.prompt_tokens.{i}" for i in (0, 2, 3)}
    assert after["segformer.encoder.prompt_tokens.2"].shape == (3, 32)
    twin = _model(seed=3)
    twin.add_prompt_token((2, 0, 3, 1))
    for n in new:
        assert torch.equal(after[n], _weights(twin)[n]), n
    assert int(m.state.count) == 0
    assert all(not v.any() for v in m.state.mu.values())
    # reference quirks: the prompt tokens do not train
    assert not any("prompt_tokens" in n for n in m.state.mu)
    m.frozen_encoder(layers=[0, 1])
    for n, t in after.items():
        assert torch.equal(m.state.model.state_dict()[n], t), n
    frozen = {n for n, p in m.state.params.items() if not p.requires_grad}
    assert frozen == {n for n in m.state.params
                      if n.startswith(("segformer.encoder.block.0.",
                                       "segformer.encoder.block.1."))
                      or "prompt_tokens" in n}
    assert frozen.isdisjoint(m.state.mu)
    m.unfroze_encoder()
    assert {n for n in m.state.params if n not in m.state.mu} == {
        n for n in m.state.params if "prompt_tokens" in n}


def test_save_then_load_warm_starts(tmp_path):
    """`load` takes the weights and BatchNorm statistics and leaves Adam
    fresh and the schedule at epoch 0; `load(full_state=True)` also takes
    the moments, Adam's count and the epoch."""
    a = _model(seed=1)
    x, gt = _batch(2)
    a.train_one_epoch(x, gt)
    a.scheduler_step()
    with torch.no_grad():
        a.state.model.decode_head.batch_norm.running_mean.normal_()
    path = str(tmp_path / "a.pt")
    a.save(path)
    warm = _model(seed=2)
    warm.load(path)
    for n, t in _weights(a).items():
        assert torch.equal(_weights(warm)[n], t), n
    assert all(not v.any() for v in warm.state.mu.values())
    assert (int(warm.state.count), float(warm.state.epoch)) == (0, 0.0)
    full = _model(seed=2)
    full.load(path, full_state=True)
    for n in a.state.mu:
        assert torch.equal(full.state.mu[n], a.state.mu[n]), n
        assert torch.equal(full.state.nu[n], a.state.nu[n]), n
    assert (int(full.state.count), float(full.state.epoch)) == (1, 1.0)


def test_three_label_checkpoint_restores_through_channel_0(tmp_path):
    """A warm start from a wider head (an autoencoder's 3 labels) into
    num_labels=1 takes output channel 0; everything else loads whole."""
    a = _model(seed=4, num_labels=3)
    path = str(tmp_path / "ae.pt")
    a.save(path)
    b = _model(seed=5)
    b.load(path)
    wa, wb = _weights(a), _weights(b)
    assert wb[CLS + "weight"].shape[0] == 1
    assert torch.equal(wb[CLS + "weight"], wa[CLS + "weight"][:1])
    assert torch.equal(wb[CLS + "bias"], wa[CLS + "bias"][:1])
    for n, t in wa.items():
        if not n.startswith(CLS):
            assert torch.equal(wb[n], t), n


@pytest.mark.parametrize("loss", ["dice", "dice_argmax"])
def test_predict_with_target_equals_eval(loss):
    """`predict(img, mask)` gives (loss, masks) of the serving copy;
    `eval_one_epoch` the binarised dice of the state's model: the same
    forward in float32 on the CPU, so the same masks bit for bit."""
    m = _model(seed=6)
    x, gt = _batch(3)
    p_loss, p_masks = m.predict(x, gt, use_loss=loss)
    e_loss, e_masks = m.eval_one_epoch(x, gt)
    np.testing.assert_array_equal(p_masks, e_masks)
    np.testing.assert_array_equal(m.predict(x), e_masks)
    if loss == "dice_argmax":
        assert float(p_loss) == float(e_loss)
    assert 0.0 <= float(p_loss) <= 1.0


def test_serving_copy_follows_training(monkeypatch):
    """The serving copy is rebuilt after a step and after a load, so
    `predict` serves the trained weights; it records no gradients, and its
    SR-attention takes tensors of its dtype, so the forward kernel follows
    the dtype (the bfloat16 wgmma kernel, the float32 3xTF32 one)."""
    m = _model(seed=7)
    x, gt = _batch(4)
    first = m.predict(x)
    served = m.model
    assert m.model is served
    assert not any(p.requires_grad for p in served.parameters())
    bf16 = SegFormerModel(config=MiTConfig(**{**TINY, "dtype": "bfloat16"}),
                          device="cpu", seed=7).model
    seen = []
    fwd = sra.SRAttention.forward

    def record(ctx, q, k, v, num_heads):
        seen.append(q.dtype)
        return fwd(ctx, q, k, v, num_heads)

    monkeypatch.setattr(sra.SRAttention, "forward", staticmethod(record))
    for model, dtype in ((served, torch.float32), (bf16, torch.bfloat16)):
        seen.clear()
        with torch.no_grad():
            forward_masks(model, torch.from_numpy(x))
        assert seen and all(d == dtype for d in seen)
        assert sra.FWD_KERNELS[dtype] == {
            torch.float32: "sr_attention_fwd_f32_kernel",
            torch.bfloat16: "sr_attention_fwd_wgmma_kernel"}[dtype]
    monkeypatch.undo()
    m.train_one_epoch(x, gt)
    assert m.model is not served
    assert not np.array_equal(m.predict(x), first)
    np.testing.assert_array_equal(m.predict(x), m.eval_one_epoch(x, gt)[1])


def test_serving_holds_no_train_state(tmp_path):
    """A model that only loads and serves holds its float32 weights and the
    serving copy, and no train state (no Adam moments); the first step
    makes the state, its moments over the trainable parameters."""
    a = _model(seed=10)
    path = str(tmp_path / "a.pt")
    a.save(path)
    m = _model(seed=11)
    m.load(path)
    x, gt = _batch(6)
    m.predict(x)
    assert m._state is None
    m.train_one_epoch(x, gt)
    assert m._state is not None and int(m.state.count) == 1
    assert set(m.state.mu) == set(m.state.params)


def test_resume_restores_last_and_refreshes_serving(tmp_path):
    """`resume` restores the `_last` checkpoint's full state and returns
    (the epoch to start at, the best loss), None when there is none; the
    serving copy then serves the restored weights."""
    from semisupervisedobjectdetection_torch.checkpoint.io import save_last

    a, b = _model(seed=12), _model(seed=13)
    x, gt = _batch(7)
    assert b.resume(str(tmp_path), "m") is None
    a.train_one_epoch(x, gt)
    save_last(str(tmp_path), "m", a.state, epoch=4, best_loss=0.25)
    before = b.predict(x)
    assert b.resume(str(tmp_path), "m") == (5, 0.25)
    assert int(b.state.count) == 1
    np.testing.assert_array_equal(b.predict(x), a.predict(x))
    assert not np.array_equal(b.predict(x), before)


def test_train_mode_without_quirks_is_seeded():
    """Without the reference's quirks a step runs in train mode, its masks
    drawn from `generator`: the same seed gives the same step."""
    tc = TrainConfig(reference_quirks=False)
    x, gt = _batch(5)
    losses = []
    for seed in (8, 8, 9):
        m = _model(train_config=tc)
        m.generator.manual_seed(seed)
        losses.append(float(m.train_one_epoch(x, gt)[0]))
    assert losses[0] == losses[1] != losses[2]


@pytest.mark.parametrize("call", [
    lambda m: m.predict(np.zeros((1, SIZE, SIZE, 3)),
                        np.zeros((1, SIZE, SIZE)), use_loss="bce"),
    lambda m: m.export_serving("a", 1), lambda m: m.export_hf("h.pth"),
], ids=["bce", "export_serving", "export_hf"])
def test_unported_surface_raises(call):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call(_model())
