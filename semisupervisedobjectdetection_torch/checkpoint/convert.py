"""Carry SegFormer weights into the port's `SegFormer` state_dict, and a
JAX train state into the port's `TrainState`.

Two sources of weights:

- `state_dict_from_flax`: the JAX package's param tree (nested dicts of
  numpy arrays, as `SegFormer.init` / `TrainState` hold them) and its
  BatchNorm statistics. Per-layer params of a stage are stacked there along
  a leading depth axis (the JAX encoder scans over its layers) and are
  unstacked here. Layouts: Dense kernel (I, O) -> Linear weight (O, I);
  Conv kernel (kh, kw, I, O) -> Conv2d weight (O, I, kh, kw); LayerNorm and
  BatchNorm scale/bias -> weight/bias; batch_stats mean/var ->
  running_mean/running_var. Prompt tokens keep their (t, c) or
  (depth, t, c) shape, CLS tokens their (1, c).
- `load_torch_checkpoint`: a `.safetensors` or `.pth`/`.bin` file in the HF
  SegFormer key layout, such as the JAX package's `export_hf` writes or the
  port's own `torch.save(model.state_dict())`.

`train_state_from_flax` carries a whole JAX `TrainState` (params,
batch_stats, Adam's mu/nu/count, epoch, base_lr, lr_decay), each
param-shaped tree through `state_dict_from_flax`, so the two sides can step
from one state.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from semisupervisedobjectdetection_torch.core.config import (
    MiTConfig,
    TrainConfig,
)

_ENC = "segformer.encoder"


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, copy=True))


def _lin(sd: Dict, name: str, leaf: Mapping, j: Optional[int] = None):
    k, b = leaf["kernel"], leaf["bias"]
    if j is not None:
        k, b = k[j], b[j]
    sd[f"{name}.weight"] = _t(np.asarray(k).T)
    sd[f"{name}.bias"] = _t(b)


def _conv(sd: Dict, name: str, leaf: Mapping, j: Optional[int] = None):
    k = leaf["kernel"] if j is None else leaf["kernel"][j]
    sd[f"{name}.weight"] = _t(np.asarray(k).transpose(3, 2, 0, 1))
    if "bias" in leaf:
        sd[f"{name}.bias"] = _t(leaf["bias"] if j is None
                                else leaf["bias"][j])


def _ln(sd: Dict, name: str, leaf: Mapping, j: Optional[int] = None):
    s, b = leaf["scale"], leaf["bias"]
    if j is not None:
        s, b = s[j], b[j]
    sd[f"{name}.weight"] = _t(s)
    sd[f"{name}.bias"] = _t(b)


def state_dict_from_flax(cfg: MiTConfig, params: Mapping,
                         batch_stats: Optional[Mapping] = None
                         ) -> Dict[str, torch.Tensor]:
    """JAX (params, batch_stats) -> the port's state_dict, loadable with
    `SegFormer(cfg).load_state_dict(sd, strict=True)`."""
    sd: Dict[str, torch.Tensor] = {}
    enc = params["encoder"]
    for i in range(cfg.num_stages):
        pe = f"{_ENC}.patch_embeddings.{i}"
        _conv(sd, f"{pe}.proj", enc[f"patch_embed_{i}"]["proj"])
        _ln(sd, f"{pe}.layer_norm", enc[f"patch_embed_{i}"]["layer_norm"])
        _ln(sd, f"{_ENC}.layer_norm.{i}", enc[f"layer_norm_{i}"])
        block = enc[f"block_{i}"]
        attn, mlp = block["attention"], block["mlp"]
        for j in range(cfg.depths[i]):
            pfx = f"{_ENC}.block.{i}.{j}"
            _ln(sd, f"{pfx}.layer_norm_1", block["layer_norm_1"], j)
            _ln(sd, f"{pfx}.layer_norm_2", block["layer_norm_2"], j)
            for ours, theirs in (("query", "attention.self.query"),
                                 ("key", "attention.self.key"),
                                 ("value", "attention.self.value"),
                                 ("out", "attention.output.dense")):
                _lin(sd, f"{pfx}.{theirs}", attn[ours], j)
            if cfg.sr_ratios[i] > 1:
                _conv(sd, f"{pfx}.attention.self.sr", attn["sr"], j)
                _ln(sd, f"{pfx}.attention.self.layer_norm", attn["sr_norm"],
                    j)
            _lin(sd, f"{pfx}.mlp.dense1", mlp["dense1"], j)
            _lin(sd, f"{pfx}.mlp.dense2", mlp["dense2"], j)
            _conv(sd, f"{pfx}.mlp.dwconv.dwconv", mlp["dwconv"], j)
        if f"prompt_tokens_{i}" in enc:
            sd[f"{_ENC}.prompt_tokens.{i}"] = _t(enc[f"prompt_tokens_{i}"])
        if f"cls_token_{i}" in enc:
            sd[f"{_ENC}.cls_token.{i}"] = _t(enc[f"cls_token_{i}"])

    head = params["decode_head"]
    for i in range(cfg.num_stages):
        _lin(sd, f"decode_head.linear_c.{i}.proj", head[f"linear_c_{i}"])
        if f"cls_proj_{i}" in head:
            _lin(sd, f"decode_head.linear_c.{i}.cls_proj",
                 head[f"cls_proj_{i}"])
    _conv(sd, "decode_head.linear_fuse", head["linear_fuse"])
    bn = "decode_head.batch_norm"
    sd[f"{bn}.weight"] = _t(head["batch_norm"]["scale"])
    sd[f"{bn}.bias"] = _t(head["batch_norm"]["bias"])
    stats = (batch_stats or {}).get("decode_head", {}).get("batch_norm")
    n = sd[f"{bn}.weight"].shape[0]
    sd[f"{bn}.running_mean"] = _t(stats["mean"]) if stats is not None \
        else torch.zeros(n)
    sd[f"{bn}.running_var"] = _t(stats["var"]) if stats is not None \
        else torch.ones(n)
    sd[f"{bn}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    _conv(sd, "decode_head.classifier", head["classifier"])
    return sd


def load_torch_checkpoint(path: str, cfg: MiTConfig
                          ) -> Dict[str, torch.Tensor]:
    """Read a `.safetensors` or `.pth`/`.bin` SegFormer checkpoint into a
    state_dict for `SegFormer(cfg)`.

    A leading `model.` is stripped from the keys. When `cfg.num_labels` is
    1 and the file's classifier has more output channels, channel 0 is
    taken (the reference's checkpoint surgery; the JAX package's
    `classifier_policy="slice0"`). A file without the prompt/CLS token keys
    the config needs is refused: the tokens would otherwise be served at
    their random init.
    """
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        raw = load_file(path)
    else:
        raw = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k.removeprefix("model."): v for k, v in raw.items()}

    w, b = "decode_head.classifier.weight", "decode_head.classifier.bias"
    if cfg.num_labels == 1 and w in sd and sd[w].shape[0] > 1:
        sd[w], sd[b] = sd[w][:1].clone(), sd[b][:1].clone()

    need = [f"{_ENC}.prompt_tokens.{i}"
            for i, t in enumerate(cfg.prompt_tokens) if t > 0]
    need += [f"{_ENC}.cls_token.{i}"
             for i, t in enumerate(cfg.cls_tokens) if t > 0]
    missing = [k for k in need if k not in sd]
    if missing:
        raise ValueError(
            f"{path} has no prompt/CLS tokens for this config (missing "
            f"{missing}); the JAX package exports them apart from the "
            "state_dict (checkpoint/hf_export.py::export_prompt_tokens)")
    return sd


def _adam_state(opt_state):
    """The (count, mu, nu) state inside an optax chain's state tuple."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def train_state_from_flax(cfg: MiTConfig, state, tc: Optional[TrainConfig]
                          = None, device: Union[str, torch.device] = "cpu"):
    """The port's `TrainState` (a float32 `SegFormer(cfg)` on `device`) from
    a JAX `TrainState` without a trainable mask: params and batch_stats,
    Adam's mu, nu and count, epoch, base_lr and lr_decay. `tc` gives the
    optimizer constants (the JAX state keeps them inside its transform)."""
    from semisupervisedobjectdetection_torch.models.segformer import (
        SegFormer,
    )
    from semisupervisedobjectdetection_torch.train.state import TrainState

    if getattr(state, "trainable_mask", None) is not None:
        raise ValueError("train_state_from_flax takes a state without a "
                         "trainable mask")
    adam = _adam_state(state.opt_state)
    if adam is None:
        raise ValueError("no Adam state (mu, nu, count) in opt_state")
    model = SegFormer(cfg)
    model.load_state_dict(state_dict_from_flax(cfg, state.params,
                                               state.batch_stats),
                          strict=True)
    model.to(device)
    out = TrainState.create(model, tc or TrainConfig(),
                            lr=float(np.asarray(state.base_lr)))
    names = list(out.mu)
    for tree, dst in ((adam.mu, out.mu), (adam.nu, out.nu)):
        sd = state_dict_from_flax(cfg, tree)
        for n in names:
            dst[n].copy_(sd[n])
    dev = out.count.device
    out.count = torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32,
                             device=dev)
    out.epoch = torch.tensor(float(np.asarray(state.epoch)),
                             dtype=torch.float32, device=dev)
    out.lr_decay = torch.tensor(float(np.asarray(state.lr_decay)),
                                dtype=torch.float32, device=dev)
    return out
