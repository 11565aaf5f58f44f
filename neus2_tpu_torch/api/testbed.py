"""Reference-style JSON configs -> ``TrainConfig`` (the static part of
``neus2_tpu/api/testbed.py::config_from_json``; reference
testbed.cu:139-162 load_network_config).

Reads encoding, network, rgb_network, loss, the Ema(ExponentialDecay(Adam))
optimizer nesting and the hyperparameters the static step uses.  The
Testbed itself is not ported yet.
"""

from __future__ import annotations

import json
from pathlib import Path

from neus2_tpu_torch.engine.train import TrainConfig
from neus2_tpu_torch.models.field import FieldConfig
from neus2_tpu_torch.ops.hashgrid import HashGridConfig
from neus2_tpu_torch.utils.optim import OptimConfig


def _read_json(path: Path) -> dict:
    # The reference's parser allows // comments.
    with open(path) as f:
        return json.loads("\n".join(l.split("//")[0] for l in f.read().splitlines()))


def config_from_json(path: str | Path) -> TrainConfig:
    """Build the training config, following ``parent`` inheritance."""
    path = Path(path)
    cfg = _read_json(path)
    while "parent" in cfg:
        parent = _read_json(path.parent / cfg.pop("parent"))
        parent.update(cfg)
        cfg = parent

    enc = cfg.get("encoding", {})
    n_levels = int(enc.get("n_levels", 14))
    base_res = int(enc.get("base_resolution", 16))
    top_res = int(enc.get("top_resolution", 2048))
    grid = HashGridConfig(
        n_levels=n_levels,
        n_features_per_level=int(enc.get("n_features_per_level", 2)),
        log2_hashmap_size=int(enc.get("log2_hashmap_size", 19)),
        base_resolution=base_res,
        per_level_scale=enc.get(
            "per_level_scale",
            HashGridConfig.per_level_scale_from_top(base_res, top_res, n_levels),
        ),
        valid_level_scale=float(enc.get("valid_level_scale", 0.02)),
        base_valid_level_scale=float(enc.get("base_valid_level_scale", 0.2)),
        base_training_step=int(enc.get("base_training_step", 100)),
    )
    net = cfg.get("network", {})
    rgb_net = cfg.get("rgb_network", {})
    field = FieldConfig(
        grid=grid,
        sdf_hidden_dim=int(net.get("n_neurons", 64)),
        sdf_n_hidden=int(net.get("n_hidden_layers", 1)),
        rgb_hidden_dim=int(rgb_net.get("n_neurons", 64)),
        rgb_n_hidden=int(rgb_net.get("n_hidden_layers", 2)),
    )
    hp = cfg.get("hyperparams", {})
    ema_decay = 0.95
    decay_start, decay_interval, decay_base = 20000, 10000, 0.33
    leaf = cfg.get("optimizer", {})
    while True:
        otype = str(leaf.get("otype", "")).lower()
        if otype == "ema":
            ema_decay = float(leaf.get("decay", ema_decay))
        elif otype == "exponentialdecay":
            decay_start = int(leaf.get("decay_start", decay_start))
            decay_interval = int(leaf.get("decay_interval", decay_interval))
            decay_base = float(leaf.get("decay_base", decay_base))
        if "nested" not in leaf:
            break
        leaf = leaf["nested"]
    optim = OptimConfig(
        learning_rate=float(leaf.get("learning_rate", 1e-3)),
        beta1=float(leaf.get("beta1", 0.9)),
        beta2=float(leaf.get("beta2", 0.99)),
        epsilon=float(leaf.get("epsilon", 1e-15)),
        l2_reg=float(leaf.get("l2_reg", 1e-6)),
        components=tuple(
            sorted(
                (str(k), bool(v))
                for k, v in leaf.get("optimize_params_components", {}).items()
            )
        ),
        adabound=bool(leaf.get("adabound", False)),
        non_matrix_lr_factor=float(leaf.get("non_matrix_learning_rate_factor", 1.0)),
        ema_decay=ema_decay,
        decay_start=decay_start,
        decay_interval=decay_interval,
        decay_base=decay_base,
    )
    return TrainConfig(
        field=field,
        optim=optim,
        rgb_loss_type=cfg.get("loss", {}).get("otype", "Huber"),
        ek_loss_weight=float(hp.get("ek_loss_weight", 0.1)),
        mask_loss_weight=float(hp.get("mask_loss_weight", 0.0)),
        anneal_end=int(hp.get("m_anneal_end", 0)),
        ema_decay=ema_decay,
    )
