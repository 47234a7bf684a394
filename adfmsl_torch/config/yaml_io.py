"""YAML round trip of ``ExperimentConfig`` (port of ``adfmsl/config/yaml_io.py``).

``save_yaml`` writes ``dataclasses.asdict`` of the tree with the fields in
declaration order, as adfmsl's does, so a file written by either package
loads in the other to an equal tree; ``load_yaml`` reads one back through
the same ``_from_dict`` as the checkpoints' config (``config/base.py``), which
warns for each key it does not know. ``load_reference_yaml`` ingests the
reference's flat ``07_Configuration_Files/model_config_*.yaml``.

pyyaml is imported inside these functions: nothing else of the port needs it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from adfmsl_torch.config.base import ExperimentConfig, _from_dict


def save_yaml(cfg: ExperimentConfig, path: str) -> None:
    import yaml

    with open(path, "w") as fh:
        yaml.safe_dump(dataclasses.asdict(cfg), fh, sort_keys=False)


def _read_mapping(path: str, text_filter=None) -> Dict[str, Any]:
    import yaml

    with open(path) as fh:
        text = fh.read()
    d = yaml.safe_load(text_filter(text) if text_filter else text)
    if not isinstance(d, dict):
        raise ValueError(
            f"{path}: expected a YAML mapping of ExperimentConfig fields, got "
            f"{type(d).__name__} (empty file?)")
    return d


def load_yaml(path: str) -> ExperimentConfig:
    return _from_dict(ExperimentConfig, _read_mapping(path))


# flat reference key -> dotted ExperimentConfig path. Keys of the reference
# files that configure what MazeSpec fixes per model (transformer_*,
# attn_pool_hidden_dim, projected_dim, gru_node, blocks, in_channels,
# res_pool_stride_w2v2, amsgrad) are returned as ignored.
_REF_KEY_MAP = {
    # model block
    "nb_samp": "data.cut",
    "first_conv": "model.architecture.first_conv",
    "filts": "model.architecture.filts",
    "nb_fc_node": "model.architecture.nb_fc_node",
    "nb_gru_layer": "model.architecture.nb_gru_layer",
    "nb_classes": "model.architecture.nb_classes",
    "fc_dropout": "model.architecture.fc_dropout",
    "dropout_rate": "model.architecture.dropout_rate",
    "transformer_dropout": "model.architecture.transformer_dropout",
    "wav2vec2_model_name": "model.wav2vec2.model_name",
    "wav2vec2_output_dim": "model.wav2vec2.output_dim",
    "wav2vec2_freeze": "model.wav2vec2.freeze",
    "wav2vec2_unfrozen_transformers": "model.wav2vec2.unfreeze_last_n",
    "use_spec_augment_w2v2": "model.spec_augment.enabled",
    "use_spec_augment_raw": "model.spec_augment.enabled",
    "spec_aug_freq_mask_param_w2v2": "model.spec_augment.freq_mask_param",
    "spec_aug_n_freq_masks_w2v2": "model.spec_augment.n_freq_masks",
    "spec_aug_time_mask_param_w2v2": "model.spec_augment.time_mask_param",
    "spec_aug_n_time_masks_w2v2": "model.spec_augment.n_time_masks",
    "spec_aug_freq_mask_param_raw": "model.spec_augment.freq_mask_param",
    "spec_aug_n_freq_masks_raw": "model.spec_augment.n_freq_masks",
    "spec_aug_time_mask_param_raw": "model.spec_augment.time_mask_param",
    "spec_aug_n_time_masks_raw": "model.spec_augment.n_time_masks",
    # training block
    "num_epochs": "train.num_epochs",
    "batch_size": "train.batch_size",
    "seed": "train.seed",
    "learning_rate": "train.optimizer.lr",
    "weight_decay": "train.optimizer.weight_decay",
    "grad_clip_norm": "train.optimizer.grad_clip_norm",
    "database_path": "data.database_path",
    "protocols_path": "data.protocols_path",
    "track": "data.track",
    # top-level focal knobs (model_config_Model4.yaml:38-39)
    "focal_loss_alpha": "train.loss.focal_alpha",
    "focal_loss_gamma": "train.loss.focal_gamma",
}


def _set_dotted(exp: ExperimentConfig, dotted: str, value: Any) -> None:
    obj = exp
    parts = dotted.split(".")
    for q in parts[:-1]:
        obj = getattr(obj, q)
    setattr(obj, parts[-1], value)


def _repair_reference_yaml_text(text: str) -> str:
    """model_config_Maze5.yaml:23 reads ``filts: filts: [...]``, a duplicated
    key token that is a YAML syntax error: drop the stutter."""
    out = []
    for line in text.splitlines():
        if line.lstrip().startswith("filts: filts:"):
            line = line.replace("filts: filts:", "filts:", 1)
        out.append(line)
    return "\n".join(out)


def load_reference_yaml(path: str, base_model: Optional[str] = None
                        ) -> Tuple[ExperimentConfig, Dict[str, Any]]:
    """Ingest a literal ``07_Configuration_Files/model_config_*.yaml``: every
    key it knows lands on the typed tree; the others come back for
    inspection. Returns ``(ExperimentConfig, ignored)``. ``base_model`` is the
    registry name to start from (default: ``main`` for a RawNet-style file,
    one with ``nb_samp`` or ``gru_node``; ``maze6`` for a wav2vec2-style one)."""
    from adfmsl_torch.config.standardized import make_experiment

    d = _read_mapping(path, _repair_reference_yaml_text)
    flat: Dict[str, Any] = {}
    for block in ("model", "training"):
        if isinstance(d.get(block), dict):
            flat.update(d[block])
    flat.update({k: v for k, v in d.items() if k not in ("model", "training")})

    if base_model is None:
        base_model = "main" if ("gru_node" in flat or "nb_samp" in flat) else "maze6"
    exp = make_experiment(base_model)

    ignored: Dict[str, Any] = {}
    for k, v in flat.items():
        if k == "optimizer":               # top-level 'optimizer: Adam'
            exp.train.optimizer.name = str(v).strip().lower()
        elif k == "loss":                  # training block 'loss: focal'
            exp.train.loss.name = "focal_ce" if str(v).startswith("focal") else "weighted_ce"
        elif k == "learning_rate_wav2vec2":    # differential LR -> backbone scale
            lr = flat.get("learning_rate", exp.train.optimizer.lr)
            exp.train.optimizer.backbone_lr_scale = float(v) / float(lr)
        elif k == "wav2vec2_freeze_cnn":
            exp.model.wav2vec2.unfreeze_feature_extractor = not bool(v)
        elif k == "wav2vec2_output_layers":
            layers = list(v) if isinstance(v, (list, tuple)) else [v]
            exp.model.wav2vec2.fusion_layers = layers if len(layers) > 1 else None
        elif k in _REF_KEY_MAP:
            _set_dotted(exp, _REF_KEY_MAP[k], v)
        else:
            ignored[k] = v
    # freeze is derived in the reference (maze6.py:110-130): frozen unless some
    # transformer layers or the CNN extractor are unfrozen explicitly
    if "wav2vec2_unfrozen_transformers" in flat or "wav2vec2_freeze_cnn" in flat:
        exp.model.wav2vec2.freeze = (
            int(flat.get("wav2vec2_unfrozen_transformers", 0)) == 0
            and bool(flat.get("wav2vec2_freeze_cnn", True)))
    return exp, ignored
