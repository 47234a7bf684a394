"""Config I/O of the port (``adfmsl_torch/config/{yaml_io,verify}.py``,
``ExperimentConfig.to_reference_dict``, ``get_standardized_config``) against
adfmsl's on the same inputs, on the CPU.

Every comparison is exact: ``dataclasses.asdict`` trees, the reference dicts,
the ignored keys, the verifier's report and the YAML text itself. The
reference's ``07_Configuration_Files`` directory is not mounted here
(tests/test_config.py:150), so the reference-format files are written by the
tests under ``tmp_path``, with the quirks the loader repairs or maps: the
``filts: filts:`` stutter, ``optimizer: Adam``, ``loss: focal``,
``learning_rate_wav2vec2`` and keys it does not know.
"""
import dataclasses
import logging
import os

import pytest

from adfmsl.config import get_standardized_config as jax_standardized
from adfmsl.config import load_reference_yaml as jax_load_reference_yaml
from adfmsl.config import load_yaml as jax_load_yaml
from adfmsl.config import make_experiment as jax_experiment
from adfmsl.config import save_yaml as jax_save_yaml
from adfmsl.config import verify_all as jax_verify_all
from adfmsl_torch.config import (ALL_MODELS, EXTRA_MODELS, experiment_from_dict,
                                 get_standardized_config, load_reference_yaml, load_yaml,
                                 make_experiment, save_yaml, verify_all)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the repo's ExperimentConfig YAMLs (configs/all_models.yaml is the batch
# CLI's schema, not a config tree)
CONFIG_YAMLS = ["maze5", "maze5_fmsl", "maze6_fmsl", "lcnn_lfcc", "resnet18_logmel"]

RAWNET_STYLE = """\
model:
  nb_samp: 64600
  first_conv: 1024
  in_channels: 1
  filts: filts: [20, [20, 20], [20, 128], [128, 128]]
  blocks: [2, 4]
  nb_fc_node: 1024
  gru_node: 1024
  nb_gru_layer: 3
  nb_classes: 2
training:
  batch_size: 32
  num_epochs: 100
  learning_rate: 0.0001
  weight_decay: 0.0001
  loss: focal
  seed: 1234
optimizer: Adam
amsgrad: false
focal_loss_alpha: 0.3
focal_loss_gamma: 1.5
database_path: /data/LA/
track: LA
some_unknown_key: 7
"""

W2V2_STYLE = """\
model:
  wav2vec2_model_name: facebook/wav2vec2-large-960h
  wav2vec2_output_dim: 1024
  wav2vec2_unfrozen_transformers: 2
  wav2vec2_freeze_cnn: true
  wav2vec2_output_layers: [0, 6, 12, 18, 24]
  transformer_dropout: 0.2
  transformer_layers: 4
  projected_dim: 128
  use_spec_augment_w2v2: true
  spec_aug_freq_mask_param_w2v2: 15
  spec_aug_n_time_masks_w2v2: 3
  filts: filts: [128, [128, 128], [128, 256]]
training:
  batch_size: 8
  learning_rate: 0.0002
  learning_rate_wav2vec2: 0.00001
  loss: weighted
  grad_clip_norm: 5.0
optimizer: AdamW
unknown_knob: abc
"""


def _tree(exp):
    return dataclasses.asdict(exp)


@pytest.mark.parametrize("name", CONFIG_YAMLS)
def test_repo_config_yamls_load_to_equal_trees(name):
    path = os.path.join(REPO, "configs", f"{name}.yaml")
    assert _tree(load_yaml(path)) == _tree(jax_load_yaml(path))


@pytest.mark.parametrize("drift", [True, False], ids=["drift", "no_drift"])
@pytest.mark.parametrize("name", ALL_MODELS + EXTRA_MODELS)
def test_registry_tree_round_trips_through_adfmsl(name, drift, tmp_path):
    """port -> YAML -> adfmsl -> YAML -> port gives the tree back; both files
    are the same text; the reference dicts are equal and hand out copies."""
    exp = make_experiment(name, drift=drift)
    assert _tree(exp) == _tree(jax_experiment(name, drift=drift))
    ours, theirs = str(tmp_path / "port.yaml"), str(tmp_path / "adfmsl.yaml")
    save_yaml(exp, ours)
    jexp = jax_load_yaml(ours)
    assert _tree(jexp) == _tree(exp)
    jax_save_yaml(jexp, theirs)
    assert _tree(load_yaml(theirs)) == _tree(exp)
    with open(ours) as a, open(theirs) as b:
        assert a.read() == b.read()
    ref = exp.to_reference_dict()
    assert ref == jexp.to_reference_dict()
    ref["filts"][1].append(0)
    assert exp.to_reference_dict() == jexp.to_reference_dict()


@pytest.mark.parametrize("text,style", [(RAWNET_STYLE, "rawnet"), (W2V2_STYLE, "w2v2")])
def test_reference_yaml_loads_the_same(text, style, tmp_path):
    path = tmp_path / f"model_config_{style}.yaml"
    path.write_text(text)
    exp, ignored = load_reference_yaml(str(path))
    jexp, jignored = jax_load_reference_yaml(str(path))
    assert _tree(exp) == _tree(jexp) and ignored == jignored
    if style == "rawnet":
        assert exp.model.name == "main"
        assert exp.model.architecture.filts == [20, [20, 20], [20, 128], [128, 128]]
        assert exp.train.optimizer.name == "adam" and exp.train.loss.name == "focal_ce"
        assert ignored == {"in_channels": 1, "blocks": [2, 4], "gru_node": 1024,
                           "amsgrad": False, "some_unknown_key": 7}
    else:
        assert exp.model.name == "maze6" and not exp.model.wav2vec2.freeze
        assert exp.train.optimizer.backbone_lr_scale == pytest.approx(0.05)
        assert exp.model.wav2vec2.fusion_layers == [0, 6, 12, 18, 24]
        assert ignored == {"transformer_layers": 4, "projected_dim": 128,
                           "unknown_knob": "abc"}


def _warnings(caplog, package):
    return sorted(r.getMessage() for r in caplog.records
                  if r.name.startswith(package + ".") and r.levelno == logging.WARNING)


def test_stale_keys_warn_by_class_in_both_packages(tmp_path, caplog):
    """A YAML with stale keys at four depths: both packages drop them, load
    the same tree and log the same warning for each class; the checkpoints'
    ``experiment_from_dict`` goes through the same loader."""
    import yaml

    d = _tree(make_experiment("maze5_fmsl"))
    d["stale_top"] = 1
    d["model"]["architecture"]["old_knob"] = 2
    d["model"]["fmsl"]["legacy"] = True
    d["train"]["optimizer"]["beta3"] = 0.5
    path = tmp_path / "stale.yaml"
    path.write_text(yaml.safe_dump(d, sort_keys=False))
    caplog.set_level(logging.WARNING)
    exp = load_yaml(str(path))
    jexp = jax_load_yaml(str(path))
    assert _tree(exp) == _tree(jexp) == _tree(make_experiment("maze5_fmsl"))
    want = sorted(["ExperimentConfig: ignoring unknown config key(s) ['stale_top']",
                   "ArchitectureConfig: ignoring unknown config key(s) ['old_knob']",
                   "FMSLConfig: ignoring unknown config key(s) ['legacy']",
                   "OptimizerConfig: ignoring unknown config key(s) ['beta3']"])
    assert _warnings(caplog, "adfmsl_torch") == want
    assert _warnings(caplog, "adfmsl") == want
    caplog.clear()
    assert _tree(experiment_from_dict(d)) == _tree(exp)
    assert _warnings(caplog, "adfmsl_torch") == want


@pytest.mark.parametrize("text", ["", "- 1\n- 2\n"], ids=["empty", "list"])
def test_load_yaml_rejects_a_non_mapping(text, tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text(text)
    for load in (load_yaml, jax_load_yaml):
        with pytest.raises(ValueError, match="expected a YAML mapping"):
            load(str(path))


@pytest.mark.parametrize("model_type", ["baseline", "fmsl"])
def test_standardized_config_equals_adfmsl(model_type):
    assert get_standardized_config(model_type) == jax_standardized(model_type)


def test_standardized_config_rejects_an_unknown_type():
    for fn in (get_standardized_config, jax_standardized):
        with pytest.raises(ValueError, match="model_type must be"):
            fn("maze5")


@pytest.mark.parametrize("drift", [True, False], ids=["drift", "no_drift"])
def test_verify_all_equals_adfmsl(drift):
    ours, theirs = verify_all(drift=drift), jax_verify_all(drift=drift)
    assert ours.summary() == theirs.summary()
    assert ours.all_canonical_ok == theirs.all_canonical_ok
    for f in ("per_model", "pair_consistent", "fmsl_drift", "opt_drift"):
        assert getattr(ours, f) == getattr(theirs, f), f
    assert bool(ours.fmsl_drift) == drift and bool(ours.opt_drift) == drift
