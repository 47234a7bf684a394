"""Standardized configurations and the per-maze experiment registry (the port's
own copy of ``adfmsl/config/standardized.py``).

Reference contract: ``Thesis/standardized_maze_config.py:8-37`` (STANDARDIZED_CONFIG),
``Thesis/06_Utilities/fmsl_standardized_config.py:17-79`` (flat dict incl. SpecAugment
keys). Per-model FMSL hyperparameter drift that the reference ships despite claiming
standardization is preserved behind ``drift=True`` (SURVEY.md section 2.3: maze4/8
s=2.0 m=0.05; maze5 s=2.0 m=0.1; maze6 n_proto=8 s=5.0 m=0.5; maze7 s=5.0 m=0.15).
"""
from __future__ import annotations

import copy
from typing import Any, Dict

from adfmsl_torch.config.base import (
    ArchitectureConfig,
    DataConfig,
    ExperimentConfig,
    FMSLConfig,
    FrontendConfig,
    LossConfig,
    MeshConfig,
    ModelConfig,
    OptimizerConfig,
    SpecAugmentConfig,
    TrainConfig,
    Wav2Vec2Config,
)

# The reference's drifted FMSL params per model (SURVEY.md 2.3). Canonical is
# (n_prototypes=3, s=32.0, m=0.45).
FMSL_DRIFT: Dict[str, Dict[str, Any]] = {
    "maze4_fmsl": {"s": 2.0, "m": 0.05},
    "maze5_fmsl": {"s": 2.0, "m": 0.1},
    "maze6_fmsl": {"n_prototypes": 8, "s": 5.0, "m": 0.5},
    "maze7_fmsl": {"s": 5.0, "m": 0.15},
    "maze8_fmsl": {"s": 2.0, "m": 0.05},
}

# Per-model OPTIMIZER drift vs the standardized claim (lr 1e-4, wd 1e-4,
# grad_clip 1.0 — fmsl_standardized_config.py:53,125), read off the actual
# argparse defaults and train_epoch bodies:
#   - main/maze2/maze3 (+ main_fmsl) train_epochs contain NO clip_grad_norm_
#     call at all -> grad_clip_norm 0.0 (main.py:58-90, maze2.py:345-374);
#   - maze6 baseline: lr 5e-5, wd 5e-4 (maze6.py:578-580);
#   - maze5_fmsl: lr 1e-3, clip 5.0 (maze5_fmsl_standardized.py:538-540);
#   - maze4/6/7/8_fmsl: lr 1e-5 ("EXTREMELY reduced LR to prevent NaN",
#     e.g. maze7_fmsl_standardized.py:471).
OPT_DRIFT: Dict[str, Dict[str, float]] = {
    "main": {"grad_clip_norm": 0.0},
    "maze2": {"grad_clip_norm": 0.0},
    "maze3": {"grad_clip_norm": 0.0},
    "maze6": {"lr": 5e-5, "weight_decay": 5e-4},
    "main_fmsl": {"grad_clip_norm": 0.0},
    "maze4_fmsl": {"lr": 1e-5},
    "maze5_fmsl": {"lr": 1e-3, "grad_clip_norm": 5.0},
    "maze6_fmsl": {"lr": 1e-5},
    "maze7_fmsl": {"lr": 1e-5},
    "maze8_fmsl": {"lr": 1e-5},
}

# Integration mode per FMSL model (SURVEY.md section 2.3 Modes A/B/C).
FMSL_MODES: Dict[str, str] = {
    "main_fmsl": "replace",
    "maze2_fmsl": "replace",
    "maze3_fmsl": "replace",
    "maze4_fmsl": "integrated",
    "maze5_fmsl": "refine",
    "maze6_fmsl": "replace",
    "maze7_fmsl": "integrated",
    "maze8_fmsl": "replace",
}

BASELINE_MODELS = ["main", "maze2", "maze3", "maze4", "maze5", "maze6", "maze7", "maze8"]
FMSL_MODELS = [f"{m}_fmsl" for m in BASELINE_MODELS]
ALL_MODELS = BASELINE_MODELS + FMSL_MODELS
# Extra TPU-native model families beyond the reference zoo (BASELINE.json configs 1-2).
EXTRA_MODELS = ["lcnn_lfcc", "lcnn1d_lfcc", "resnet18_logmel"]


def get_standardized_config(model_type: str = "baseline") -> Dict[str, Any]:
    """Reference-compatible flat dict (standardized_maze_config.py:39-64)."""
    if model_type not in ("baseline", "fmsl"):
        raise ValueError(f"model_type must be 'baseline' or 'fmsl', got {model_type!r}")
    exp = make_experiment("maze5_fmsl" if model_type == "fmsl" else "maze5", drift=False)
    return exp.to_reference_dict()


def _fmsl_for(name: str, drift: bool = True) -> FMSLConfig:
    cfg = FMSLConfig(mode=FMSL_MODES.get(name, "replace"))
    if drift and name in FMSL_DRIFT:
        for k, v in FMSL_DRIFT[name].items():
            setattr(cfg, k, v)
    return cfg


def make_experiment(name: str, drift: bool = True, **overrides) -> ExperimentConfig:
    """Build the standardized ExperimentConfig for a registry model name."""
    if name not in ALL_MODELS and name not in EXTRA_MODELS:
        known = ", ".join(ALL_MODELS + EXTRA_MODELS)
        raise KeyError(f"unknown model '{name}'; known: {known}")
    is_fmsl = name.endswith("_fmsl")
    w2v2_models = {"maze2", "maze3", "maze6", "maze7", "maze8"}
    base = name[:-5] if is_fmsl else name

    frontend = FrontendConfig(name="raw")
    if base in w2v2_models:
        frontend = FrontendConfig(name="wav2vec2")
    elif base in {"main", "maze4", "maze5"}:
        frontend = FrontendConfig(name="sinc")
    elif name in ("lcnn_lfcc", "lcnn1d_lfcc"):
        frontend = FrontendConfig(name="lfcc", n_lfcc=60)
    elif name == "resnet18_logmel":
        frontend = FrontendConfig(name="logmel", n_mels=80)

    w2v2 = Wav2Vec2Config()
    if base == "maze6":
        # maze6: wav2vec2-large multi-layer fusion w/ partial unfreezing (maze6.py:103-165)
        w2v2 = Wav2Vec2Config(
            model_name="facebook/wav2vec2-large-960h",
            output_dim=1024,
            freeze=False,
            fusion_layers=[0, 6, 12, 18, 24],
            unfreeze_last_n=2,
        )

    spec = SpecAugmentConfig(enabled=base in {"maze2", "maze4", "maze5", "maze6"})
    if is_fmsl and base in {"maze4", "maze5"}:
        spec.semantics = "reference_handrolled"

    loss = LossConfig(name="weighted_ce", class_weights=[0.1, 0.9])
    if base in {"maze2", "maze5"}:
        # the only baselines whose default --loss actually builds FocalLoss
        # (maze2.py:387,444; maze5.py:447,500). maze4/7/8 advertise a 'focal'
        # choice but BOTH branches construct weighted CE [0.1,0.9]
        # (maze4.py:485-489, maze7.py:465-469, maze8.py:515-521).
        loss = LossConfig(name="focal_ce")
    elif base == "maze6":
        # --loss default 'cce' -> CrossEntropyLoss([0.3, 0.7]) (maze6.py:581,684)
        loss = LossConfig(name="weighted_ce", class_weights=[0.3, 0.7])
    # FMSL modes B ('replace') and C ('integrated') compute loss inside the model;
    # mode A ('refine', maze5_fmsl) keeps an external loss — the reference's is
    # weighted CE [0.3, 0.7], NOT the baseline's focal
    # (maze5_fmsl_standardized.py:607).
    if is_fmsl:
        loss = (LossConfig(name="weighted_ce", class_weights=[0.3, 0.7])
                if FMSL_MODES.get(name) == "refine" else LossConfig(name="fmsl"))

    # AdamW everywhere the reference builds torch.optim.AdamW: baselines
    # maze4/5/6/7/8 (e.g. maze4.py:482) and every *_fmsl_standardized file
    # except main_fmsl (Adam, main_fmsl_standardized.py:378); main/maze2/maze3
    # baselines use Adam (main.py:187, maze2.py:437). maze3's config SAYS
    # {'type': 'AdamW', ...CosineAnnealingLR} but create_optimizer/create_
    # scheduler read the 'name' key (maze3.py:312, :330) — so it actually runs
    # Adam(wd=1e-4) with NO scheduler. Torch Adam's weight_decay is coupled L2
    # (handled in train/optim.py:_base_optimizer).
    if is_fmsl:
        opt = OptimizerConfig(name="adam" if base == "main" else "adamw")
    else:
        opt = OptimizerConfig(
            name="adamw" if base in {"maze4", "maze5", "maze6", "maze7", "maze8"}
            else "adam")
    # Structural scheduler choices (not numeric drift): maze6 baseline runs
    # CosineAnnealingLR (maze6.py:691-694); maze6_fmsl runs ReduceLROnPlateau
    # (mode='max' on dev accuracy, maze6_fmsl_standardized.py:684-686, :749).
    if base == "maze6":
        if is_fmsl:
            opt.scheduler, opt.plateau_mode = "plateau", "max"
        else:
            opt.scheduler, opt.min_lr = "cosine", 1e-7
    # Numeric optimizer drift vs the standardized claim (lr 1e-4, wd 1e-4,
    # clip 1.0) — reference-faithful defaults, suppressed by drift=False:
    if drift and name in OPT_DRIFT:
        for k, v in OPT_DRIFT[name].items():
            setattr(opt, k, v)

    exp = ExperimentConfig(
        model=ModelConfig(
            name=name,
            architecture=ArchitectureConfig(),
            wav2vec2=w2v2,
            fmsl=_fmsl_for(name, drift) if is_fmsl else None,
            spec_augment=spec,
            frontend=frontend,
        ),
        data=DataConfig(),
        train=TrainConfig(optimizer=opt, loss=loss),
        mesh=MeshConfig(),
    )
    apply_overrides(exp, overrides)
    return exp


def apply_overrides(exp, overrides) -> None:
    """Apply {'train.num_epochs': 1, ...} dotted-path overrides in place.

    Leaf names are validated against the dataclass fields — setattr would
    otherwise happily create a brand-new attribute for a typo'd key and the
    run would proceed with the default value. Shared by make_experiment and
    the batch plan YAML."""
    import dataclasses as _dc

    for k, v in (overrides or {}).items():
        obj = exp
        parts = k.split(".")
        for q in parts[:-1]:
            obj = getattr(obj, q)
        if parts[-1] not in {f.name for f in _dc.fields(type(obj))}:
            raise AttributeError(
                f"unknown config field {k!r} ({type(obj).__name__} has no "
                f"field {parts[-1]!r})")
        setattr(obj, parts[-1], copy.deepcopy(v))
