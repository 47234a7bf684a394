"""Typed configuration tree (the port's own copy of ``adfmsl/config/base.py``;
``dataclasses.asdict`` of both trees is equal, tests/test_torch_ops.py).

The reference scatters configuration over four overlapping mechanisms (argparse CLI,
in-file ``model_config`` dicts, importable standardized-config modules, unused YAMLs;
standardized_maze_config.py:8-37 and fmsl_standardized_config.py:17-79). Here there
is ONE typed tree; ``ExperimentConfig.to_reference_dict`` gives the reference's flat
dict, and ``experiment_from_dict`` (checkpoints) and ``config/yaml_io.py:load_yaml``
read a plain dict back through one ``_from_dict``, which warns for each key it does
not know.
"""
from __future__ import annotations

import copy
import dataclasses
import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

FiltSpec = List[Union[int, List[int]]]


@dataclass
class ArchitectureConfig:
    """Mirrors the reference 'architecture' block (standardized_maze_config.py:10-16)."""

    filts: FiltSpec = field(default_factory=lambda: [128, [128, 128], [128, 256]])
    nb_fc_node: int = 1024
    nb_classes: int = 2
    sample_rate: int = 16000
    first_conv: int = 251          # sinc kernel size (odd)
    nb_gru_layer: int = 1          # RawNet GRU depth (reference yaml stacks 3)
    dropout_rate: float = 0.3
    fc_dropout: float = 0.5
    transformer_dropout: float = 0.1   # encoder-stack dropout (maze6.py:237,
                                       # model_config_Maze6.yaml transformer_dropout)
    # 'textbook' = real windowed-sinc band-pass (default: the reference's formula is
    # nearly flat across taps — see ops/sinc.py — and carries almost no spectral
    # information); 'reference' reproduces maze4.py:93-95 bit-for-bit for parity.
    sinc_formula: str = "textbook"
    # Residual-block semantics. 'tpu' (default): non-overlapping stride-s avg pool,
    # SE before pooling, 1x1 skip only on channel change. 'reference' reproduces
    # maze4.py:105-147 exactly (overlap AvgPool1d(2s-1, s, pad s-1) incl. pads,
    # SE after pooling, 1x1 skip whenever stride>1 or channels change) — required
    # when evaluating checkpoints ported from the reference (models/port.py).
    block_semantics: str = "tpu"


@dataclass
class Wav2Vec2Config:
    """Mirrors the reference 'wav2vec2' block (standardized_maze_config.py:18-22).

    Zero-egress environments cannot download HF checkpoints; ``pretrained_path`` points
    at a local checkpoint (HF torch .bin/.safetensors or an adfmsl-native msgpack). When
    absent, the encoder is randomly initialised (tests) or loading fails loudly
    (``require_pretrained=True``).
    """

    model_name: str = "facebook/wav2vec2-base-960h"
    output_dim: int = 768
    freeze: bool = True
    pretrained_path: Optional[str] = None
    require_pretrained: bool = False
    # maze6-style multi-layer fusion (reference maze6.py:103-165)
    fusion_layers: Optional[List[int]] = None     # e.g. [0, 6, 12, 18, 24]
    unfreeze_last_n: int = 0                      # partial unfreezing of encoder layers
    unfreeze_feature_extractor: bool = False
    # per-layer jax.checkpoint in the encoder: training peak memory scales with
    # one transformer layer instead of all of them (w2v2-large fine-tuning at
    # larger batch on one chip); forward numerics unchanged
    remat_layers: bool = False
    # jax.checkpoint the conv feature extractor too (its activation pyramid is
    # the batch-64 OOM source on w2v2-large); one recompute per backward
    remat_extractor: bool = False


@dataclass
class FMSLConfig:
    """Mirrors the reference 'fmsl' block + per-model drift knobs
    (fmsl_advanced.py:31-68; drift documented in SURVEY.md section 2.3)."""

    fmsl_type: str = "prototype"
    n_prototypes: int = 3
    s: float = 32.0                 # AM-Softmax scale
    m: float = 0.45                 # angular margin
    enable_lsa: bool = False        # latent space augmentation
    lsa_strength: float = 0.1
    # Integration mode: 'refine' (Mode A: embeddings feed the original classifier),
    # 'replace' (Mode B: FMSL logits + external CE), 'integrated' (Mode C: internal
    # loss), 'fallback' (checkpoint-parity: the literal maze6_fmsl live path — FMSL
    # computed but dead, fc1/fc2 classifier scores; models/mazes.py).
    mode: str = "replace"
    prototype_loss_weight: float = 0.1
    proj_dropout: float = 0.1       # projection MLP dropout (fmsl_advanced.py:133)


@dataclass
class SpecAugmentConfig:
    """SpecAugment knobs (fmsl_standardized_config.py:59-64). ``semantics`` selects
    torchaudio-style masks vs the reference's hand-rolled variant whose mask end is
    drawn uniformly in [start, size) (maze4_fmsl_standardized.py:193-214)."""

    enabled: bool = False
    freq_mask_param: int = 10
    time_mask_param: int = 10
    n_freq_masks: int = 2
    n_time_masks: int = 2
    semantics: str = "torchaudio"   # 'torchaudio' | 'reference_handrolled'


@dataclass
class LossConfig:
    """Loss selection. Reference variants: weighted CE [0.1,0.9]/[0.3,0.7], CE-form
    focal (alpha .25, gamma 2 — maze2.py:195-207), BCE-form focal (maze3.py:79-98)."""

    name: str = "weighted_ce"       # 'ce' | 'weighted_ce' | 'focal_ce' | 'focal_bce' | 'fmsl'
    class_weights: Optional[List[float]] = None
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0


@dataclass
class OptimizerConfig:
    name: str = "adam"              # 'adam' | 'adamw' | 'sgd'
    lr: float = 1e-4
    weight_decay: float = 1e-4
    grad_clip_norm: float = 1.0
    momentum: float = 0.9           # sgd only
    # differential LR for pretrained front-end params (reference maze3.py:283-324,
    # maze6.py:666-678 put wav2vec2 params in a lower-LR group)
    backbone_lr_scale: float = 0.1
    scheduler: str = "constant"     # 'constant' | 'cosine' | 'step' | 'warmup_cosine' | 'plateau'
    min_lr: float = 0.0             # cosine eta_min (maze6.py:590 --min_lr 1e-7)
    warmup_steps: int = 0
    step_size: int = 10
    step_gamma: float = 0.5
    plateau_patience: int = 2
    plateau_factor: float = 0.5
    plateau_mode: str = "min"       # maze6_fmsl plateaus on valid_accuracy -> 'max'


@dataclass
class TrainConfig:
    """Mirrors the reference 'training' block (standardized_maze_config.py:29-36)."""

    batch_size: int = 12
    num_epochs: int = 5
    seed: int = 1234
    eval_batch_size: int = 128
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    early_stop_patience: int = 0    # 0 disables (maze3.py:391-425 EarlyStopper)
    early_stop_min_delta: float = 0.0
    early_stop_metric: str = "dev_acc"
    early_stop_mode: str = "max"
    checkpoint_dir: str = "checkpoints"
    keep_best_k: int = 1
    log_every_steps: int = 10
    remat: bool = False             # jax.checkpoint the trunk (maze4_fmsl grad ckpt analog)


@dataclass
class DataConfig:
    sample_rate: int = 16000
    cut: int = 64600                # 4 s @ 16 kHz (reference pad(), maze2.py:236)
    pad_mode: str = "tile"          # 'tile' (maze2.py:236-242) | 'zero' (maze3.py:558-569)
    database_path: str = ""
    protocols_path: str = ""
    track: str = "LA"
    label_polarity: str = "bonafide1"   # 'bonafide1' (canonical) | 'spoof1' (maze3 compat)
    num_workers: int = 2
    prefetch: int = 4
    use_native_io: bool = True      # C++ decoder/loader when the shared lib is built
    # waveform augmentation (maze3.py:577-670, config-gated, default off); banks are
    # supplied at Trainer construction (noise clips / RIRs as arrays)
    augment_enabled: bool = False
    augment_noise_prob: float = 0.5
    augment_reverb_prob: float = 0.3
    augment_snr_db_min: float = 5.0
    augment_snr_db_max: float = 20.0


@dataclass
class MeshConfig:
    """Device-mesh layout. Data-parallel by default; model axis reserved for
    tensor-parallel Wav2Vec2-large sharding (SURVEY.md section 2.9)."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1         # -1: all devices on the data axis
    model_parallel: int = 1


@dataclass
class FrontendConfig:
    """On-device DSP front-end selection (reference delegates to librosa/torchaudio;
    here it is jnp/Pallas — SURVEY.md section 2.8)."""

    name: str = "raw"               # 'raw' | 'sinc' | 'lfcc' | 'logmel' | 'wav2vec2'
    n_fft: int = 512
    hop_length: int = 160
    win_length: int = 400
    n_mels: int = 80
    n_lfcc: int = 60
    n_filter: int = 70              # linear filters feeding the LFCC DCT
    fmin: float = 0.0
    fmax: Optional[float] = None
    log_eps: float = 1e-6
    cmvn: bool = False
    # DFT matmul precision tier (ops/stft.py): 'highest' exact-f32, 'high'
    # (default) 3-pass bf16 at ~2e-4 relative — inside every golden-test
    # tolerance and ~1.4x faster on v5e, 'default' trunk-grade bf16.
    dsp_precision: str = "high"
    # Fuse the |STFT|^2 square into the filterbank GEMM operand (ops/lfcc.py):
    # the (B, frames, bins) power spectrum never round-trips HBM. Same math to
    # f32 summation order.
    fused_power: bool = False


@dataclass
class ModelConfig:
    name: str = "maze5"             # registry key
    architecture: ArchitectureConfig = field(default_factory=ArchitectureConfig)
    wav2vec2: Wav2Vec2Config = field(default_factory=Wav2Vec2Config)
    fmsl: Optional[FMSLConfig] = None
    spec_augment: SpecAugmentConfig = field(default_factory=SpecAugmentConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    dtype: str = "bfloat16"         # compute dtype for the trunk; params stay f32
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ExperimentConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def to_reference_dict(self) -> Dict[str, Any]:
        """The reference's flat standardized dict, key for key
        (fmsl_standardized_config.py:36-79), for diffing and verification."""
        a, t, o = self.model.architecture, self.train, self.train.optimizer
        d: Dict[str, Any] = {
            "filts": copy.deepcopy(a.filts),   # never hand out live config state
            "nb_fc_node": a.nb_fc_node,
            "nb_classes": a.nb_classes,
            "sample_rate": a.sample_rate,
            "first_conv": a.first_conv,
            "dropout_rate": a.dropout_rate,
            "fc_dropout": a.fc_dropout,
            "wav2vec2_model_name": self.model.wav2vec2.model_name,
            "wav2vec2_output_dim": self.model.wav2vec2.output_dim,
            "wav2vec2_freeze": self.model.wav2vec2.freeze,
            "batch_size": t.batch_size,
            "lr": o.lr,
            "weight_decay": o.weight_decay,
            "grad_clip_norm": o.grad_clip_norm,
            "num_epochs": t.num_epochs,
            "seed": t.seed,
            "use_spec_augment_raw": self.model.spec_augment.enabled,
            "spec_aug_freq_mask_param_raw": self.model.spec_augment.freq_mask_param,
            "spec_aug_time_mask_param_raw": self.model.spec_augment.time_mask_param,
            "spec_aug_n_freq_masks_raw": self.model.spec_augment.n_freq_masks,
            "spec_aug_n_time_masks_raw": self.model.spec_augment.n_time_masks,
        }
        if self.model.fmsl is not None:
            f = self.model.fmsl
            d.update({"fmsl_type": f.fmsl_type, "fmsl_n_prototypes": f.n_prototypes,
                      "fmsl_s": f.s, "fmsl_m": f.m, "fmsl_enable_lsa": f.enable_lsa,
                      "fmsl_lsa_strength": f.lsa_strength})
        return d


# the dataclass of each nested field, keyed by (owner class, field name)
_NESTED = {
    (ExperimentConfig, "model"): ModelConfig,
    (ExperimentConfig, "data"): DataConfig,
    (ExperimentConfig, "train"): TrainConfig,
    (ExperimentConfig, "mesh"): MeshConfig,
    (ModelConfig, "architecture"): ArchitectureConfig,
    (ModelConfig, "wav2vec2"): Wav2Vec2Config,
    (ModelConfig, "fmsl"): FMSLConfig,
    (ModelConfig, "spec_augment"): SpecAugmentConfig,
    (ModelConfig, "frontend"): FrontendConfig,
    (TrainConfig, "optimizer"): OptimizerConfig,
    (TrainConfig, "loss"): LossConfig,
}


def _from_dict(cls, d: Optional[Dict[str, Any]]):
    """``cls`` from a plain dict, nested fields through ``_NESTED``. A key the
    class does not know is logged, named by class, and dropped (a stale or
    mistyped key falling back to its default is what the verifier exists to
    catch), as adfmsl's loader does (config/yaml_io.py:31-51)."""
    if d is None:
        return None
    unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        logging.getLogger(__name__).warning(
            "%s: ignoring unknown config key(s) %s", cls.__name__, sorted(unknown))
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        sub = _NESTED.get((cls, f.name))
        kwargs[f.name] = _from_dict(sub, d[f.name]) if sub is not None else d[f.name]
    return cls(**kwargs)


def experiment_from_dict(d: Dict[str, Any]) -> "ExperimentConfig":
    """Inverse of ``dataclasses.asdict(ExperimentConfig)`` (checkpoints store
    the config as a plain dict, models/port.py:save_checkpoint)."""
    return _from_dict(ExperimentConfig, d)
