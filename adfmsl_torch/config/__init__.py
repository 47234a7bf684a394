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
    experiment_from_dict,
)
from adfmsl_torch.config.standardized import (
    ALL_MODELS,
    BASELINE_MODELS,
    EXTRA_MODELS,
    FMSL_DRIFT,
    FMSL_MODELS,
    FMSL_MODES,
    OPT_DRIFT,
    apply_overrides,
    get_standardized_config,
    make_experiment,
)
from adfmsl_torch.config.verify import verify_all
from adfmsl_torch.config.yaml_io import load_reference_yaml, load_yaml, save_yaml

__all__ = [
    "ArchitectureConfig", "DataConfig", "ExperimentConfig", "FMSLConfig",
    "FrontendConfig", "LossConfig", "MeshConfig", "ModelConfig", "OptimizerConfig",
    "SpecAugmentConfig", "TrainConfig", "Wav2Vec2Config", "experiment_from_dict",
    "ALL_MODELS", "BASELINE_MODELS", "EXTRA_MODELS", "FMSL_DRIFT", "FMSL_MODELS",
    "FMSL_MODES", "OPT_DRIFT", "apply_overrides", "get_standardized_config",
    "make_experiment", "load_yaml", "load_reference_yaml", "save_yaml", "verify_all",
]
