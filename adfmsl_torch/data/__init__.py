from adfmsl_torch.data.audio import load_audio, read_wav, resample, write_wav
from adfmsl_torch.data.augment import (
    AugmentDraws,
    add_noise_snr,
    apply_augment,
    augment_waveform,
    draw_augment,
    mix_at_snr,
    rir_from_noise,
    rir_reverb,
    synthetic_rir,
)
from adfmsl_torch.data.pack import PackedDataset, create_pack
from adfmsl_torch.data.pad import pad, tile_pad, tile_pad_device, zero_pad, zero_pad_device
from adfmsl_torch.data.pipeline import (
    AsvspoofDataset,
    Batch,
    DataLoader,
    FuzzyAudioResolver,
    resolve_audio_path,
)
from adfmsl_torch.data.preprocess import (
    ManifestEntry,
    ValidationReport,
    create_dataset_manifest,
    explore_data_structure,
    preprocess_audio,
    trim_silence,
    validate_dataset,
)
from adfmsl_torch.data.protocol import Protocol, ProtocolEntry, gen_spoof_list, parse_protocol
from adfmsl_torch.data.synthetic import SyntheticSpec, generate_fixture, generate_wild_fixture

__all__ = [
    "load_audio", "read_wav", "resample", "write_wav",
    "pad", "tile_pad", "tile_pad_device", "zero_pad", "zero_pad_device",
    "AsvspoofDataset", "Batch", "DataLoader", "FuzzyAudioResolver", "resolve_audio_path",
    "Protocol", "ProtocolEntry", "gen_spoof_list", "parse_protocol",
    "SyntheticSpec", "generate_fixture", "generate_wild_fixture",
    "PackedDataset", "create_pack",
    "add_noise_snr", "augment_waveform", "rir_reverb", "synthetic_rir",
    "AugmentDraws", "apply_augment", "draw_augment", "mix_at_snr", "rir_from_noise",
    "create_dataset_manifest", "explore_data_structure", "preprocess_audio", "trim_silence",
    "validate_dataset", "ManifestEntry", "ValidationReport",
]
