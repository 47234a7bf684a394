from adfmsl_torch.data.audio import load_audio, read_wav, resample, write_wav
from adfmsl_torch.data.pad import pad, tile_pad, zero_pad
from adfmsl_torch.data.pipeline import (
    AsvspoofDataset,
    Batch,
    DataLoader,
    resolve_audio_path,
)
from adfmsl_torch.data.protocol import Protocol, ProtocolEntry, parse_protocol
from adfmsl_torch.data.synthetic import SyntheticSpec, generate_fixture, generate_wild_fixture

__all__ = [
    "load_audio", "read_wav", "resample", "write_wav",
    "pad", "tile_pad", "zero_pad",
    "AsvspoofDataset", "Batch", "DataLoader", "resolve_audio_path",
    "Protocol", "ProtocolEntry", "parse_protocol",
    "SyntheticSpec", "generate_fixture", "generate_wild_fixture",
]
