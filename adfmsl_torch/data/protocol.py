"""ASVspoof CM protocol parsing (the port's copy of ``adfmsl/data/protocol.py``).

File contract (reference ``genSpoof_list``, maze2.py:213-234): five space-separated
columns ``speaker utt_id - attack_type label``; utt_id in column 2, label
('bonafide'/'spoof') last. Eval protocols may be bare utt_id lists. Canonical label
polarity here is bonafide=1 / spoof=0 (maze2.py:222); ``polarity='spoof1'`` reproduces
maze3's flipped mapping (maze3.py:549) for score-compat experiments.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass(frozen=True)
class ProtocolEntry:
    speaker: str
    utt_id: str
    attack_type: str     # '-' for bonafide
    label: Optional[int]  # 1=bonafide, 0=spoof (canonical); None for bare eval lists


@dataclass
class Protocol:
    entries: List[ProtocolEntry]

    @property
    def utt_ids(self) -> List[str]:
        return [e.utt_id for e in self.entries]

    @property
    def labels(self) -> Dict[str, int]:
        return {e.utt_id: e.label for e in self.entries if e.label is not None}

    @property
    def attack_types(self) -> Dict[str, str]:
        return {e.utt_id: e.attack_type for e in self.entries}

    def __len__(self) -> int:
        return len(self.entries)


def parse_protocol(path: str, polarity: str = "bonafide1") -> Protocol:
    """Parse a full 5-column CM protocol file."""
    if polarity not in ("bonafide1", "spoof1"):
        raise ValueError(f"unknown polarity {polarity!r}")
    bona = 1 if polarity == "bonafide1" else 0
    entries = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            # whitespace split, not a single literal space: double-spaced or
            # tab-separated protocol exports would silently shift columns
            # (wrong labels) or parse every row as a bare unlabeled id
            parts = line.split()
            if len(parts) == 1:
                entries.append(ProtocolEntry("", parts[0], "-", None))
                continue
            if len(parts) < 5:
                raise ValueError(f"malformed protocol line: {line!r}")
            speaker, utt_id, _, attack, label_s = parts[:5]
            label = bona if label_s == "bonafide" else 1 - bona
            entries.append(ProtocolEntry(speaker, utt_id, attack, label))
    return Protocol(entries)


def gen_spoof_list(
    dir_meta: str, is_train: bool = False, is_eval: bool = False,
    polarity: str = "bonafide1",
):
    """Reference-compatible wrapper (maze2.py:213-234): returns ``(d_meta, file_list)``
    for train/dev, ``file_list`` for bare eval lists."""
    if is_eval:
        with open(dir_meta) as fh:
            return [ln.strip() for ln in fh if ln.strip()]
    p = parse_protocol(dir_meta, polarity=polarity)
    return p.labels, p.utt_ids
