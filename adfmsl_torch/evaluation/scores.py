"""Score-file IO (the port's copy of ``adfmsl/evaluation/scores.py``).

THE inter-layer contract of the reference (SURVEY.md section 1): one line per
utterance, ``"{utt_id} {score}\\n"``, score = the class-1 (bonafide) log-prob/logit
(written maze2.py:333-343, parsed score_file_processor.py:138-154)."""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple


def write_score_file(path: str, utt_ids: Iterable[str], scores: Iterable[float]) -> int:
    import os

    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    n = 0
    with open(path, "w") as fh:
        for u, s in zip(utt_ids, scores):
            fh.write(f"{u} {s}\n")
            n += 1
    return n


def read_score_file(path: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) < 2:
                continue
            try:
                out[parts[0]] = float(parts[1])
            except ValueError:
                continue   # tolerate headers/garbage like the reference parser
    return out



def join_scores_with_labels(scores: Dict[str, float], labels: Dict[str, int]
                            ) -> Tuple[List[float], List[int], List[str]]:
    """Inner-join on utt_id; returns (scores, labels, missing_utts)."""
    s, y, missing = [], [], []
    for u, v in scores.items():
        if u in labels:
            s.append(v)
            y.append(labels[u])
        else:
            missing.append(u)
    return s, y, missing
