"""Configuration consistency verifier (port of ``adfmsl/config/verify.py``).

The reference checks its "standardization" by scraping hyperparameters back
out of 16 source files (``verify_maze_configurations.py:11-178``). With one
typed tree the check is structural: each registry model's reference dict
against the canonical contract, key by key, the baseline / FMSL pairs
against each other, and the per-model drift reported beside them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

from adfmsl_torch.config.standardized import ALL_MODELS, BASELINE_MODELS, make_experiment

# keys that must match across every model for a fair comparison
# (standardized_maze_config.py architecture + training blocks)
CANONICAL_KEYS = [
    "filts", "nb_fc_node", "nb_classes", "sample_rate", "first_conv", "dropout_rate",
    "fc_dropout", "batch_size", "lr", "weight_decay", "grad_clip_norm", "num_epochs",
    "seed",
]
FMSL_KEYS = ["fmsl_type", "fmsl_n_prototypes", "fmsl_s", "fmsl_m", "fmsl_enable_lsa"]


@dataclass
class VerificationReport:
    per_model: Dict[str, Dict[str, Tuple[Any, Any, bool]]] = field(default_factory=dict)
    pair_consistent: Dict[str, bool] = field(default_factory=dict)
    fmsl_drift: Dict[str, Dict[str, Tuple[Any, Any]]] = field(default_factory=dict)
    opt_drift: Dict[str, Dict[str, Tuple[Any, Any]]] = field(default_factory=dict)

    @property
    def all_canonical_ok(self) -> bool:
        return all(ok for m in self.per_model.values() for (_, _, ok) in m.values())

    def summary(self) -> str:
        lines = ["CONFIG VERIFICATION", "=" * 50]
        for model, keys in self.per_model.items():
            bad = [k for k, (_, _, ok) in keys.items() if not ok]
            lines.append(f"{model:16s} {'OK' if not bad else 'MISMATCH: ' + ', '.join(bad)}")
        lines.append("-" * 50)
        for pair, ok in self.pair_consistent.items():
            lines.append(f"pair {pair:16s} {'consistent' if ok else 'INCONSISTENT'}")
        for title, drift in (("FMSL drift vs canonical (reference-faithful, drift=True):",
                              self.fmsl_drift),
                             ("Optimizer drift vs standardized claim (drift=True):",
                              self.opt_drift)):
            if drift:
                lines.append("-" * 50)
                lines.append(title)
                for model, keys in drift.items():
                    kv = ", ".join(f"{k}: {c} -> {v}" for k, (c, v) in keys.items())
                    lines.append(f"  {model}: {kv}")
        return "\n".join(lines)


def verify_all(drift: bool = True) -> VerificationReport:
    report = VerificationReport()
    canonical = make_experiment("maze5").to_reference_dict()
    canonical_fmsl = make_experiment("maze3_fmsl", drift=False).to_reference_dict()

    for name in ALL_MODELS:
        # the canonical check is against the standardization claim
        # (drift=False); drift=True's deltas are reported apart, not flagged:
        # the reference files disagree with their own standardized config
        d = make_experiment(name, drift=False).to_reference_dict()
        report.per_model[name] = {
            k: (canonical[k], d.get(k), d.get(k) == canonical[k]) for k in CANONICAL_KEYS}
        if drift:
            dd = make_experiment(name, drift=True).to_reference_dict()
            drifted = {k: (d.get(k), dd.get(k))
                       for k in ("lr", "weight_decay", "grad_clip_norm")
                       if dd.get(k) != d.get(k)}
            if drifted:
                report.opt_drift[name] = drifted
        if name.endswith("_fmsl"):
            df = make_experiment(name, drift=drift).to_reference_dict()
            drifted = {k: (canonical_fmsl.get(k), df.get(k)) for k in FMSL_KEYS
                       if df.get(k) != canonical_fmsl.get(k)}
            if drifted:
                report.fmsl_drift[name] = drifted

    for base in BASELINE_MODELS:
        b = make_experiment(base, drift=False).to_reference_dict()
        f = make_experiment(f"{base}_fmsl", drift=False).to_reference_dict()
        report.pair_consistent[f"{base}/+fmsl"] = all(b[k] == f[k] for k in CANONICAL_KEYS)
    return report
