"""Utilities of the port: the name -> factory registry, the scalar metrics
log, the profiler hooks and step timer, and the host-side seeding."""
from adfmsl_torch.utils.metrics_log import MetricsLogger, read_metrics
from adfmsl_torch.utils.profiling import StepTimer, annotate, trace
from adfmsl_torch.utils.registry import Registry
from adfmsl_torch.utils.rng import set_global_seed

__all__ = ["Registry", "MetricsLogger", "read_metrics", "StepTimer", "annotate", "trace",
           "set_global_seed"]
