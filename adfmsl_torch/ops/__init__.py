"""The port's operators: the DSP front ends, the norms, the kernels' wrappers
(each imported by name, ``adfmsl_torch.ops.resblock_fused`` and so on, so
that no kernel library is built at import) and ``BNAct`` / ``norm_act``."""
from adfmsl_torch.ops.bn_act import BNAct, norm_act

__all__ = ["BNAct", "norm_act"]
