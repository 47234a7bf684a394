from adfmsl_torch.heads.fmsl import FMSLHead, am_softmax_logits, l2_normalize

__all__ = ["FMSLHead", "am_softmax_logits", "l2_normalize"]
