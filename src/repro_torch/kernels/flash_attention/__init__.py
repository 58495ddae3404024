from repro_torch.kernels.flash_attention import kernel, ops, ref
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd

__all__ = ["kernel", "ops", "ref", "flash_attention_fwd"]
