from repro_torch.kernels.wkv6 import kernel, ops, ref
from repro_torch.kernels.wkv6.kernel import wkv6_fwd

__all__ = ["kernel", "ops", "ref", "wkv6_fwd"]
