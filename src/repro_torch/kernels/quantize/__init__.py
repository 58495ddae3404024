from repro_torch.kernels.quantize import kernel, ops, ref
from repro_torch.kernels.quantize.kernel import quantize_ef_fwd

__all__ = ["kernel", "ops", "ref", "quantize_ef_fwd"]
