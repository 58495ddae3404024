from repro_torch.kernels.mamba_scan import kernel, ops, ref
from repro_torch.kernels.mamba_scan.kernel import mamba_scan_fwd

__all__ = ["kernel", "ops", "ref", "mamba_scan_fwd"]
