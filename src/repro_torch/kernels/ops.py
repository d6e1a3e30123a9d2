"""Public kernel entry points the models call (the counterpart of the JAX
package's `kernels/ops.py`)."""
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rglru_scan import rglru_scan

__all__ = ["flash_attention", "rglru_scan"]
