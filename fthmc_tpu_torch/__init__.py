"""fthmc_tpu_torch: the PyTorch/CUDA port of fthmc_tpu (field-transformation
HMC for 2D U(1) lattice gauge theory) to an NVIDIA H100.

Plain tensor code is PyTorch; the hot path of FT-HMC runs on hand-written
CUDA kernels (``ops/``, sources in ``csrc/``). Entry points run on the card
unless the caller passes ``device="cpu"``. The package imports nothing of
JAX or of ``fthmc_tpu``.
"""

__version__ = "0.1.0"

from fthmc_tpu_torch.config import FlowSpec, HMCConfig, LeapfrogConfig

__all__ = ["FlowSpec", "HMCConfig", "LeapfrogConfig", "__version__"]
