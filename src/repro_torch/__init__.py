"""repro_torch — the PyTorch/CUDA port of ``repro`` (GARL + DDAL).

It mirrors the reference module for module (``repro_torch.core.ddal``
↔ ``repro.core.ddal``) and imports neither JAX nor the reference
package. Entry points run on the CUDA card unless the caller passes
``device="cpu"``; the eq. 4 share step runs in a hand-written CUDA
kernel (``repro_torch.kernels.ddal_wavg``).
"""

__version__ = "0.1.0"
