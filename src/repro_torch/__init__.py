"""repro_torch — the PyTorch/CUDA port of ``repro`` (GARL + DDAL).

It mirrors the reference module for module (``repro_torch.core.ddal``
↔ ``repro.core.ddal``) and imports neither JAX nor the reference
package. Entry points run on the CUDA card unless the caller passes
``device="cpu"``. Ported so far: the buffer trainer for DDA3C and
DDADQN groups (adaptive gossip, learned and observation-statistics
relevance, elastic membership, the faulty transport and checkpoints
included), whose eq. 4 share step and gradient sketch run in
hand-written CUDA kernels
(``repro_torch.kernels.ddal_wavg``, ``repro_torch.kernels.grad_sketch``),
and Mamba2 serving (``repro_torch.serving``, ``repro_torch.launch.serve``),
whose prefill runs the SSD intra-chunk dual form in a hand-written CUDA
kernel (``repro_torch.kernels.ssd_scan``).
"""

__version__ = "0.1.0"
