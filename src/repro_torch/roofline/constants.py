"""NVIDIA H100 SXM constants (per card) — the dry run's target.

The port of ``repro.roofline.constants`` (the TPU v5e's): the same
names, the values from NVIDIA's H100 SXM data sheet (dense rates, no
sparsity, at the full 700 W power limit), plus ``PEAK_FLOPS_FP32``,
which the reference lacks and the kernels' bounds need.

``ICI_BW_PER_LINK`` keeps the reference's one-term collective model:
every collective byte of a rank leaves over ONE link at this rate.
It is NVLink 4's rate per link and direction; a card has 18 links
(450 GB/s each way in all). Links between nodes
(InfiniBand), which a 256-card mesh crosses, are not modelled.
"""

PEAK_FLOPS_BF16 = 989e12        # FLOP/s per card, bf16 tensor cores
PEAK_FLOPS_FP32 = 67e12         # FLOP/s per card, fp32 outside them
HBM_BW = 3.35e12                # bytes/s per card
ICI_BW_PER_LINK = 25e9          # bytes/s per NVLink 4 link, each way
VMEM_BYTES = 228 * 2 ** 10      # shared memory of one SM (228 KiB)
