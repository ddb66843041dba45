"""The Mamba2 SSD intra-chunk dual form: a CUDA kernel
(``csrc/ssd_scan.cu``), its plain PyTorch version (``ref``) and the
dispatch (``ops``)."""
