"""Causal GQA flash attention: a CUDA kernel
(``csrc/flash_attention.cu``), its plain PyTorch version (``ref``) and
the dispatch (``ops``)."""
