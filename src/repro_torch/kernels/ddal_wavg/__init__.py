"""The eq. 4 share step: a CUDA kernel (``csrc/ddal_wavg.cu``), its
plain PyTorch version (``ref``) and the dispatch (``ops``)."""
