"""The gradient-sketch projection: a CUDA kernel
(``csrc/grad_sketch.cu``), its plain PyTorch version (``ref``) and the
dispatch (``ops``)."""
