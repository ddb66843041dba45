"""The model zoo (port of ``repro.models``): the SSM family (Mamba2),
the dense transformer family (llama, qwen2, granite, yi), the MoE
transformers (qwen3-moe, deepseek-v2-lite with Multi-head Latent
Attention), the hybrid (zamba2), the VLM backbone (qwen2-vl, M-RoPE and
a vision prefix) and the audio decoder (musicgen, codebooks and
cross-attention)."""
from repro_torch.models.model import Model, get_model  # noqa: F401
