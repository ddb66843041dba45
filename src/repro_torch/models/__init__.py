"""The model zoo (port of ``repro.models``): the SSM family (Mamba2),
the dense transformer family (llama, qwen2, granite, yi), the MoE
transformers (qwen3-moe, deepseek-v2-lite with Multi-head Latent
Attention) and the hybrid (zamba2)."""
from repro_torch.models.model import Model, get_model  # noqa: F401
