"""The model zoo (port of ``repro.models``): the SSM family (Mamba2),
the dense transformer family (llama, qwen2, granite, yi) and the hybrid
(zamba2)."""
from repro_torch.models.model import Model, get_model  # noqa: F401
