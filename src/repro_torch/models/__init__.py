"""The model zoo (port of ``repro.models``): the SSM family (Mamba2) and
the dense transformer family (llama)."""
from repro_torch.models.model import Model, get_model  # noqa: F401
