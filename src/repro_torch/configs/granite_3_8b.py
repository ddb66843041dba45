"""Granite-3.0-8B — dense GQA decoder [hf:ibm-granite/granite-3.0-2b-base];
the published widths of ``repro.configs.granite_3_8b``: 40 layers,
d_model 4096, 32 query heads and 8 kv heads of 128, SwiGLU d_ff 12800,
vocab 49155, tied embeddings, rope θ 1e4."""
from repro_torch.configs.base import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="granite-3-8b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=12800,
        vocab_size=49155,
        rope_theta=1e4,
        tie_embeddings=True,
        citation="hf:ibm-granite/granite-3.0-2b-base",
    )
