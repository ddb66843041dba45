"""Llama-3.2-3B — small llama3 dense GQA [hf:meta-llama/Llama-3.2-1B];
the published widths of ``repro.configs.llama3_2_3b``: 28 layers,
d_model 3072, 24 query heads and 8 kv heads of 128, SwiGLU d_ff 8192,
vocab 128256, tied embeddings, rope θ 5e5."""
from repro_torch.configs.base import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="llama3.2-3b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=128256,
        rope_theta=5e5,
        tie_embeddings=True,
        citation="hf:meta-llama/Llama-3.2-1B",
    )
