"""Yi-34B — dense llama-arch GQA decoder [arXiv:2403.04652]; the
published widths of ``repro.configs.yi_34b``: 60 layers, d_model 7168,
56 query heads and 8 kv heads of 128, SwiGLU d_ff 20480, vocab 64000,
rope θ 5e6. Its fp32 weights (~137 GB) exceed one 80 GB card."""
from repro_torch.configs.base import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="yi-34b",
        family="dense",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab_size=64000,
        rope_theta=5e6,
        citation="arXiv:2403.04652",
    )
