"""Qwen2-7B — dense GQA decoder with QKV bias [arXiv:2407.10671]; the
published widths of ``repro.configs.qwen2_7b``: 28 layers, d_model 3584,
28 query heads and 4 kv heads of 128, SwiGLU d_ff 18944, vocab 152064,
rope θ 1e6."""
from repro_torch.configs.base import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-7b",
        family="dense",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1e6,
        citation="arXiv:2407.10671",
    )
