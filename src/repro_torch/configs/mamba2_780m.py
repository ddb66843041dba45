"""Mamba2-780M — attention-free SSM with SSD (state-space duality)
[arXiv:2405.21060]; the published widths of
``repro.configs.mamba2_780m``. d_inner = expand · d_model = 3072,
head_dim 64 → 48 SSD heads, d_state 128, chunk 256, conv 4."""
from repro_torch.configs.base import ArchConfig, SSMConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-780m",
        family="ssm",
        n_layers=48,
        d_model=1536,
        n_heads=0,               # attention-free
        n_kv_heads=0,
        head_dim=0,
        d_ff=0,                  # no MLP: Mamba2 blocks only
        vocab_size=50280,
        rope_mode="none",
        ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1,
                      chunk=256, d_conv=4),
        citation="arXiv:2405.21060",
    )
