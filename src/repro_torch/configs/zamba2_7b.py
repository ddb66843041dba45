"""Zamba2-7B — hybrid Mamba2 + shared attention blocks
[arXiv:2411.15242]; the published widths of ``repro.configs.zamba2_7b``:
81 layers realised as 16 super-blocks of (4 Mamba2 + 1 SHARED
attention/MLP block) + 1 closing Mamba2 layer, d_model 3584, 32 heads of
112 in the shared block (MHA), SwiGLU d_ff 14336, vocab 32000, rope θ
1e4; the shared block's weights take a rank-128 LoRA delta at each of
its 16 call sites; Mamba2 d_state 64, 112 heads of 64, one group, chunk
256."""
from repro_torch.configs.base import ArchConfig, HybridConfig, SSMConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,           # MHA in the shared block
        head_dim=112,            # 3584 / 32
        d_ff=14336,
        vocab_size=32000,
        rope_theta=1e4,
        ssm=SSMConfig(d_state=64, expand=2, head_dim=64, n_groups=1,
                      chunk=256, d_conv=4),
        hybrid=HybridConfig(n_super_blocks=16, mamba_per_block=4,
                            tail_mamba=1, lora_rank=128),
        citation="arXiv:2411.15242",
    )
