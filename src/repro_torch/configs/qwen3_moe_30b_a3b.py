"""Qwen3-30B-A3B — MoE, 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]; the
published widths of ``repro.configs.qwen3_moe_30b_a3b``: 48 layers,
d_model 2048, 32 query heads and 4 kv heads of 128 (the q projection
2048 → 4096 is explicit in the model card), every layer's feed-forward
128 routed SwiGLU experts of width 768 with top-8 gates and no shared
expert, vocab 151936, rope θ 1e6. 30.53 B parameters: 122 GB in fp32,
61 GB in bf16."""
from repro_torch.configs.base import ArchConfig, MoEConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=768,                # routed-expert FF width
        vocab_size=151936,
        rope_theta=1e6,
        moe=MoEConfig(n_experts=128, top_k=8, expert_ff=768, n_shared=0),
        citation="hf:Qwen/Qwen3-30B-A3B",
    )
