"""DeepSeek-V2-Lite (16B) — MoE with Multi-head Latent Attention
[arXiv:2405.04434]; the published widths of
``repro.configs.deepseek_v2_lite_16b``: 27 layers, d_model 2048, 16
heads, MLA with a rank-512 latent, nope / rope / v dims 128 / 64 / 128
and uncompressed queries; 2 shared + 64 routed SwiGLU experts of width
1408, top-6 (the reference's note: V2-Lite's 64, not the full V2's 160);
layer 0 is dense with d_ff 10944 per the model card; vocab 102400, rope
θ 1e4. 15.71 B parameters: 62.8 GB in fp32."""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,            # v head dim; MLA dims below
        d_ff=1408,               # routed-expert FF width
        vocab_size=102400,
        rope_theta=1e4,
        moe=MoEConfig(n_experts=64, top_k=6, expert_ff=1408, n_shared=2),
        mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                      v_dim=128, q_lora_rank=None),
        first_k_dense=1,
        dense_ff=10944,
        citation="arXiv:2405.04434",
    )
