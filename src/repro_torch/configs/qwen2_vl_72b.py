"""Qwen2-VL-72B — the VLM language backbone with M-RoPE
[arXiv:2409.12191]; the published widths of
``repro.configs.qwen2_vl_72b``: 80 layers, d_model 8192, 64 query heads
and 8 kv heads of 128, SwiGLU d_ff 29568, vocab 152064, QKV bias, rope
θ 1e6 split by M-RoPE into (t, h, w) sections (16, 24, 24) of the half
head dim. The ViT vision encoder and its projector are stubbed, as in
the reference: a batch carries ``vision_prefix`` = 256 pre-projected
patch embeddings, concatenated ahead of the text tokens."""
from repro_torch.configs.base import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-72b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        qkv_bias=True,
        rope_mode="mrope",
        mrope_sections=(16, 24, 24),
        rope_theta=1e6,
        vision_prefix=256,       # stubbed patch-embedding prefix length
        citation="arXiv:2409.12191",
    )
