"""MusicGen-medium — a decoder-only transformer over EnCodec tokens
[arXiv:2306.05284]; the published widths of
``repro.configs.musicgen_medium``: 48 layers, d_model 1536, 24 heads of
64 (MHA), a GELU MLP of d_ff 6144, 4 codebooks of 2048 entries whose
embeddings are summed and which have 4 parallel heads, sinusoidal
positions (no rope), and cross-attention in every layer to a
conditioning sequence of ``cond_len`` = 64. The EnCodec codec and the
T5 text encoder are stubbed, as in the reference: a batch carries the
conditioning embeddings."""
from repro_torch.configs.base import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="musicgen-medium",
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,           # MHA (kv = heads)
        head_dim=64,
        d_ff=6144,
        vocab_size=2048,
        rope_mode="none",        # musicgen uses sinusoidal embeddings
        cross_attention=True,
        cond_len=64,             # stubbed T5 conditioning length
        n_codebooks=4,
        citation="arXiv:2306.05284",
    )
