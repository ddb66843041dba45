"""Configuration dataclasses — the port's copies of
``repro.configs.base.GroupSpec`` (DDAL group configuration, paper §5),
``ArchConfig``, ``MoEConfig``, ``MLAConfig``, ``SSMConfig`` and
``HybridConfig``.

The fields, defaults and validation are the reference's, so a spec
that the reference rejects is rejected here with the same
``ValueError``. On top of that, a field whose behaviour the port does
not implement yet is refused at construction with a
:class:`NotPortedError` naming the field, so an unported option is
never silently ignored: only a ``knowledge_dtype`` other than fp32 and
bf16 remains. Both trainers' settings construct, the pod dispatch
(``pods > 0``, the ``pod`` combiner) included; which combiner, delay
and estimator a trainer
accepts is checked where the reference checks it, in
``repro_torch.core.exchange.build_exchange``. ``ArchConfig`` and
its nested configs (the model zoo) are copied for every family of the
reference: SSM, dense, MoE, hybrid, VLM and audio.
``ShapeConfig`` and ``INPUT_SHAPES`` are the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

TOPOLOGIES = ("full", "ring", "torus2d", "star", "random_k",
              "hierarchical")
RELEVANCE_MODES = ("uniform", "grad_cos")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Every strategy key the reference's registries know. A key outside
# these is a configuration error (ValueError); a key inside them that
# the port's registries lack is a NotPortedError.
REFERENCE_STRATEGIES = {
    "schedule": ("dynamic", "relevance_topk", "static"),
    "estimator": ("grad_cos", "grad_cos+sketch", "obs_stats", "uniform"),
    "delay": ("hops", "none", "uniform"),
    "combiner": ("flat", "pod", "store"),
    "transport": ("faulty", "none"),
}


class NotPortedError(NotImplementedError):
    """A ``GroupSpec`` field asks for reference behaviour that the
    PyTorch port does not implement yet."""


def validate_choice(family: str, name: str) -> None:
    """``"auto"`` or a strategy key the reference registers; anything
    else raises naming the valid choices."""
    if name == "auto":
        return
    choices = REFERENCE_STRATEGIES[family]
    if name not in choices:
        raise ValueError(
            f"unknown {family} strategy {name!r}; expected 'auto' or "
            f"one of {choices}")


@dataclass(frozen=True)
class GroupSpec:
    """DDAL group-agent training configuration (paper §5).

    Invalid combinations raise ``ValueError`` at construction, exactly
    as the reference does; valid fields that select behaviour the port
    lacks raise :class:`NotPortedError`.
    """
    n_agents: int = 1
    threshold: int = 1_000       # warm-up epochs of independent learning
    minibatch: int = 100         # share/update cadence (paper's name)
    m_pieces: int = 8            # pieces retrieved from K_i ∪ K_-i
    knowledge_mode: str = "buffer"   # buffer | streaming (LLM-scale)
    knowledge_dtype: str = "float32"
    topology: str = "full"       # full | ring | torus2d | star |
                                 # random_k | hierarchical
    degree: int = 4              # k for random_k; pod size for hierarchical
    pods: int = 0
    pod_axis: str = "pod"
    topology_seed: int = 0       # seed for random_k gossip sampling
    resample_every: int = 0
    max_delay: int = 0           # async staleness simulation (epochs)
    t_weighting: str = "epochs"  # T_j source
    r_weighting: str = "uniform" # R_j source (paper §6 uses uniform)
    relevance_mode: str = "uniform"
    relevance_ema: float = 0.9
    relevance_sketch_dim: int = 0
    exchange_schedule: str = "auto"
    exchange_estimator: str = "auto"
    exchange_delay: str = "auto"
    exchange_combiner: str = "auto"
    explore_eps: float = 0.1
    elastic: bool = False
    knowledge_quant_block: int = 0
    transport_loss: float = 0.0
    transport_dup: float = 0.0
    transport_corrupt: float = 0.0
    transport_jitter: int = 0
    transport_retransmit: int = 0
    transport_seed: int = 0
    transport_horizon: int = 256
    transport_decay: float = 1.0
    max_staleness: Optional[int] = None
    exchange_transport: str = "auto"

    def __post_init__(self):
        self._validate_as_reference()
        self._reject_unported()

    def _validate_as_reference(self):
        if self.topology not in TOPOLOGIES:
            raise ValueError(
                f"unknown topology {self.topology!r}; expected one of "
                f"{TOPOLOGIES}")
        if self.relevance_mode not in RELEVANCE_MODES:
            raise ValueError(
                f"unknown relevance_mode {self.relevance_mode!r}; "
                f"expected one of {RELEVANCE_MODES}")
        if self.resample_every < 0:
            raise ValueError(
                f"resample_every must be >= 0, got {self.resample_every}")
        if self.resample_every > 0 and self.topology != "random_k":
            raise ValueError(
                f"resample_every > 0 needs topology='random_k', got "
                f"{self.topology!r}")
        validate_choice("schedule", self.exchange_schedule)
        validate_choice("estimator", self.exchange_estimator)
        validate_choice("delay", self.exchange_delay)
        validate_choice("combiner", self.exchange_combiner)
        if self.exchange_schedule == "relevance_topk":
            if self.topology != "random_k" or self.resample_every < 1:
                raise ValueError(
                    "exchange_schedule='relevance_topk' resamples a "
                    "gossip graph and needs topology='random_k' with "
                    "resample_every >= 1, got "
                    f"topology={self.topology!r}, "
                    f"resample_every={self.resample_every}")
        if self.exchange_schedule == "static" and self.resample_every:
            raise ValueError(
                "exchange_schedule='static' pins a fixed graph but "
                f"resample_every={self.resample_every} requests "
                "resampling — drop one of them")
        if not 0.0 <= self.explore_eps <= 1.0:
            raise ValueError(
                f"explore_eps must be in [0, 1], got {self.explore_eps}")
        if self.topology == "random_k":
            if not 1 <= self.degree < max(self.n_agents, 2):
                raise ValueError(
                    f"random_k degree must satisfy 1 <= degree < "
                    f"n_agents (self-loop included; use topology="
                    f"'full' for k = n), got degree={self.degree} "
                    f"with n_agents={self.n_agents}")
        if not 0.0 <= self.relevance_ema < 1.0:
            raise ValueError(
                f"relevance_ema must be in [0, 1), got "
                f"{self.relevance_ema}")
        if self.relevance_sketch_dim < 0:
            raise ValueError(
                f"relevance_sketch_dim must be >= 0 (0 = exact "
                f"pairwise cosines), got {self.relevance_sketch_dim}")
        if (self.exchange_estimator not in ("auto", "grad_cos+sketch")
                and self.relevance_sketch_dim > 0):
            raise ValueError(
                f"exchange_estimator={self.exchange_estimator!r} "
                "does not sketch and would silently ignore "
                f"relevance_sketch_dim={self.relevance_sketch_dim} — "
                "use 'grad_cos+sketch' (or drop the dim)")
        if (self.relevance_sketch_dim > 0
                and self.relevance_mode != "grad_cos"
                and self.exchange_estimator != "grad_cos+sketch"):
            raise ValueError(
                f"relevance_sketch_dim > 0 sketches the grad_cos "
                f"estimator and needs relevance_mode='grad_cos' (or "
                f"exchange_estimator='grad_cos+sketch'), got "
                f"{self.relevance_mode!r}")
        if self.pods < 0:
            raise ValueError(f"pods must be >= 0, got {self.pods}")
        if self.pods > 0:
            if self.topology != "hierarchical":
                raise ValueError(
                    f"pods > 0 maps hierarchical pods onto a two-level "
                    f"mesh and needs topology='hierarchical', got "
                    f"{self.topology!r}")
            if self.n_agents != self.pods * self.degree:
                raise ValueError(
                    f"pod dispatch needs n_agents == pods * degree "
                    f"(uniform pods of `degree` agents), got "
                    f"n_agents={self.n_agents}, pods={self.pods}, "
                    f"degree={self.degree}")
            if (not self.pod_axis
                    or not isinstance(self.pod_axis, str)
                    or self.pod_axis == "agent"):
                raise ValueError(
                    f"pod_axis must be a non-empty mesh axis name "
                    f"distinct from the intra-pod 'agent' axis, got "
                    f"{self.pod_axis!r}")
        qb = self.knowledge_quant_block
        if qb < 0:
            raise ValueError(
                f"knowledge_quant_block must be >= 0, got {qb}")
        if qb > 0 and (qb % 128 != 0 or 8192 % qb != 0):
            raise ValueError(
                f"knowledge_quant_block must be a multiple of 128 "
                f"dividing 8192 (one scale per whole sublane row group "
                f"of the wavg kernel tile), got {qb}")
        for name in ("transport_loss", "transport_dup",
                     "transport_corrupt"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(
                    f"{name} is a per-message probability and must be "
                    f"in [0, 1], got {p}")
        if self.transport_jitter < 0:
            raise ValueError(
                f"transport_jitter must be >= 0 (max extra delivery "
                f"delay in epochs), got {self.transport_jitter}")
        if not 0 <= self.transport_retransmit <= 8:
            raise ValueError(
                f"transport_retransmit must be in [0, 8] (the delay "
                f"line grows by the 2^budget - 1 worst-case backoff), "
                f"got {self.transport_retransmit}")
        if self.transport_horizon < 1:
            raise ValueError(
                f"transport_horizon must be >= 1 (planned epochs "
                f"before the fault history replays), got "
                f"{self.transport_horizon}")
        if not 0.0 < self.transport_decay <= 1.0:
            raise ValueError(
                f"transport_decay must be in (0, 1] (per-epoch "
                f"staleness discount; 1.0 = none), got "
                f"{self.transport_decay}")
        if self.max_staleness is not None and self.max_staleness < 1:
            raise ValueError(
                f"max_staleness must be >= 1 (epochs; None disables "
                f"the cutoff), got {self.max_staleness}")
        validate_choice("transport", self.exchange_transport)
        if self.exchange_transport == "none" and (
                self.transport_loss > 0 or self.transport_dup > 0
                or self.transport_corrupt > 0
                or self.transport_jitter > 0):
            raise ValueError(
                "exchange_transport='none' would silently ignore the "
                "nonzero transport fault knobs (loss="
                f"{self.transport_loss}, dup={self.transport_dup}, "
                f"corrupt={self.transport_corrupt}, jitter="
                f"{self.transport_jitter}) — use 'faulty' (or 'auto') "
                "or zero the rates")

    def _reject_unported(self):
        # deferred: the exchange registries import this module
        from repro_torch.core.exchange.registry import REGISTRIES
        for family in ("schedule", "estimator", "delay", "combiner",
                       "transport"):
            key = getattr(self, f"exchange_{family}")
            if key != "auto" and key not in REGISTRIES[family]:
                raise NotPortedError(
                    f"exchange_{family}={key!r} is not ported yet; the "
                    f"port has {REGISTRIES[family].choices}")
        if self.knowledge_dtype not in DTYPES:
            raise NotPortedError(
                f"GroupSpec.knowledge_dtype={self.knowledge_dtype!r} is "
                f"not ported to repro_torch; the port has "
                f"{tuple(DTYPES)}")


# ---------------------------------------------------------------------
# Model zoo: the SSM family (Mamba2), the dense transformer family, the
# MoE transformers (routed experts, optionally Multi-head Latent
# Attention and leading dense layers), the hybrid (Mamba2 super-blocks
# around a shared attention block), the VLM backbone (M-RoPE and a
# vision prefix) and the audio decoder (codebooks, sinusoidal positions,
# cross-attention, a GELU MLP)
# ---------------------------------------------------------------------
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
TRANSFORMER_FAMILIES = ("dense", "moe", "vlm", "audio")
SSD_IMPLS = ("xla", "pallas_interpret")
ATTENTION_IMPLS = ("xla", "pallas", "pallas_interpret")
ROPE_MODES = ("standard", "mrope", "none")
MOE_DISPATCHES = ("auto", "dense", "expert_parallel")


@dataclass(frozen=True)
class MoEConfig:
    """Routed experts — the reference's fields and defaults: top-k of
    ``n_experts`` SwiGLU experts of width ``expert_ff`` with normalised
    gates, ``n_shared`` always-on experts fused into one SwiGLU of
    width ``n_shared · expert_ff``, a capacity of ``capacity_factor ·
    S · top_k / n_experts`` tokens an expert (the rest dropped), and the
    load-balance (``aux_loss``) and router z-loss (``router_zloss``)
    weights."""
    n_experts: int
    top_k: int
    expert_ff: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_zloss: float = 1e-3
    aux_loss: float = 1e-2


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2) — the reference's
    fields and defaults: keys and values re-expanded from a rank
    ``kv_lora_rank`` latent plus one shared rotary key of
    ``qk_rope_dim``; queries of ``qk_nope_dim + qk_rope_dim`` and values
    of ``v_dim`` a head. ``q_lora_rank`` is kept for the config's sake:
    the reference reads it nowhere (V2-Lite does not compress
    queries)."""
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128
    q_lora_rank: Optional[int] = None


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block configuration — the reference's fields and
    defaults."""
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256
    d_conv: int = 4


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: N super-blocks of (mamba_per_block Mamba2 layers +
    one SHARED attention/MLP block) plus tail Mamba2 layers — the
    reference's fields and defaults."""
    n_super_blocks: int = 16
    mamba_per_block: int = 4
    tail_mamba: int = 1
    lora_rank: int = 128       # per-call-site LoRA on the shared block


@dataclass(frozen=True)
class ArchConfig:
    """The port's copy of ``repro.configs.base.ArchConfig``, cut to the
    fields the model zoo reads (``remat``, ``unroll_layers`` and
    ``max_position`` are not copied: the port has no scan to
    checkpoint or unroll). An unknown family, ``rope_mode``,
    ``moe_dispatch``, ``ssd_impl``, ``attention_impl`` or dtype raises
    ``ValueError``, and so do a hybrid config without both ``ssm`` and
    ``hybrid``, a ``moe`` family without ``moe``, and ``moe``, ``mla``
    or ``first_k_dense`` on a family that is not a transformer.

    The modality fields are the reference's backbone stubs. The VLM
    (``family="vlm"``, ``rope_mode="mrope"``) prepends
    ``vision_prefix`` pre-projected patch embeddings to the text and
    rotates by (t, h, w) position triples (B, 3, S), whose half head
    dim splits into ``mrope_sections``: they must sum to
    ``head_dim / 2``, checked where the reference asserts it, at the
    rotation (``ValueError`` naming both). The audio family sums
    ``n_codebooks`` embedding tables, adds sinusoidal positions, has
    ``n_codebooks`` heads and a GELU MLP, and with ``cross_attention``
    attends in every layer to a (B, ``cond_len``, d_model)
    conditioning sequence.

    ``moe`` makes every stacked layer's feed-forward a routed
    ``MoEConfig`` block; ``mla`` makes every layer's attention
    Multi-head Latent Attention; the first ``first_k_dense`` layers (0
    or 1, as in the reference) keep a dense SwiGLU of ``dense_ff`` and
    run before the stack (``params["layer0"]``). ``moe_dispatch``
    takes the reference's values; with no model axis the reference
    dispatches dense whatever it says, and so does the port; on a
    ``(data, model)`` mesh whose model axis divides the experts,
    ``"dense"`` keeps the dense dispatch and the others take the
    expert-parallel one (``repro_torch.models.moe``). ``mla_absorb``
    scores a query against the cached latent directly (the reference's
    weight absorption) whenever a cache is given with more slots than
    the pass has queries.

    ``ssd_impl`` and ``attention_impl`` are validated against the
    reference's values and decide one thing: a pass that autograd
    records (``torch.is_grad_enabled()`` and an input that requires
    grad: a training step's loss) with ``"pallas"`` or
    ``"pallas_interpret"`` raises :class:`NotPortedError`, as the
    reference's Pallas kernels have no VJP and only its ``"xla"`` branch
    trains. Every pass otherwise takes the kernels, recorded or not:
    the cache-free attention calls the flash attention (causal by
    index) and the SSD the intra-chunk kernel, on CUDA tensors the
    kernels and on CPU tensors their plain versions
    (``repro_torch.kernels.flash_attention.ops``,
    ``repro_torch.kernels.ssd_scan.ops``). A recorded pass calls them
    through ``kernels.plain_vjp``: the forward is the kernel's and the
    gradient the plain version's vector-Jacobian product at the same
    inputs (the plain SSD is the reference's einsum form; the plain
    attention masks by index and scores in fp32, which by position and
    at ``attention_scores_dtype="float32"`` is the reference's
    ``"xla"`` branch). The kernel masks by index, the reference's
    ``"xla"`` branch by position (the w row ``positions[:, -1, :]`` of
    M-RoPE's triples): the two agree where each row's positions are
    0..S−1, as in every batch the repo builds (the synthetic streams,
    ``build_prefill_batch``); a cache-free pass over other positions
    takes the kernel's mask. MLA never reaches the flash kernel, as in the
    reference (its query and value widths differ): it scores with the
    materialised softmax attention. ``attention_scores_dtype`` applies
    to the attention over a KV cache and to MLA's expanded branch. The
    kernel wrappers still refuse inputs that require grad.
    """
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False
    rope_mode: str = "standard"         # standard | mrope | none
    rope_theta: float = 1e6
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    sliding_window: Optional[int] = None
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    first_k_dense: int = 0              # deepseek: leading dense layers
    dense_ff: int = 0                   # d_ff of those dense layers
    # -- modality backbone stubs (the reference's carve-out) ---------
    cross_attention: bool = False       # musicgen: cross-attn to cond.
    cond_len: int = 0                   # conditioning sequence length
    n_codebooks: int = 1                # musicgen: 4 EnCodec codebooks
    vision_prefix: int = 0              # qwen2-vl: # of patch embeddings
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    moe_dispatch: str = "auto"          # auto | dense | expert_parallel
    mla_absorb: bool = True             # MLA weight absorption
    attention_scores_dtype: str = "float32"
    attention_impl: str = "xla"
    ssd_impl: str = "xla"
    citation: str = ""

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}; expected "
                             f"one of {FAMILIES}")
        if self.family == "ssm" and self.ssm is None:
            raise ValueError("an ssm-family ArchConfig needs ssm=SSMConfig")
        if self.family == "hybrid" and (self.ssm is None
                                        or self.hybrid is None):
            raise ValueError("a hybrid ArchConfig needs ssm=SSMConfig and "
                             "hybrid=HybridConfig")
        if self.family == "moe" and self.moe is None:
            raise ValueError("a moe ArchConfig needs moe=MoEConfig")
        if self.family in ("ssm", "hybrid") and (
                self.moe is not None or self.mla is not None
                or self.first_k_dense):
            raise ValueError(
                f"moe, mla and first_k_dense shape a transformer's layers; "
                f"a {self.family} ArchConfig has none")
        if self.first_k_dense not in (0, 1) or (
                self.first_k_dense and (self.dense_ff < 1
                                        or self.n_layers < 2)):
            raise ValueError(
                f"first_k_dense must be 0 or 1 (one leading dense layer "
                f"of dense_ff > 0 before the stack), got first_k_dense="
                f"{self.first_k_dense}, dense_ff={self.dense_ff}, "
                f"n_layers={self.n_layers}")
        if self.mla is not None and self.mla.qk_rope_dim % 2:
            raise ValueError(f"MLA's qk_rope_dim must be even, got "
                             f"{self.mla.qk_rope_dim}")
        if self.moe_dispatch not in MOE_DISPATCHES:
            raise ValueError(f"unknown moe_dispatch {self.moe_dispatch!r}; "
                             f"expected one of {MOE_DISPATCHES}")
        if self.family in TRANSFORMER_FAMILIES + ("hybrid",) and not (
                self.n_heads >= 1 and self.n_kv_heads >= 1
                and self.n_heads % self.n_kv_heads == 0
                and self.head_dim >= 2 and self.head_dim % 2 == 0):
            raise ValueError(
                f"a {self.family} ArchConfig needs n_kv_heads dividing "
                f"n_heads and an even head_dim, got n_heads={self.n_heads}, "
                f"n_kv_heads={self.n_kv_heads}, head_dim={self.head_dim}")
        if self.rope_mode not in ROPE_MODES:
            raise ValueError(f"unknown rope_mode {self.rope_mode!r}; "
                             f"expected one of {ROPE_MODES}")
        if self.ssd_impl not in SSD_IMPLS:
            raise ValueError(f"unknown ssd_impl {self.ssd_impl!r}; "
                             f"expected one of {SSD_IMPLS}")
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"unknown attention_impl "
                             f"{self.attention_impl!r}; expected one of "
                             f"{ATTENTION_IMPLS}")
        for which in ("param_dtype", "compute_dtype",
                      "attention_scores_dtype"):
            if getattr(self, which) not in DTYPES:
                raise ValueError(f"{which} must be one of "
                                 f"{tuple(DTYPES)}, got "
                                 f"{getattr(self, which)!r}")

    def dtype(self, which: str = "compute") -> torch.dtype:
        return DTYPES[self.param_dtype if which == "param" else
                      self.compute_dtype]

    def with_(self, **kw) -> "ArchConfig":
        return replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant, the reference's numbers: 2 layers,
        d_model ≤ 256, vocab ≤ 512, fp32; ≤ 4 heads of 32 with the kv
        heads cut to divide them, d_ff ≤ 512, a sliding window of 16
        where there is one; 4 experts of width 128, top-k ≤ 2, ≤ 1
        shared expert; MLA rank 64 with nope / rope / v dims 32 / 16 /
        32; a leading dense layer of width 128; ssm d_state 16, head_dim
        16, chunk 32; a hybrid gets 3 layers: one super-block of one
        Mamba2 layer, one tail layer, LoRA rank 8; cond_len ≤ 8 with
        cross-attention (else 0), vision_prefix ≤ 8, M-RoPE sections
        (4, 6, 6)."""
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        kw = dict(
            n_layers=2, d_model=min(self.d_model, 256), n_heads=n_heads,
            n_kv_heads=n_kv, head_dim=32,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            cond_len=min(self.cond_len, 8) if self.cross_attention else 0,
            vision_prefix=min(self.vision_prefix, 8), param_dtype="float32",
            compute_dtype="float32")
        if self.moe is not None:
            kw["moe"] = replace(self.moe, n_experts=4,
                                top_k=min(self.moe.top_k, 2), expert_ff=128,
                                n_shared=min(self.moe.n_shared, 1))
        if self.mla is not None:
            kw["mla"] = replace(self.mla, kv_lora_rank=64, qk_nope_dim=32,
                                qk_rope_dim=16, v_dim=32)
        if self.first_k_dense:
            kw["dense_ff"] = 128
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, d_state=16, head_dim=16, chunk=32)
        if self.hybrid is not None:
            kw["hybrid"] = replace(self.hybrid, n_super_blocks=1,
                                   mamba_per_block=1, tail_mamba=1,
                                   lora_rank=8)
            kw["n_layers"] = 3
        if self.sliding_window is not None:
            kw["sliding_window"] = 16
        if self.rope_mode == "mrope":
            kw["mrope_sections"] = (4, 6, 6)    # sums to head_dim/2 = 16
        return replace(self, **kw)


# ---------------------------------------------------------------------
# Input shapes — the reference's. ``kind`` names the step a shape is
# for: train / prefill / decode.
# ---------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,   32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",  524_288,    1, "decode"),
}

# Dense (full-attention) archs fall back to a sliding-window variant for
# long_500k (sub-quadratic requirement), as the reference's do.
LONG_CONTEXT_WINDOW = 8_192
