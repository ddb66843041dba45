#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    PYTHONPATH=src python3 chip_smoke.py        # src/ is also found alone

Phases, each printing its lines:

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. build every CUDA kernel of the main paths from the sources in this
   checkout (one ``nvcc`` per source, all started together), with the
   registers and spills ptxas reports for each kernel instance (a
   flash, SSD or fp32 share-step instance that spills fails the run);
3. each kernel against its plain PyTorch version on the card, at the
   shapes of the main paths and at edge cases, with its time beside the
   plain version's, a one-call PyTorch yardstick's and the least time
   the card could take: the fp32 eq. 4 share step (both entries,
   bitwise, also at m = 1, 5, 33, 4096, n = 1 and in each instance), the
   gradient sketch (signs through the kernel bitwise, sketches within
   their gate, two launches bitwise equal, also at the row-block and
   chunk edges), the int8 share step (bitwise, also at m = 1, 5, 33,
   4096 and n = 1), the SSD intra-chunk dual form (bf16 on the tensor
   cores at the tile, group and window edges, fp32 on the CUDA cores;
   each within its gate, two launches bitwise equal, both kernels run;
   inputs that require grad refused; also at zamba2-7b's n = 64) and
   the flash attention (bf16 on the tensor cores, fp32 on the CUDA
   cores; each within its gate, two launches bitwise equal, with its
   TFLOP/s over the tiles it visits and the blocks per SM of every
   flash instance; ``[kernel] flash_attention D=112`` at zamba2-7b's
   head dim, (2, 4096, 32, 32, 112), a ragged S, a window, GQA;
   ``[kernel] flash_attention GQA 8`` at qwen3-moe-30b-a3b's (2, 4096,
   32, 4, 128), a ragged S, a window, fp32; ``[kernel] flash_attention
   H=64 GQA 8`` at qwen2-vl-72b's (2, 4096, 64, 8, 128), a ragged S,
   fp32; ``[kernel] flash_attention D=64 MHA`` at musicgen-medium's (2,
   1500, 24, 24, 64) in bf16 and fp32, a ragged S); and both
   share steps on the robustness paths' inputs (T and R discounted by
   0.95**age, pieces past the staleness cutoff, quarantined pieces,
   an agent with no valid piece), bitwise;
4. the main paths, through the entry points a user calls, each run with
   the kernels' launch counts zeroed just before it and read just
   after: DDA3C groups at the paper's width (A2C, hidden 64,
   CartPole-v0) trained for 120 epochs (2 share steps), the fourth with
   learned sketched relevance and int8 knowledge planes; DDADQN groups
   (dueling double DQN, hidden 64, P = 8835) through ``make_dqn_group``,
   n = 2 ``full`` and n = 8 ``ring`` with sketches and int8 planes, each
   ending with every replay ring above one minibatch; the robustness
   paths: (a) DDA3C n = 8 on ``relevance_topk`` gossip (k = 4, every 10
   epochs, ε 0.1) with sketched relevance and int8 planes, (b) DDA3C
   n = 8 ring with elastic membership on a ``chaos_schedule`` over a
   faulty transport (loss, corruption, retransmit, jitter, duplicates)
   with ``max_staleness`` 8 and decay 0.95, (c) DDADQN n = 4 with
   ``obs_stats`` relevance on ``dynamic`` gossip; mamba2-780m
   and llama3.2-3b at their published widths and depth served by
   ``repro_torch.launch.serve`` (``[serve]``: 4 requests of up to 1023
   prompt tokens, prefill and 32 greedy tokens each); llama3.2-3b
   scoring 2 x 4096 ids through ``get_model(cfg).forward`` / ``.loss``
   without a cache (``[score]``: the flash kernel in every layer), with
   a profile of one scoring pass, and its ``ServeEngine.decode`` under
   ``torch.cuda.set_sync_debug_mode("error")`` (``[nosync]``); the
   hybrid zamba2-7b at its published widths and depth served the same
   way (``[serve] zamba2-7b``: the SSD kernel in each of its 65 Mamba2
   layers per prefill, no flash) and scored (``[score] zamba2-7b``: 16
   flash launches, one per call of the shared block, and 65 SSD
   launches per pass), with a profile of one pass; the MoE pair at its
   published widths and depth, one model on the card at a time:
   ``[serve] qwen3-moe-30b-a3b`` (bf16 weights, 56.9 GiB, through
   ``ServeEngine``, its decode under ``set_sync_debug_mode("error")``,
   and the ``ContinuousBatcher``), ``[score] qwen3-moe-30b-a3b`` (48
   flash launches a pass, the experts' aux term printed) with a profile
   of one pass, ``[serve] deepseek-v2-lite-16b`` through the launcher
   (fp32 weights; MLA takes the absorbed branch at every prefill and
   decode step) and ``[score] deepseek-v2-lite-16b`` (no kernel: MLA
   scores with the materialised softmax, as the reference does); the
   audio family: ``[serve] musicgen-medium`` at its published widths
   and depth through the launcher (fp32 weights, 4 codebooks,
   cross-attention to the cache's zero keys), ``[score]
   musicgen-medium`` (2 x 1500 delayed frames of 4 codebooks from
   ``make_agent_batch`` with a 64-position ``cond``, 48 flash launches
   a pass) and its decode under ``set_sync_debug_mode("error")``; the
   VLM at its published widths cut to 20 of its 80 layers with bf16
   weights: ``[score] qwen2-vl-72b, 20 layers`` (2 x 4096 positions,
   256 of them the vision prefix, M-RoPE; 20 flash launches a pass)
   and ``[serve] qwen2-vl-72b, 20 layers`` (``ServeEngine``, max_len
   1312, the decode under ``set_sync_debug_mode("error")``); the
   slot engines at full width, mamba2-780m, llama3.2-3b and
   musicgen-medium cut to SLOT_LAYERS (8) layers: ``[continuous]
   mamba2-780m, 8 layers`` (8 requests through 2 slots), ``[group]
   mamba2-780m, 8 layers`` (4 agents, 4 slots, 16 requests, a hot swap
   after 8) and ``[group] llama3.2-3b, 8 layers`` (2 agents, 2 slots, 4
   requests), ``[group] zamba2-7b`` (2 agents'
   bf16 planes, 2 slots, 4 requests), ``[group] deepseek-v2-lite-16b, 6
   layers`` (its widths, layer 0 + 5 MoE layers, 2 agents' bf16
   planes), ``[continuous] musicgen-medium, 8 layers`` (4 requests, 2
   slots), ``[group] musicgen-medium, 8 layers`` (2 agents' fp32
   planes) and ``[group]
   qwen2-vl-72b, 4 layers`` (2 agents' bf16 planes), each request's
   first token against
   the fixed-batch engine on its admitted planes and one synchronizing
   call per step, ``[exact]`` the same engines in fp32 compute with
   every token equal, and ``[load] mamba2-780m``, the load bench's twin
   at full depth (16 open-loop Poisson arrivals, a hot swap, its three
   gates); the
   streaming trainer (Slice D): ``[train] mamba2-780m`` at its
   published widths and depth through ``repro_torch.launch.train``
   (2 agents, batch 4 x 256, 12 steps, sketched relevance d 256, shares
   at steps 4 and 8; every loss finite, the window empty after each
   share, ``grad_sketch`` launched once per leaf per accumulation step
   and the SSD kernel once per layer in every agent's forward, whose
   gradient is the plain einsum form's), ``[train] llama3.2-3b, 2
   layers`` (its published widths, depth cut to 2: 4 agents on a ring,
   exact grad_cos, int8 planes; the flash kernel once per layer in every
   agent's forward), and the sketch kernel on the trainer's own leaves
   (signs on the 77.2 M-position embedding at offsets near 0.86 B, a
   dense (2, 2^23) slice at such an offset against its plain version,
   time at the largest leaf, 2 x 226.5 M positions); the pod dispatch
   (Slice E): ``[train] pods`` (llama3.2-3b's widths cut to 2 layers,
   4 agents in 2 pods of 2 on the ``hierarchical`` graph, the ``pod``
   combiner on one device, sketched relevance d 256, int8 planes; the
   flash kernel once per layer in every agent's forward and the sketch
   once per leaf per accumulation step) with the cross-pod and flat
   byte counts, and ``[mesh]``: the launcher under
   ``torch.distributed.run`` on a (1, 1) ``(pod, agent)`` mesh over
   NCCL (in the background, beside the card-against-CPU serving phases
   of 5.), its checkpoint against the same launcher's one-device run;
   the model axis (Slice E part 2), in a one-rank NCCL group of this
   process: ``[tp]`` (``[train] pods``' model and exchange, 4 agents on
   a ring, on a (1, 1) ``(data, model)`` mesh against the same step with
   no mesh: losses and parameters within rtol 1e-5 / atol 1e-6, flash
   once per layer in every agent's forward, the sketch once per leaf per
   accumulation step), ``[equiv] experts ep`` (qwen3-moe-30b-a3b's
   widths cut to 2 layers, fp32, scoring 2 x 4096 ids: the
   expert-parallel dispatch on the (1, 1) mesh against the dense one,
   loss rtol 1e-5, gradients rtol 3e-4 / atol 3e-5, one ``moe_combine``
   all-reduce per MoE layer) and ``[kernel] grad_sketch strided`` (the
   ``[tp]`` model's stacked ``w_gate`` leaf cut into 2 and 4 column
   slices: each slice's kernel against its plain version, their sum
   against the contiguous kernel on the whole leaf, ms, bound and
   ``matmul`` ms per slice); serving on the production meshes (Slice E
   part 3a), in the same group: ``[serve-tp] llama3.2-3b`` (its
   published widths and depth, bf16 compute, the [serve] prompts as one
   batch: ``dryrun_lib.prefill_on_mesh`` and 32 greedy
   ``decode_on_mesh`` steps on the (1, 1) ``(data, model)`` mesh, the
   KV-slot sweep and the gathered logits, against the one-device
   ``ServeEngine``: tokens equal but for a bf16 near tie, logits within
   2^-5·max|want|, the cache at its placed shapes), ``[score-tp]
   llama3.2-3b`` (the cache-free pass over 2 x 4096 ids on the mesh: the
   full logits against one device, flash once per layer),
   ``[serve-tp] deepseek-v2-lite-16b, 2 layers`` (fp32: absorbed MLA
   with the latent cache's sweep and the expert-parallel dispatch,
   [equiv]'s gates) and ``[group-tp]`` (``GroupServeEngine(mesh=)`` on
   a (1, 1) ``(pod, agent)`` mesh, llama3.2-3b's widths at 2 layers, 4
   agents: tokens equal to the one-process engine's); the ssm, hybrid,
   VLM and audio families on the same mesh (Slice E part 3b): ``[tp]
   mamba2-780m, 4 layers`` (as ``[tp]``, the SSD kernel once per layer
   in every agent's forward), ``[serve-tp] mamba2-780m`` (full depth,
   bf16 compute, as ``[serve-tp] llama3.2-3b``; 48 SSD launches in the
   prefill) and ``[score-tp]`` of zamba2-7b cut to 2 super-blocks (SSD
   and flash counts), qwen2-vl-72b cut to 2 layers with bf16 weights
   and musicgen-medium (flash counts), each against one device within
   2^-5·max|want|; one rank on one card shows that the code path and
   NCCL run, not traffic between cards (the kernel at a rank's heads of
   a larger model axis: ``[kernel] ssd_intra_chunk`` at 24 and 12 of
   mamba2-780m's heads and 56 and 28 of zamba2-7b's);
5. the card against the port's CPU path: ``[train-equiv]``, the
   streaming trainer at reduced() llama3.2-3b and mamba2-780m with fp32
   compute, 8 steps with 2 shares, from the same state and batches,
   once on the models' own gradients and once on given gradients (the
   window, its sketch and the learned relevance held step by step);
   ``[train-equiv] pods``, the same for 4 agents in 2 pods of 2 through
   the ``pod`` combiner, and the pod run against the flat run on the
   card on given gradients (parameters within rtol 1e-5 / atol 1e-6);
   small DDA3C groups with seeded
   gradients, fp32 and int8 + learned relevance; a small DDADQN group
   with seeded gradients (target syncs included) and ``dqn_loss`` with
   its gradient on one seeded batch; the robustness paths (a) and (b)
   cut to n = 6 on seeded gradients, and a checkpoint written on the
   card restored on the CPU; the serving paths at
   mamba2-780m's and llama3.2-3b's widths cut to 2 layers with fp32
   compute (every [equiv] serve request decodes 8 greedy tokens on both
   sides; the [serve] prompts of over 512 ids cut to their first
   third, ``_equiv_prompts``, here and below); the llama scoring pass at the same cut; the continuous and
   group engines at both cuts (step logits within 1e-4, tokens equal);
   ``[equiv] zamba2-7b``: its widths cut to one super-block of one
   Mamba2 layer and the tail layer, fp32, LoRA ``b`` drawn non-zero,
   served on the [serve] prompts (prefill logits within 1e-4, tokens
   equal) and scored (logits within 1e-4, the loss within 1e-4);
   ``[equiv] qwen3-moe-30b-a3b`` and ``[equiv] deepseek-v2-lite-16b``:
   their widths cut to 2 layers (deepseek: layer 0 + 1 MoE layer), fp32,
   served on the [serve] prompts (prefill logits within 1e-4, 8 greedy
   tokens equal; every router call's experts equal), through the
   continuous batcher (8 greedy
   tokens equal) and scored (logits within 1e-4, the loss within 1e-5
   relative); ``[equiv] musicgen-medium`` (2 layers) and ``[equiv]
   qwen2-vl-72b`` (1 layer, three prompts under 64 ids and one of
   270): served (prefill
   logits within 1e-4, 8 greedy tokens equal, the continuous batcher's
   too) and scored (a non-zero ``cond`` or the vision prefix; logits
   within 1e-4, the loss within 1e-5 relative); beside them, in a child
   process with its own default process group, ``[dryrun]``: a fake
   256-rank world at rank (0, 0) of the 16 x 16 mesh
   (``launch.mesh.make_traced_mesh``) traces mamba2-780m
   ``prefill_32k`` (2 rows x 32,768 tokens: the SSD kernel in each of
   48 layers) and llama3.2-3b ``decode_32k`` on ``meta`` tensors
   (``launch.dryrun_lib``), then runs each step for real on the card
   with the rank's slices (collectives faked: no bytes move); the
   measured peak within 10 % of the traced ``total_bytes_per_device``
   and each kernel's launches equal to the traced count;
6. a profile of a few main-path epochs of the quickstart group, of
   the fourth run's configuration and of the DDADQN n = 2 group (the
   device's busy share, the ops that take the time and the host-clock
   split of an epoch), and of
   one full-width mamba2-780m prefill and 4 decode steps (the SSD
   library's kernels' share of the prefill); skipped, with a line that
   says so, when the run has spent PROFILE_DEADLINE (1,000) s.

Each phase group ends with a ``[time]`` line (host seconds). It prints
one JSON line of per-kernel numbers (``launches`` is the
count of the first path that drives the kernel, ``launches_by_path``
each such path's own count) and, last, one JSON line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero, as
does a machine with no CUDA card.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

G_TOL = dict(rtol=2e-5, atol=2e-5)     # ḡ, as the Pallas kernel is held
W_RTOL = 1e-6                          # Σw
EPOCHS = 120                           # of each main-path run

SKETCH_DIM, QUANT_BLOCK = 256, 128      # the fourth main-path run's
DQN_EPS_DECAY = 500                     # the DDADQN runs' ε anneal
SOURCES = ("ddal_wavg", "grad_sketch", "ssd_scan", "flash_attention")
SSD_GATE = 1e-5        # × Σ_j (|C_i|·|B_j|)·L_ij·dt_j·|x_jp|, per element
# bf16 SSD cases at the edges of the kernel's 64-row tiles, its windows of
# 4 column tiles for dt and cs (l > 256), its 16-byte copies (p, n not
# multiples of 8), and its head sets (g > 1 with several sets per group;
# every instance, 1, 2 and 3 heads a block): (label, (b, nc, l, h, p, n, g))
SSD_BF16_EDGES = [
    ("l = 1", (1, 2, 1, 4, 64, 128, 1)),
    ("l = 63", (1, 2, 63, 4, 64, 128, 1)),
    ("l = 65", (1, 2, 65, 4, 64, 128, 1)),
    ("l = 100, p = 40, n = 48, 3 groups", (1, 3, 100, 6, 40, 48, 3)),
    ("p = 1, n = 16", (1, 2, 256, 4, 1, 16, 1)),
    ("n = 100, p = 40, 2 groups", (1, 2, 256, 4, 40, 100, 2)),
    ("l = 129, p = 33, n = 24, 3 groups", (1, 1, 129, 18, 33, 24, 3)),
    ("l = 300: two windows, 2 groups", (1, 1, 300, 4, 64, 128, 2)),
    ("l = 600: three windows", (1, 1, 600, 2, 64, 64, 1)),
    ("2 groups of 6 heads", (4, 8, 256, 12, 64, 128, 2)),
    ("3 groups of 12 heads", (2, 8, 256, 36, 64, 128, 3)),
    ("3 groups of 4 heads", (8, 8, 256, 12, 64, 128, 3)),
    ("48 heads, two waves", (4, 16, 256, 48, 64, 128, 1)),
    ("l = 300, 3 heads a block: two windows", (16, 8, 300, 6, 64, 128, 2)),
    ("l = 600, 2 heads a block: three windows", (16, 8, 600, 4, 64, 64, 1))]
# the serving path: mamba2-780m at its published widths and depth
SERVE_ARGV = ["--arch", "mamba2-780m", "--full", "--serve", "engine=batch",
              "--serve", "slots=2", "--requests", "4", "--prompt-len",
              "1024", "--serve", "max_new_tokens=32"]
SERVE_LABEL = "[serve] mamba2-780m"
# the scoring path: llama3.2-3b at its published widths and depth, B
# rows of the repo's train_4k sequence length
LLAMA = "llama3.2-3b"
SCORE_B, SCORE_S, SCORE_PASSES = 2, 4096, 3
SCORE_LABEL = "[score] llama3.2-3b"
LLAMA_SERVE_ARGV = ["--arch", LLAMA, "--full", "--serve", "engine=batch",
                    "--serve", "slots=2", "--requests", "4", "--prompt-len",
                    "1024", "--serve", "max_new_tokens=32", "--serve",
                    "max_len=1056"]
LLAMA_SERVE_LABEL = "[serve] llama3.2-3b"
# the hybrid: zamba2-7b at its published widths and depth (16 super-blocks
# of 4 Mamba2 layers around a shared attention block, one tail layer)
MAMBA = "mamba2-780m"
ZAMBA = "zamba2-7b"
ZAMBA_SERVE_ARGV = ["--arch", ZAMBA] + LLAMA_SERVE_ARGV[2:]
ZAMBA_SERVE_LABEL = "[serve] zamba2-7b"
ZAMBA_SCORE_LABEL = "[score] zamba2-7b"
# the SSD kernel at zamba2-7b's scoring pass: the first shape with n = 64
# a model rank's heads of the two SSD models' prefills (m = 2 and 4 of
# mamba2-780m's 48 heads and zamba2-7b's 112): the shapes the kernel takes
# on a (data, model) mesh, which the one-card (1, 1) mesh cannot reach
SSD_LOCAL_HEADS = [
    ("mamba2-780m prefill, a model rank's 24 heads (m = 2)",
     (2, 4, 256, 24, 64, 128, 1)),
    ("mamba2-780m prefill, a model rank's 12 heads (m = 4)",
     (2, 4, 256, 12, 64, 128, 1)),
    ("zamba2-7b prefill, a model rank's 56 heads (m = 2)",
     (2, 4, 256, 56, 64, 64, 1)),
    ("zamba2-7b prefill, a model rank's 28 heads (m = 4)",
     (2, 4, 256, 28, 64, 64, 1)),
]
ZAMBA_SSD_LABEL = "zamba2-7b scoring, n = 64"
# the MoE pair: qwen3-moe-30b-a3b (48 layers of 128 experts, top-8, GQA
# 32 / 4) with bf16 weights (fp32 would take 122 GB), served from the
# library; deepseek-v2-lite-16b (MLA, 2 shared + 64 routed experts,
# top-6, a leading dense layer) with fp32 weights through the launcher
QWEN = "qwen3-moe-30b-a3b"
QWEN_SERVE_LABEL = "[serve] qwen3-moe-30b-a3b"
QWEN_SCORE_LABEL = "[score] qwen3-moe-30b-a3b"
DEEPSEEK = "deepseek-v2-lite-16b"
DEEPSEEK_SERVE_ARGV = ["--arch", DEEPSEEK] + LLAMA_SERVE_ARGV[2:]
DEEPSEEK_SERVE_LABEL = "[serve] deepseek-v2-lite-16b"
DEEPSEEK_SCORE_LABEL = "[score] deepseek-v2-lite-16b"
DEEPSEEK_GROUP_LAYERS = 6           # layer 0 + 5 MoE layers
# the VLM and audio pair: qwen2-vl-72b (80 layers, GQA 64 / 8, M-RoPE, a
# stubbed vision prefix of 256) cut to 20 layers with bf16 weights (the
# whole model is ~145 GB even in bf16), served from the library; and
# musicgen-medium (48 layers, MHA 24 heads of 64, 4 codebooks, a GELU MLP,
# cross-attention to 64 conditioning positions) at full depth with fp32
# weights through the launcher
QWEN_VL = "qwen2-vl-72b"
VL_SCORE_LAYERS, VL_GROUP_LAYERS = 20, 4
VL_SERVE_LABEL = f"[serve] {QWEN_VL}, {VL_SCORE_LAYERS} layers"
VL_SCORE_LABEL = f"[score] {QWEN_VL}, {VL_SCORE_LAYERS} layers"
MUSICGEN = "musicgen-medium"
MUSICGEN_FRAMES = 1500              # 30 s at 50 Hz
MUSICGEN_SERVE_ARGV = ["--arch", MUSICGEN] + LLAMA_SERVE_ARGV[2:]
MUSICGEN_SERVE_LABEL = f"[serve] {MUSICGEN}"
MUSICGEN_SCORE_LABEL = f"[score] {MUSICGEN}"
FA_TOL = dict(rtol=2e-5, atol=2e-5)    # fp32, as the Pallas kernel is held
# the training path: the streaming trainer's launcher at mamba2-780m's
# published widths and depth, 2 agents, share steps 4 and 8
TRAIN_ARGV = ["--arch", "mamba2-780m", "--full", "--agents", "2",
              "--steps", "12", "--batch", "4", "--seq", "256",
              "--threshold", "4", "--minibatch", "4", "--exchange",
              "estimator=grad_cos+sketch", "--exchange",
              "relevance_sketch_dim=256", "--seed", "0"]
TRAIN_LABEL = "[train] mamba2-780m"
TRAIN_SHARES = [4, 8]
TRAIN_ACCUMULATE = 8            # steps 4 .. 11 add to the window
LLAMA_TRAIN_LABEL = "[train] llama3.2-3b, 2 layers"
PODS_TRAIN_LABEL = "[train] pods, llama3.2-3b, 2 layers"
# 4 agents in 2 pods of 2 on the hierarchical graph (the pod combiner)
PODS_SPEC = dict(n_agents=4, knowledge_mode="streaming",
                 topology="hierarchical", degree=2, pods=2)
POD_TOL = dict(rtol=1e-5, atol=1e-6)   # the reference's pod-dispatch tolerance

KERNELS = {
    "ddal_fused_wavg": dict(
        route="cuda",
        source="src/repro_torch/kernels/ddal_wavg/csrc/ddal_wavg.cu",
        replaces="src/repro/kernels/ddal_wavg/kernel.py:164"),
    "ddal_wavg": dict(
        route="cuda",
        source="src/repro_torch/kernels/ddal_wavg/csrc/ddal_wavg.cu",
        replaces="src/repro/kernels/ddal_wavg/kernel.py:58"),
    "ddal_fused_wavg_q": dict(
        route="cuda",
        source="src/repro_torch/kernels/ddal_wavg/csrc/ddal_wavg.cu",
        replaces="src/repro/kernels/ddal_wavg/kernel.py:185"),
    "grad_sketch": dict(
        route="cuda",
        source="src/repro_torch/kernels/grad_sketch/csrc/grad_sketch.cu",
        replaces="src/repro/kernels/grad_sketch/kernel.py:116"),
    "ssd_intra_chunk": dict(
        route="cuda",
        source="src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:48"),
    "flash_attention": dict(
        route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:93"),
}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


def _counted():
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from repro_torch.kernels.ddal_wavg import ops
    from repro_torch.kernels.grad_sketch import ops as sketch_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {"ddal_fused_wavg": ops.fused_wavg, "ddal_wavg": ops.wavg,
            "ddal_fused_wavg_q": ops.fused_wavg_q,
            "grad_sketch": sketch_ops.sketch_flat,
            "ssd_intra_chunk": ssd_ops.ssd_intra_chunk,
            "flash_attention": fa_ops.flash_attention}


def reset_launches():
    for fn in _counted().values():
        fn.launches = 0


def launch_counts():
    return {name: fn.launches for name, fn in _counted().items()}


def kernel_layers(cfg):
    """(SSD launches, flash launches) of one cache-free pass of ``cfg``:
    one SSD launch per Mamba2 layer, one flash launch per attention
    layer (the hybrid: per call of its shared block; none for MLA, which
    scores with the materialised softmax, as the reference does). A
    pass with a cache launches the SSD kernels alone."""
    if cfg.family == "ssm":
        return cfg.n_layers, 0
    if cfg.mla is not None:
        return 0, 0
    if cfg.family == "hybrid":
        hy = cfg.hybrid
        return (hy.n_super_blocks * hy.mamba_per_block + hy.tail_mamba,
                hy.n_super_blocks)
    return 0, cfg.n_layers


def widths(cfg):
    """The published widths of ``cfg`` for a phase's line."""
    out = []
    if cfg.ssm is not None:
        s = cfg.ssm
        out.append(f"{s.expand * cfg.d_model // s.head_dim} SSD heads of "
                   f"{s.head_dim}, d_state {s.d_state}, chunk {s.chunk}")
    if cfg.mla is not None:
        m = cfg.mla
        out.append(f"{cfg.n_heads} MLA heads, latent rank "
                   f"{m.kv_lora_rank}, nope / rope / v dims "
                   f"{m.qk_nope_dim} / {m.qk_rope_dim} / {m.v_dim}")
    elif cfg.family != "ssm":
        out.append(f"{cfg.n_heads} query / {cfg.n_kv_heads} kv heads of "
                   f"{cfg.head_dim}" + ("" if cfg.moe else
                                        f", d_ff {cfg.d_ff}"))
    if cfg.moe is not None:
        e = cfg.moe
        out.append(f"{e.n_experts} experts of {e.expert_ff}, top-{e.top_k}, "
                   f"{e.n_shared} shared, capacity factor "
                   f"{e.capacity_factor}")
    if cfg.first_k_dense:
        out.append(f"layer 0 dense, d_ff {cfg.dense_ff}")
    if cfg.family == "vlm":
        out.append(f"M-RoPE sections {cfg.mrope_sections}, a vision prefix "
                   f"of {cfg.vision_prefix}")
    if cfg.family == "audio":
        out.append(f"{cfg.n_codebooks} codebooks, sinusoidal positions, a "
                   f"GELU MLP, cross-attention to {cfg.cond_len} positions")
    if cfg.hybrid is not None:
        hy = cfg.hybrid
        out.append(f"{hy.n_super_blocks} super-blocks of "
                   f"{hy.mamba_per_block} Mamba2 layers and the shared "
                   f"block with rank-{hy.lora_rank} LoRA, "
                   f"{hy.tail_mamba} tail layer")
    return ", ".join(out)


def device_phase(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"devices {torch.cuda.device_count()} "
          f"name {torch.cuda.get_device_name(0)} "
          f"matmul_precision {torch.get_float32_matmul_precision()}")
    return card


def build_phase():
    """Builds every source and prints each kernel instance's registers
    and spills; returns {source: the instances' names}."""
    from repro_torch.kernels import cuda_build
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = dict(zip(SOURCES, pool.map(cuda_build.load, SOURCES)))
    secs = time.perf_counter() - t0
    instances = {}
    for name in SOURCES:
        src = cuda_build.source_of(name).relative_to(ROOT)
        print(f"[build] {src} -> "
              f"{cuda_build.BUILD_DIR.relative_to(ROOT)}/{name}.so")
        report = cuda_build.ptxas_report(libs[name][1])
        instances[name] = {kernel for kernel, *_ in report}
        for kernel, regs, stores, loads in report:
            print(f"[build]   ptxas {kernel}: {regs} registers, spill "
                  f"stores {stores} B, spill loads {loads} B")
        if name == "ddal_wavg":
            fp32 = [r for r in report if "wavg_kernel" in r[0]]
            check(len(fp32) == 10 and all(st == ld == 0 for _, _, st, ld
                                          in fp32),
                  f"ddal_wavg: ptxas reports spills or not the 10 fp32 "
                  f"instances (fused / wavg x 5 geometries): {fp32}")
        if name == "ssd_scan":
            check(len(report) == 4 and all(st == ld == 0 for _, _, st, ld
                                           in report),
                  f"ssd_scan: ptxas reports spills or not the 4 instances "
                  f"(fp32 CUDA cores, bf16 tensor cores x 1, 2, 3 heads a "
                  f"block): {report}")
        if name == "flash_attention":
            check(len(report) == 10 and all(st == ld == 0 for _, _, st, ld
                                            in report),
                  f"flash_attention: ptxas reports spills or not the 10 "
                  f"instances (fp32 / bf16 x D = 16, 32, 64, 112, 128): "
                  f"{report}")
    print(f"[build] {len(SOURCES)} sources built in parallel and loaded "
          f"in {secs:.2f} s")
    return instances


def time_ms(torch, fn, iters):
    """(device ms, host ms) of one call. The device time comes from
    CUDA events around ``iters`` back-to-back calls that the host
    queued while the card was held busy by a spin kernel, so it is the
    card's time and not the host's launch rate; the host time is the
    wall time of queueing one call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # spin 1.5× the queueing time at 2 GHz (the card's clock is at most
    # 1.98 GHz, so the spin lasts at least that long)
    torch.cuda._sleep(int(host_s * iters * 1.5 * 2e9) + 1_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_s * 1e3


def time_cold_ms(torch, fn, iters):
    """Device ms of one call that finds the L2 cache cold: a 256 MiB
    write (five times the H100's 50 MB L2) before each call, and CUDA
    events around the call alone, averaged over ``iters`` calls."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    del flush
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def bound(n, m, p, fused):
    """Least time (ms) for the same work: each input read once, each
    output written once, over the HBM rate; and 2·n·m·P fp32 operations
    over the fp32 peak. The larger of the two, and which one it is."""
    from repro_torch.roofline.constants import HBM_BW, PEAK_FLOPS_FP32
    meta = n * m * (4 + 4 + 1) if fused else n * m * 4
    out = n * p * 4 + (n * 4 if fused else 0)
    bytes_ms = (n * m * p * 4 + meta + out) / HBM_BW * 1e3
    ops_ms = 2 * n * m * p / PEAK_FLOPS_FP32 * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def sketch_bound(n, p, d):
    """Least time (ms) of a sketch of n rows of P entries to d: the rows
    read and the sketches written once over the HBM rate, and 2·n·P·d
    fp32 operations over the fp32 peak (the hash work is not in it).
    The larger of the two, and which one it is."""
    from repro_torch.roofline.constants import HBM_BW, PEAK_FLOPS_FP32
    bytes_ms = (4 * n * p + 4 * n * d) / HBM_BW * 1e3
    ops_ms = 2 * n * p * d / PEAK_FLOPS_FP32 * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def make_case(torch, n, m, p, seed, invalid="some"):
    g = torch.Generator(device="cuda").manual_seed(seed)
    G = torch.randn((n, m, p), generator=g, device="cuda")
    T = torch.rand((n, m), generator=g, device="cuda") * 100 + 1
    R = torch.rand((n, m), generator=g, device="cuda") + 0.1
    if invalid == "none":
        valid = torch.ones((n, m), dtype=torch.bool, device="cuda")
    elif invalid == "all":
        valid = torch.zeros((n, m), dtype=torch.bool, device="cuda")
    else:
        valid = torch.rand((n, m), generator=g, device="cuda") > 0.3
    return G, T, R, valid


def errors(torch, got, want):
    diff = (got - want).abs()
    rel = diff / want.abs().clamp_min(1e-30)
    return float(diff.max()), float(rel.max())


def kernel_phase(torch):
    """Both fp32 share-step kernels against their plain versions,
    bitwise for ḡ and Σw (and within the Pallas kernel's bounds), at the
    main path's shapes and at edge cases: the batch edges m = 1, 5, 33
    and MAX_PIECES, one agent, and each kernel instance. Returns the
    per-kernel numbers of the first shape."""
    from repro_torch.kernels.ddal_wavg import ops, ref
    # (label, n, m, P, invalid pieces, timed)
    cases = [("quickstart share step", 2, 32, 9155, "none", True),
             ("DDADQN share step", 2, 32, 8835, "none", True),
             ("ring n=8 share step", 8, 32, 9155, "some", True),
             ("big ragged plane", 16, 8, 2 ** 20 + 37, "some", True),
             ("single element", 1, 1, 1, "none", False),
             ("some pieces invalid", 3, 32, 9155, "some", False),
             ("every piece invalid", 2, 32, 9155, "all", False),
             # across the kernel's batches, one agent, each instance
             ("one piece", 8, 1, 9155, "some", False),
             ("5 pieces", 8, 5, 9155, "some", False),
             ("33 pieces", 8, 33, 9155, "some", False),
             (f"{ops.MAX_PIECES} pieces (the most)", 1, ops.MAX_PIECES,
              9155, "some", False),
             ("one agent", 1, 32, 9155, "some", False),
             ("12 pieces, two agents", 2, 12, 9155, "some", False),
             ("12 pieces", 8, 12, 9155, "some", False),
             ("12 pieces, big ragged plane", 4, 12, 2 ** 20 + 37, "some",
              False)]
    table, instances = {}, set()
    for label, n, m, p, invalid, timed in cases:
        G, T, R, valid = make_case(torch, n, m, p, seed=n * 31 + m,
                                   invalid=invalid)
        got_g, got_w = ops.fused_wavg(G, T, R, valid)
        want_g, want_w = ref.fused_wavg(G, T, R, valid)
        w = ref.eq4_weights(T, R, valid)
        got_u = ops.wavg(G, w)
        want_u = ref.wavg(G, w)
        torch.cuda.synchronize()
        errs = {"ddal_fused_wavg": errors(torch, got_g, want_g),
                "ddal_wavg": errors(torch, got_u, want_u)}
        w_err = float(((got_w - want_w).abs()
                       / want_w.abs().clamp_min(1e-30)).max())
        bitwise = (torch.equal(got_g, want_g) and torch.equal(got_w, want_w)
                   and torch.equal(got_u, want_u))
        ok = (bitwise and torch.allclose(got_g, want_g, **G_TOL)
              and torch.allclose(got_u, want_u, **G_TOL)
              and torch.allclose(got_w, want_w, rtol=W_RTOL, atol=0.0))
        if invalid == "all":
            ok = ok and not bool(got_g.any()) and not bool(got_w.any())
        geo = ops.wavg_geometry(n, m, p)
        instances.add((geo.batch, geo.items))
        print(f"[kernel] {label} (n, m, P) = ({n}, {m}, {p}), grid "
              f"{geo.blocks} x {n} = {geo.blocks * n} blocks of "
              f"{ops.F32_THREADS} folding threads x {geo.items} positions "
              f"(the fused entry's blocks add a weighing warp), "
              f"{geo.batch}-piece batches: "
              f"fused max abs {errs['ddal_fused_wavg'][0]:.3e} "
              f"rel {errs['ddal_fused_wavg'][1]:.3e}, Σw rel {w_err:.3e}; "
              f"wavg max abs {errs['ddal_wavg'][0]:.3e} "
              f"rel {errs['ddal_wavg'][1]:.3e}; ḡ and Σw bitwise {bitwise}, "
              f"tolerance ḡ rtol=atol=2e-5, Σw rtol 1e-6 -> "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"kernel disagrees with its plain version: {label}")
        if not timed:
            continue
        iters = 200 if n * m * p < 1e8 else 20
        rows = {
            "ddal_fused_wavg": (
                lambda: ops.fused_wavg(G, T, R, valid),
                lambda: ref.fused_wavg(G, T, R, valid), True),
            "ddal_wavg": (lambda: ops.wavg(G, w),
                          lambda: ref.wavg(G, w), False),
        }
        lib_ms, lib_host = time_ms(
            torch, lambda: torch.einsum("nm,nmp->np", w, G), iters)
        for name, (kern, plain, fused) in rows.items():
            ms, host = time_ms(torch, kern, iters)
            plain_ms, plain_host = time_ms(torch, plain,
                                           max(iters // 10, 5))
            b_ms, b_by = bound(n, m, p, fused)
            print(f"[kernel] {label} {name}: device {ms:.5f} ms "
                  f"({b_ms / ms:.1%} of the {b_ms:.5f} ms bound, "
                  f"{b_by}), plain {plain_ms:.5f} ms, einsum "
                  f"{lib_ms:.5f} ms ({ms / lib_ms:.2f}x); host per call: "
                  f"kernel {host:.5f} ms, plain {plain_host:.5f} ms, "
                  f"einsum {lib_host:.5f} ms")
            if label == "quickstart share step":
                table[name] = dict(max_abs_err=errs[name][0], ms=ms,
                                   plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by, library_ms=lib_ms)
    want = {(32, 1), (16, 1), (16, 2), (8, 1), (8, 4)}
    print(f"[kernel] ddal_fused_wavg / ddal_wavg instances (batch, "
          f"positions per thread) run: {sorted(instances)} of "
          f"{sorted(want)}")
    check(instances == want, "not every fp32 kernel instance was held "
                             "against the plain version")
    return table


def _a2c_layout(torch):
    """The paper's A2C (hidden 64) leaf table: P = 9155 in 12 leaves."""
    from repro_torch.common.pytree import PlaneLayout
    from repro_torch.rl import networks
    tree = networks.init_policy_value(torch.Generator().manual_seed(0), 1,
                                      4, 2, 64)
    return PlaneLayout.from_tree(tree, lead=1)


def _dueling_layout(torch):
    """DDADQN's dueling network on CartPole (hidden 64): P = 8835 in 10
    leaves."""
    from repro_torch.common.pytree import PlaneLayout
    from repro_torch.rl import networks
    tree = networks.init_dueling_q(torch.Generator().manual_seed(0), 1, 4,
                                   2, 64)
    return PlaneLayout.from_tree(tree, lead=1)


def sketch_phase(torch):
    """The gradient-sketch kernel against its plain version: signs
    through the kernel (one-hot rows of G give exact rows of S) bitwise,
    sketches within |got − want| ≤ 1e-5·Σ_p |G[r, p]| (and the
    reference's own rtol 1e-4 / atol 1e-3 at its test shapes), two
    launches bitwise equal. Returns the numbers at the main path's
    shape (8, 9155, 256)."""
    from repro_torch.core.relevance import fold_seed
    from repro_torch.kernels.grad_sketch import ops, ref

    p = 9155
    pos = [0, 1, 255, 256, 8191, p - 1]
    G = torch.zeros((len(pos), p), device="cuda")
    G[torch.arange(len(pos)), torch.tensor(pos)] = 1.0
    for offset in (0, 2 ** 31 - 3, 2 ** 32 - 4000):
        for d in (SKETCH_DIM, 100):
            got = ops.sketch_flat(G, 12345, d, offset=offset)
            want = torch.cat([ref.sign_block(12345, offset + q, 1, d, "cuda")
                              for q in pos])
            check(torch.equal(got, want),
                  f"sketch kernel signs differ at offset {offset}, d {d}")
    print(f"[kernel] grad_sketch signs through the kernel at positions "
          f"{pos} + offsets 0, 2^31-3, 2^32-4000 (wrapping), d 256 and "
          f"100: bitwise -> ok")

    seed = fold_seed(0, 100)
    # (label, n, P, d, offset, seed, reference gate, timed)
    cases = [("main path: n=8 agents' rows", 8, p, SKETCH_DIM, 0, seed,
              False, True),
             ("DDADQN main path: n=8 agents' dueling rows", 8, 8835,
              SKETCH_DIM, 0, seed, False, True),
             ("reference test shape", 8, 1024, 128, 11, 7, True, True),
             ("reference test shape", 3, 4097, 256, 11, 7, True, True),
             ("reference test shape", 8, 1000, 128, 11, 7, True, True),
             ("reference test shape", 16, 2048, 384, 11, 7, True, True),
             ("unaligned width", 8, p, 100, 0, seed, False, True),
             ("LLM-scale plane", 16, 2 ** 22 + 37, SKETCH_DIM, 0, seed,
              False, True),
             # the row-block instances' edges and the chunk's
             ("one row", 1, p, SKETCH_DIM, 5, seed, False, False),
             ("9 rows in a 16-row block", 9, p, SKETCH_DIM, 5, seed, False,
              False),
             ("17 rows in two 16-row blocks", 17, p, SKETCH_DIM, 5, seed,
              False, False),
             ("P shorter than one chunk", 8, ops.MIN_CHUNK - 12, SKETCH_DIM,
              3, seed, False, False),
             ("P one chunk + 1", 8, ops.MIN_CHUNK + 1, SKETCH_DIM, 3, seed,
              False, False)]
    row = {}
    for label, n, p_, d, offset, sd, ref_gate, timed in cases:
        g = torch.Generator(device="cuda").manual_seed(n * 7 + d)
        G = torch.randn((n, p_), generator=g, device="cuda")
        got = ops.sketch_flat(G, sd, d, offset=offset)
        again = ops.sketch_flat(G, sd, d, offset=offset)
        want = ref.sketch_flat(G, sd, d, offset=offset)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        gate = 1e-5 * G.abs().sum(dim=1, keepdim=True)
        ok = bool((diff <= gate).all()) and torch.equal(got, again)
        if ref_gate:
            ok = ok and torch.allclose(got, want, rtol=1e-4, atol=1e-3)
        err = float(diff.max())
        geo = ops.sketch_geometry(n, p_, d)
        x, y, z = geo.grid(n, d)
        print(f"[kernel] grad_sketch {label} (n, P, d) = ({n}, {p_}, {d}), "
              f"offset {offset}, {geo.rows}-row blocks, {geo.chunks} chunks "
              f"of {geo.chunk} (grid {x} x {y} x {z} = {x * y * z} blocks, "
              f"second pass {geo.reduce_blocks} blocks): max abs "
              f"{err:.3e}, worst share of the "
              f"1e-5·Σ|G| gate {float((diff / gate).max()):.3f}"
              f"{', reference gate rtol 1e-4 atol 1e-3' if ref_gate else ''}"
              f", two launches bitwise {torch.equal(got, again)} -> "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"sketch kernel disagrees with its plain version: {label}")
        if not timed:
            continue
        big = n * p_ > 1e7
        iters = 20 if big else 200
        ms, host = time_ms(
            torch, lambda: ops.sketch_flat(G, sd, d, offset=offset), iters)
        plain_ms, plain_host = time_ms(
            torch, lambda: ref.sketch_flat(G, sd, d, offset=offset),
            3 if big else 20)
        S = ref.sign_block(sd, offset, p_, d, "cuda")  # outside the timing
        lib_ms, lib_host = time_ms(torch, lambda: torch.matmul(G, S), iters)
        del S
        b_ms, b_by = sketch_bound(n, p_, d)
        print(f"[kernel] grad_sketch {label}: device {ms:.5f} ms "
              f"({b_ms / ms:.1%} of the {b_ms:.5f} ms bound, {b_by}: "
              f"2·n·P·d fp32 flops at 67 TFLOP/s vs 4·n·P bytes at "
              f"3.35 TB/s; the hash work is not in it), plain "
              f"{plain_ms:.5f} ms, torch.matmul(G, S) with S built "
              f"outside the timing (not the same function: S is read, "
              f"not regenerated) {lib_ms:.5f} ms; host per call: kernel "
              f"{host:.5f} ms, plain {plain_host:.5f} ms, matmul "
              f"{lib_host:.5f} ms")
        if not row:
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    return row


def wavg_q_phase(torch):
    """The int8 share-step kernel against its plain version, bitwise for
    ḡ and Σw. Returns the numbers at the main path's shape: n = 8 stores
    of 32 pieces over the A2C's blocks at q_block 128."""
    from repro_torch.common.pytree import PlaneLayout
    from repro_torch.kernels.ddal_wavg import ops, ref
    from repro_torch.roofline.constants import HBM_BW

    a2c = _a2c_layout(torch)
    ragged = PlaneLayout(None, [()], [(2 ** 20 + 37,)])
    # (label, layout, n, m, q_block, invalid pieces, timed)
    cases = [("main path: n=8 ring share step, q_block 128", a2c, 8, 32,
              128, "some", True),
             ("DDADQN main path: n=8 ring share step over the dueling "
              "layout, q_block 128", _dueling_layout(torch), 8, 32, 128,
              "some", True),
             ("q_block 1024", a2c, 8, 32, 1024, "some", True),
             ("every piece invalid", a2c, 8, 32, 128, "all", True),
             ("big ragged plane, q_block 128", ragged, 16, 8, 128, "some",
              True),
             # across the kernel's 32-piece batches, and one agent
             ("one piece", a2c, 8, 1, 128, "some", False),
             ("5 pieces", a2c, 8, 5, 128, "some", False),
             ("33 pieces", a2c, 8, 33, 128, "some", False),
             (f"{ops.MAX_PIECES} pieces (the most)", a2c, 1, ops.MAX_PIECES,
              128, "some", False),
             ("one agent", a2c, 1, 32, 128, "some", False),
             ("12 pieces", a2c, 8, 12, 128, "some", False),
             ("12 pieces, two agents", a2c, 2, 12, 128, "some", False),
             ("12 pieces, big ragged plane", ragged, 4, 12, 128, "some",
              False)]
    row, instances = {}, set()
    for label, layout, n, m, qb, invalid, timed in cases:
        G, T, R, valid = make_case(torch, n, m, layout.size, seed=n + qb,
                                   invalid=invalid)
        blocks = layout.blocks(qb)
        Q, S = ref.quantize_flat(G, blocks)
        del G
        got_g, got_w = ops.fused_wavg_q(Q, S, T, R, valid, blocks)
        want_g, want_w = ref.fused_wavg_q(Q, S, T, R, valid, blocks)
        torch.cuda.synchronize()
        ok = torch.equal(got_g, want_g) and torch.equal(got_w, want_w)
        if invalid == "all":
            ok = ok and not bool(got_g.any()) and not bool(got_w.any())
        err = float((got_g - want_g).abs().max())
        geo = ops.wavg_q_geometry(n, m, layout.size)
        instances.add((geo.batch, geo.items))
        print(f"[kernel] ddal_fused_wavg_q {label} (n, m, P) = ({n}, {m}, "
              f"{layout.size}), {blocks.n_blocks} scale columns, grid "
              f"{geo.blocks} x {n} = {geo.blocks * n} blocks of "
              f"{ops.Q_THREADS} threads x {geo.items} positions, "
              f"{geo.batch}-piece batches: "
              f"max abs {err:.3e}, ḡ and Σw bitwise {ok} -> "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"int8 kernel disagrees with its plain version: {label}")
        if not timed:
            continue
        big = n * m * layout.size > 1e8
        iters = 20 if big else 200
        w = ref.eq4_weights(T, R, valid)
        deq = ref.dequantize_flat(Q, S, blocks)        # outside the timing
        ms, host = time_ms(
            torch, lambda: ops.fused_wavg_q(Q, S, T, R, valid, blocks), iters)
        plain_ms, plain_host = time_ms(
            torch, lambda: ref.fused_wavg_q(Q, S, T, R, valid, blocks),
            max(iters // 10, 5))
        lib_ms, lib_host = time_ms(
            torch, lambda: torch.einsum("nm,nmp->np", w, deq), iters)
        del deq
        nb = blocks.n_blocks
        b_ms = ((n * m * layout.size + n * m * nb * 4 + n * layout.size * 4
                 + n * m * 9 + n * 4) / HBM_BW * 1e3)
        print(f"[kernel] ddal_fused_wavg_q {label}: device {ms:.5f} ms "
              f"({b_ms / ms:.1%} of the {b_ms:.5f} ms bound, bytes: "
              f"n·m·P int8 + n·m·nb·4 scales + n·P·4 out + metadata at "
              f"3.35 TB/s), plain {plain_ms:.5f} ms, torch.einsum over "
              f"planes dequantised outside the timing (no single torch "
              f"call dequantises and reduces) {lib_ms:.5f} ms; host per "
              f"call: kernel {host:.5f} ms, plain {plain_host:.5f} ms, "
              f"einsum {lib_host:.5f} ms")
        if not row:
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by="bytes", library_ms=lib_ms)
    want = {(32, 1), (16, 1), (16, 2), (8, 1), (8, 4)}
    print(f"[kernel] ddal_fused_wavg_q instances (batch, positions per "
          f"thread) run: {sorted(instances)} of {sorted(want)}")
    check(instances == want, "not every int8 kernel instance was held "
                             "against the plain version")
    return row


def stale_kernel_phase(torch):
    """The fused fp32 and int8 share steps on the inputs the robustness
    paths give them, bitwise against their plain versions: T and R
    discounted by 0.95**age (ages 0–8) with pieces past max_staleness 6
    cut (``combiners.age_gate``), quarantined pieces (int8: payload and
    scales zeroed, valid cleared), and agents whose every piece is
    invalid (Σw = 0)."""
    from repro_torch.core import knowledge as K
    from repro_torch.core.exchange.combiners import age_gate
    from repro_torch.kernels.ddal_wavg import ops, ref

    a2c = _a2c_layout(torch)
    n, m, p = 8, 32, a2c.size
    for label in ("fp32", "int8"):
        G, T, R, valid = make_case(torch, n, m, p, seed=71)
        g = torch.Generator(device="cuda").manual_seed(72)
        born = 100 - torch.randint(0, 9, (n, m), generator=g, device="cuda",
                                   dtype=torch.int32)
        quar = torch.rand((n, m), generator=g, device="cuda") < 0.1
        valid = valid & ~quar
        valid[3] = False                                 # an empty store
        scale, blocks = None, None
        if label == "int8":
            blocks = a2c.blocks(QUANT_BLOCK)
            G, scale = ref.quantize_flat(G, blocks)
            scale = torch.where(quar[..., None], 0.0, scale)
        G = torch.where(quar[..., None], torch.zeros((), dtype=G.dtype,
                                                     device="cuda"), G)
        st = K.KnowledgeStore(G, T, R, valid, torch.zeros(
            (n,), dtype=torch.int32, device="cuda"), scale, blocks, born)
        gated = age_gate(st, 100, 6, 0.95)
        cut = int((st.valid & ~gated.valid).sum())
        if label == "int8":
            got = ops.fused_wavg_q(gated.grads, gated.scale, gated.T,
                                   gated.R, gated.valid, blocks)
            want = ref.fused_wavg_q(gated.grads, gated.scale, gated.T,
                                    gated.R, gated.valid, blocks)
        else:
            got = ops.fused_wavg(gated.grads, gated.T, gated.R, gated.valid)
            want = ref.fused_wavg(gated.grads, gated.T, gated.R, gated.valid)
        torch.cuda.synchronize()
        ok = (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
              and not bool(got[0][3].any()) and float(got[1][3]) == 0.0)
        print(f"[kernel] stale {label} share step (n, m, P) = ({n}, {m}, "
              f"{p}): T, R × 0.95**age (ages 0–8), {cut} pieces past "
              f"max_staleness 6 cut, {int(quar.sum())} quarantined, agent "
              f"3 all invalid: ḡ and Σw bitwise against the plain version "
              f"{ok}, Σw of the empty store {float(got[1][3])} -> "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{label} share step disagrees with its plain version on "
                  f"discounted / quarantined / empty stores")


def ssd_instance(dtype, heads):
    """The name ptxas reports for the SSD kernel instance that takes
    ``dtype`` inputs with ``heads`` heads per block."""
    if str(dtype) == "torch.float32":
        return "fp32::ssd_chunk_fp32_kernel"
    return f"tc::ssd_chunk_bf16_mma_kernel<{heads}>"


def _ssd_case(torch, seed, b, nc, l, h, p, n, g, dtype, pad=0):
    """Chunked SSD inputs on the card, drawn as the reference's kernel
    test draws them (x, B, C normal, dt = softplus(normal), A =
    −exp(normal), cs the cumsum of dt·A); x, B, C in ``dtype``. The
    last ``pad`` steps of every chunk are ``ssd_chunked``'s padding:
    dt = 0 and x, B, C zero."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    xc, dtc = normal(b, nc, l, h, p), torch.nn.functional.softplus(
        normal(b, nc, l, h))
    A = -torch.exp(normal(h))
    Bc, Cc = normal(b, nc, l, g, n), normal(b, nc, l, g, n)
    if pad:
        for t in (xc, dtc, Bc, Cc):
            t[:, :, l - pad:] = 0
    cs = torch.cumsum(dtc * A, dim=2)
    return [xc.to(dtype), dtc, cs, Bc.to(dtype), Cc.to(dtype)]


def ssd_kernel_phase(torch, built):
    """The SSD intra-chunk kernels against their plain version: the
    reference's three test shapes within its rtol = atol = 2e-5; the
    main path's shape in fp32 and bf16, ragged shapes, a dt = 0 padded
    chunk and the bf16 kernel's edges (SSD_BF16_EDGES) within SSD_GATE ·
    Σ_j (|C_i|·|B_j|)·L_ij·dt_j·|x_jp| per element (the plain version on
    |x|, |B|, |C|: the sum of the absolute values of the terms both add,
    in other orders); every case launched twice, bitwise equal; every
    kernel instance ptxas reported (``built``) run. Returns the numbers
    at the main path's (bn, h, l, p, n) = (8, 48, 256, 64, 128) in
    bf16."""
    from repro_torch.configs.base import NotPortedError
    from repro_torch.kernels.ssd_scan import ops, ref
    f32, bf16 = torch.float32, torch.bfloat16
    # no backward on the card: a call autograd would record raises
    # rather than drop the gradient of the intra-chunk term
    outcomes = []
    for which in range(5):
        args = _ssd_case(torch, 99, 1, 1, 32, 2, 16, 16, 2, f32)
        args[which].requires_grad_(True)
        launches = ops.ssd_intra_chunk.launches
        try:
            ops.ssd_intra_chunk(*args)
            raised = False
        except NotPortedError:
            raised = True
        refused = raised and ops.ssd_intra_chunk.launches == launches
        with torch.no_grad():
            ran = ops.ssd_intra_chunk(*args)
        outcomes.append(refused and ops.ssd_intra_chunk.launches
                        == launches + 1 and bool(torch.isfinite(ran).all()))
    ok = all(outcomes)
    print(f"[kernel] ssd_intra_chunk with x, dt, cs, B or C requiring grad "
          f"under grad mode: NotPortedError and no launch in "
          f"{sum(outcomes)} of 5, and each call runs under "
          f"torch.no_grad() -> {'ok' if ok else 'FAIL'}")
    check(ok, "ssd_intra_chunk ran with an input that requires grad, which "
              "would drop that input's gradient")
    # (label, (b, nc, l, h, p, n, g), dtype, pad, reference gate, timed)
    cases = [("reference test shape", (2, 2, 32, 3, 16, 16, 3), f32, 0,
              True, False),
             ("reference test shape", (1, 4, 64, 2, 32, 64, 2), f32, 0,
              True, False),
             ("reference test shape", (2, 1, 128, 4, 64, 128, 4), f32, 0,
              True, False),
             ("main path, bf16", (2, 4, 256, 48, 64, 128, 1), bf16, 0,
              False, True),
             ("main path, fp32", (2, 4, 256, 48, 64, 128, 1), f32, 0,
              False, True),
             ("dt = 0 padding (70 of 256 steps)", (1, 2, 256, 48, 64, 128,
                                                   1), bf16, 70, False,
              False),
             ("ragged l, p, n; 3 groups", (1, 3, 100, 6, 40, 48, 3), f32,
              0, False, False),
             ("dt = 0 padding at the main path's shape", (2, 4, 256, 48, 64,
                                                         128, 1), bf16, 70,
              False, False),
             ("the slot engines' B = 1 prefill, nc = 1", (1, 1, 256, 48, 64,
                                                         128, 1), bf16, 0,
              False, False),
             ("the slot engines' B = 1 prefill, nc = 4", (1, 4, 256, 48, 64,
                                                         128, 1), bf16, 0,
              False, False),
             (ZAMBA_SSD_LABEL, (2, 16, 256, 112, 64, 64, 1), bf16, 0,
              False, True),
             ("zamba2-7b prefill, n = 64", (2, 4, 256, 112, 64, 64, 1),
              bf16, 0, False, False)] + [
        (label, shape, bf16, 0, False, True)
        for label, shape in SSD_LOCAL_HEADS] + [
        (f"bf16 {label}", shape, bf16, 0, False, False)
        for label, shape in SSD_BF16_EDGES]
    row, instances_run = {}, set()
    for seed, (label, shape, dtype, pad, ref_gate, timed) in enumerate(
            cases):
        b, nc, l, h, p, n, g = shape
        args = _ssd_case(torch, seed, b, nc, l, h, p, n, g, dtype, pad)
        got = ops.ssd_intra_chunk(*args)
        again = ops.ssd_intra_chunk(*args)
        want = ref.ssd_intra_chunk(*args)
        xc, dtc, cs, Bc, Cc = args
        scale = ref.ssd_intra_chunk(xc.abs(), dtc, cs, Bc.abs(), Cc.abs())
        torch.cuda.synchronize()
        diff = (got - want).abs()
        share = float((diff / (SSD_GATE * scale).clamp_min(1e-30)).max())
        bitwise = torch.equal(got, again)
        ok = bool((diff <= SSD_GATE * scale).all()) and bitwise
        if ref_gate:
            ok = ok and torch.allclose(got, want, rtol=2e-5, atol=2e-5)
        if pad:
            ok = ok and not bool(got[:, :, l - pad:].any())
        err = float(diff.max())
        geo = ops.ssd_geometry(b * nc, l, h, g, dtype)
        instances_run.add(ssd_instance(dtype, geo.heads))
        gx, gy, gz = geo.grid
        print(f"[kernel] ssd_intra_chunk {label} (b·nc, h, l, p, n, g) = "
              f"({b * nc}, {h}, {l}, {p}, {n}, {g}) {str(dtype)[6:]}, "
              f"{ssd_instance(dtype, geo.heads)} grid {gx} x {gy} x {gz}: "
              f"max abs {err:.3e}, worst share of the "
              f"{SSD_GATE:g}·Σ|terms| gate {share:.4f}"
              f"{', reference gate rtol=atol=2e-5' if ref_gate else ''}"
              f"{', padded rows exactly 0' if pad else ''}, two launches "
              f"bitwise {bitwise} -> {'ok' if ok else 'FAIL'}")
        check(ok, f"ssd kernel disagrees with its plain version: {label} "
                  f"{shape} {dtype}")
        if not timed:
            continue
        bn = b * nc
        ms, host = time_ms(torch, lambda: ops.ssd_intra_chunk(*args), 50)
        plain_ms, plain_host = time_ms(
            torch, lambda: ref.ssd_intra_chunk(*args), 10)
        # the plain version's two matmuls, per head as it computes them,
        # with the operands laid out and the mask L·dt built outside
        heads = [ref.heads_of(t, h).float().movedim(3, 2).reshape(
            bn, h, l, n) for t in (Cc, Bc)]
        Ch, BhT = heads[0].contiguous(), heads[1].transpose(-1, -2) \
            .contiguous()
        Xh = xc.float().movedim(3, 2).reshape(bn, h, l, p).contiguous()
        csh = cs.movedim(3, 2).reshape(bn, h, l)
        L = torch.where(torch.ones(l, l, dtype=torch.bool, device="cuda")
                        .tril(), torch.exp(csh[..., :, None]
                                           - csh[..., None, :]), 0.0)
        M = L * dtc.movedim(3, 2).reshape(bn, h, l)[..., None, :]
        del L
        lib_ms, lib_host = time_ms(
            torch, lambda: torch.matmul(torch.matmul(Ch, BhT) * M, Xh), 50)
        del Ch, BhT, Xh, M
        esize = xc.element_size()
        b_ms, b_by = ops.ssd_bound(bn, l, h, p, n, g, esize)
        if esize == 2:
            cold = time_cold_ms(torch, lambda: ops.ssd_intra_chunk(*args),
                                50)
            old_ms, old_by = ops.ssd_bound(bn, l, h, p, n, g, esize,
                                           split_sx=False)
            pricing = (f"C·Bᵀ once per (chunk, group) and S_hi·x + S_lo·x "
                       f"at 989 TFLOP/s bf16, the decay at 67 TFLOP/s "
                       f"fp32; priced with S·x at the fp32 rate, as for the "
                       f"CUDA-core kernel: {old_ms:.5f} ms, {old_by}); with "
                       f"the L2 flushed before each launch {cold:.5f} ms "
                       f"({b_ms / cold:.1%} of the bound")
        else:
            pricing = "every product at 67 TFLOP/s fp32"
        print(f"[kernel] ssd_intra_chunk {label}: device {ms:.5f} ms "
              f"({b_ms / ms:.1%} of the {b_ms:.5f} ms bound, {b_by}: on the "
              f"causal half, {pricing}), plain {plain_ms:.5f} ms, the plain "
              f"version's two torch.matmuls per head, fp32, mask built "
              f"outside the timing {lib_ms:.5f} ms ({ms / lib_ms:.2f}x); "
              f"host per call: kernel {host:.5f} ms, plain "
              f"{plain_host:.5f} ms, matmuls {lib_host:.5f} ms")
        numbers = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        if not row:
            row = numbers
        elif label == ZAMBA_SSD_LABEL:
            row["zamba2"] = numbers
        elif label in dict(SSD_LOCAL_HEADS):
            row.setdefault("rank_heads", {})[label] = numbers
    per_sm = {k: ops.blocks_per_sm(k) for k in range(1, ops.MAX_HEADS + 1)}
    print(f"[kernel] ssd_intra_chunk instances run: "
          f"{sorted(instances_run)}; bf16 blocks one SM holds, by heads a "
          f"block: {per_sm}")
    check(instances_run == built,
          f"not every SSD kernel instance was held against the plain "
          f"version: ran {sorted(instances_run)}, built {sorted(built)}")
    check(all(per_sm[k] >= ops.BLOCKS_PER_SM[k] for k in per_sm),
          f"an SM holds fewer bf16 SSD blocks than ssd_geometry plans "
          f"({ops.BLOCKS_PER_SM}): {per_sm}")
    return row


def _fa_within_gate(torch, got, want):
    """fp32: the reference's rtol = atol = 2e-5. bf16: kernel and plain
    version both compute in fp32 and round the output once, so they may
    land one bf16 unit apart where the fp32 values straddle a rounding
    boundary: |got − want| ≤ 2^-7·|want| + 2e-5."""
    if got.dtype == torch.float32:
        return torch.allclose(got, want, **FA_TOL)
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= 2.0 ** -7 * w.abs() + 2e-5).all())


def _flash_cases(torch, cases):
    """Each case's kernel against the plain version: within its gate,
    launched twice, bitwise equal; the timed ones beside the plain
    version, ``scaled_dot_product_attention`` and the bound. Returns
    the numbers of the first timed case."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref
    f32, bf16 = torch.float32, torch.bfloat16
    row = {}
    for seed, (label, (B, S, H, K, D), window, dtype, timed) in enumerate(
            cases):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for shape in ((B, S, H, D), (B, S, K, D), (B, S, K, D)))
        got = ops.flash_attention(q, k, v, window=window)
        again = ops.flash_attention(q, k, v, window=window)
        want = ref.attention(q, k, v, window=window)
        torch.cuda.synchronize()
        bitwise = torch.equal(got, again)
        ok = _fa_within_gate(torch, got, want) and bitwise
        err = float((got.float() - want.float()).abs().max())
        gate = ("rtol=atol=2e-5" if dtype == f32
                else "2^-7·|want| + 2e-5 (one bf16 unit)")
        print(f"[kernel] flash_attention {label} (B, S, H, K, D) = "
              f"({B}, {S}, {H}, {K}, {D}) {str(dtype)[6:]}: max abs "
              f"{err:.3e}, gate {gate}, two launches bitwise {bitwise} -> "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"flash kernel disagrees with its plain version: {label} "
                  f"{(B, S, H, K, D)} {dtype}")
        del want
        if not timed:
            continue
        ms, host = time_ms(torch, lambda: ops.flash_attention(
            q, k, v, window=window), 20)
        plain_ms, plain_host = time_ms(torch, lambda: ref.attention(
            q, k, v, window=window), 3)
        # the yardstick in the (B, H, S, D) layout it takes, GQA by its
        # own flag (torch >= 2.5), the window as a boolean mask built
        # outside the timing
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = None
        if window is not None:
            i = torch.arange(S, device="cuda")[:, None]
            j = torch.arange(S, device="cuda")[None, :]
            mask = (j <= i) & (i - j < window)
        lib_ms, lib_host = time_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True), 20)
        del qt, kt, vt, mask
        b_ms, b_by = ops.flash_bound(B, S, H, K, D, window,
                                     q.element_size())
        mma = ops.flash_mma_flops(B, S, H, D, window, dtype == bf16)
        work = ("q·kᵀ + p_hi·v + p_lo·v at 989 TFLOP/s bf16" if dtype == bf16
                else "q·kᵀ + p·v at 67 TFLOP/s fp32")
        print(f"[kernel] flash_attention {label} {str(dtype)[6:]}: device "
              f"{ms:.5f} ms ({b_ms / ms:.1%} of the {b_ms:.5f} ms bound, "
              f"{b_by}: {work} over the kept pairs), "
              f"{mma / ms / 1e9:.1f} TFLOP/s over the {mma / 1e9:.1f} GFLOP "
              f"of the tiles it visits, plain {plain_ms:.5f} ms, "
              f"scaled_dot_product_attention ({str(dtype)[6:]}, enable_gqa"
              f"{', window as a mask' if window else ', is_causal'}) "
              f"{lib_ms:.5f} ms; host per call: kernel {host:.5f} ms, "
              f"plain {plain_host:.5f} ms, sdpa {lib_host:.5f} ms")
        if not row:
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    return row


def flash_kernel_phase(torch):
    """The flash-attention kernels against their plain version: the
    scoring path's shape in bf16 (the tensor-core kernel) and fp32 (the
    CUDA-core kernel), a window of 512 at S = 4096, windows smaller than
    a tile and across 128-row tiles, ragged S, MQA, D = 16, 32 and 64,
    each within its gate and launched twice, bitwise equal; then the
    blocks per SM of every instance. Returns the numbers at the scoring
    path's (B, S, H, K, D) = (2, 4096, 24, 8, 128) in bf16."""
    from repro_torch.kernels.flash_attention import ops
    f32, bf16 = torch.float32, torch.bfloat16
    # (label, (B, S, H, K, D), window, dtype, timed)
    path = (SCORE_B, SCORE_S, 24, 8, 128)
    cases = [("scoring path", path, None, bf16, True),
             ("scoring path", path, None, f32, True),
             ("window 512", path, 512, bf16, True),
             ("window 512", (1, SCORE_S, 24, 8, 128), 512, f32, False),
             ("window 5, smaller than a tile", (1, 300, 4, 2, 128), 5, f32,
              False),
             ("window 40", (2, 300, 4, 2, 64), 40, bf16, False),
             ("ragged S = 4000", (1, 4000, 24, 8, 128), None, bf16, False),
             ("ragged S = 80", (2, 80, 4, 4, 32), None, f32, False),
             ("MQA, D = 64", (2, 513, 8, 1, 64), None, f32, False),
             ("MQA, D = 64", (2, 513, 8, 1, 64), None, bf16, False),
             ("D = 16, one token", (1, 1, 2, 1, 16), None, f32, False),
             ("S = 129, one row past a 128-row tile", (1, 129, 4, 2, 128),
              None, bf16, False),
             ("window 127 across 128-row tiles", (1, 700, 4, 2, 128), 127,
              bf16, False),
             ("D = 16", (2, 333, 6, 3, 16), None, bf16, False),
             ("D = 32, window 100", (2, 333, 6, 3, 32), 100, bf16, False)]
    row = _flash_cases(torch, cases)
    print("[kernel] flash_attention blocks per SM (256 threads each): "
          + ", ".join(f"{str(dt)[6:]} D = {D} {ops.blocks_per_sm(dt, D)}"
                      for dt in (f32, bf16) for D in ops.HEAD_DIMS))
    return row


def flash_d112_phase(torch):
    """[kernel] flash_attention D=112, zamba2-7b's shared block: its
    scoring shape (B, S, H, K, D) = (2, 4096, 32, 32, 112) in bf16 (the
    tensor-core kernel: 7 k-steps, 14 output n-tiles) and fp32 (the
    CUDA-core kernel: 7 columns a thread, one at a time), a ragged
    S = 4000, a window of 512 and GQA (32, 8), each within the flash
    gates and launched twice, bitwise equal; the bf16 scoring shape
    timed beside the plain version, ``scaled_dot_product_attention``
    and the bound; the blocks one SM holds of both D = 112 instances.
    Returns the numbers of the bf16 scoring shape."""
    from repro_torch.kernels.flash_attention import ops
    f32, bf16 = torch.float32, torch.bfloat16
    path = (SCORE_B, SCORE_S, 32, 32, 112)
    row = _flash_cases(torch, [
        ("D=112 zamba2-7b scoring", path, None, bf16, True),
        ("D=112 zamba2-7b scoring", path, None, f32, True),
        ("D=112 ragged S = 4000", (1, 4000, 32, 32, 112), None, bf16, False),
        ("D=112 window 512", path, 512, bf16, False),
        ("D=112 window 512", (1, 1100, 32, 32, 112), 512, f32, False),
        ("D=112 GQA (32, 8)", (SCORE_B, SCORE_S, 32, 8, 112), None, bf16,
         False),
        ("D=112 GQA (32, 8)", (1, 700, 32, 8, 112), None, f32, False)])
    per_sm = {str(dt)[6:]: ops.blocks_per_sm(dt, 112) for dt in (f32, bf16)}
    print(f"[kernel] flash_attention D=112 blocks per SM (256 threads "
          f"each): {per_sm}")
    check(all(n >= 1 for n in per_sm.values()),
          f"a D = 112 flash instance does not fit an SM: {per_sm}")
    return row


def flash_gqa8_phase(torch):
    """[kernel] flash_attention GQA 8, qwen3-moe-30b-a3b's attention: its
    scoring shape (B, S, H, K, D) = (2, 4096, 32, 4, 128) in bf16 (8
    query heads on each kv head, a ratio no earlier path runs), timed
    beside the plain version, ``scaled_dot_product_attention`` and the
    bound; a ragged S = 4000, a window of 512 and fp32, each within the
    flash gates and launched twice, bitwise equal. Returns the numbers
    of the bf16 scoring shape."""
    f32, bf16 = torch.float32, torch.bfloat16
    path = (SCORE_B, SCORE_S, 32, 4, 128)
    return _flash_cases(torch, [
        ("GQA 8 qwen3-moe-30b-a3b scoring", path, None, bf16, True),
        ("GQA 8 ragged S = 4000", (1, 4000, 32, 4, 128), None, bf16, False),
        ("GQA 8 window 512", (1, 1100, 32, 4, 128), 512, bf16, False),
        ("GQA 8", (1, 1100, 32, 4, 128), None, f32, False)])


def flash_h64_phase(torch):
    """[kernel] flash_attention H=64 GQA 8, qwen2-vl-72b's attention: its
    scoring shape (B, S, H, K, D) = (2, 4096, 64, 8, 128) in bf16 (64
    query heads, twice the widest earlier path), timed beside the plain
    version, ``scaled_dot_product_attention`` and the bound; a ragged
    S = 4000 and fp32, each within the flash gates and launched twice,
    bitwise equal. Returns the numbers of the bf16 scoring shape."""
    f32, bf16 = torch.float32, torch.bfloat16
    return _flash_cases(torch, [
        ("H=64 GQA 8 qwen2-vl-72b scoring", (SCORE_B, SCORE_S, 64, 8, 128),
         None, bf16, True),
        ("H=64 GQA 8 ragged S = 4000", (1, 4000, 64, 8, 128), None, bf16,
         False),
        ("H=64 GQA 8", (1, 1100, 64, 8, 128), None, f32, False)])


def flash_d64_mha_phase(torch):
    """[kernel] flash_attention D=64 MHA, musicgen-medium's attention: its
    scoring shape (B, S, H, K, D) = (2, 1500, 24, 24, 64) in bf16 (30 s
    of frames at 50 Hz, a ragged S: 1500 = 11 tiles of 128 + 92), timed
    beside the plain version, ``scaled_dot_product_attention`` and the
    bound, and in fp32; a ragged S = 1000, each within the flash gates
    and launched twice, bitwise equal. Returns the numbers of the bf16
    scoring shape."""
    f32, bf16 = torch.float32, torch.bfloat16
    path = (SCORE_B, MUSICGEN_FRAMES, 24, 24, 64)
    return _flash_cases(torch, [
        ("D=64 MHA musicgen-medium scoring", path, None, bf16, True),
        ("D=64 MHA musicgen-medium scoring", path, None, f32, True),
        ("D=64 MHA ragged S = 1000", (1, 1000, 24, 24, 64), None, bf16,
         False)])


def _mean(x):
    return float(x.float().mean()) if x.numel() else float("nan")


SLICE2_SPEC = dict(relevance_mode="grad_cos", relevance_ema=0.9,
                   relevance_sketch_dim=SKETCH_DIM,
                   knowledge_quant_block=QUANT_BLOCK)
# the robustness paths: relevance-aware gossip; elastic membership over a
# faulty transport with a staleness cutoff; DDADQN with obs_stats
# relevance on resampled gossip
TOPK_SPEC = dict(topology="random_k", degree=4, resample_every=10,
                 exchange_schedule="relevance_topk", explore_eps=0.1,
                 **SLICE2_SPEC)
FAULTY_SPEC = dict(topology="ring", elastic=True, transport_loss=0.2,
                   transport_corrupt=0.05, transport_retransmit=2,
                   transport_jitter=1, transport_dup=0.05, max_staleness=8,
                   transport_decay=0.95)
CHAOS = dict(kill_prob=0.05, revive_after=3)
OBS_SPEC = dict(topology="random_k", degree=3, resample_every=10,
                exchange_estimator="obs_stats")


def _dqn_config():
    from repro_torch.rl.dqn import DQNConfig
    return DQNConfig(eps_decay=DQN_EPS_DECAY)


def _watch_combine(torch, ddal):
    """Counts, on the device, the agents of each update epoch whose
    store weighed nothing (Σw = 0: the local fallback, or a hold),
    alive agents only; returns the counters."""
    seen = {"updates": 0, "local": torch.zeros((), dtype=torch.int64,
                                               device="cuda")}
    combine = ddal.exchange.combine

    def watched(stores, rel, step):
        gbar, wsum = combine(stores, rel, step)
        alive = ddal._alive_dev[1] if ddal.elastic else None
        empty = wsum <= 0
        if alive is not None:
            empty = empty & alive
        seen["updates"] += int(wsum.numel() if alive is None
                               else ddal._alive_dev[0].sum())
        seen["local"] += empty.sum()
        return gbar, wsum

    ddal.exchange.combine = watched
    return seen


def _run_chaos(ddal, gs, gen, epochs, plan):
    """``epochs`` epochs with the membership events of ``plan`` applied
    between them; returns (gs, {"return": (epochs, n)})."""
    import torch
    from repro_torch.core.chaos import membership_events
    events = {e: (k, r) for e, k, r in membership_events(plan[:epochs])}
    rets = []
    for e in range(epochs):
        if e in events:
            kill, revive = events[e]
            if kill.any():
                gs = ddal.kill(gs, kill)
            if revive.any():
                gs = ddal.revive(gs, revive)
        gs, m = ddal.epoch_step(gs, gen)
        rets.append(m["return"])
    return gs, {"return": torch.stack(rets)}


def main_path_phase(torch, epochs=EPOCHS):
    """The main path at the paper's width, through the entry points a
    user calls: DDA3C (A2C) and DDADQN (dueling double DQN) groups on
    CartPole-v0. Each path's launch counts are zeroed just before its
    run and read just after; returns {kernel: {path: launches}} over the
    paths that drive each kernel."""
    from repro_torch import optim
    from repro_torch.configs.base import GroupSpec
    from repro_torch.core import transport
    from repro_torch.core.chaos import chaos_schedule
    from repro_torch.core.ddal import DDAL
    from repro_torch.rl.a2c import init_a2c, make_a2c_callbacks, \
        make_a2c_group
    from repro_torch.rl.dqn import make_dqn_group
    from repro_torch.rl.envs import CartPole

    env = CartPole()
    ring = dict(n_agents=8, threshold=epochs // 3, minibatch=50,
                m_pieces=32, topology="ring", exchange_delay="uniform",
                max_delay=2)
    robust = dict(threshold=epochs // 3, minibatch=50, m_pieces=32)
    plan = chaos_schedule(1, 8, epochs, **CHAOS)
    full2 = dict(n_agents=2, threshold=epochs // 3, minibatch=50,
                 m_pieces=32, topology="full")
    cfg = _dqn_config()

    def a2c(spec, gen):
        return make_a2c_group(env, optim.adamw(3e-3), spec, gen)

    def legacy(spec, gen):
        opt = optim.adamw(3e-3)
        astates, layout = init_a2c(gen, spec.n_agents, env, opt)
        ddal = DDAL(spec, *make_a2c_callbacks(env, opt, layout),
                    use_wavg_kernel=True)
        return ddal, ddal.init(astates)

    def dqn(spec, gen):
        return make_dqn_group(env, optim.adamw(1e-3), spec, gen, cfg)

    # (label, spec, epochs, group constructor, P, membership plan)
    runs = [
        ("n=2 full", GroupSpec(**full2), epochs, a2c, 9155, None),
        ("n=8 ring, uniform delay 2", GroupSpec(**ring), epochs, a2c, 9155,
         None),
        ("n=2 full, legacy wavg", GroupSpec(
            n_agents=2, threshold=epochs // 6, minibatch=25, m_pieces=32,
            topology="full"), epochs // 2, legacy, 9155, None),
        ("n=8 ring, uniform delay 2, sketch 256, int8 128",
         GroupSpec(**ring, **SLICE2_SPEC), epochs, a2c, 9155, None),
        ("dqn n=2 full", GroupSpec(**full2), epochs, dqn, 8835, None),
        ("dqn n=8 ring, uniform delay 2, sketch 256, int8 128",
         GroupSpec(**ring, **SLICE2_SPEC), epochs, dqn, 8835, None),
        ("(a) n=8 relevance_topk k=4 every 10, eps 0.1, sketch 256, "
         "int8 128", GroupSpec(n_agents=8, **robust, **TOPK_SPEC), epochs,
         a2c, 9155, None),
        ("(b) n=8 ring, elastic (chaos 0.05, back after 3), faulty "
         "transport, max_staleness 8, decay 0.95",
         GroupSpec(n_agents=8, **robust, **FAULTY_SPEC), epochs, a2c, 9155,
         plan),
        ("(c) dqn n=4 obs_stats, dynamic k=3 every 10",
         GroupSpec(n_agents=4, **robust, **OBS_SPEC), epochs, dqn, 8835,
         None),
    ]
    by_path = {name: {} for name in KERNELS}
    for label, spec, n_epochs, build, p, chaos in runs:
        gen = torch.Generator(device="cuda").manual_seed(0)
        ddal, gs = build(spec, gen)
        seen = _watch_combine(torch, ddal)
        mismatches = torch.zeros((), dtype=torch.int64, device="cuda")
        checksum_ok = transport.checksum_ok

        def counted_ok(carried, recomputed):
            nonlocal mismatches
            ok = checksum_ok(carried, recomputed)
            mismatches = mismatches + (~ok).sum()
            return ok

        transport.checksum_ok = counted_ok
        tables = set()
        table_of = ddal.exchange.schedule.refresh

        def refresh(step, nbr, rel, alive=None):
            out = table_of(step, nbr, rel, alive)
            tables.add(out.tobytes())
            return out

        ddal.exchange.schedule.refresh = refresh
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        try:
            if chaos is None:
                gs, metrics = ddal.run(gs, gen, n_epochs)
            else:
                gs, metrics = _run_chaos(ddal, gs, gen, n_epochs, chaos)
            torch.cuda.synchronize()
        finally:
            transport.checksum_ok = checksum_ok
        secs = time.perf_counter() - t0
        launched = launch_counts()
        shares = sum(1 for e in range(spec.threshold, n_epochs)
                     if e % spec.minibatch == 0)
        # the estimator skips warm-up epochs (the reference computes and
        # discards them), so it sketches once per sharing epoch
        sharing = n_epochs - spec.threshold
        ret = metrics["return"]
        params = gs.agent_states.params
        pre, post = ret[:spec.threshold], ret[spec.threshold:]
        print(f"[main] {label}: {n_epochs} epochs in {secs:.2f} s "
              f"({n_epochs / secs:.2f} epochs/s), share steps {shares}, "
              f"sharing epochs {sharing}, launches "
              + ", ".join(f"{k} {v}" for k, v in launched.items())
              + f", mean return {_mean(pre):.2f} before sharing -> "
              f"{_mean(post):.2f} after (last 100: {_mean(ret[-100:]):.2f})"
              f", params {tuple(params.shape)}; update epochs whose store "
              f"weighed nothing (alive agents): {int(seen['local'])} of "
              f"{seen['updates']} agent updates "
              f"({int(seen['local']) / max(seen['updates'], 1):.1%}, "
              f"{'local fallback' if ddal.local_fallback else 'held'})")
        if build is legacy:
            want = {"ddal_wavg": shares}
        elif spec.knowledge_quant_block:
            want = {"ddal_fused_wavg_q": shares, "grad_sketch": sharing}
        else:
            want = {"ddal_fused_wavg": shares}
        want = {name: want.get(name, 0) for name in KERNELS}
        check(shares > 0 and launched == want,
              f"{label}: launches {launched} != {want} for {shares} "
              f"share steps and {sharing} sharing epochs")
        check(bool(torch.isfinite(ret).all())
              and bool(torch.isfinite(params).all())
              and params.shape == (spec.n_agents, p),
              f"{label}: non-finite returns / params or wrong shape")
        if build is dqn:
            st = gs.agent_states
            size = st.replay.size
            print(f"[main] {label}: replay sizes {size.tolist()} "
                  f"(minibatch {cfg.batch}), updates {st.step.tolist()}, "
                  f"ε {float(metrics['epsilon'][-1, 0]):.4f} at the end, "
                  f"target params finite "
                  f"{bool(torch.isfinite(st.target_params).all())}")
            check(bool(torch.isfinite(st.target_params).all())
                  and bool((size >= cfg.batch).all()),
                  f"{label}: non-finite target params, or a replay ring "
                  f"below one minibatch (no real gradient)")
        if spec.relevance_sketch_dim:
            rel = gs.relevance
            off = rel[~torch.eye(spec.n_agents, dtype=torch.bool,
                                 device=rel.device)]
            print(f"[main] {label}: learned relevance off the diagonal "
                  f"min {float(off.min()):.4f} max {float(off.max()):.4f}, "
                  f"stores {gs.stores.grads.dtype} with "
                  f"{gs.stores.scale.shape[-1]} scale columns")
            check(bool(torch.isfinite(rel).all())
                  and bool((rel >= 1e-3).all()) and bool((rel <= 1).all())
                  and bool((off < 1).any()),
                  f"{label}: learned relevance not finite, outside "
                  f"[1e-3, 1], or never learned")
        if ddal.exchange.schedule.resamples:
            nbr = gs.nbr
            rows_ok = all(len(set(r)) == len(r) for r in nbr.tolist())
            rounds = -(-n_epochs // spec.resample_every)
            print(f"[main] {label}: {len(tables)} distinct gossip tables "
                  f"over {rounds} resample rounds; last table "
                  f"{nbr.tolist()}")
            check(rows_ok and bool((nbr[:, 0] == range(len(nbr))).all())
                  and len(tables) > 1,
                  f"{label}: a gossip table repeats a source, loses its "
                  f"self-loop, or never moved")
        if spec.exchange_estimator == "obs_stats":
            st = gs.relevance
            rel = st.rel
            off = rel[~torch.eye(spec.n_agents, dtype=torch.bool,
                                 device=rel.device)]
            print(f"[main] {label}: obs_stats relevance off the diagonal "
                  f"min {float(off.min()):.4f} max {float(off.max()):.4f}, "
                  f"observations per agent {st.count.tolist()}")
            check(bool(torch.isfinite(rel).all()) and bool((off > 0).all())
                  and bool((off <= 1).all())
                  and bool((st.count > 0).all()),
                  f"{label}: obs_stats relevance not finite or outside "
                  f"(0, 1], or no observation counted")
        if ddal.transport is not None:
            from repro_torch.core.transport import CORRUPT_BIAS
            tp = ddal.transport
            import numpy as np
            foreign = gs.nbr != np.arange(spec.n_agents)[:, None]
            corrupt = sum(int((tp.at(e).corrupt & foreign).sum())
                          for e in range(spec.threshold, n_epochs))
            kills = int((chaos[:-1] & ~chaos[1:]).sum())
            revives = int((~chaos[:-1] & chaos[1:]).sum())
            big = float(gs.stores.grads.abs().max())
            print(f"[main] {label}: {kills} kills and {revives} revivals "
                  f"({int((~chaos).sum())} dead agent-epochs), "
                  f"{corrupt} corrupted sends planned over the sharing "
                  f"epochs (self-loops exempt, dead agents' included), "
                  f"{int(mismatches)} checksum mismatches at delivery "
                  f"(quarantined), delay line of {tp.extra_delay} extra "
                  f"planes; largest |piece| in a store {big:.3e}; alive "
                  f"at the end {gs.alive.astype(int).tolist()}")
            check(big < CORRUPT_BIAS / 2 and int(mismatches) > 0
                  and bool((gs.alive == chaos[n_epochs - 1]).all()),
                  f"{label}: a corrupted piece reached a store, nothing "
                  f"was quarantined, or membership drifted from the plan")
        for name, count in want.items():
            if count:
                by_path[name][label] = launched[name]
    return by_path


def equivalence_phase(torch):
    """The card against the port's CPU path on small groups with seeded
    gradients, so both see the same inputs: every delay-line write,
    delivery, kernel share step and AdamW update, with the parameters
    held at rtol 1e-5 (the card's fp32 transcendentals may round
    differently). fp32: stores bitwise. Learned sketched relevance and
    int8 planes: int8 stores and scales bitwise, the relevance (sketch
    kernel on the card, plain projection on the CPU, summed in another
    order) within atol 1e-6."""
    import numpy as np
    from repro_torch import optim
    from repro_torch.configs.base import GroupSpec
    from repro_torch.core.ddal import DDAL
    from repro_torch.rl.a2c import init_a2c, make_a2c_callbacks
    from repro_torch.rl.envs import CartPole

    base = dict(n_agents=4, threshold=2, minibatch=2, m_pieces=4,
                topology="ring", exchange_delay="uniform", max_delay=1)
    rng = np.random.default_rng(0)
    grads = rng.normal(size=(12, 4, 9155)).astype(np.float32)
    for label, spec in (
            ("ring n=4, delay 1", GroupSpec(**base)),
            ("ring n=4, delay 1, sketch 256, int8 128",
             GroupSpec(**base, **SLICE2_SPEC))):
        results = {}
        for dev in ("cpu", "cuda"):
            opt = optim.adamw(3e-3)
            astates, layout = init_a2c(torch.Generator().manual_seed(0), 4,
                                       CartPole(), opt)
            astates = type(astates)(
                astates.params.to(dev),
                {k: v.to(dev) for k, v in astates.opt_state.items()},
                astates.step.to(dev))
            _, apply_grads, params_of = make_a2c_callbacks(CartPole(), opt,
                                                           layout)
            calls = []

            def gen_grads(state, gen, dev=dev, calls=calls):
                g = torch.from_numpy(grads[len(calls) % 12]).to(dev)
                calls.append(1)
                return g, {"return": g.sum(-1)}, state

            ddal = DDAL(spec, gen_grads, apply_grads, params_of,
                        device=dev, layout=layout)
            gs = ddal.init(astates)
            reset_launches()
            gs, _ = ddal.run(gs, None, 9)
            check(launch_counts()["flash_attention"] == 0,
                  f"{label} on {dev}: the DDA3C path launched "
                  f"flash_attention")
            results[dev] = [gs.agent_states.params.cpu(),
                            gs.stores.grads.cpu(), gs.relevance.cpu()]
            if spec.knowledge_quant_block:
                results[dev].append(gs.stores.scale.cpu())
        (p_gpu, s_gpu, r_gpu, *sc_gpu), (p_cpu, s_cpu, r_cpu, *sc_cpu) = (
            results["cuda"], results["cpu"])
        err = float((p_gpu - p_cpu).abs().max())
        r_err = float((r_gpu - r_cpu).abs().max())
        stores_eq = torch.equal(s_gpu, s_cpu) and all(
            torch.equal(a, b) for a, b in zip(sc_gpu, sc_cpu))
        ok = (torch.allclose(p_gpu, p_cpu, rtol=1e-5, atol=1e-6)
              and stores_eq and r_err <= 1e-6)
        print(f"[equiv] {label}, 9 epochs, card vs CPU: params max abs "
              f"{err:.3e} (rtol 1e-5), relevance max abs {r_err:.3e} "
              f"(atol 1e-6), stores {s_gpu.dtype} bitwise {stores_eq} -> "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"card and CPU paths disagree on a small group: {label}")


def robust_equivalence_phase(torch):
    """The robustness paths, the card against the port's CPU path on
    seeded gradients (the same table on both): (a) relevance-aware
    gossip with sketched relevance and int8 planes, and (b) elastic
    membership (a kill at epoch 3, the revival at 6) over the faulty
    transport with staleness. Stores (payloads, scales, T, valid, ptr,
    send epochs) and gossip tables bitwise, parameters rtol 1e-5. Then
    a checkpoint of (b) written on the card is restored into the CPU
    state and both continue 3 epochs: equal again."""
    import os
    import tempfile

    import numpy as np
    from repro_torch import optim
    from repro_torch.checkpoint import npz
    from repro_torch.configs.base import GroupSpec
    from repro_torch.core.ddal import DDAL
    from repro_torch.rl.a2c import init_a2c, make_a2c_callbacks
    from repro_torch.rl.envs import CartPole

    n = 6
    base = dict(n_agents=n, threshold=2, minibatch=2, m_pieces=6)
    rng = np.random.default_rng(2)
    grads = rng.normal(size=(12, n, 9155)).astype(np.float32)
    cases = [
        ("(a) n=6 relevance_topk k=3 every 2, eps 0.3, sketch 256, int8 "
         "128", GroupSpec(**base, **dict(TOPK_SPEC, degree=3,
                                         resample_every=2,
                                         explore_eps=0.3)), None),
        ("(b) n=6 ring, elastic, faulty transport, max_staleness 8, decay "
         "0.95", GroupSpec(**base, **dict(FAULTY_SPEC, transport_seed=4,
                                          transport_corrupt=0.2)),
         {3: (np.eye(n, dtype=bool)[1], None),
          6: (None, np.eye(n, dtype=bool)[1])}),
    ]
    for label, spec, events in cases:
        out = {}
        for dev in ("cpu", "cuda"):
            opt = optim.adamw(3e-3)
            astates, layout = init_a2c(torch.Generator().manual_seed(0), n,
                                       CartPole(), opt)
            astates = _to(astates, dev)
            _, apply_grads, params_of = make_a2c_callbacks(CartPole(), opt,
                                                           layout)

            def gen_grads(state, e, dev=dev):
                g = torch.from_numpy(grads[e % 12]).to(dev)
                return g, {"return": g.sum(-1)}, state

            ddal = DDAL(spec, gen_grads, apply_grads, params_of, device=dev,
                        layout=layout)
            gs = ddal.init(astates)
            for e in range(9):
                kill, revive = (events or {}).get(e, (None, None))
                if kill is not None:
                    gs = ddal.kill(gs, kill)
                if revive is not None:
                    gs = ddal.revive(gs, revive)
                gs, _ = ddal.epoch_step(gs, e)
            out[dev] = (ddal, gs, layout)
        (_, g_cpu, layout), (d_gpu, g_gpu, _) = out["cpu"], out["cuda"]

        def same(a, b):
            names = ("grads", "scale", "T", "valid", "ptr", "born")
            st = all(getattr(a.stores, k) is None or torch.equal(
                getattr(a.stores, k).cpu(), getattr(b.stores, k))
                for k in names)
            return (st and np.array_equal(a.nbr, b.nbr)
                    and torch.allclose(a.agent_states.params.cpu(),
                                       b.agent_states.params, rtol=1e-5,
                                       atol=1e-6))

        err = float((g_gpu.agent_states.params.cpu()
                     - g_cpu.agent_states.params).abs().max())
        ok = same(g_gpu, g_cpu)
        print(f"[equiv] {label}, 9 epochs, card vs CPU: stores and gossip "
              f"tables bitwise, params max abs {err:.3e} (rtol 1e-5) -> "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"card and CPU paths disagree: {label}")
        if events is None:
            continue
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "group.npz")
            npz.save_group(path, g_gpu, layout, step=9)
            back = npz.restore_group(path, g_cpu, layout)
        d_cpu = out["cpu"][0]
        for e in range(9, 12):
            back, _ = d_cpu.epoch_step(back, e)
            g_gpu, _ = d_gpu.epoch_step(g_gpu, e)
        ok = back.epoch == 12 and same(g_gpu, back)
        err = float((g_gpu.agent_states.params.cpu()
                     - back.agent_states.params).abs().max())
        print(f"[equiv] {label}: checkpoint written on the card at epoch 9, "
              f"restored on the CPU, both continued 3 epochs: stores "
              f"bitwise, params max abs {err:.3e} -> "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, "a checkpoint written on the card does not continue "
                  "equal on the CPU")


def _to(x, dev):
    """A nest of tensors, dicts and NamedTuples moved to ``dev``."""
    if hasattr(x, "_fields"):
        return type(x)(*(_to(v, dev) for v in x))
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    return x.to(dev)


def dqn_equivalence_phase(torch):
    """DDADQN, the card against the port's CPU path on the same inputs:
    a small ring group (n = 4, delay 1, ``target_period=2``, 9 epochs)
    fed seeded gradients through DQN's ``apply_grads`` and DDAL, with
    parameters and target parameters within rtol 1e-5 and the stores
    bitwise; and ``dqn_loss`` with its gradient on one seeded replay
    batch within rtol 1e-5."""
    import numpy as np
    from repro_torch import optim
    from repro_torch.configs.base import GroupSpec
    from repro_torch.core.ddal import DDAL
    from repro_torch.rl import dqn
    from repro_torch.rl.envs import CartPole

    spec = GroupSpec(n_agents=4, threshold=2, minibatch=2, m_pieces=4,
                     topology="ring", exchange_delay="uniform", max_delay=1)
    cfg = dqn.DQNConfig(capacity=256, target_period=2)
    env = CartPole()
    rng = np.random.default_rng(1)
    grads = rng.normal(size=(12, 4, 8835)).astype(np.float32)
    astates, layout = dqn.init_dqn(torch.Generator().manual_seed(0), 4, env,
                                   optim.adamw(1e-3), cfg)
    results = {}
    for dev in ("cpu", "cuda"):
        _, apply_grads, params_of = dqn.make_dqn_callbacks(
            env, optim.adamw(1e-3), cfg, layout)
        calls = []

        def gen_grads(state, gen, dev=dev, calls=calls):
            g = torch.from_numpy(grads[len(calls) % 12]).to(dev)
            calls.append(1)
            return g, {"return": g.sum(-1)}, state

        ddal = DDAL(spec, gen_grads, apply_grads, params_of, device=dev,
                    layout=layout)
        gs, _ = ddal.run(ddal.init(_to(astates, dev)), None, 9)
        st = gs.agent_states
        results[dev] = [st.params.cpu(), st.target_params.cpu(),
                        gs.stores.grads.cpu(), st.step.cpu()]
    (p_g, t_g, s_g, n_g), (p_c, t_c, s_c, n_c) = results["cuda"], \
        results["cpu"]
    err = max(float((p_g - p_c).abs().max()), float((t_g - t_c).abs().max()))
    ok = (torch.allclose(p_g, p_c, rtol=1e-5, atol=1e-6)
          and torch.allclose(t_g, t_c, rtol=1e-5, atol=1e-6)
          and torch.equal(s_g, s_c) and torch.equal(n_g, n_c)
          and not torch.equal(t_c, astates.target_params))
    print(f"[equiv] dqn ring n=4, delay 1, target period 2, 9 epochs, card "
          f"vs CPU: params and target params max abs {err:.3e} (rtol 1e-5), "
          f"updates {n_c.tolist()}, stores bitwise {torch.equal(s_g, s_c)} "
          f"-> {'ok' if ok else 'FAIL'}")
    check(ok, "card and CPU paths disagree on a small DDADQN group")

    # dqn_loss and its gradient on one seeded batch
    B = 64
    batch = (rng.normal(size=(4, B, 4)).astype(np.float32),
             rng.integers(0, 2, (4, B)),
             rng.normal(size=(4, B)).astype(np.float32),
             rng.normal(size=(4, B, 4)).astype(np.float32),
             rng.random((4, B)) < 0.2)
    target = astates.params + 0.01 * torch.from_numpy(
        rng.normal(size=astates.params.shape).astype(np.float32))
    out = {}
    for dev in ("cpu", "cuda"):
        flat = astates.params.to(dev).requires_grad_(True)
        loss = dqn.dqn_loss(layout.unflatten(flat),
                            layout.unflatten(target.to(dev)),
                            tuple(torch.from_numpy(np.asarray(x)).to(dev)
                                  for x in batch), cfg.gamma)
        (g,) = torch.autograd.grad(loss.sum(), flat)
        out[dev] = (loss.detach().cpu(), g.cpu())
    (l_g, g_g), (l_c, g_c) = out["cuda"], out["cpu"]
    scale = float(g_c.abs().max())
    ok = (torch.allclose(l_g, l_c, rtol=1e-5, atol=1e-6)
          and torch.allclose(g_g, g_c, rtol=1e-5, atol=1e-6 * scale))
    print(f"[equiv] dqn_loss, 4 agents x {B} steps, card vs CPU: loss max "
          f"abs {float((l_g - l_c).abs().max()):.3e}, gradient max abs "
          f"{float((g_g - g_c).abs().max()):.3e} of max {scale:.3e} "
          f"(rtol 1e-5, atol 1e-6 of the max) -> {'ok' if ok else 'FAIL'}")
    check(ok, "card and CPU disagree on dqn_loss or its gradient")


PROFILE_EPOCHS = 2      # sharing epochs under the profiler, per group
# the script's limit is 1,200 s and a slow host runs it ~40 % longer
# than a fast one: past this many seconds the closing profiles
# (measurements that check nothing, ~66 s on a slow host) are skipped
PROFILE_DEADLINE = 1000


def profile_phase(torch):
    """Device busy share and time by op over PROFILE_EPOCHS main-path
    epochs (each a share step at minibatch 2), for the quickstart group,
    for the fourth main-path run's configuration (learned sketched
    relevance, int8 planes), for the DDADQN n = 2 group and for the
    robustness path (b); then the host-clock split of an epoch, over 3
    epochs. The profiler's own accounting of ~40,000 kernels an epoch
    sets this phase's time, so the window stays short."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import optim
    from repro_torch.configs.base import GroupSpec
    from repro_torch.rl.a2c import make_a2c_group
    from repro_torch.rl.dqn import make_dqn_group
    from repro_torch.rl.envs import CartPole

    def a2c(spec, gen):
        return make_a2c_group(CartPole(), optim.adamw(3e-3), spec, gen)

    def dqn(spec, gen):
        return make_dqn_group(CartPole(), optim.adamw(1e-3), spec, gen,
                              _dqn_config())

    configs = [
        ("n=2 full", GroupSpec(n_agents=2, threshold=2, minibatch=2,
                               m_pieces=32), a2c),
        ("n=8 ring, delay 2, sketch 256, int8 128", GroupSpec(
            n_agents=8, threshold=2, minibatch=2, m_pieces=32,
            topology="ring", exchange_delay="uniform", max_delay=2,
            **SLICE2_SPEC), a2c),
        ("dqn n=2 full", GroupSpec(n_agents=2, threshold=2, minibatch=2,
                                   m_pieces=32), dqn),
        ("(b) n=8 ring, elastic, faulty transport, max_staleness 8",
         GroupSpec(n_agents=8, threshold=2, minibatch=2, m_pieces=32,
                   **FAULTY_SPEC), a2c),
    ]
    for label, spec, build in configs:
        gen = torch.Generator(device="cuda").manual_seed(0)
        ddal, gs = build(spec, gen)
        gs, _ = ddal.run(gs, gen, 4)                   # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            gs, _ = ddal.run(gs, gen, PROFILE_EPOCHS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = []
        for ev in prof.key_averages():
            dev_us = getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0))
            rows.append((ev.key, ev.count, dev_us, ev.cpu_time_total))
        kernels = [e for e in prof.events()
                   if getattr(e, "device_type", None) is not None
                   and str(e.device_type).endswith("CUDA")]
        busy_us = sum(e.time_range.elapsed_us() for e in kernels)
        rows.sort(key=lambda r: -r[2])
        ours = [(r[0][:40], r[1], round(r[2]), round(r[3])) for r in rows
                if "wavg_kernel" in r[0] or "wavg_q_kernel" in r[0]
                or "sketch_" in r[0] or "ssd_chunk_" in r[0]]

        def wall_of(fn, reps=3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / reps

        # host-clock split of an epoch (profiler off): the agents'
        # episode, loss and backward (gen_grads) against the rest
        state = {"gs": gs}

        def epoch():
            state["gs"], _ = ddal.epoch_step(state["gs"], gen)

        epoch_s = wall_of(epoch)
        gen_s = wall_of(lambda: ddal.gen_grads(state["gs"].agent_states,
                                               gen))
        print(f"[profile] {label}, {PROFILE_EPOCHS} sharing epochs: wall "
              f"{wall:.3f} s, "
              f"device busy {busy_us / 1e3:.2f} ms "
              f"({busy_us / (wall * 1e6):.1%}), {len(kernels)} device "
              f"kernels; the port's kernels (name, calls, device us, "
              f"host us) {ours}")
        print(f"[profile] {label}: epoch {epoch_s * 1e3:.2f} ms on the "
              f"host clock (profiler off), of which gen_grads (episode + "
              f"loss + backward) {gen_s * 1e3:.2f} ms")
        host_rows = sorted((r for r in rows if r[3] > 0),
                           key=lambda r: -r[3])
        for key, count, dev_us, cpu_us in host_rows[:10]:
            print(f"[profile]   {key[:60]}: {count} calls, device "
                  f"{dev_us:.0f} us, host {cpu_us:.0f} us")
        for key, count, dev_us, cpu_us in [r for r in rows if r[2] > 0][:8]:
            print(f"[profile]   by device time: {key[:60]}: {count} calls, "
                  f"device {dev_us:.0f} us, host {cpu_us:.0f} us")


def serve_max_len(cfg):
    """The serving phases' cache: 1024 prompt positions and 32 new
    tokens, and a VLM's vision prefix (256 for qwen2-vl), which every
    prefill writes ahead of the prompt."""
    return 1056 + cfg.vision_prefix


def _llama_batch(torch, cfg, B, S, seed=0):
    """B rows of S ids drawn by ``np.random.default_rng(seed)`` over the
    vocabulary, the next ids as labels, positions 0..S−1, on the card."""
    import numpy as np
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                               (B, S + 1), dtype=np.int32)
    pos = torch.arange(S, dtype=torch.int32, device="cuda").expand(B, S)
    return {"tokens": torch.from_numpy(ids[:, :-1].copy()).cuda(),
            "labels": torch.from_numpy(ids[:, 1:].copy()).cuda(),
            "positions": pos}


def _score_batch(torch, cfg, S, seed=0):
    """A scoring batch of SCORE_B rows of S positions on the card: ids
    (``_llama_batch``) for the text families, and for the VLM and audio
    families the training batch of ``make_agent_batch`` (uniform ids):
    musicgen's 4 delayed codebooks and its 0.02·N(0, 1) ``cond``,
    qwen2-vl's vision prefix ahead of S − 256 text ids, their −100
    labels and (3, S) positions."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import StreamSpec, make_agent_batch
    if cfg.family not in ("audio", "vlm"):
        return _llama_batch(torch, cfg, SCORE_B, S, seed)
    return make_agent_batch(cfg, ShapeConfig("score", S, SCORE_B, "train"),
                            StreamSpec(seed=seed, kind="uniform"), 0, 0,
                            "cuda")


def score_phase(torch, cfg, params, label=SCORE_LABEL):
    """A scoring path: llama3.2-3b, zamba2-7b, qwen3-moe-30b-a3b,
    deepseek-v2-lite-16b or musicgen-medium at its published widths and
    depth, or qwen2-vl-72b at its widths cut to 20 layers (weights
    drawn from seed 0 in ``cfg.param_dtype``, bf16 compute) scores B =
    2 rows of S = 4096 ids (musicgen: 2 x 1500 frames of 4 codebooks
    with a 64-position ``cond``; qwen2-vl: 2 x 4096 positions, 256 of
    them vision; ``_score_batch``) through
    ``get_model(cfg).forward(..., None)``
    and ``.loss`` under ``torch.no_grad()``: one warm-up pass, then, with
    the launch counts zeroed, one forward (logits checked, and its
    cross-entropy: the loss less it is the MoE layers' auxiliary term)
    and SCORE_PASSES timed loss passes; flash launches once per
    attention layer (zamba2: per call of the shared block; MLA: none)
    and SSD once per Mamba2 layer in every pass. Returns {kernel: {path:
    launches}}."""
    from repro_torch.models import get_model
    from repro_torch.models.common import cross_entropy

    model = get_model(cfg)
    batch = _score_batch(torch, cfg, MUSICGEN_FRAMES
                         if cfg.family == "audio" else SCORE_S)
    B, S = batch["labels"].shape[0], batch["labels"].shape[-1]
    with torch.no_grad():
        model.loss(cfg, params, batch)                       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        logits, cache = model.forward(cfg, params, batch, None)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(logits).all())
        shape = tuple(logits.shape)
        ce = float(cross_entropy(logits, batch["labels"]))
        lstd = (float(logits.float().std()) if cfg.family == "audio"
                else None)
        del logits
        times, losses = [], []
        for _ in range(SCORE_PASSES):
            t0 = time.perf_counter()
            loss = model.loss(cfg, params, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
        launched = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    passes = 1 + SCORE_PASSES
    ms = [t * 1e3 for t in times]
    tokens = B * S
    best = min(ms)
    # random weights, logits after the final norm: of variance
    # d_model·0.02² through a tied embedding, ~0.77 through a drawn head
    # (a truncated normal of fan-in scale), d_model·0.77 / 4 through
    # musicgen's 4 codebook heads (4, E, V), whose fan-in the reference's
    # dense_init takes from their first axis, 4
    var = (cfg.d_model * 0.774 / cfg.n_codebooks if cfg.family == "audio"
           else cfg.d_model * 4e-4 if cfg.tie_embeddings else 0.774)
    aux = losses[0] - ce
    print(f"{label}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{widths(cfg)}, vocab {cfg.vocab_size}, {cfg.param_dtype} "
          f"weights, {cfg.compute_dtype} compute; {B} x {S} positions"
          + ("".join(f", {k} {tuple(batch[k].shape)}" for k in
                     ("cond", "vision") if k in batch))
          + "; loss passes ms " + ", ".join(f"{t:.2f}" for t in ms)
          + f" (best {best:.2f}: {tokens / best * 1e3:,.0f} tokens/s); "
          f"loss " + ", ".join(f"{x:.5f}" for x in losses)
          + f" = cross-entropy {ce:.5f} + aux {aux:.5f}"
          + f" (ln V = {math.log(cfg.vocab_size):.5f}, ln V + var/2 = "
          f"{math.log(cfg.vocab_size) + var / 2:.5f}); logits "
          f"{shape} "
          + ("" if lstd is None else
             f"std {lstd:.3f} (predicted {math.sqrt(var):.3f}) ")
          + f"finite {finite}; peak memory {peak / 2 ** 30:.3f} GiB; "
          f"{passes} passes, launches "
          + ", ".join(f"{k} {v}" for k, v in launched.items()))
    ssd, flash = kernel_layers(cfg)
    want = {name: 0 for name in KERNELS}
    want["flash_attention"] = flash * passes
    want["ssd_intra_chunk"] = ssd * passes
    check(launched == want, f"{label}: launches {launched} != {want} "
                            f"({flash} attention and {ssd} SSD layers x "
                            f"{passes} passes)")
    check(cache is None and finite
          and shape == tuple(batch["labels"].shape) + (cfg.vocab_size,),
          f"{label}: non-finite or misshapen logits, or a cache")
    # random weights: after the final norm the logits have variance
    # d_model·0.02² (1.23), so the cross-entropy sits near ln V + 0.61 =
    # 12.38; the MoE aux term is positive (about 0.01·k + 0.001·(ln
    # Ne)² a layer with balanced routing), 0 for a dense model.
    # musicgen's logits (variance 297) put it far above ln V, below the
    # ln V + var/2 of small variances, and their spread is checked
    ln_v = math.log(cfg.vocab_size)
    check(all(math.isfinite(x) for x in losses)
          and ln_v - 0.5 < ce < ln_v + max(1.5, var / 2)
          and (lstd is None or abs(lstd / math.sqrt(var) - 1) < 0.1)
          and max(losses) - min(losses) < 1e-3
          and (0 < aux < 1.0 * cfg.n_layers if cfg.moe is not None
               else abs(aux) < 1e-3),
          f"{label}: loss {losses} (cross-entropy {ce}, aux {aux}, logits "
          f"std {lstd}) not within (ln V − 0.5, ln V + max(1.5, var/2)) "
          f"plus its aux, or not repeatable")
    return {name: {label: launched[name]} for name, n in want.items() if n}


def serve_phase(torch, argv, label):
    """A serving path at its arch's published widths and depth, through
    ``repro_torch.launch.serve`` called as a function with ``argv`` (4
    requests of up to 1023 prompt tokens, 2 slots, 32 greedy tokens),
    with every kernel's launch count zeroed just before the call and
    read just after: mamba2-780m's and zamba2-7b's prefill runs the SSD
    kernel in every Mamba2 layer, llama3.2-3b's and deepseek-v2-lite-16b's
    none, and none runs the flash kernel (prefill passes a cache, as in
    the reference). With MLA (deepseek), every prefill into the wider
    cache and every decode step takes the absorbed branch: the
    expanded one's ``softmax_attention`` is counted and must not run.
    Returns ({kernel: {path: launches}}, prompts)."""
    import contextlib
    import io

    from repro_torch.configs import get_arch_config
    from repro_torch.launch import serve
    from repro_torch.models import attention

    cfg = get_arch_config(argv[argv.index("--arch") + 1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    expanded = []
    plain_softmax = attention.softmax_attention
    if cfg.mla is not None:
        attention.softmax_attention = (
            lambda *a, **kw: expanded.append(1) or plain_softmax(*a, **kw))
    reset_launches()
    try:
        with contextlib.redirect_stdout(out):
            report = serve.main(argv)
        torch.cuda.synchronize()
    finally:
        attention.softmax_attention = plain_softmax
    launched = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # the launcher's per-slot lines print ~1000-id prompts: summarise
    for (toks, lens), outs in zip(report["batches"], report["outputs"]):
        for row in range(outs.shape[0]):
            print(f"[serve]   prompt of {int(lens[row])} ids -> "
                  f"{outs[row].tolist()}")
    for ln in out.getvalue().splitlines()[-2:]:
        print(f"[serve]   {ln}")
    calls = report["prefill_calls"]
    want = {name: 0 for name in KERNELS}
    want["ssd_intra_chunk"] = kernel_layers(cfg)[0] * calls
    lens = [len(pr) for pr in report["prompts"]]
    print(f"{label}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{widths(cfg)}"
          f", vocab {cfg.vocab_size}, {cfg.compute_dtype} compute; "
          f"{len(lens)} requests, prompt lengths {lens}, {calls} prefill "
          f"calls; prefill ms per batch "
          + ", ".join(f"{ms:.2f}" for ms in report["prefill_ms"])
          + f" (the first includes the card's warm-up); decode "
          f"{report['decode_tok_s']:.1f} tok/s over "
          f"{sum(report['decode_s']):.3f} s; peak memory "
          f"{peak / 2 ** 30:.3f} GiB; launches "
          + ", ".join(f"{k} {v}" for k, v in launched.items()))
    check(launched == want, f"{label}: launches {launched} != {want} "
                            f"({kernel_layers(cfg)[0]} SSD layers x {calls} "
                            f"prefills, no flash: prefill passes a cache)")
    if cfg.mla is not None:
        print(f"{label}: MLA's expanded branch ran {len(expanded)} times "
              f"(every prefill, S <= {max(lens)} queries into 1056 slots, "
              f"and every decode step take the absorbed branch)")
        check(not expanded, f"{label}: MLA took the expanded branch "
                            f"{len(expanded)} times")
    outs = report["outputs"]
    check(calls == 2 and len(outs) == 2
          and all(o.shape == (2, 32) and o.dtype == torch.int32
                  and bool(((o >= 0) & (o < cfg.vocab_size)).all())
                  for o in outs),
          f"{label}: not 4 requests x 32 tokens in the vocabulary")
    check(all(lg.shape == (2, cfg.vocab_size)
              and bool(torch.isfinite(lg.float()).all())
              for lg in report["first_logits"]),
          f"{label}: non-finite or misshapen prefill logits")
    return ({name: {label: launched[name]} for name, n in want.items() if n},
            report["prompts"])


def library_serve_phase(torch, cfg, params, label=QWEN_SERVE_LABEL):
    """[serve] qwen3-moe-30b-a3b at its published widths and depth with
    bf16 weights (fp32 ones would take 122 GB), or qwen2-vl-72b at its
    widths cut to 20 layers with bf16 weights (``serve_max_len`` 1312:
    each prefill writes 256 vision positions ahead of the prompt), through
    the library's entry points, as the launcher has no dtype or depth
    flag: the [serve] prompts
    (the launcher's draw, seed 0, prompt-len 1024: 871, 596, 1001, 802
    ids) through ``ServeEngine`` in batches of 2 (prefill, then 32
    greedy tokens, the decode under
    ``torch.cuda.set_sync_debug_mode("error")`` with host lengths: a
    synchronizing call raises), then through the ``ContinuousBatcher``
    (2 slots, prompt_pad 16; ``[equiv] qwen3-moe-30b-a3b`` holds its
    tokens against the CPU path). No flash launch (prefill passes a
    cache)."""
    from repro_torch.launch.serve import draw_prompts
    from repro_torch.serving import (ContinuousBatcher, ServeConfig,
                                     ServeEngine, serve_batches)

    prompts = draw_prompts(cfg.vocab_size, 4, 1024, 0)
    max_len = serve_max_len(cfg)
    serve = ServeConfig(max_len=max_len, max_new_tokens=32)
    engine = ServeEngine(cfg, params, serve)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    prefill_ms, decode_s, outs, errors = [], [], [], []
    for toks, lens in serve_batches(prompts, 2, device="cpu"):
        toks = toks.to("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = engine.prefill(toks, lens)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = engine.decode(logits, cache, lens)
        except RuntimeError as exc:
            errors.append(str(exc).splitlines()[0])
            continue
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t1)
        prefill_ms.append((t1 - t0) * 1e3)
        finite = bool(torch.isfinite(logits.float()).all())
        outs.append((out.cpu(), finite, tuple(logits.shape)))
    check(not errors, f"{label}: decode synchronized with the card: "
                      f"{errors}")
    launched_batch = launch_counts()
    peak_batch = torch.cuda.max_memory_allocated()
    decoded = sum(o.shape[0] * (o.shape[1] - 1) for o, _, _ in outs)
    batcher = ContinuousBatcher(cfg, params, serve, batch_size=2,
                                prompt_pad=16)
    reset_launches()
    with _StepClock() as clock:
        t0 = time.perf_counter()
        results = batcher.run(prompts)
        secs = time.perf_counter() - t0
    launched_cont = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"{label}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{widths(cfg)}, vocab {cfg.vocab_size}, {cfg.param_dtype} "
          f"weights, {cfg.compute_dtype} compute, max_len {max_len}; "
          f"ServeEngine: 4 requests, "
          f"prompt lengths {[len(p) for p in prompts]}, 2 prefill calls; "
          f"prefill ms per batch " + ", ".join(f"{ms:.2f}" for ms in
                                              prefill_ms)
          + f" (the first includes the card's warm-up); decode "
          f"{decoded / sum(decode_s):.1f} tok/s over {sum(decode_s):.3f} s "
          f"under set_sync_debug_mode('error'); peak memory "
          f"{peak_batch / 2 ** 30:.3f} GiB; launches "
          + ", ".join(f"{k} {v}" for k, v in launched_batch.items()))
    for (out, _, _), (_, lens) in zip(outs, serve_batches(prompts, 2,
                                                          device="cpu")):
        for row in range(out.shape[0]):
            print(f"[serve]   prompt of {int(lens[row])} ids -> "
                  f"{out[row].tolist()}")
    print(f"{label}: ContinuousBatcher, 2 slots, prompt_pad 16, in "
          f"{secs:.2f} s; decode {clock.summary()}; peak memory "
          f"{peak / 2 ** 30:.3f} GiB; launches "
          + ", ".join(f"{k} {v}" for k, v in launched_cont.items()))
    none = {name: 0 for name in KERNELS}
    check(launched_batch == none and launched_cont == none,
          f"{label}: launches {launched_batch} / {launched_cont}, want none "
          f"(prefill passes a cache)")
    check(len(outs) == 2 and all(
        o.shape == (2, 32) and bool(((o >= 0) & (o < cfg.vocab_size)).all())
        and fin and shape == (2, cfg.vocab_size) for o, fin, shape in outs),
        f"{label}: not 4 requests x 32 tokens in the vocabulary, or "
        f"non-finite prefill logits")
    check(sorted(results) == list(range(4))
          and all(len(v) == 32 and all(0 <= t < cfg.vocab_size for t in v)
                  for v in results.values()),
          f"{label}: the ContinuousBatcher did not complete every request "
          f"with 32 tokens in the vocabulary")


def train_phase(torch):
    """The streaming trainer at mamba2-780m's published widths and depth
    through ``repro_torch.launch.train.main`` (``TRAIN_ARGV``: 2 agents,
    batch 4 x 256, sketched relevance d 256, share steps 4 and 8), with
    the launch counts zeroed just before it and read just after. Checks:
    every loss finite; ``<shared>`` at steps 4 and 8 only; the window
    empty after each share and one piece fuller after each later step;
    ``grad_sketch`` launched once per parameter leaf on each of the 8
    accumulation steps, the SSD kernel once per layer in each agent's
    forward of every step (the recorded pass runs the kernel; its
    gradient is the plain einsum form's, ``kernels.plain_vjp``) and no
    other kernel launched. Returns ({kernel: {path: launches}}, the
    positions of the largest leaf per agent)."""
    import contextlib
    import io

    from repro_torch.launch import train

    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    out = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(out):
        report = train.main(TRAIN_ARGV)
    torch.cuda.synchronize()
    launched = launch_counts()
    lines = out.getvalue().splitlines()
    for ln in lines[:1] + lines[-3:]:
        print(f"[train]   {ln}")
    state, spec = report["state"], report["spec"]
    losses = report["losses"]
    finite = all(math.isfinite(x) for row in losses for x in row)
    leaves = report["leaves"]
    want = {name: 0 for name in KERNELS}
    want["grad_sketch"] = leaves * TRAIN_ACCUMULATE
    want["ssd_intra_chunk"] = (report["cfg"].n_layers * spec.n_agents
                               * len(losses))
    expect_window, count = [], 0
    for step in range(len(losses)):
        if step >= spec.threshold:
            count += 1
        if step in TRAIN_SHARES:
            count = 0
        expect_window.append([float(count)] * spec.n_agents)
    med = report["median_ms"]
    print(f"{TRAIN_LABEL}: {report['params_per_agent']:,} params/agent x "
          f"{spec.n_agents} agents ({leaves} leaves), batch 4 x 256, "
          f"{report['tokens_per_s']:,.0f} tokens/s over "
          f"{len(losses)} steps ({report['seconds']:.2f} s); median ms per "
          f"step: " + ", ".join(f"{k} {v:.1f}" for k, v in med.items())
          + f"; peak memory {report['peak_bytes'] / 2 ** 30:.3f} GiB; "
          f"losses first {losses[0]} last {losses[-1]}; shared at "
          f"{report['shared']}; launches "
          + ", ".join(f"{k} {v}" for k, v in launched.items()))
    check(finite, f"{TRAIN_LABEL}: a non-finite loss")
    check(report["shared"] == TRAIN_SHARES,
          f"{TRAIN_LABEL}: shared at {report['shared']}, not {TRAIN_SHARES}")
    check(report["window"] == expect_window,
          f"{TRAIN_LABEL}: window piece counts {report['window']} != "
          f"{expect_window}")
    check(launched == want, f"{TRAIN_LABEL}: launches {launched} != {want}")
    check(all(bool(torch.isfinite(x).all()) for x in
              _tree_leaves(state.params)),
          f"{TRAIN_LABEL}: non-finite parameters")
    largest = max(x.numel() for x in _tree_leaves(state.params)
                  ) // spec.n_agents
    profile_train_steps(torch, report)
    del report, state
    gc.collect()
    torch.cuda.empty_cache()
    return {name: {TRAIN_LABEL: launched[name]}
            for name in ("grad_sketch", "ssd_intra_chunk")}, largest


def profile_train_steps(torch, report):
    """One more step of the [train] run in a profiler window: step 12,
    a share step (forward and backward of both agents, the window, 20
    sketch launches, eq. 4, AdamW). Prints the wall time, the device's
    busy share, the kernel count and the ops that take the device's
    time (one window: the profiler's own processing of ~40,000 kernels
    takes tens of seconds)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import optim
    from repro_torch.core.sharded_ddal import make_group_train_step
    from repro_torch.data import StreamSpec, make_group_batch
    from repro_torch.configs.base import ShapeConfig

    cfg, spec = report["cfg"], report["spec"]
    step = make_group_train_step(cfg, spec, optim.adamw(1e-3))
    shape = ShapeConfig("train_cli", 256, 4, "train")
    state = report["state"]
    for _ in range(1):
        kind = "share" if state.step % spec.minibatch == 0 else "accumulation"
        batch = make_group_batch(cfg, shape, StreamSpec(seed=0),
                                 spec.n_agents, state.step, "cuda")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.events()
                   if getattr(e, "device_type", None) is not None
                   and str(e.device_type).endswith("CUDA")]
        busy_us = sum(e.time_range.elapsed_us() for e in kernels)
        rows = [(ev.key, ev.count,
                 getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0)),
                 getattr(ev, "self_cpu_time_total", 0.0))
                for ev in prof.key_averages()]
        print(f"[profile] train mamba2-780m {kind} step {state.step - 1} "
              f"(2 agents, batch 4 x 256): wall {wall * 1e3:.1f} ms, device "
              f"busy {busy_us / 1e3:.2f} ms ({busy_us / (wall * 1e6):.1%}), "
              f"{len(kernels)} device kernels")
        for key, count, dev_us, cpu_us in sorted(rows,
                                                 key=lambda r: -r[2])[:8]:
            print(f"[profile]   by device time: {key[:60]}: {count} calls, "
                  f"device {dev_us:.0f} us, self host {cpu_us:.0f} us")


def _tree_leaves(tree):
    from repro_torch.common.pytree import tree_leaves_with_paths
    return [x for _, x in tree_leaves_with_paths(tree)]


def train_llama_phase(torch):
    """The streaming trainer at llama3.2-3b's published widths cut to 2
    layers (the cut: 28 → 2 layers; 4 agents of the full model need
    ~4 x 64 GB), bf16 compute: 4 agents on a ring, exact grad_cos
    relevance, int8 knowledge planes (q_block 128), built through
    ``init_train_state`` / ``make_group_train_step`` /
    ``make_group_batch``, 6 steps with shares at 2 and 4. Checks: finite
    losses, the flash kernel launched once per layer in each agent's
    forward (its gradient is the plain version's) and no other kernel.
    Returns {kernel: {path: launches}}."""
    from repro_torch import optim
    from repro_torch.configs import get_arch_config
    from repro_torch.configs.base import GroupSpec, ShapeConfig
    from repro_torch.core.sharded_ddal import (init_train_state,
                                               make_group_train_step)
    from repro_torch.data import StreamSpec, make_group_batch

    cfg = get_arch_config(LLAMA).with_(n_layers=2)
    spec = GroupSpec(n_agents=4, threshold=2, minibatch=2,
                     knowledge_mode="streaming", topology="ring",
                     relevance_mode="grad_cos", knowledge_quant_block=128)
    opt = optim.adamw(1e-3)
    shape = ShapeConfig("train_smoke", 256, 2, "train")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    state = init_train_state(cfg, spec, opt, seed=0, device="cuda")
    step = make_group_train_step(cfg, spec, opt)
    losses, shared, ms = [], [], []
    for i in range(6):
        batch = make_group_batch(cfg, shape, StreamSpec(seed=0), 4, i,
                                 "cuda")
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(m["loss"].tolist())
        if m["shared"]:
            shared.append(i)
    launched = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(x.numel() for x in _tree_leaves(state.params)) // 4
    finite = all(math.isfinite(x) for row in losses for x in row)
    print(f"{LLAMA_TRAIN_LABEL}: {n_params:,} params/agent x 4 agents, "
          f"ring, grad_cos, int8 q_block 128, bf16 compute, batch 2 x 256; "
          f"ms per step {[round(x, 1) for x in ms]} (warm-up, warm-up, "
          f"share, accumulation, share, accumulation); "
          f"{time.perf_counter() - t0:.1f} s with init; peak memory "
          f"{peak / 2 ** 30:.3f} GiB; losses first {losses[0]} last "
          f"{losses[-1]}; shared at {shared}; launches "
          + ", ".join(f"{k} {v}" for k, v in launched.items()))
    check(finite, f"{LLAMA_TRAIN_LABEL}: a non-finite loss")
    check(shared == [2, 4], f"{LLAMA_TRAIN_LABEL}: shared at {shared}")
    want = dict({name: 0 for name in KERNELS},
                flash_attention=cfg.n_layers * 4 * 6)
    check(launched == want,
          f"{LLAMA_TRAIN_LABEL}: kernel launches {launched} != {want}")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention": {LLAMA_TRAIN_LABEL:
                                launched["flash_attention"]}}


def _loose_params(torch, got, want, bound):
    """(max |got − want|, share of elements beyond 2e-4) over two trees
    of parameters, and whether every element is within ``bound`` and at
    most 1e-4 of them beyond 2e-4 (AdamW's first steps turn ulp-level
    gradient differences of elements whose gradient is near its eps
    into steps up to lr)."""
    worst, over, total = 0.0, 0, 0
    for g, w in zip(_tree_leaves(got), _tree_leaves(want)):
        d = (g.cpu() - w).abs()
        worst = max(worst, float(d.max()))
        over += int((d > 2e-4).sum())
        total += d.numel()
    return worst, over / total, worst <= bound and over <= 1e-4 * total


def _linear_loss(params, feed):
    """A loss whose gradient is ``feed["g"]`` exactly and whose value is
    ``feed["loss"]``: the trainer then runs on given gradients."""
    pl, gl = _tree_leaves(params), _tree_leaves(feed["g"])
    a = sum((x * y).sum() for x, y in zip(pl, gl))
    b = sum((x.detach() * y).sum() for x, y in zip(pl, gl))
    return feed["loss"] + (a - b)


def _fed_gradients(torch, params, step):
    """Step ``step``'s given gradients, made on the CPU from a seed: per
    leaf a part shared by the agents plus half as much of each agent's
    own, so that the learned relevance is far from 0 and from 1."""
    from repro_torch.common.pytree import tree_map
    g = torch.Generator().manual_seed(1000 + step)

    def leaf(x):
        shared = torch.randn(x.shape[1:], generator=g)
        own = torch.randn(x.shape, generator=g)
        return 1e-2 * (shared + 0.5 * own)
    return tree_map(leaf, params)


def _fed_equiv(torch, cfg, spec, opt, start):
    """The trainer on given gradients (``_linear_loss``) on the card and
    on the CPU, step by step: the share flags, tg and rg bitwise; the
    window sketch ``know.sk`` (the kernel's result) within 1e-5·Σ|g| per
    row, Σ over the window's gradients; the learned relevance
    ``know.rel`` within 1e-6; parameters within 1e-6. Returns (worst sk
    error over its bound, worst rel error, worst param error, the
    card's launches, ok)."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.core.sharded_ddal import (clone_state,
                                               make_group_train_step)
    cpu = clone_state(start)
    card = _state_to(torch, clone_state(start), "cuda")
    steps = {dev: make_group_train_step(cfg, spec, opt, loss_fn=_linear_loss)
             for dev in ("cpu", "cuda")}
    n = spec.n_agents
    l1 = torch.zeros((n,), dtype=torch.float64)
    sk_worst = rel_worst = p_worst = 0.0
    ok = True
    reset_launches()
    for i in range(8):
        g = _fed_gradients(torch, start.params, i)
        if i >= spec.threshold:
            l1 += sum(x.to(torch.float64).abs().reshape(n, -1).sum(1)
                      for x in _tree_leaves(g))
        feed = {"loss": torch.zeros((n,)), "g": g}
        cpu, m_cpu = steps["cpu"](cpu, feed)
        card, m_card = steps["cuda"](card, tree_map(
            lambda x: x.to("cuda"), feed))
        ok &= m_cpu["shared"] == m_card["shared"]
        kc, kg = cpu.know, card.know
        for name in ("tg", "rg"):
            ok &= all(torch.equal(a.cpu(), b) for a, b in zip(
                _tree_leaves(getattr(kg, name)),
                _tree_leaves(getattr(kc, name))))
        ok &= torch.equal(kg.tsum.cpu(), kc.tsum)
        err = (kg.sk.cpu() - kc.sk).abs().to(torch.float64)
        sk_worst = max(sk_worst, float((err / (1e-5 * l1[:, None] + 1e-12)
                                        ).max()))
        rel_worst = max(rel_worst, float((kg.rel.cpu() - kc.rel).abs().max()))
        p_worst = max(p_worst, max(float((a.cpu() - b).abs().max())
                                   for a, b in zip(_tree_leaves(card.params),
                                                   _tree_leaves(cpu.params))))
        if m_cpu["shared"]:
            l1.zero_()
    launched = launch_counts()
    ok &= sk_worst <= 1.0 and rel_worst <= 1e-6 and p_worst <= 1e-6
    return sk_worst, rel_worst, p_worst, launched, ok


def train_equiv_phase(torch):
    """The streaming trainer on the card against the port's CPU path, at
    reduced() llama3.2-3b and mamba2-780m with fp32 compute (TF32 off),
    from the same state and the same batches: 3 agents on a ring,
    sketched relevance (d 64) and int8 planes (q_block 128), 8 steps
    with shares at 3 and 6. On the models' own gradients: losses within
    rtol = atol = 1e-4; the share flags equal; parameters within 2e-4
    but for 1e-4 of the elements, every one within 2·lr per update; the
    card's sketch launches one per leaf per accumulation step and the
    model's kernel (flash or SSD) one per layer per agent per step. On
    given gradients (``_fed_equiv``), where the two sides see the same
    inputs: the window bitwise, its sketch, the learned relevance and
    the parameters held step by step."""
    from repro_torch import optim
    from repro_torch.configs import get_arch_config
    from repro_torch.configs.base import GroupSpec, ShapeConfig
    from repro_torch.core.sharded_ddal import (clone_state,
                                               init_train_state,
                                               make_group_train_step)
    from repro_torch.data import StreamSpec, make_group_batch

    lr = 1e-3
    for arch in (LLAMA, "mamba2-780m"):
        cfg = get_arch_config(arch).reduced()
        spec = GroupSpec(n_agents=3, threshold=2, minibatch=3,
                         knowledge_mode="streaming", topology="ring",
                         relevance_mode="grad_cos", relevance_sketch_dim=64,
                         knowledge_quant_block=128)
        opt = optim.adamw(lr)
        shape = ShapeConfig("equiv", 64, 2, "train")
        start = init_train_state(cfg, spec, opt, seed=0, device="cpu")
        runs = {}
        for dev in ("cpu", "cuda"):
            st = clone_state(start)
            if dev == "cuda":
                st = _state_to(torch, st, dev)
            step = make_group_train_step(cfg, spec, opt)
            reset_launches()
            losses, shared = [], []
            t0 = time.perf_counter()
            for i in range(8):
                batch = make_group_batch(cfg, shape, StreamSpec(seed=1), 3,
                                         i, dev)
                st, m = step(st, batch)
                losses.append(m["loss"].cpu())
                shared.append(m["shared"])
            runs[dev] = (st, torch.stack(losses), shared, launch_counts(),
                         time.perf_counter() - t0)
        cpu, card = runs["cpu"], runs["cuda"]
        leaves = len(_tree_leaves(start.params))
        loss_ok = torch.allclose(card[1], cpu[1], rtol=1e-4, atol=1e-4)
        worst, share, p_ok = _loose_params(torch, card[0].params,
                                           cpu[0].params, 2 * lr * 4)
        want = {name: 0 for name in KERNELS}
        model_kernel = ("flash_attention" if cfg.family == "dense"
                        else "ssd_intra_chunk")
        want_card = dict(want, grad_sketch=leaves * 6,
                         **{model_kernel: cfg.n_layers * 3 * 8})
        ok = (loss_ok and p_ok and card[2] == cpu[2]
              and cpu[2].count(1) == 2 and cpu[3] == want
              and card[3] == want_card)
        shares = [i for i, x in enumerate(cpu[2]) if x]
        print(f"[train-equiv] {arch} reduced(), fp32, 3 agents ring, sketch "
              f"64, int8 128, 8 steps (shares {shares}), "
              f"card vs CPU: losses max abs "
              f"{float((card[1] - cpu[1]).abs().max()):.3e} (rtol=atol=1e-4)"
              f", params max abs {worst:.3e}, share beyond 2e-4 "
              f"{share:.2e} (bound {2 * lr * 4:.0e}, share <= 1e-4); card "
              f"launches {card[3]['grad_sketch']} grad_sketch "
              f"({leaves} leaves x 6 steps), {card[3][model_kernel]} "
              f"{model_kernel} ({cfg.n_layers} layers x 3 agents x 8 "
              f"steps), others 0; CPU {cpu[4]:.1f} s, "
              f"card {card[4]:.1f} s -> {'ok' if ok else 'FAIL'}")
        check(ok, f"[train-equiv] {arch}: card and CPU disagree")
        sk_ratio, rel_err, p_err, fed_launches, fed_ok = _fed_equiv(
            torch, cfg, spec, opt, start)
        fed_want = dict(want, grad_sketch=leaves * 6)
        fed_ok = fed_ok and fed_launches == fed_want
        print(f"[train-equiv] {arch} on given gradients, same spec, card vs "
              f"CPU step by step: tg, rg, tsum and share flags bitwise; "
              f"know.sk worst {sk_ratio:.3e} of its bound 1e-5·Σ|g| per "
              f"row; know.rel max abs {rel_err:.3e} (<= 1e-6); params max "
              f"abs {p_err:.3e} (<= 1e-6); card launches "
              f"{fed_launches['grad_sketch']} grad_sketch, others 0 -> "
              f"{'ok' if fed_ok else 'FAIL'}")
        check(fed_ok, f"[train-equiv] {arch}: on given gradients, card and "
                      f"CPU disagree")


def train_pods_phase(torch):
    """The streaming trainer with the pod dispatch on one device (no
    mesh: the intra-pod sums, then the leader-level ones): llama3.2-3b's
    published widths cut to 2 layers, bf16 compute, ``PODS_SPEC`` (4
    agents, 2 pods of 2), sketched relevance d 256, int8 planes (q_block
    128), 6 steps with shares at 2 and 4. Checks: finite losses, the
    shares, flash once per layer in each agent's forward (2 x 4 x 6 =
    48), the sketch once per leaf on each of the 4 accumulation steps,
    no other kernel. Prints ``cross_pod_bytes`` beside
    ``flat_exchange_bytes`` for this P (byte counts, not times).
    Returns {kernel: {path: launches}}."""
    from repro_torch import optim
    from repro_torch.configs import get_arch_config
    from repro_torch.configs.base import GroupSpec, ShapeConfig
    from repro_torch.core.exchange import build_exchange
    from repro_torch.core.pod_dispatch import (cross_pod_bytes,
                                               flat_exchange_bytes,
                                               split_topology)
    from repro_torch.core.sharded_ddal import (init_train_state,
                                               make_group_train_step)
    from repro_torch.core.topology import hierarchical_layout
    from repro_torch.data import StreamSpec, make_group_batch

    cfg = get_arch_config(LLAMA).with_(n_layers=2)
    spec = GroupSpec(threshold=2, minibatch=2,
                     exchange_estimator="grad_cos+sketch",
                     relevance_sketch_dim=256, knowledge_quant_block=128,
                     **PODS_SPEC)
    opt = optim.adamw(1e-3)
    shape = ShapeConfig("train_smoke", 256, 2, "train")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ex = build_exchange(spec, kind="streaming")
    check(ex.combiner.__qualname__.startswith("make_pod_combiner"),
          f"{PODS_TRAIN_LABEL}: the spec did not build the pod combiner")
    reset_launches()
    t0 = time.perf_counter()
    state = init_train_state(cfg, spec, opt, seed=0, exchange=ex,
                             device="cuda")
    step = make_group_train_step(cfg, spec, opt, exchange=ex)
    losses, shared, ms = [], [], []
    for i in range(6):
        batch = make_group_batch(cfg, shape, StreamSpec(seed=0), 4, i,
                                 "cuda")
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(m["loss"].tolist())
        if m["shared"]:
            shared.append(i)
    launched = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    leaves = len(_tree_leaves(state.params))
    P = sum(x.numel() for x in _tree_leaves(state.params)) // 4
    topo = ex.static_topology
    edges = split_topology(topo, hierarchical_layout(4, 2))
    cross = cross_pod_bytes(edges, P, 4, 128)
    flat = flat_exchange_bytes(topo, P, 4, 128)
    finite = all(math.isfinite(x) for row in losses for x in row)
    print(f"{PODS_TRAIN_LABEL}: {P:,} params/agent x 4 agents in 2 pods "
          f"of 2 (the pod combiner, one device), grad_cos+sketch d 256, "
          f"int8 q_block 128, bf16 compute, batch 2 x 256; ms per step "
          f"{[round(x, 1) for x in ms]} (warm-up, warm-up, share, "
          f"accumulation, share, accumulation); {time.perf_counter() - t0:.1f}"
          f" s with init; peak memory {peak / 2 ** 30:.3f} GiB; losses "
          f"first {losses[0]} last {losses[-1]}; shared at {shared}; "
          f"launches " + ", ".join(f"{k} {v}" for k, v in launched.items()))
    print(f"{PODS_TRAIN_LABEL}: bytes per share step at P = {P:,}, int8 "
          f"planes (counts, not times): cross-pod {cross:,} "
          f"({int(edges.ledge.sum())} leader edges) beside the flat "
          f"placement's {flat:,}")
    check(finite, f"{PODS_TRAIN_LABEL}: a non-finite loss")
    check(shared == [2, 4], f"{PODS_TRAIN_LABEL}: shared at {shared}")
    want = dict({name: 0 for name in KERNELS},
                flash_attention=cfg.n_layers * 4 * 6,
                grad_sketch=leaves * 4)
    check(launched == want,
          f"{PODS_TRAIN_LABEL}: kernel launches {launched} != {want}")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return {name: {PODS_TRAIN_LABEL: launched[name]}
            for name in ("flash_attention", "grad_sketch")}


def _fed_params(torch, cfg, spec, opt, start):
    """The trainer on the card on ``_fed_gradients`` for 8 steps from
    ``start``: the final parameters."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.core.sharded_ddal import (clone_state,
                                               make_group_train_step)
    card = _state_to(torch, clone_state(start), "cuda")
    step = make_group_train_step(cfg, spec, opt, loss_fn=_linear_loss)
    n = spec.n_agents
    for i in range(8):
        feed = {"loss": torch.zeros((n,)),
                "g": _fed_gradients(torch, start.params, i)}
        card, _ = step(card, tree_map(lambda x: x.to("cuda"), feed))
    return card.params


def train_equiv_pods_phase(torch):
    """``[train-equiv]``'s gates for the pod dispatch: reduced()
    llama3.2-3b, fp32 compute (TF32 off), ``PODS_SPEC`` (4 agents in 2
    pods of 2), sketch d 64, int8 128, 8 steps with shares at 3 and 6,
    the card against the port's CPU path on the model's own gradients
    and on given gradients; then the pod run against the flat run (the
    same spec with ``pods=0``) on the card on given gradients,
    parameters within rtol 1e-5 / atol 1e-6."""
    from repro_torch import optim
    from repro_torch.configs import get_arch_config
    from repro_torch.configs.base import GroupSpec, ShapeConfig
    from repro_torch.core.sharded_ddal import (clone_state,
                                               init_train_state,
                                               make_group_train_step)
    from repro_torch.data import StreamSpec, make_group_batch

    lr = 1e-3
    cfg = get_arch_config(LLAMA).reduced()
    base = dict(PODS_SPEC, threshold=2, minibatch=3,
                relevance_mode="grad_cos", relevance_sketch_dim=64,
                knowledge_quant_block=128)
    spec = GroupSpec(**base)
    opt = optim.adamw(lr)
    shape = ShapeConfig("equiv", 64, 2, "train")
    start = init_train_state(cfg, spec, opt, seed=0, device="cpu")
    runs = {}
    for dev in ("cpu", "cuda"):
        st = clone_state(start)
        if dev == "cuda":
            st = _state_to(torch, st, dev)
        step = make_group_train_step(cfg, spec, opt)
        reset_launches()
        losses, shared = [], []
        t0 = time.perf_counter()
        for i in range(8):
            batch = make_group_batch(cfg, shape, StreamSpec(seed=1), 4, i,
                                     dev)
            st, m = step(st, batch)
            losses.append(m["loss"].cpu())
            shared.append(m["shared"])
        runs[dev] = (st, torch.stack(losses), shared, launch_counts(),
                     time.perf_counter() - t0)
    cpu, card = runs["cpu"], runs["cuda"]
    leaves = len(_tree_leaves(start.params))
    loss_ok = torch.allclose(card[1], cpu[1], rtol=1e-4, atol=1e-4)
    worst, share, p_ok = _loose_params(torch, card[0].params, cpu[0].params,
                                       2 * lr * 4)
    want = {name: 0 for name in KERNELS}
    want_card = dict(want, grad_sketch=leaves * 6,
                     flash_attention=cfg.n_layers * 4 * 8)
    ok = (loss_ok and p_ok and card[2] == cpu[2] and cpu[2].count(1) == 2
          and cpu[3] == want and card[3] == want_card)
    shares = [i for i, x in enumerate(cpu[2]) if x]
    print(f"[train-equiv] pods {LLAMA} reduced(), fp32, 4 agents in 2 pods "
          f"of 2, sketch 64, int8 128, 8 steps (shares {shares}), card vs "
          f"CPU: losses max abs {float((card[1] - cpu[1]).abs().max()):.3e}"
          f" (rtol=atol=1e-4), params max abs {worst:.3e}, share beyond "
          f"2e-4 {share:.2e} (bound {2 * lr * 4:.0e}, share <= 1e-4); card "
          f"launches {card[3]['grad_sketch']} grad_sketch ({leaves} leaves "
          f"x 6 steps), {card[3]['flash_attention']} flash_attention "
          f"({cfg.n_layers} layers x 4 agents x 8 steps), others 0; CPU "
          f"{cpu[4]:.1f} s, card {card[4]:.1f} s -> "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "[train-equiv] pods: card and CPU disagree")
    sk_ratio, rel_err, p_err, fed_launches, fed_ok = _fed_equiv(
        torch, cfg, spec, opt, start)
    fed_ok = fed_ok and fed_launches == dict(want, grad_sketch=leaves * 6)
    print(f"[train-equiv] pods on given gradients, card vs CPU step by "
          f"step: tg, rg, tsum and share flags bitwise; know.sk worst "
          f"{sk_ratio:.3e} of its bound 1e-5·Σ|g| per row; know.rel max "
          f"abs {rel_err:.3e} (<= 1e-6); params max abs {p_err:.3e} (<= "
          f"1e-6); card launches {fed_launches['grad_sketch']} grad_sketch,"
          f" others 0 -> {'ok' if fed_ok else 'FAIL'}")
    check(fed_ok, "[train-equiv] pods: on given gradients, card and CPU "
                  "disagree")
    pod = _fed_params(torch, cfg, spec, opt, start)
    flat = _fed_params(torch, cfg, GroupSpec(**dict(base, pods=0)), opt,
                       start)
    diff = max(float((a - b).abs().max()) for a, b in zip(
        _tree_leaves(pod), _tree_leaves(flat)))
    close = all(torch.allclose(a, b, **POD_TOL) for a, b in zip(
        _tree_leaves(pod), _tree_leaves(flat)))
    print(f"[train-equiv] pods against flat on the card, given gradients, "
          f"8 steps: params max abs {diff:.3e} (rtol 1e-5, atol 1e-6) -> "
          f"{'ok' if close else 'FAIL'}")
    check(close, "[train-equiv] pods: the pod run leaves the flat run's "
                 "trajectory")


MESH_FLAGS = ["--arch", LLAMA, "--device", "cuda", "--agents", "4",
              "--steps", "4", "--batch", "2", "--seq", "64", "--threshold",
              "1", "--minibatch", "2", "--exchange", "topology=hierarchical",
              "--exchange", "degree=4", "--exchange", "pods=1"]


MESH_DIR = ROOT / "build" / "mesh_phase"
MESH_TIMEOUT = 600                     # s, the launcher's run on the card


def start_mesh_run():
    """Starts the launcher's ``--mesh pods`` on the card in the
    background: ``python -m torch.distributed.run --standalone
    --nproc-per-node 1 -m repro_torch.launch.train --mesh pods`` (NCCL,
    a (1, 1) ``(pod, agent)`` mesh; reduced() llama3.2-3b, 4 agents, one
    pod of 4, 4 steps), its output in files under build/. It runs beside
    the CPU-bound card-against-CPU phases, whose times nothing reads;
    ``mesh_phase`` waits for it. Returns (the process, its start)."""
    import os

    MESH_DIR.mkdir(parents=True, exist_ok=True)
    for name in ("mesh.npz", "one.npz"):
        if (MESH_DIR / name).exists():
            (MESH_DIR / name).unlink()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    with open(MESH_DIR / "mesh.out", "w") as out, \
            open(MESH_DIR / "mesh.err", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "1", "-m", "repro_torch.launch.train",
             "--mesh", "pods", *MESH_FLAGS, "--ckpt-full",
             str(MESH_DIR / "mesh.npz")],
            cwd=ROOT, env=env, stdout=out, stderr=err, text=True,
            start_new_session=True)
    return proc, time.perf_counter()


def stop_mesh_run(proc):
    """Kills the launcher and its worker (one process group)."""
    import os
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def mesh_phase(torch, run):
    """Waits for ``start_mesh_run``'s launcher (``run``) and runs the
    same launcher with ``--mesh cpu`` in this process; their
    ``--ckpt-full`` files within rtol 1e-5 / atol 1e-6. One rank on one
    card: this shows that NCCL starts and the mesh code runs on the
    card, nothing about traffic between cards."""
    import contextlib
    import io

    import numpy as np

    from repro_torch.launch import train

    proc, t0 = run
    try:
        rc = proc.wait(timeout=max(1.0, MESH_TIMEOUT
                                   - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        stop_mesh_run(proc)
        raise SmokeFailure(f"[mesh]: the launcher under "
                           f"torch.distributed.run ran past {MESH_TIMEOUT} s")
    t_mesh = time.perf_counter() - t0
    mesh_file, one_file = MESH_DIR / "mesh.npz", MESH_DIR / "one.npz"
    lines = (MESH_DIR / "mesh.out").read_text().splitlines()
    for ln in lines[:2] + lines[-3:]:
        print(f"[mesh]   {ln}")
    check(rc == 0,
          f"[mesh]: the launcher under torch.distributed.run exited "
          f"{rc}: {(MESH_DIR / 'mesh.err').read_text()[-2000:]}")
    check(any("over nccl" in ln for ln in lines),
          "[mesh]: the mesh run did not report the NCCL backend")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        train.main(["--mesh", "cpu", *MESH_FLAGS, "--ckpt-full",
                    str(one_file)])
    t_one = time.perf_counter() - t0
    a, b = np.load(mesh_file), np.load(one_file)
    keys_ok = sorted(a.files) == sorted(b.files)
    worst, ok = 0.0, keys_ok
    for k in a.files if keys_ok else []:
        x, y = a[k].astype(np.float64), b[k].astype(np.float64)
        if x.size:
            worst = max(worst, float(np.abs(x - y).max()))
        ok &= bool(np.allclose(a[k], b[k], **POD_TOL))
    print(f"[mesh] {LLAMA} reduced(), 4 agents in 1 pod, 4 steps: the "
          f"launcher on a (1, 1) (pod, agent) mesh over NCCL "
          f"({t_mesh:.1f} s from its start to the wait's end, process "
          f"start included, beside the [equiv] phases) against --mesh cpu "
          f"({t_one:.1f} s): {len(a.files)} checkpoint leaves, max abs "
          f"{worst:.3e} (rtol 1e-5, atol 1e-6) -> {'ok' if ok else 'FAIL'}."
          f" One rank on one card: NCCL starts and the mesh path runs on "
          f"the card; traffic between cards is not exercised")
    check(ok, "[mesh]: the mesh run's checkpoint differs from the "
              "one-device run's")


TP_STEPS = 6
EP_LABEL = "[equiv] experts ep"
STRIDED_LABEL = "[kernel] grad_sketch strided"


def _one_rank_nccl(torch):
    """A one-rank NCCL process group in this process (a ``FileStore``
    under build/, no network) and the (1, 1) ``(data, model)`` mesh."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    store = ROOT / "build" / "tp_phase" / "store"
    store.parent.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    return make_debug_mesh((1, 1), ("data", "model"), device_type="cuda")


def _tp_run(torch, mesh, cfg, spec_kw=None):
    """``[tp]``'s trainer run of ``cfg`` (mesh None: the one-device
    step; ``spec_kw`` overrides the ring exchange): (per-step losses on
    the host, the final params (the state's own tensors, the rest of
    the state freed), the kernel launches, the number of leaves, ms per
    step, the share steps). On a ``(pod, data, model)`` mesh the state
    is drawn sliced (``init_train_state(..., mesh=)``) and the batch is
    the rank's pod's agents' rows."""
    from repro_torch import optim
    from repro_torch.configs.base import GroupSpec, ShapeConfig
    from repro_torch.core.exchange import build_exchange
    from repro_torch.core.sharded_ddal import (init_train_state,
                                               make_group_train_step,
                                               mesh_kind)
    from repro_torch.data import StreamSpec, make_data_batch, make_group_batch
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import train_rules

    kw = dict(topology="ring", exchange_estimator="grad_cos+sketch",
              relevance_sketch_dim=SKETCH_DIM,
              knowledge_quant_block=QUANT_BLOCK)
    kw.update(spec_kw or {})
    spec = GroupSpec(n_agents=4, threshold=2, minibatch=2,
                     knowledge_mode="streaming", **kw)
    opt = optim.adamw(1e-3)
    shape = ShapeConfig("train_smoke", 256, 2, "train")
    ex = build_exchange(spec, kind="streaming", mesh=mesh)
    pods = mesh_kind(mesh) == "pod_model"
    if pods:
        specs = SH.state_placement_specs(cfg, mesh, ex.estimator.learns,
                                         ex.sketch_dim)
        like = SH.full_shapes(init_train_state(
            cfg, spec, opt, seed=0, exchange=ex, device="meta"))
        state = init_train_state(cfg, spec, opt, seed=0, exchange=ex,
                                 device="cuda", mesh=mesh)
    else:
        state = init_train_state(cfg, spec, opt, seed=0, exchange=ex,
                                 device="cuda")
    if mesh is not None and not pods:
        specs = SH.train_state_partition_specs(
            cfg, train_rules(mesh), None, ex.estimator.learns, ex.sketch_dim)
        like = SH.full_shapes(state)
        state = SH.place(state, specs, mesh, cfg)
    step = make_group_train_step(cfg, spec, opt, exchange=ex, mesh=mesh)
    reset_launches()
    losses, ms, shared = [], [], []
    for i in range(TP_STEPS):
        if mesh is None:
            batch = make_group_batch(cfg, shape, StreamSpec(seed=0), 4, i,
                                     "cuda")
        else:
            batch = make_data_batch(
                cfg, shape, StreamSpec(seed=0), 4, i, mesh, "cuda",
                rows=None if ex.shard is None else ex.shard.rows)
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(m["loss"].cpu())
        if m["shared"]:
            shared.append(i)
    launched = launch_counts()
    full = (state.params if mesh is None else
            SH.gather(state.params, specs.params, mesh, like.params, cfg))
    params = _tree_leaves(full)
    del state, step, full
    gc.collect()
    torch.cuda.empty_cache()
    return losses, params, launched, len(params), ms, shared


def tp_phase(torch, mesh, arch=LLAMA, n_layers=2):
    """``[tp]``: the streaming trainer on the (1, 1) ``(data, model)``
    mesh over NCCL (the model under ``train_rules``: vocab-parallel
    embedding and loss, split attention and SwiGLU or Mamba2 split by its
    SSD heads, each with its all-reduce; gradients over ``data``; partial
    sums over ``model``) against the same step with no mesh on the card:
    ``arch``'s widths cut to ``n_layers`` layers (llama3.2-3b 2,
    mamba2-780m 4), 4 agents on a ring, sketched relevance d 256, int8
    planes, 6 steps, shares at 2 and 4. Gates: losses and parameters
    within rtol 1e-5 / atol 1e-6; flash (llama) or SSD (mamba2) once per
    layer per agent per step; the sketch once per leaf per accumulation
    step; NCCL. Returns {kernel: {path: n}}."""
    import torch.distributed as dist

    from repro_torch.common.sharding import COLLECTIVES
    from repro_torch.configs import get_arch_config
    t0 = time.perf_counter()
    cfg = get_arch_config(arch).with_(n_layers=n_layers)
    label = (f"[tp] {arch}, {n_layers} layers, (1, 1) (data, model) mesh")
    want = _tp_run(torch, None, cfg)
    COLLECTIVES.clear()
    got = _tp_run(torch, mesh, cfg)
    w_loss, w_params, _, leaves, w_ms, w_shared = want
    loss, params, launched, _, ms, shared = got
    worst_loss = max(float((a - b).abs().max()) for a, b in zip(loss, w_loss))
    loss_ok = all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                  for a, b in zip(loss, w_loss))
    worst = max(float((a - b).abs().max()) for a, b in zip(params, w_params))
    params_ok = all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                    for a, b in zip(params, w_params))
    del params, w_params, want, got
    gc.collect()
    torch.cuda.empty_cache()
    backend = dist.get_backend()
    n_ssd, n_flash = kernel_layers(cfg)
    want_launches = dict({name: 0 for name in KERNELS},
                         flash_attention=n_flash * 4 * TP_STEPS,
                         ssd_intra_chunk=n_ssd * 4 * TP_STEPS,
                         grad_sketch=leaves * (TP_STEPS - 2))
    print(f"{label}: over {backend}; ms per step with the mesh "
          f"{[round(x, 1) for x in ms]}, without "
          f"{[round(x, 1) for x in w_ms]}; losses max abs {worst_loss:.3e},"
          f" parameters max abs {worst:.3e} over {leaves} leaves (rtol "
          f"1e-5, atol 1e-6) -> {'ok' if loss_ok and params_ok else 'FAIL'};"
          f" shared at {shared}; launches " + ", ".join(
              f"{k} {v}" for k, v in launched.items())
          + "; forward collectives " + ", ".join(
              f"{k} {v}" for k, v in sorted(COLLECTIVES.items()))
          + f"; {time.perf_counter() - t0:.1f} s. One rank on one card: "
          f"the code path and NCCL run on the card; traffic between "
          f"cards is not exercised")
    check(backend == "nccl", f"{label}: the group runs {backend}")
    check(loss_ok, f"{label}: losses differ from the one-device step")
    check(params_ok, f"{label}: parameters differ from the one-device "
                     f"step")
    check(shared == w_shared == [2, 4], f"{label}: shared at {shared}")
    check(launched == want_launches,
          f"{label}: kernel launches {launched} != {want_launches}")
    return {name: {label: launched[name]}
            for name in ("flash_attention", "ssd_intra_chunk", "grad_sketch")
            if launched[name]}


def tp_pods_phase(torch):
    """``[tp-pods]``: the streaming trainer on the (1, 1, 1) ``(pod,
    data, model)`` mesh over NCCL (agents over ``pod``, the model under
    ``train_rules``, the state drawn sliced, the exchange gathered over
    ``pod``) against the same step with no mesh, as ``[tp]``: llama3.2-3b
    cut to 2 layers, 4 agents on a ring, sketched relevance d 256, int8
    planes, 6 steps, shares at 2 and 4; then the same with
    ``topology=hierarchical``, 2 pods of 2 and the ``pod`` combiner
    (the one-device pod dispatch beside it). Gates as ``[tp]``. Returns
    {kernel: {path: n}}."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch_config
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh((1, 1, 1), ("pod", "data", "model"),
                           device_type="cuda")
    cfg = get_arch_config(LLAMA).with_(n_layers=2)
    out = {}
    for case, kw in (("ring", {}), ("pod combiner", dict(
            topology="hierarchical", degree=2, pods=2))):
        t0 = time.perf_counter()
        label = (f"[tp-pods] {LLAMA}, 2 layers, (1, 1, 1) (pod, data, "
                 f"model) mesh, {case}")
        w_loss, w_params, _, leaves, w_ms, w_shared = _tp_run(
            torch, None, cfg, kw)
        loss, params, launched, _, ms, shared = _tp_run(torch, mesh, cfg,
                                                        kw)
        worst_loss = max(float((a - b).abs().max())
                         for a, b in zip(loss, w_loss))
        loss_ok = all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                      for a, b in zip(loss, w_loss))
        worst = max(float((a - b).abs().max())
                    for a, b in zip(params, w_params))
        params_ok = all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                        for a, b in zip(params, w_params))
        del params, w_params
        gc.collect()
        torch.cuda.empty_cache()
        backend = dist.get_backend()
        n_ssd, n_flash = kernel_layers(cfg)
        want_launches = dict({name: 0 for name in KERNELS},
                             flash_attention=n_flash * 4 * TP_STEPS,
                             grad_sketch=leaves * (TP_STEPS - 2))
        print(f"{label}: over {backend}; ms per step with the mesh "
              f"{[round(x, 1) for x in ms]}, without "
              f"{[round(x, 1) for x in w_ms]}; losses max abs "
              f"{worst_loss:.3e}, parameters max abs {worst:.3e} over "
              f"{leaves} leaves (rtol 1e-5, atol 1e-6) -> "
              f"{'ok' if loss_ok and params_ok else 'FAIL'}; shared at "
              f"{shared}; launches " + ", ".join(
                  f"{k} {v}" for k, v in launched.items())
              + f"; {time.perf_counter() - t0:.1f} s. One rank on one "
              f"card: traffic between cards is not exercised")
        check(backend == "nccl", f"{label}: the group runs {backend}")
        check(loss_ok, f"{label}: losses differ from the one-device step")
        check(params_ok, f"{label}: parameters differ from the one-device "
                         f"step")
        check(shared == w_shared == [2, 4], f"{label}: shared at {shared}")
        check(launched == want_launches,
              f"{label}: kernel launches {launched} != {want_launches}")
        for name in ("flash_attention", "grad_sketch"):
            out.setdefault(name, {})[label] = launched[name]
    return out


def _state_bytes(torch, state) -> int:
    from repro_torch.checkpoint.npz import _paths
    return sum(x.numel() * x.element_size() for _, x in _paths(state)
               if isinstance(x, torch.Tensor))


def _largest_drawn_tree(cfg) -> int:
    """Bytes of the largest tree one agent's init draws whole: a layer
    of a stack (its leaves' bytes over the stacked dims), the
    embedding, the head or a tree drawn whole (``layer0``, ``shared``)."""
    from repro_torch.common.pytree import tree_leaves_with_paths
    from repro_torch.models.model import param_specs
    STACKS = {"layers": 1, "mamba_blocks": 2, "lora": 1, "tail": 1}
    trees = {}
    for path, x in tree_leaves_with_paths(param_specs(cfg)):
        lead = STACKS.get(path[0], 0)
        n = x.numel() * x.element_size()
        for d in range(lead):
            n //= x.shape[d]
        trees[path[0]] = trees.get(path[0], 0) + n
    return max(trees.values())


def init_slice_phase(torch):
    """``[init-slice]``: the sliced init alone (no step runs at that size
    on one card). Rank (0, 0, 0) of the 2 x 16 x 16 ``(pod, data,
    model)`` mesh, described by a ``MeshPoint`` (no process group),
    draws its slice of qwen3-moe-30b-a3b's state at published widths
    and depth in fp32, 2 agents, sketch d 256: its state bytes, the peak
    allocated during the init and the seconds, gated on the peak being
    at most the rank's state + the largest tree drawn whole for one
    agent + 1 GiB. Then llama3.2-3b at full width cut to 4 layers, 2
    agents: the sliced params at every coordinate of a (1, 1, 4) and a
    (2, 1, 2) description bitwise ``place`` of a whole draw."""
    from repro_torch import optim
    from repro_torch.common.pytree import tree_leaves_with_paths
    from repro_torch.common.sharding import MeshPoint
    from repro_torch.configs import get_arch_config
    from repro_torch.configs.base import GroupSpec
    from repro_torch.core.exchange import build_exchange
    from repro_torch.core.sharded_ddal import init_train_state
    from repro_torch.launch import shardings as SH
    axes = ("pod", "data", "model")
    spec = GroupSpec(n_agents=2, knowledge_mode="streaming",
                     exchange_estimator="grad_cos+sketch",
                     relevance_sketch_dim=SKETCH_DIM)
    opt = optim.adamw(1e-3)
    ex = build_exchange(spec, kind="streaming")
    label = (f"[init-slice] {QWEN}, published widths and depth, fp32, 2 "
             f"agents, rank (0, 0, 0) of the 2 x 16 x 16 (pod, data, "
             f"model) mesh")
    cfg = get_arch_config(QWEN).with_(param_dtype="float32")
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = init_train_state(cfg, spec, opt, seed=0, exchange=ex,
                             device="cuda",
                             mesh=MeshPoint(axes, (2, 16, 16), (0, 0, 0)))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    held = _state_bytes(torch, state)
    tree = _largest_drawn_tree(cfg)
    bound = held + tree + (1 << 30)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{label}: the rank's state {held / 2**30:.3f} GiB, peak "
          f"allocated during the init {peak / 2**30:.3f} GiB, the largest "
          f"tree drawn whole for one agent {tree / 2**30:.3f} GiB, bound "
          f"(state + tree + 1 GiB) {bound / 2**30:.3f} GiB -> "
          f"{'ok' if peak <= bound else 'FAIL'}; {secs:.1f} s. This "
          f"phase measures the init alone: no step runs at that size on "
          f"one card")
    check(peak <= bound, f"{label}: peak {peak} > bound {bound}")
    t0 = time.perf_counter()
    cfg = get_arch_config(LLAMA).with_(n_layers=4)
    whole = init_train_state(cfg, spec, opt, seed=0, exchange=ex,
                             device="cuda").params
    n_points = 0
    for shape in ((1, 1, 4), (2, 1, 2)):
        for pt in MeshPoint(axes, shape, (0, 0, 0)).points():
            specs = SH.state_placement_specs(cfg, pt, True, SKETCH_DIM)
            want = SH.place(whole, specs.params, pt, cfg)
            got = init_train_state(cfg, spec, opt, seed=0, exchange=ex,
                                   device="cuda", mesh=pt).params
            same = all(
                a.shape == b.shape and torch.equal(a, b)
                for (_, a), (_, b) in zip(tree_leaves_with_paths(got),
                                          tree_leaves_with_paths(want)))
            check(same, f"[init-slice] {LLAMA}, 4 layers: the slice at "
                        f"{pt.coord} of {shape} is not place() of the "
                        f"whole draw")
            n_points += 1
            del want, got
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[init-slice] {LLAMA} at full width, 4 layers, 2 agents: the "
          f"sliced params at every coordinate of (1, 1, 4) and (2, 1, 2) "
          f"({n_points} ranks) bitwise place() of the whole draw -> ok; "
          f"{time.perf_counter() - t0:.1f} s")


def expert_parallel_phase(torch, mesh):
    """``[equiv] experts ep``: qwen3-moe-30b-a3b's widths cut to 2 layers
    with fp32 params and compute, scoring 2 x 4096 ids (C = 320): the
    loss and its gradients through the expert-parallel dispatch on the
    (1, 1) mesh against the dense dispatch with no mesh, at
    ``tests/test_moe_dispatch.py``'s gates; one ``moe_combine``
    all-reduce per MoE layer in the forward."""
    from repro_torch.common.sharding import COLLECTIVES, axis_rules, set_mesh
    from repro_torch.configs import get_arch_config
    from repro_torch.launch.mesh import train_rules
    from repro_torch.models import get_model

    t0 = time.perf_counter()
    cfg = get_arch_config(QWEN).with_(n_layers=2, param_dtype="float32",
                                      compute_dtype="float32")
    dense = cfg.with_(moe_dispatch="dense")
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    batch = _score_batch(torch, cfg, SCORE_S)
    leaves = _tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    loss_d = model.loss(dense, params, batch)
    grads_d = torch.autograd.grad(loss_d, leaves)
    COLLECTIVES.clear()
    with set_mesh(mesh), axis_rules(train_rules(mesh)):
        loss_e = model.loss(cfg, params, batch)
        combines = COLLECTIVES["moe_combine"]
        grads_e = torch.autograd.grad(loss_e, leaves)
    loss_e, loss_d = float(loss_e.detach()), float(loss_d.detach())
    ok_loss = math.isclose(loss_e, loss_d, rel_tol=1e-5)
    worst, ok_grads = 0.0, True
    for a, b in zip(grads_e, grads_d):
        worst = max(worst, float((a - b).abs().max()))
        ok_grads &= bool(torch.allclose(a, b, rtol=3e-4, atol=3e-5))
    C = max(1, int(cfg.moe.capacity_factor * SCORE_S * cfg.moe.top_k
                   / cfg.moe.n_experts))
    print(f"{EP_LABEL}: {QWEN} widths, 2 layers, fp32, scoring "
          f"{SCORE_B} x {SCORE_S} ids (C = {C}): expert-parallel loss "
          f"{loss_e:.6f} against dense {loss_d:.6f} (rtol "
          f"1e-5); gradients max abs {worst:.3e} over {len(leaves)} leaves "
          f"(rtol 3e-4, atol 3e-5); {combines} moe_combine all-reduces "
          f"(one a MoE layer) -> "
          f"{'ok' if ok_loss and ok_grads and combines == 2 else 'FAIL'}; "
          f"{time.perf_counter() - t0:.1f} s")
    check(ok_loss, f"{EP_LABEL}: the losses differ")
    check(ok_grads, f"{EP_LABEL}: the gradients differ")
    check(combines == cfg.n_layers,
          f"{EP_LABEL}: {combines} combines for {cfg.n_layers} MoE layers")
    del params, leaves, grads_d, grads_e, loss_d, loss_e
    gc.collect()
    torch.cuda.empty_cache()


def sketch_strided_phase(torch):
    """``[kernel] grad_sketch strided``: the ``[tp]`` model's stacked
    ``w_gate`` leaf, 4 agents x (2, 3072, 8192), cut into m = 2 and m =
    4 column slices as a model axis of that size places it. Each slice
    through the strided kernel against its plain version on its first
    2^18 positions (the plain version builds S a tile at a time), the
    slices' sum against the contiguous kernel on the whole leaf within
    the sketch's gate (1e-5·Σ|G| per row), and per slice the kernel's
    ms, its bound and ``torch.matmul`` of the slice with its S built
    outside the timing."""
    from repro_torch.common.sharding import LeafShard
    from repro_torch.core.relevance import fold_seed
    from repro_torch.kernels.grad_sketch import ops, ref

    t0 = time.perf_counter()
    n, shape, d = 4, (2, 3072, 8192), SKETCH_DIM
    seed, offset = fold_seed(0, 3), 123_456_789
    g = torch.Generator(device="cuda").manual_seed(11)
    full = torch.randn((n,) + shape, generator=g, device="cuda")
    whole = ops.sketch_leaf(full, seed, d, offset)
    gate = 1e-5 * full.reshape(n, -1).abs().sum(1, keepdim=True)
    rows, cut = [], 2 ** 18
    ok = True
    for m in (2, 4):
        blk = shape[2] // m
        acc = torch.zeros((n, d), device="cuda")
        for r in range(m):
            x = full[..., r * blk:(r + 1) * blk].contiguous()
            leaf = LeafShard(shape, 2, r * blk, blk)
            pmap = leaf.position_map()
            G = x.reshape(n, -1)
            got = ops.sketch_leaf(x, seed, d, offset, leaf)
            acc += got
            Gc = G[:, :cut].contiguous()
            k = ops.sketch_flat(Gc, seed, d, offset, pmap)
            p = ref.sketch_flat(Gc, seed, d, offset, position_map=pmap)
            err = float((k - p).abs().max())
            ok_r = bool(((k - p).abs()
                         <= 1e-5 * Gc.abs().sum(1, keepdim=True)).all())
            ok &= ok_r
            ms, _ = time_ms(torch, lambda: ops.sketch_flat(
                G, seed, d, offset, pmap), 10)
            plain_ms, _ = time_ms(torch, lambda: ref.sketch_flat(
                Gc, seed, d, offset, position_map=pmap), 1)
            P = G.shape[1]
            b_ms, b_by = sketch_bound(n, P, d)
            S = torch.empty((P, d), device="cuda")      # outside the timing
            piece = 2 ** 18
            for start in range(0, P, piece):
                pos = ref.shard_positions(start, min(piece, P - start),
                                          offset, *pmap, device="cuda")
                S[start:start + piece] = 1.0 - 2.0 * ref._hash_bits(
                    seed, pos, d).to(torch.float32)
            lib_ms, _ = time_ms(torch, lambda: torch.matmul(G, S), 10)
            del S
            torch.cuda.empty_cache()
            rows.append(dict(m=m, rank=r, n=n, positions=P, ms=ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                             plain_ms_first_2_18=plain_ms, max_abs_err=err))
            print(f"{STRIDED_LABEL} m = {m}, slice {r} ({n}, {P:,}, {d}) at "
                  f"columns {r * blk}..{(r + 1) * blk - 1} of 8192: device "
                  f"{ms:.5f} ms (bound {b_ms:.5f} ms, {b_by}), "
                  f"torch.matmul(G, S) with S built outside {lib_ms:.5f} ms;"
                  f" on its first 2^18 positions against the plain version "
                  f"({plain_ms:.5f} ms): max abs {err:.3e} -> "
                  f"{'ok' if ok_r else 'FAIL'}")
        sum_err = float((acc - whole).abs().max())
        sum_ok = bool(((acc - whole).abs() <= gate).all())
        ok &= sum_ok
        print(f"{STRIDED_LABEL} m = {m}: the slices' sum against the "
              f"contiguous kernel on the whole leaf: max abs {sum_err:.3e} "
              f"(1e-5·Σ|G| per row) -> {'ok' if sum_ok else 'FAIL'}")
    print(f"{STRIDED_LABEL}: {time.perf_counter() - t0:.1f} s")
    check(ok, f"{STRIDED_LABEL}: a slice disagrees")
    del full
    torch.cuda.empty_cache()
    return rows


# the model-axis phases' cuts of the families that came to the axis last
SCORE_TP_DEPTH = {ZAMBA: "2 super-blocks", QWEN_VL: "2 layers"}
BF16_GATE = 2.0 ** -5          # × max|want|: bf16 logits, as the tests'


def _collectives():
    from repro_torch.common.sharding import COLLECTIVES
    return ", ".join(f"{k} {v}" for k, v in sorted(COLLECTIVES.items()))


def _greedy_on_mesh(torch, cfg, shape, mesh, params, batch, lens, steps):
    """``prefill_on_mesh`` then ``steps`` greedy ``decode_on_mesh`` steps:
    (next-token logits per step, tokens (B, steps + 1), the cache, the
    collectives of the prefill and of the last step, ms of the prefill
    and per step)."""
    from repro_torch.common.sharding import COLLECTIVES
    from repro_torch.launch import dryrun_lib as DL
    from repro_torch.serving.api import decode_batch

    rows = torch.arange(len(lens), device="cuda")
    pos = torch.tensor(lens, dtype=torch.int32, device="cuda")
    COLLECTIVES.clear()
    t0 = time.perf_counter()
    logits, cache = DL.prefill_on_mesh(cfg, shape, mesh, params, batch)
    nl = logits[rows, pos.long() - 1]
    del logits
    torch.cuda.synchronize()
    ms = [(time.perf_counter() - t0) * 1e3]
    prefill = _collectives()
    out, toks = [nl], [nl.argmax(-1).to(torch.int32)]
    for _ in range(steps):
        COLLECTIVES.clear()
        t0 = time.perf_counter()
        logits, cache = DL.decode_on_mesh(
            cfg, shape, mesh, params,
            decode_batch(cfg, toks[-1][:, None], pos[:, None]), cache)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        pos = pos + 1
        out.append(logits[:, -1])
        toks.append(logits[:, -1].argmax(-1).to(torch.int32))
    return out, torch.stack(toks, 1), cache, prefill, _collectives(), ms


def _greedy_one_device(torch, cfg, params, batch, lens, steps):
    """The one-device ``ServeEngine`` on the same batch: (next-token
    logits per step, its ``steps + 1`` greedy tokens, ms per decode
    step)."""
    import dataclasses

    from repro_torch.serving import ServeConfig, ServeEngine

    engine = ServeEngine(cfg, params, ServeConfig(
        max_len=serve_max_len(cfg), max_new_tokens=steps + 1))
    seen = []
    decode = engine.model.decode

    def recorded(*a, **kw):
        logits, cache = decode(*a, **kw)
        seen.append(logits[:, -1])
        return logits, cache
    engine.model = dataclasses.replace(engine.model, decode=recorded)
    first, cache = engine.prefill(batch["tokens"], lens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = engine.decode(first, cache, lens)
    torch.cuda.synchronize()
    return [first] + seen, toks, (time.perf_counter() - t0) * 1e3 / steps


def _tie_agreement(torch, got, want, got_tok, want_tok, gate):
    """Greedy tokens equal, but for a bf16 near tie (``tests/
    test_torch_transformer_serving.py``): up to the first step whose
    token differs every step's logits lie within ``gate`` × max|want|,
    and there the card's token is a maximum of the one-device logits to
    that resolution; rows apart after it are not compared. Returns (ok,
    worst share of max|want|, rows that parted at a tie)."""
    ok, worst, parted = True, 0.0, []
    for b in range(got_tok.shape[0]):
        for t in range(got_tok.shape[1]):
            w = want[t][b].float()
            d = float((got[t][b].float() - w).abs().max())
            top = float(w.abs().max())
            worst = max(worst, d / top)
            ok &= d <= gate * top
            if int(got_tok[b, t]) != int(want_tok[b, t]):
                ok &= float(w[int(got_tok[b, t])]) >= float(w.max()) \
                    - gate * top
                parted.append((b, t))
                break
    return ok, worst, parted


def serve_tp_phase(torch, mesh, arch=LLAMA, n_layers=None,
                   dtype="bfloat16"):
    """``[serve-tp]``: ``arch`` at its published widths (depth cut to
    ``n_layers`` where given) served on the (1, 1) ``(data, model)``
    mesh through ``repro_torch.launch.dryrun_lib``: the [serve] prompts
    (the launcher's draw over its vocabulary: 871, 596, 1001 and 802
    ids) as one right-padded batch, ``prefill_on_mesh`` into a
    ``serve_max_len`` cache, then 32 greedy ``decode_on_mesh`` steps,
    under ``serve_rules`` (the KV-slot sweep over ``model``, the
    vocab-parallel head's logits gathered). Held against the one-device
    ``ServeEngine`` on the same weights: llama3.2-3b at full depth in
    bf16 compute, greedy tokens equal but for a bf16 near tie and every
    step's next-token logits within 2^-5·max|want|; deepseek-v2-lite-16b
    at layer 0 + 1 MoE layer in fp32 (absorbed MLA with the latent
    cache's slot sweep, the expert-parallel dispatch on one rank), the
    [equiv] gates: logits within rtol = atol = 1e-4 and every token
    equal, MLA's expanded branch never taken; mamba2-780m at full depth
    in bf16 compute as llama, its Mamba2 layers on the rank's SSD heads
    (the SSD kernel once per layer in the prefill). The cache leaves at
    the shapes ``cache_partition_specs`` places. Returns {kernel: {path:
    launches}} of the kernels the prefill ran."""
    from repro_torch.common.pytree import tree_leaves_with_paths
    from repro_torch.configs import get_arch_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.dryrun_lib import _cache_specs
    from repro_torch.launch.mesh import serve_rules
    from repro_torch.launch.serve import draw_prompts
    from repro_torch.models import attention, get_model
    from repro_torch.models.model import cache_specs
    from repro_torch.serving import serve_batches

    t0 = time.perf_counter()
    cfg = get_arch_config(arch).with_(compute_dtype=dtype)
    if n_layers:
        cfg = cfg.with_(n_layers=n_layers, param_dtype="float32")
    label = f"[serve-tp] {arch}" + (f", {n_layers} layers" if n_layers
                                   else "")
    prompts = draw_prompts(cfg.vocab_size, 4, 1024, 0)
    lens = [len(p) for p in prompts]
    toks, _ = serve_batches(prompts, 4, device="cuda")[0]
    batch = {"tokens": toks, "positions": torch.arange(
        toks.shape[1], dtype=torch.int32, device="cuda").expand(4, -1)}
    params = get_model(cfg).init(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    steps = 32
    shape = ShapeConfig("serve_tp", serve_max_len(cfg), 4, "prefill")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    expanded = []
    plain = (attention.softmax_attention, attention._slot_attention)
    if cfg.mla is not None:          # MLA's expanded branch, either form
        attention.softmax_attention = (
            lambda *a, **kw: expanded.append(1) or plain[0](*a, **kw))
        attention._slot_attention = (
            lambda *a, **kw: expanded.append(1) or plain[1](*a, **kw))
    reset_launches()
    try:
        with torch.no_grad():
            got, got_tok, cache, pre_c, step_c, ms = _greedy_on_mesh(
                torch, cfg, shape, mesh, params, batch, lens, steps)
    finally:
        attention.softmax_attention, attention._slot_attention = plain
    launched = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    placed = SH.place(cache_specs(cfg, shape), _cache_specs(
        cfg, shape, serve_rules(mesh, 4)), mesh, cfg)
    shapes_ok = all(tuple(x.shape) == tuple(w.shape) for (_, x), (_, w) in
                    zip(tree_leaves_with_paths(cache),
                        tree_leaves_with_paths(placed)))
    kv = tree_leaves_with_paths(cache)[0]
    del cache
    with torch.no_grad():
        want, want_tok, one_ms = _greedy_one_device(torch, cfg, params,
                                                    batch, lens, steps)
    if dtype == "bfloat16":
        ok, worst, parted = _tie_agreement(torch, got, want, got_tok,
                                           want_tok, BF16_GATE)
        gate = f"2^-5·max|want|, ties {parted}"
    else:
        worst = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ok = bool(torch.equal(got_tok, want_tok)) and all(
            torch.allclose(g, w, rtol=1e-4, atol=1e-4)
            for g, w in zip(got, want))
        top = max(float(w.abs().max()) for w in want)
        gate = (f"{worst / top:.3e} of max|want|; rtol = atol = 1e-4, "
                f"tokens equal")
        parted = []
    tokens_equal = int((got_tok == want_tok).all(1).sum())
    # a prefill with a cache runs the SSD kernel in each Mamba2 layer (on
    # the rank's heads) and no flash: attention reads its cache's slots
    want_launches = dict({k: 0 for k in KERNELS},
                         ssd_intra_chunk=kernel_layers(cfg)[0])
    print(f"{label}: {cfg.n_layers} layers, {cfg.param_dtype} weights, "
          f"{cfg.compute_dtype} compute, (1, 1) (data, model) mesh over "
          f"NCCL; prompts {lens} as one batch, max_len "
          f"{serve_max_len(cfg)}; prefill {ms[0]:.2f} ms (the first "
          f"includes the card's warm-up), decode ms per step median "
          f"{sorted(ms[1:])[len(ms[1:]) // 2]:.2f} (the one-device "
          f"engine's {one_ms:.2f} a step, host clock); peak memory "
          f"{peak / 2 ** 30:.3f} GiB; cache leaf {'/'.join(kv[0])} "
          f"{tuple(kv[1].shape)}, every leaf at its placed shape "
          f"{shapes_ok}; collectives of the prefill: {pre_c}; of a decode "
          f"step: {step_c}; "
          + (f"MLA expanded calls {len(expanded)}; " if cfg.mla else "")
          + "launches " + ", ".join(f"{k} {v}" for k, v in launched.items())
          + f"; against the one-device ServeEngine: rows with every token "
          f"equal {tokens_equal} of 4, logits apart by at most {worst:.3e}"
          f"{' of max|want|' if dtype == 'bfloat16' else ''} ({gate}) -> "
          f"{'ok' if ok and shapes_ok and launched == want_launches else 'FAIL'}; "
          f"{time.perf_counter() - t0:.1f} s")
    check(ok, f"{label}: the mesh's tokens or logits differ from one "
              f"device")
    check(shapes_ok, f"{label}: a cache leaf is not at its placed shape")
    check(cfg.mla is None or not expanded,
          f"{label}: MLA took the expanded branch {len(expanded)} times")
    check(launched == want_launches,
          f"{label}: launches {launched} != {want_launches}")
    del params, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return {"ssd_intra_chunk": {label: launched["ssd_intra_chunk"]}} \
        if launched["ssd_intra_chunk"] else {}


def score_tp_phase(torch, mesh, arch=LLAMA, cut=None, param_dtype=None):
    """``[score-tp] arch``: the cache-free pass over 2 x 4096 ids
    (musicgen: 2 x 1500 frames; ``_score_batch``) at its published
    widths (depth cut by ``cut``, a dict of config overrides, where
    given; weights in ``param_dtype`` where given) with bf16 compute
    under ``serve_rules`` on the (1, 1) mesh: the full logits (the
    vocab-parallel head's columns gathered) against the one-device pass
    within 2^-5·max|want|; the flash kernel once per attention layer
    and the SSD kernel once per Mamba2 layer in each pass, on the rank's
    heads (``kernel_layers``). Returns {kernel: {path: launches}}."""
    from repro_torch.common.sharding import COLLECTIVES, axis_rules, set_mesh
    from repro_torch.configs import get_arch_config
    from repro_torch.launch.mesh import serve_rules
    from repro_torch.models import get_model

    t0 = time.perf_counter()
    cfg = get_arch_config(arch).with_(**(cut or {}))
    if param_dtype:
        cfg = cfg.with_(param_dtype=param_dtype)
    label = f"[score-tp] {arch}" + (f", {SCORE_TP_DEPTH[arch]}" if cut
                                   else "")
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    batch = _score_batch(torch, cfg, MUSICGEN_FRAMES
                         if cfg.family == "audio" else SCORE_S)
    batch = {k: v for k, v in batch.items() if k != "labels"}
    with torch.no_grad():
        want, _ = model.forward(cfg, params, batch, None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        passes, ms = 2, []
        reset_launches()
        COLLECTIVES.clear()
        with set_mesh(mesh), axis_rules(serve_rules(mesh, SCORE_B)):
            for _ in range(passes):
                t1 = time.perf_counter()
                got, _ = model.forward(cfg, params, batch, None)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t1) * 1e3)
        launched = launch_counts()
        coll = _collectives()
        top = float(want.float().abs().max())
        d = float((got.float() - want.float()).abs().max())
    ok = d <= BF16_GATE * top and got.shape == want.shape
    n_ssd, n_flash = kernel_layers(cfg)
    want_launches = dict({k: 0 for k in KERNELS},
                         flash_attention=n_flash * passes,
                         ssd_intra_chunk=n_ssd * passes)
    print(f"{label}: {widths(cfg)}; {tuple(batch['tokens'].shape)} ids, "
          f"{cfg.n_layers} layers, {cfg.param_dtype} weights, bf16 "
          f"compute, cache-free, on the (1, 1) mesh under serve_rules;"
          f" ms per pass {', '.join(f'{x:.2f}' for x in ms)}; full logits "
          f"{tuple(got.shape)} against one device: max abs {d:.3e} "
          f"({d / top:.3e} of max|want|, gate 2^-5); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; "
          f"collectives over {passes} passes: {coll}; launches "
          + ", ".join(f"{k} {v}" for k, v in launched.items())
          + f" -> {'ok' if ok and launched == want_launches else 'FAIL'}; "
          f"{time.perf_counter() - t0:.1f} s")
    check(ok, f"{label}: the mesh's full logits differ from one device")
    check(launched == want_launches,
          f"{label}: launches {launched} != {want_launches}")
    del params, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return {name: {label: launched[name]}
            for name in ("flash_attention", "ssd_intra_chunk")
            if launched[name]}


def group_tp_phase(torch):
    """``[group-tp]``: ``GroupServeEngine(mesh=)`` on a (1, 1) ``(pod,
    "agent")`` mesh over NCCL, llama3.2-3b's widths cut to 2 layers, 4
    agents (agent a from seed a), 4 slots, 8 requests of the launcher's
    draw (prompt-len 64) round-robin, 8 greedy tokens: every token equal
    to the one-process engine's on the same planes; each slot's rows come
    through the owner-masked all-reduce (``plane_rows``), each
    admission's logits and cache through broadcasts from the owner."""
    from repro_torch.common.sharding import COLLECTIVES
    from repro_torch.configs import get_arch_config
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.launch.serve import agent_planes, draw_prompts
    from repro_torch.launch.shardings import AgentPlanes
    from repro_torch.serving import (GroupRequest, GroupServeEngine,
                                     ParamStore, ServeConfig)

    t0 = time.perf_counter()
    label = "[group-tp] llama3.2-3b, 2 layers"
    cfg = get_arch_config(LLAMA).with_(n_layers=2)
    mesh = make_pod_mesh(1, device_type="cuda")
    planes = agent_planes(cfg, 4, 0, "cuda")
    serve = ServeConfig(max_len=128, max_new_tokens=8)
    reqs = [GroupRequest(rid, rid % 4, pr) for rid, pr in
            enumerate(draw_prompts(cfg.vocab_size, 8, 64, 0))]
    results, secs = {}, {}
    torch.cuda.reset_peak_memory_stats()
    for kind in ("one process", "mesh"):
        placer = AgentPlanes.on(mesh, 4) if kind == "mesh" else None
        store = ParamStore(planes, donate=True, placer=placer)
        engine = GroupServeEngine(cfg, store, serve, batch_size=4,
                                  prompt_pad=16,
                                  mesh=mesh if kind == "mesh" else None)
        COLLECTIVES.clear()
        t1 = time.perf_counter()
        results[kind] = engine.run(reqs)
        torch.cuda.synchronize()
        secs[kind] = time.perf_counter() - t1
        del engine, store
    coll = _collectives()
    same = results["mesh"] == results["one process"]
    print(f"{label}: 4 agents on a (1, 1) (pod, agent) mesh over NCCL, 4 "
          f"slots, {len(reqs)} requests x 8 greedy tokens: tokens equal to "
          f"the one-process engine's {same}; {secs['mesh']:.2f} s on the "
          f"mesh, {secs['one process']:.2f} s without; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; "
          f"collectives on the mesh: {coll} -> {'ok' if same else 'FAIL'}; "
          f"{time.perf_counter() - t0:.1f} s")
    check(same, f"{label}: tokens differ from the one-process engine")
    del planes
    gc.collect()
    torch.cuda.empty_cache()


def model_axis_phases(torch, table):
    """``[tp]`` (llama3.2-3b, then mamba2-780m), ``[tp-pods]`` (the
    (1, 1, 1) ``(pod, data, model)`` mesh), ``[init-slice]`` (no group
    needed), ``[equiv] experts ep``,
    ``[serve-tp]``, ``[score-tp]`` and ``[group-tp]`` in one one-rank
    NCCL group, destroyed after them, then ``[kernel] grad_sketch
    strided``. The families that came to the model axis last take
    ``[tp] mamba2-780m, 4 layers``, ``[serve-tp] mamba2-780m`` and
    ``[score-tp]`` of zamba2-7b (2 super-blocks), qwen2-vl-72b (2
    layers, bf16 weights) and musicgen-medium, timed together."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_arch_config
    mesh = _one_rank_nccl(torch)
    paths = []
    try:
        paths.append(tp_phase(torch, mesh))
        t0 = time.perf_counter()
        paths.append(tp_pods_phase(torch))
        init_slice_phase(torch)
        print(f"[time] [tp-pods] and [init-slice]: "
              f"{time.perf_counter() - t0:.1f} s")
        expert_parallel_phase(torch, mesh)
        t0 = time.perf_counter()
        serve_tp_phase(torch, mesh)
        paths.append(score_tp_phase(torch, mesh))
        serve_tp_phase(torch, mesh, DEEPSEEK, 2, "float32")
        group_tp_phase(torch)
        print(f"[time] serving on the mesh: "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        paths.append(tp_phase(torch, mesh, MAMBA, 4))
        paths.append(serve_tp_phase(torch, mesh, MAMBA))
        zamba = get_arch_config(ZAMBA).hybrid
        paths.append(score_tp_phase(torch, mesh, ZAMBA, dict(
            n_layers=11, hybrid=dataclasses.replace(zamba,
                                                    n_super_blocks=2))))
        paths.append(score_tp_phase(torch, mesh, QWEN_VL, dict(n_layers=2),
                                    "bfloat16"))
        paths.append(score_tp_phase(torch, mesh, MUSICGEN))
        print(f"[time] the ssm, hybrid, VLM and audio families on the "
              f"mesh: {time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()
    table["grad_sketch"]["strided"] = sketch_strided_phase(torch)
    launches = {}
    for by_kernel in paths:
        for name, by_path in by_kernel.items():
            launches.setdefault(name, {}).update(by_path)
    return launches


def _state_to(torch, state, dev):
    def to(x):
        if isinstance(x, dict):
            return {k: to(v) for k, v in x.items()}
        return x.to(dev) if isinstance(x, torch.Tensor) else x
    know = type(state.know)(*(to(x) for x in state.know))
    return state._replace(params=to(state.params),
                          opt_state=to(state.opt_state), know=know)


def sketch_leaf_phase(torch, p_big):
    """The gradient-sketch kernel on the trainer's own leaves: signs
    through the kernel bitwise at mamba2-780m's 77.2 M-position
    embedding leaf at an offset near its 0.86 B parameters (positions
    past 2^24 and near the leaf's end); a dense (2, 2^23) slice at an
    offset near 0.86 B against the plain version (which builds S a tile
    at a time), within 1e-5·Σ_p |G[r, p]| per row; and the time of
    one launch at the trainer's largest leaf (a stacked (48, 1536, 3072)
    projection: 2 x 226.5 M positions → 256) beside its bound.
    torch.matmul(G, S) there would need a 232 GB S, so the yardstick is
    taken on the slice, with the kernel and the plain pieces beside it."""
    from repro_torch.core.relevance import fold_seed
    from repro_torch.kernels.grad_sketch import ops, ref

    seed, d = fold_seed(0, 2), SKETCH_DIM
    p_embed, offset = 50280 * 1536, 780_000_000
    pos = [0, 2 ** 24 + 3, p_embed - 2, p_embed - 1]
    G = torch.zeros((len(pos), p_embed), device="cuda")
    G[torch.arange(len(pos)), torch.tensor(pos)] = 1.0
    got = ops.sketch_flat(G, seed, d, offset=offset)
    want = torch.cat([ref.sign_block(seed, offset + q, 1, d, "cuda")
                      for q in pos])
    check(torch.equal(got, want), "sketch signs differ on the embedding leaf")
    del G
    print(f"[kernel] grad_sketch signs on the embedding leaf (P {p_embed:,},"
          f" offset {offset:,}, positions {pos}): bitwise -> ok")
    g = torch.Generator(device="cuda").manual_seed(5)
    G = torch.randn((2, p_big), generator=g, device="cuda")
    ms, host = time_ms(torch, lambda: ops.sketch_flat(G, seed, d), 5)
    b_ms, b_by = sketch_bound(2, p_big, d)
    del G
    cut, piece, off = 2 ** 23, 2 ** 18, 850_000_000
    Gs = torch.randn((2, cut), generator=g, device="cuda")

    def plain():                      # S a tile of positions at a time
        return ref.sketch_flat(Gs, seed, d, offset=off)
    got = ops.sketch_flat(Gs, seed, d, offset=off)
    err = (got - plain()).abs()
    gate = 1e-5 * Gs.abs().sum(1, keepdim=True)
    print(f"[kernel] grad_sketch dense (2, 2^23, {d}) at offset {off:,} "
          f"against its plain version: max abs "
          f"{float(err.max()):.3e}, worst {float((err / gate).max()):.3e} "
          f"of 1e-5·Σ|G| per row -> "
          f"{'ok' if bool((err <= gate).all()) else 'FAIL'}")
    check(bool((err <= gate).all()),
          "sketch kernel disagrees with its plain version on a dense slice "
          "near 0.86 B")
    ms_s, _ = time_ms(torch, lambda: ops.sketch_flat(Gs, seed, d,
                                                     offset=off), 20)
    plain_s, _ = time_ms(torch, plain, 3)
    S = torch.empty((cut, d), device="cuda")          # outside the timing
    for start in range(0, cut, piece):
        S[start:start + piece] = ref.sign_block(seed, off + start, piece, d,
                                                "cuda")
    lib_ms, _ = time_ms(torch, lambda: torch.matmul(Gs, S), 20)
    del S, Gs
    torch.cuda.empty_cache()
    print(f"[kernel] grad_sketch at the trainer's largest leaf (n, P, d) = "
          f"(2, {p_big:,}, {d}): device {ms:.5f} ms ({b_ms / ms:.1%} of the "
          f"{b_ms:.5f} ms bound, {b_by}: 2·n·P·d fp32 flops at 67 TFLOP/s "
          f"vs 4·n·P bytes at 3.35 TB/s), host per call {host:.5f} ms; at "
          f"(2, 2^23, {d}): kernel {ms_s:.5f} ms, plain "
          f"{plain_s:.5f} ms, torch.matmul(G, S) with S built outside the "
          f"timing {lib_ms:.5f} ms")
    return dict(big_ms=ms, big_bound_ms=b_ms, big_p=p_big, slice_ms=ms_s,
                slice_plain_ms=plain_s, slice_lib_ms=lib_ms)


def _host_init(torch, cfg, seed):
    """``cfg``'s weights drawn on the card from ``seed`` (a host draw of
    a published width takes seconds a layer) and copied to the host."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.models import get_model

    params = get_model(cfg).init(
        cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    return tree_map(lambda t: t.cpu(), params)


def _cut_to_two_layers(torch, arch):
    """``arch`` at its published widths cut to 2 layers with fp32
    compute, and its weights from seed 0 on the host."""
    from repro_torch.configs import get_arch_config

    cfg = get_arch_config(arch).with_(n_layers=2, compute_dtype="float32")
    return cfg, _host_init(torch, cfg, 0)


def _cut_hybrid(torch):
    """zamba2-7b at its published widths cut to one super-block of one
    Mamba2 layer and the tail layer, fp32 compute, its weights from seed
    0 on the host and every LoRA ``b`` drawn non-zero (the init's zeros
    would leave the merge untested)."""
    from repro_torch.configs import HybridConfig, get_arch_config

    cfg = get_arch_config(ZAMBA).with_(
        n_layers=3, compute_dtype="float32",
        hybrid=HybridConfig(n_super_blocks=1, mamba_per_block=1,
                            tail_mamba=1, lora_rank=128))
    params = _host_init(torch, cfg, 0)
    gen = torch.Generator().manual_seed(1)
    for fac in params["lora"].values():
        fac["b"] = torch.randn(fac["b"].shape, generator=gen) * 0.05
    return cfg, params


# greedy tokens of each [equiv] serve request: the CPU side's decode steps
# set the serving equivalence's time (zamba2-7b's 32 took 54 s there)
EQUIV_TOKENS = 8
# the CPU side's prefill sets the rest: a [serve] prompt longer than
# EQUIV_LONG ids is cut to its first third (871, 596, 1001, 802 ids ->
# 290, 198, 333, 267: still ragged, two of them past the SSD's chunk of
# 256); the card runs the full prompts in [serve]
EQUIV_LONG = 512


def _equiv_prompts(prompts):
    return [p if len(p) <= EQUIV_LONG else p[:len(p) // 3] for p in prompts]


def _logit_atol(cfg, logits):
    """The absolute part of the card-against-CPU logit gate: 1e-4, or
    for musicgen 1e-4 × the logits' standard deviation. Its heads (4,
    E, V) take their fan-in from their first axis, 4, as the
    reference's ``dense_init`` does, so random weights give logits of
    std ~17 (``[score] musicgen-medium``), and an fp32 difference of
    the same relative size sits ~17 times higher than at the other
    archs' std of ~1."""
    if cfg.family != "audio":
        return 1e-4
    return 1e-4 * float(logits.float().std())


def equiv_serve_phase(torch, arch, prompts, cut=None, depth="2 layers"):
    """The card against the port's CPU path on the [serve] prompts (cut,
    ``_equiv_prompts``), at ``arch``'s widths cut to ``depth`` with fp32 compute, on the same
    weights (``_host_init``): prefill logits
    within rtol = atol = 1e-4 (matmuls and, for mamba2-780m and
    zamba2-7b, the SSD kernel sum in another fp32 order than the CPU),
    EQUIV_TOKENS greedy tokens of every request equal; the SSD kernel
    launched once per Mamba2 layer per prefill on the card, no flash
    kernel (prefill passes a cache), none on the CPU."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.serving import ServeConfig, ServeEngine, serve_batches

    cfg, params = cut or _cut_to_two_layers(torch, arch)
    prompts = _equiv_prompts(prompts)
    serve = ServeConfig(max_len=serve_max_len(cfg),
                        max_new_tokens=EQUIV_TOKENS)
    results, launched, secs = {}, {}, {}
    for dev in ("cpu", "cuda"):
        engine = ServeEngine(cfg, tree_map(lambda t: t.to(dev), params),
                             serve)
        reset_launches()
        t0 = time.perf_counter()
        results[dev] = []
        for toks, lens in serve_batches(prompts, 2, device="cpu"):
            logits, cache = engine.prefill(toks.to(dev), lens)
            out = engine.decode(logits, cache, lens)
            results[dev].append((logits.cpu(), out.cpu()))
        secs[dev] = time.perf_counter() - t0
        launched[dev] = launch_counts()
    errs, rels, same = [], [], True
    for (lg_c, out_c), (lg_g, out_g) in zip(results["cpu"], results["cuda"]):
        d = (lg_g - lg_c).abs()
        errs.append(float(d.max()))
        rels.append(float((d / lg_c.abs().clamp_min(1e-30)).max()))
        same = same and torch.equal(out_g, out_c)
    want = {name: 0 for name in KERNELS}
    want_cuda = dict(want)
    want_cuda["ssd_intra_chunk"] = kernel_layers(cfg)[0] * len(errs)
    atol = min(_logit_atol(cfg, c[0]) for c in results["cpu"])
    ok = (all(torch.allclose(g[0], c[0], rtol=1e-4, atol=atol) for g, c in
              zip(results["cuda"], results["cpu"])) and same
          and launched == {"cpu": want, "cuda": want_cuda})
    print(f"[equiv] serve {arch} widths, {depth}, fp32, {len(prompts)} "
          f"requests x {EQUIV_TOKENS} greedy tokens, card vs CPU: prefill "
          f"logits max abs "
          f"{max(errs):.3e} (max rel {max(rels):.3e}; rtol=1e-4, atol="
          f"{atol:.3g}), "
          f"greedy tokens equal {same}, card launches "
          + ", ".join(f"{k} {v}" for k, v in launched["cuda"].items())
          + f"; CPU {secs['cpu']:.1f} s, card {secs['cuda']:.1f} s "
          f"-> {'ok' if ok else 'FAIL'}")
    check(ok, f"card and CPU serving paths disagree: {arch}")


def equiv_score_phase(torch, cut, arch=LLAMA, depth="2 layers"):
    """The scoring path on the card against the port's CPU path at
    ``arch``'s widths cut to ``depth`` with fp32 compute, on the same
    weights, 2 rows of 320 positions (ids; musicgen and
    qwen2-vl: ``_score_batch`` of 320 positions, a non-zero ``cond`` or
    a vision prefix of 256): logits within rtol = atol = 1e-4 and
    the loss within a relative 1e-5 (the flash and SSD kernels, on the
    card, against their plain versions, on the CPU, and matmuls summed
    in other orders); each kernel launched once per layer it serves in
    each of the two passes on the card, never on the CPU."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.models import get_model

    cfg, params = cut
    model = get_model(cfg)
    batch = {k: t.cpu() for k, t in _score_batch(torch, cfg, 320,
                                                 seed=1).items()}
    out, launched = {}, {}
    with torch.no_grad():
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev), params)
            b = {k: t.to(dev) for k, t in batch.items()}
            reset_launches()
            logits, _ = model.forward(cfg, p, b, None)
            out[dev] = (logits.cpu(), float(model.loss(cfg, p, b)))
            launched[dev] = {k: n for k, n in launch_counts().items() if n}
    ssd, flash = kernel_layers(cfg)
    want_cuda = {k: 2 * n for k, n in (("ssd_intra_chunk", ssd),
                                       ("flash_attention", flash)) if n}
    d = (out["cuda"][0] - out["cpu"][0]).abs()
    loss_err = abs(out["cuda"][1] - out["cpu"][1])
    atol = _logit_atol(cfg, out["cpu"][0])
    ok = (torch.allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=atol)
          and loss_err <= 1e-5 * abs(out["cpu"][1])
          and launched == {"cpu": {}, "cuda": want_cuda})
    print(f"[equiv] score {arch} widths, {depth}, fp32, 2 x 320 "
          f"positions, card "
          f"vs CPU: logits max abs {float(d.max()):.3e} (rtol=1e-4, atol="
          f"{atol:.3g}), "
          f"loss {out['cuda'][1]:.6f} vs {out['cpu'][1]:.6f} (rel "
          f"1e-5), launches {launched} (forward + loss) -> "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"card and CPU scoring paths disagree: {arch}")


def profile_serve_phase(torch, prompts, ssd_kernels):
    """The device's busy share and the ops that take the time at full
    width, after a warm-up: one prefill of the first [serve] batch in
    one profiler window, with the time of every kernel of the SSD
    library (``ssd_kernels``: the instances ptxas reported when it was
    built), 4 decode steps in another; then the same split on the host
    clock with the profiler off."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch_config
    from repro_torch.kernels.cuda_build import short_name
    from repro_torch.models import get_model
    from repro_torch.serving import ServeConfig, ServeEngine, serve_batches

    cfg = get_arch_config("mamba2-780m")
    params = get_model(cfg).init(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    engine = ServeEngine(cfg, params, ServeConfig(max_len=128,
                                                  max_new_tokens=5))
    toks, lens = serve_batches(prompts[:2], 2, device="cpu")[0]
    toks = toks.to("cuda")
    engine.generate(toks, lens)                       # warm-up
    torch.cuda.synchronize()
    state = {}

    def prefill():
        state["prefill"] = engine.prefill(toks, lens)

    def decode():
        engine.decode(*state["prefill"], lens)

    for label, fn in (("prefill", prefill), ("4 decode steps", decode)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.events()
                   if getattr(e, "device_type", None) is not None
                   and str(e.device_type).endswith("CUDA")]
        busy_us = sum(e.time_range.elapsed_us() for e in kernels)
        rows = [(ev.key, ev.count,
                 getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0)),
                 getattr(ev, "self_cpu_time_total", 0.0))
                for ev in prof.key_averages()]
        ssd = [r for r in rows if short_name(r[0]) in ssd_kernels]
        ssd_us = sum(r[2] for r in ssd)
        print(f"[profile] serve mamba2-780m {label}, batch of "
              f"{toks.shape[0]} x {toks.shape[1]} prompt tokens: wall "
              f"{wall * 1e3:.1f} ms, device busy {busy_us / 1e3:.2f} ms "
              f"({busy_us / (wall * 1e6):.1%}), {len(kernels)} device "
              f"kernels, the SSD library's kernels {ssd_us / 1e3:.3f} ms "
              f"({ssd_us / max(busy_us, 1e-9):.1%} of the busy time) in "
              f"{sum(r[1] for r in ssd)} calls of "
              f"{sorted(short_name(r[0]) for r in ssd)}")
        if label == "prefill":
            check(bool(ssd), f"no kernel of the SSD library in the prefill "
                             f"profile (its kernels: {sorted(ssd_kernels)})")
        for what, col in (("device", 2), ("self host", 3)):
            for key, count, dev_us, cpu_us in sorted(
                    rows, key=lambda r: -r[col])[:6]:
                print(f"[profile]   by {what} time: {key[:60]}: {count} "
                      f"calls, device {dev_us:.0f} us, self host "
                      f"{cpu_us:.0f} us")
    times = {"prefill": [], "decode step": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        decode()
        torch.cuda.synchronize()
        times["prefill"].append((t1 - t0) * 1e3)
        times["decode step"].append((time.perf_counter() - t1) * 1e3 / 4)
    print("[profile] serve, host clock, profiler off, 3 repetitions (ms): "
          + "; ".join(f"{k} " + ", ".join(f"{v:.2f}" for v in vs)
                      for k, vs in times.items()))


def profile_score_phase(torch, cfg, params, libraries, label=SCORE_LABEL):
    """The device's busy share and the ops that take the time over one
    full-width scoring pass (the loss of SCORE_B x SCORE_S ids), after
    the warm-up of the [score] phase, with the share of the busy time of
    every kernel of each library the pass runs (``libraries``: {"flash"
    or "SSD": the instances ptxas reported when it was built, whatever
    they are named})."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.cuda_build import short_name
    from repro_torch.models import get_model

    model = get_model(cfg)
    batch = _llama_batch(torch, cfg, SCORE_B, SCORE_S)
    with torch.no_grad():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.loss(cfg, params, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA")]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    rows = [(ev.key, ev.count,
             getattr(ev, "device_time_total",
                     getattr(ev, "cuda_time_total", 0.0)),
             getattr(ev, "self_cpu_time_total", 0.0))
            for ev in prof.key_averages()]
    shares = []
    for lib, names in libraries.items():
        mine = [r for r in rows if short_name(r[0]) in names]
        us = sum(r[2] for r in mine)
        shares.append(f"the {lib} library's kernels {us / 1e3:.3f} ms "
                      f"({us / max(busy_us, 1e-9):.1%} of the busy time) in "
                      f"{sum(r[1] for r in mine)} calls of "
                      f"{sorted(short_name(r[0]) for r in mine)}")
        check(bool(mine), f"{label}: no kernel of the {lib} library in the "
                          f"profile (its kernels: {sorted(names)})")
    print(f"[profile] score {cfg.name}, one loss pass over {SCORE_B} x "
          f"{SCORE_S} ids: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms ({busy_us / (wall * 1e6):.1%}), "
          f"{len(kernels)} device kernels, " + "; ".join(shares))
    for what, col in (("device", 2), ("self host", 3)):
        for key, count, dev_us, cpu_us in sorted(rows,
                                                 key=lambda r: -r[col])[:8]:
            print(f"[profile]   by {what} time: {key[:60]}: {count} calls, "
                  f"device {dev_us:.0f} us, self host {cpu_us:.0f} us")


# ---------------------------------------------------------------------
# continuous batching and multi-tenant group serving
# ---------------------------------------------------------------------
SLOT_ARCH = "mamba2-780m"
# the slot engines' depth for mamba2-780m, llama3.2-3b and musicgen-medium
# (published widths; [serve], [load] and [train] keep the whole depth):
# their host-bound steps and the B = 1 reference runs scale with it
SLOT_LAYERS = 8
LOAD_REQUESTS = 16


class _StepClock:
    """Host ms of every ``SlotBatch.step`` while installed: each step
    ends with its one device→host copy, so its host time is the step's
    time."""

    def __init__(self):
        from repro_torch.serving import continuous
        self._cls, self.ms = continuous.SlotBatch, []
        self._orig = self._cls.step

    def __enter__(self):
        orig, ms = self._orig, self.ms

        def timed(slots, *args, **kw):
            t0 = time.perf_counter()
            out = orig(slots, *args, **kw)
            ms.append((time.perf_counter() - t0) * 1e3)
            return out

        self._cls.step = timed
        return self

    def __exit__(self, *exc):
        self._cls.step = self._orig

    def summary(self) -> str:
        ms = sorted(self.ms)
        return (f"{len(ms)} steps, ms per step median "
                f"{ms[len(ms) // 2]:.2f}, min {ms[0]:.2f}, max {ms[-1]:.2f}")


def _padded_prompt(torch, cfg, prompt, prompt_pad, max_len):
    """(1, W) ids on the card and host lengths of ``prompt`` padded to
    the width the slot engines prefill it at."""
    from repro_torch.serving.continuous import prefill_width
    toks = torch.zeros((1, prefill_width(cfg, prompt_pad, len(prompt),
                                         max_len)), dtype=torch.int32)
    toks[0, :len(prompt)] = torch.tensor(prompt, dtype=torch.int32)
    return toks.to("cuda"), [len(prompt)]


def _alone(torch, cfg, params, serve, prompt, prompt_pad):
    """The fixed-batch ServeEngine's greedy tokens for ``prompt`` alone
    (B = 1), padded as the slot engines pad it, and the logits (V,) of
    each decode step, on the host."""
    import dataclasses

    from repro_torch.serving import ServeEngine
    from repro_torch.serving.api import last_logits
    toks, lens = _padded_prompt(torch, cfg, prompt, prompt_pad,
                                serve.max_len)
    engine = ServeEngine(cfg, params, serve)
    rows = []

    def decode(*args):
        logits, cache = model_decode(*args)
        rows.append(last_logits(cfg, logits)[0].float().clone())
        return logits, cache

    model_decode = engine.model.decode
    engine.model = dataclasses.replace(engine.model, decode=decode)
    logits, cache = engine.prefill(toks, lens)
    out = engine.decode(logits, cache, lens)[0].tolist()
    return out, [r.cpu() for r in rows]


class _SlotLogits:
    """Each request's decode-step logits (V,) in a slot engine (the
    sampled ones: musicgen's codebook 0): wraps
    the engine's decode (``attr``) and keeps the rows on the card until
    :meth:`rows` (no copy inside a step)."""

    def __init__(self, engine, attr, slots_of):
        from repro_torch.serving.api import last_logits
        self.engine, self.attr, self._slots_of = engine, attr, slots_of
        self._orig = getattr(engine, attr)
        self._steps = []
        assert attr not in vars(engine)        # a method of the class

        def wrapped(*args):
            live = {i: s.request_id for i, s in
                    enumerate(self._slots_of()) if not s.done}
            logits, cache = self._orig(*args)
            self._steps.append((live, last_logits(engine.cfg, logits)
                                .float().clone()))
            return logits, cache

        setattr(engine, attr, wrapped)

    def remove(self):
        # back to the class's method: no engine → wrapper → engine cycle
        # keeps the engine's planes alive past the phase
        delattr(self.engine, self.attr)

    def rows(self):
        out = {}
        for live, logits in self._steps:
            host = logits.cpu()
            for i, rid in live.items():
                out.setdefault(rid, []).append(host[i])
        self._steps = []
        return out


def _first_diff(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


FP32_LOGITS = 1e-3     # × max|logit|, full depth in fp32 compute


def _agree(got, want, got_rows, want_rows, gate=None):
    """Whether a slot engine's greedy tokens agree with the fixed-batch
    engine's on the same prompt and weights. The first token comes from
    the same B = 1 prefill and must be equal. The slot engines' decode
    products run other cuBLAS kernels (per-slot weights as a batched
    product, B rows instead of 1), which sum in other orders; with
    ``gate`` (× max|logit|) every decode step's logits up to the first
    token that differs must lie within it of the fixed-batch engine's,
    and a differing token must be a near tie: the fixed-batch engine's
    logit for the slot engine's token within twice that step's largest
    logit difference of its best. Returns (ok, what, the largest step
    difference over max|logit| before the tokens part)."""
    t = _first_diff(got, want)
    n = len(want) - 1 if t is None else t
    if t == 0 or len(got_rows) < n or len(want_rows) < n:
        return False, f"first token or step count differs (at {t})", 1.0
    share = 0.0
    for s in range(n):
        d = float((got_rows[s] - want_rows[s]).abs().max())
        share = max(share, d / float(want_rows[s].abs().max()))
        if gate is not None and share > gate:
            return False, f"step {s + 1} logits apart by {d:.3e}", share
    if t is None:
        return True, "equal", share
    w = want_rows[t - 1]
    gap = float(w[want[t]] - w[got[t]])
    d = float((got_rows[t - 1] - w).abs().max())
    return (gate is None or gap <= 2 * d,
            f"from token {t} (gap {gap:.3e}, logits apart by {d:.3e})",
            share)


def _agreement(results, rows, alone, gate=None):
    """``_agree`` for every request ({rid: (tokens, rows)} of the
    fixed-batch engine in ``alone``) → (summary, the requests that
    disagree)."""
    verdicts = {rid: _agree(results.get(rid, []), alone[rid][0],
                            rows.get(rid, []), alone[rid][1], gate)
                for rid in alone}
    equal = sum(v[1] == "equal" for v in verdicts.values())
    apart = {rid: v[1] for rid, v in verdicts.items()
             if v[0] and v[1] != "equal"}
    bad = {rid: v[1] for rid, v in verdicts.items() if not v[0]}
    text = (f"first tokens equal in {len(alone) - len(bad)} of "
            f"{len(alone)}, all tokens in {equal}"
            + (f", apart {apart}" if apart else "")
            + f"; step logits apart by at most "
              f"{max(v[2] for v in verdicts.values()):.2e} of max|logit| "
              f"before the tokens part"
            + ("" if gate is None else f" (gate {gate:g})"))
    return text, bad


def continuous_phase(torch, arch=SLOT_ARCH, n_requests=8, n_layers=None):
    """[continuous] mamba2-780m (or musicgen-medium) at its published
    widths and depth (or cut to ``n_layers``): ``n_requests`` requests
    drawn as the launcher
    draws them (seed 0, prompt-len
    1024) through 2 slots (prompt_pad 16, max_len 1056, 32 greedy
    tokens), kernel counts zeroed just before and read just after: every
    request completes, each one's first token equals the fixed-batch
    ServeEngine's on that prompt alone (the same B = 1 prefill; how many
    requests agree in every token and how far the step logits drift in
    bf16 is printed, ``_agree``), and the SSD kernel runs once per
    Mamba2 layer per admission (one B = 1 prefill each; one per layer
    for mamba2-780m, none for musicgen-medium)."""
    from repro_torch.configs import get_arch_config
    from repro_torch.launch.serve import draw_prompts
    from repro_torch.models import get_model
    from repro_torch.serving import ContinuousBatcher, ServeConfig

    label = f"[continuous] {arch}" + (f", {n_layers} layers" if n_layers
                                      else "")
    cfg = get_arch_config(arch)
    if n_layers:
        cfg = cfg.with_(n_layers=n_layers)
    params = get_model(cfg).init(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    prompts = draw_prompts(cfg.vocab_size, n_requests, 1024, 0)
    serve = ServeConfig(max_len=serve_max_len(cfg), max_new_tokens=32)
    batcher = ContinuousBatcher(cfg, params, serve, batch_size=2,
                                prompt_pad=16)
    recorder = _SlotLogits(batcher, "_decode", lambda: batcher.slots)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with _StepClock() as clock:
        t0 = time.perf_counter()
        out = batcher.run(prompts)
        secs = time.perf_counter() - t0
    recorder.remove()
    launched = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {name: 0 for name in KERNELS}
    want["ssd_intra_chunk"] = kernel_layers(cfg)[0] * len(prompts)
    alone = {rid: _alone(torch, cfg, params, serve, pr, 16)
             for rid, pr in enumerate(prompts)}
    text, bad = _agreement(out, recorder.rows(), alone)
    print(f"{label}: {len(prompts)} requests (prompt lengths "
          f"{[len(p) for p in prompts]}) through 2 slots, 32 greedy tokens, "
          f"in {secs:.2f} s; decode {clock.summary()}; peak memory "
          f"{peak / 2 ** 30:.3f} GiB; launches "
          + ", ".join(f"{k} {v}" for k, v in launched.items())
          + f"; {text}")
    check(sorted(out) == list(range(len(prompts)))
          and all(len(v) == 32 for v in out.values()),
          f"{label}: not every request completed with 32 tokens")
    check(launched == want, f"{label}: launches {launched} != {want} "
                            f"({cfg.n_layers} layers x {len(prompts)} "
                            f"admissions)")
    check(not bad, f"{label}: first tokens differ from the fixed-batch "
                   f"engine's: {bad}")
    if not want["ssd_intra_chunk"]:
        return {}
    return {"ssd_intra_chunk": {label: launched["ssd_intra_chunk"]}}


def _single_agent_steps(torch, cfg, params, serve, prompts, slots):
    """Decode-step times of the single-tenant ContinuousBatcher at
    ``slots`` slots on ``prompts``."""
    from repro_torch.serving import ContinuousBatcher
    with _StepClock() as clock:
        ContinuousBatcher(cfg, params, serve, batch_size=slots,
                          prompt_pad=16).run(prompts)
    return clock


# the stacked layer trees of each family's planes, with their depth axes
# after the agent axis: (A, L, ...), the hybrid's (A, nb, mpb, ...) and
# its shared block (A, ...)
LAYER_TREES = {"layers": 1, "mamba_blocks": 2, "shared": 0}


def _product_probe(torch, cfg, planes, slots):
    """Whether cuBLAS gives a row the same sums in the group step's
    per-slot batched product, (slots, 1, K) @ (slots, K, N), as in the
    fixed-batch engine's (slots, K) @ (K, N), for each matrix of
    agent 0's first layer (and the hybrid's shared block) at the
    compute dtype, on seeded rows → (bitwise count, total, the (name,
    K, N) that differ)."""
    from repro_torch.common.pytree import tree_leaves_with_paths
    gen = torch.Generator(device="cuda").manual_seed(0)
    cdt = cfg.dtype("compute")
    differ, total = [], 0
    leaves = [(path, leaf[(0,) * (1 + depth)])
              for key, depth in LAYER_TREES.items() if key in planes
              for path, leaf in tree_leaves_with_paths(planes[key], (key,))
              if leaf.ndim == 3 + depth and "conv" not in str(path[-2])]
    for path, w in leaves:                              # products only
        w = w.to(cdt)
        K, N = w.shape
        x = torch.randn((slots, 1, K), generator=gen, device="cuda").to(cdt)
        total += 1
        if not torch.equal(x @ w, x @ w.expand(slots, K, N).contiguous()):
            differ.append(("/".join(map(str, path)), K, N))
    return total - len(differ), total, differ


def group_phase(torch, arch, n_agents, slots, n_requests,
                param_dtype="float32", n_layers=None):
    """[group] ``arch`` at its published widths and depth (or cut to
    ``n_layers``: SLOT_LAYERS for mamba2-780m, llama3.2-3b and
    musicgen-medium): ``n_agents``
    agents' planes in ``param_dtype`` (agent a from seed a; zamba2-7b
    in bf16, where two agents' fp32 planes and a second published set
    would not fit the card), ``slots`` slots,
    ``n_requests`` requests (the launcher's draw, seed 0, prompt-len
    1024) round-robin over the agents, 16 greedy tokens, and planes from
    seeds 100 + a published (handed over) after half the requests
    finished. Every request's first token equals the single-agent
    ServeEngine's on the planes of the version it was admitted under
    (agreement in every token and the bf16 drift printed, ``_agree``;
    ``[exact]`` holds every token in fp32); requests admitted after the
    swap carry version 1;
    SSD launches one per Mamba2 layer per admission (one a layer for
    mamba2-780m, 65 for zamba2-7b), none for llama3.2-3b and
    deepseek-v2-lite-16b (its depth cut to ``n_layers``: layer 0 and 5
    MoE layers, as two full agents' bf16 planes and a publish would need
    ~94 GB; every MLA, router and expert weight gathered per slot, and
    ``layer0``'s planes without a depth index), none for musicgen-medium
    (cross-attention, the codebook tables and heads gathered per slot)
    and qwen2-vl-72b (cut to 4 layers, bf16 planes; ``serve_max_len``
    1312: each admission's prefill writes 256 vision positions ahead of
    its prompt). Then one step
    with every slot live and nothing queued, under
    ``torch.cuda.set_sync_debug_mode("warn")``: exactly one
    synchronizing call (the step's device→host copy)."""
    import warnings

    from repro_torch.common.pytree import tree_leaves_with_paths, tree_map
    from repro_torch.configs import get_arch_config
    from repro_torch.launch.serve import agent_planes, draw_prompts
    from repro_torch.serving import (GroupRequest, GroupServeEngine,
                                     ParamStore, ServeConfig, ServeMetrics)

    label = f"[group] {arch}" + (f", {n_layers} layers" if n_layers else "")
    cfg = get_arch_config(arch).with_(param_dtype=param_dtype)
    if n_layers:
        cfg = cfg.with_(n_layers=n_layers)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    store = ParamStore(agent_planes(cfg, n_agents, 0, "cuda"), donate=True)
    planes_by_version = {0: store.acquire()[0]}
    serve = ServeConfig(max_len=serve_max_len(cfg), max_new_tokens=16)
    metrics = ServeMetrics()
    engine = GroupServeEngine(cfg, store, serve, batch_size=slots,
                              prompt_pad=16, metrics=metrics)
    prompts = draw_prompts(cfg.vocab_size, n_requests, 1024, 0)
    reqs = [GroupRequest(rid, rid % n_agents, pr)
            for rid, pr in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    recorder = _SlotLogits(engine, "decode_step", lambda: engine._slots)
    reset_launches()
    finished, swapped = 0, False
    with _StepClock() as clock:
        t0 = time.perf_counter()
        while not engine.idle:
            finished += len(engine.step())
            if not swapped and finished >= n_requests // 2:
                store.publish(agent_planes(cfg, n_agents, 100, "cuda"),
                              donate=True)
                metrics.observe_swap()
                planes_by_version[1] = store.acquire()[0]
                swapped = True
        secs = time.perf_counter() - t0
    launched = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    recorder.remove()
    want = {name: 0 for name in KERNELS}
    want["ssd_intra_chunk"] = kernel_layers(cfg)[0] * n_requests
    results = dict(engine.results)
    versions = {r.rid: metrics.traces[r.rid].version for r in reqs}
    alone = {r.rid: _alone(torch, cfg,
                           tree_map(lambda p: p[r.agent_id],
                                    planes_by_version[versions[r.rid]]),
                           serve, list(r.prompt), 16) for r in reqs}
    text, bad = _agreement(results, recorder.rows(), alone)
    after = [rid for rid, v in versions.items() if v == 1]
    single = _single_agent_steps(
        torch, cfg, tree_map(lambda p: p[0], planes_by_version[1]), serve,
        prompts[:2 * slots], slots)
    # one step with every slot live and nothing queued
    engine.reset()
    for r in reqs[:slots]:
        engine.submit(r)
    engine.step()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            engine.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    engine.drain()
    gb = sum(t.numel() * t.element_size() for _, t in
             tree_leaves_with_paths(planes_by_version[0])) / 1e9
    same_sums, n_mats, differ = _product_probe(torch, cfg,
                                               planes_by_version[0], slots)
    print(f"{label}: {n_agents} agents' {param_dtype} planes ({gb:.2f} GB), "
          f"{slots} "
          f"slots, {n_requests} requests round-robin, 16 greedy tokens, "
          f"publish after {n_requests // 2} finished, in {secs:.2f} s; group "
          f"{clock.summary()}; single-agent ContinuousBatcher at {slots} "
          f"slots: {single.summary()}; peak memory {peak / 2 ** 30:.3f} GiB; "
          f"launches " + ", ".join(f"{k} {v}" for k, v in launched.items())
          + f"; versions by request {[versions[r.rid] for r in reqs]}; "
          f"against the single-agent ServeEngine on the admitted version's "
          f"planes: {text} (cuBLAS sums a row alike in the per-slot and "
          f"the fixed-batch product for {same_sums} of {n_mats} layer "
          f"matrices; differ: {differ}); synchronizing calls in one full "
          f"step: "
          f"{len(syncs)}" + ("" if len(syncs) == 1 else f" {syncs}"))
    check(sorted(results) == list(range(n_requests))
          and all(len(v) == 16 for v in results.values()),
          f"{label}: not every request completed with 16 tokens")
    check(launched == want, f"{label}: launches {launched} != {want}")
    check(swapped and after and all(v == 1 for v in
                                    list(versions.values())[min(after):]),
          f"{label}: requests admitted after the swap do not carry "
          f"version 1: {versions}")
    check(not bad, f"{label}: first tokens differ from the single-agent "
                   f"engine's: {bad}")
    check(len(syncs) == 1, f"{label}: {len(syncs)} synchronizing calls in "
                           f"one step, not the one copy: {syncs}")
    if not want["ssd_intra_chunk"]:
        return {}
    return {"ssd_intra_chunk": {label: launched["ssd_intra_chunk"]}}


def exact_slots_phase(torch, arch, n_agents, n_layers=None,
                      param_dtype="float32"):
    """[exact] ``arch`` at its published widths and depth (or cut to
    ``n_layers``, with ``param_dtype`` planes: qwen2-vl-72b at 4 layers
    in bf16) with fp32
    compute, where a different order of sums moves logits by ulps, not
    by bf16 units: ``n_agents`` requests (the launcher's draw, seed 0,
    prompt-len 1024), 8 greedy tokens, through the ContinuousBatcher (2
    slots, agent 0's weights) and the GroupServeEngine (one request per
    agent, one slot each); every request's tokens equal the fixed-batch
    ServeEngine's on its agent's weights, a near tie excepted, and every
    decode step's logits within FP32_LOGITS · max|logit| of its."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.configs import get_arch_config
    from repro_torch.launch.serve import agent_planes, draw_prompts
    from repro_torch.serving import (ContinuousBatcher, GroupRequest,
                                     GroupServeEngine, ParamStore,
                                     ServeConfig)

    cfg = get_arch_config(arch).with_(compute_dtype="float32",
                                      param_dtype=param_dtype)
    if n_layers:
        cfg = cfg.with_(n_layers=n_layers)
    gc.collect()
    torch.cuda.empty_cache()
    planes = agent_planes(cfg, n_agents, 0, "cuda")
    serve = ServeConfig(max_len=serve_max_len(cfg), max_new_tokens=8)
    prompts = draw_prompts(cfg.vocab_size, n_agents, 1024, 0)
    agent = [lambda p, a=a: p[a] for a in range(n_agents)]
    batcher = ContinuousBatcher(cfg, tree_map(agent[0], planes), serve,
                                batch_size=2, prompt_pad=16)
    rec = _SlotLogits(batcher, "_decode", lambda: batcher.slots)
    out = batcher.run(prompts)
    rec.remove()
    alone = {rid: _alone(torch, cfg, tree_map(agent[0], planes), serve, pr,
                         16) for rid, pr in enumerate(prompts)}
    text_c, bad_c = _agreement(out, rec.rows(), alone, FP32_LOGITS)
    engine = GroupServeEngine(cfg, ParamStore(planes, donate=True), serve,
                              batch_size=n_agents, prompt_pad=16)
    rec = _SlotLogits(engine, "decode_step", lambda: engine._slots)
    out = engine.run([GroupRequest(a, a, prompts[a])
                      for a in range(n_agents)])
    rec.remove()
    alone = {a: _alone(torch, cfg, tree_map(agent[a], planes), serve,
                       prompts[a], 16) for a in range(n_agents)}
    text_g, bad_g = _agreement(out, rec.rows(), alone, FP32_LOGITS)
    depth = f"{n_layers} layers" if n_layers else "depth"
    print(f"[exact] {arch}, full width and {depth}, {param_dtype} "
          f"weights, fp32 compute, "
          f"{n_agents} requests x 8 greedy tokens, against the fixed-batch "
          f"ServeEngine on each request's weights: continuous (2 slots) "
          f"{text_c}; group ({n_agents} agents, one request each) {text_g} "
          f"-> {'ok' if not bad_c and not bad_g else 'FAIL'}")
    check(not bad_c and not bad_g, f"[exact] {arch}: the slot engines "
                                   f"disagree with the fixed-batch engine: "
                                   f"{bad_c} {bad_g}")


def load_phase(torch):
    """[load] mamba2-780m: the load bench's twin at full width and depth
    (``repro_torch.benchmarks.bench_serving --full --agents 4 --slots 4
    --requests 16``, LOAD_REQUESTS; the reference's defaults otherwise: open-loop
    Poisson arrivals at 0.6 of the calibrated capacity, a hot swap
    mid-run), with its three gates (completeness, throughput ≥ 0.4 ×
    offered, p50 ≤ 6x and p99 ≤ 15x the calibrated ideal); SSD launches
    48 per admission (the calibration's 5 and the stream's 16)."""
    import contextlib
    import io

    from repro_torch.benchmarks import bench_serving
    from repro_torch.configs import get_arch_config

    label = f"[load] {SLOT_ARCH}"
    cfg = get_arch_config(SLOT_ARCH)
    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reset_launches()
    path = ROOT / "build" / "BENCH_serving_torch.json"
    path.parent.mkdir(exist_ok=True)
    try:
        with contextlib.redirect_stdout(out):
            payload = bench_serving.main(
                ["--arch", SLOT_ARCH, "--full", "--agents", "4", "--slots",
                 "4", "--requests", str(LOAD_REQUESTS), "--json",
                 str(path)])
    except SystemExit as exc:
        print(out.getvalue())
        raise SmokeFailure(f"{label}: {exc}")
    launched = launch_counts()
    for ln in out.getvalue().splitlines():
        if ln.strip():
            print(f"[load]   {ln}")
    c, s, o = payload["calibration"], payload["summary"], payload["open_loop"]
    g = payload["gates"]
    want = {name: 0 for name in KERNELS}
    want["ssd_intra_chunk"] = cfg.n_layers * (4 + 1 + LOAD_REQUESTS)
    print(f"{label}: t_step_s {c['t_step_s']:.5f}, t_prefill_s "
          f"{c['t_prefill_s']:.5f}, capacity {c['capacity_tok_s']:.1f} tok/s, "
          f"offered {o['offered_tok_s']:.1f} tok/s, achieved "
          f"{s['throughput_tok_s']:.1f} tok/s, latency p50 "
          f"{s['latency_p50']:.3f} s (bound {g['latency']['p50_bound']:.3f}), "
          f"p99 {s['latency_p99']:.3f} s (bound "
          f"{g['latency']['p99_bound']:.3f}), gates "
          + ", ".join(f"{k} {'PASS' if v['pass'] else 'FAIL'}"
                      for k, v in g.items())
          + "; launches " + ", ".join(f"{k} {v}" for k, v in launched.items()))
    check(all(v["pass"] for v in g.values()), f"{label}: a gate failed")
    check(launched == want, f"{label}: launches {launched} != {want}")
    return {"ssd_intra_chunk": {label: launched["ssd_intra_chunk"]}}


def _record_logits(fn, sink):
    def wrapped(*args):
        logits, cache = fn(*args)
        sink.append(logits.detach().float().cpu())
        return logits, cache
    return wrapped


def equiv_slots_phase(torch, arch):
    """[equiv] continuous and group at ``arch``'s widths cut to 2 layers
    with fp32 compute, card against the port's CPU path on the same
    weights (drawn on the card, copied to the host; 2 agents for the
    group, the second from seed 1): 4 requests
    (the launcher's draw, seed 1, prompt-len 64) through 2 slots, 8 greedy
    tokens; every decode step's logits within rtol = atol = 1e-4 and the
    tokens equal."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.configs import get_arch_config
    from repro_torch.launch.serve import draw_prompts
    from repro_torch.serving import (ContinuousBatcher, GroupRequest,
                                     GroupServeEngine, ServeConfig)

    cfg = get_arch_config(arch).with_(n_layers=2, compute_dtype="float32")
    p0, p1 = (_host_init(torch, cfg, s) for s in (0, 1))
    planes = tree_map(lambda a, b: torch.stack([a, b]), p0, p1)
    prompts = draw_prompts(cfg.vocab_size, 4, 64, 1)
    serve = ServeConfig(max_len=128, max_new_tokens=8)
    for engine_name in ("continuous", "group"):
        results, steps = {}, {}
        for dev in ("cpu", "cuda"):
            steps[dev] = []
            if engine_name == "continuous":
                eng = ContinuousBatcher(
                    cfg, tree_map(lambda t: t.to(dev), p0), serve,
                    batch_size=2, prompt_pad=16)
                eng._decode = _record_logits(eng._decode, steps[dev])
                results[dev] = eng.run(prompts)
            else:
                eng = GroupServeEngine(
                    cfg, tree_map(lambda t: t.to(dev), planes), serve,
                    batch_size=2, prompt_pad=16)
                eng.decode_step = _record_logits(eng.decode_step, steps[dev])
                results[dev] = eng.run([GroupRequest(i, i % 2, pr)
                                        for i, pr in enumerate(prompts)])
        errs = [float((g - c).abs().max())
                for g, c in zip(steps["cuda"], steps["cpu"])]
        ok = (len(steps["cuda"]) == len(steps["cpu"]) > 0
              and all(torch.allclose(g, c, rtol=1e-4, atol=1e-4)
                      for g, c in zip(steps["cuda"], steps["cpu"]))
              and results["cuda"] == results["cpu"])
        print(f"[equiv] {engine_name} {arch} widths, 2 layers, fp32, 4 "
              f"requests x 8 greedy tokens through 2 slots, card vs CPU: "
              f"{len(steps['cuda'])} decode steps, step logits max abs "
              f"{max(errs):.3e} (rtol=atol=1e-4), tokens equal "
              f"{results['cuda'] == results['cpu']} -> "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"card and CPU {engine_name} engines disagree: {arch}")


def equiv_moe_phase(torch, arch):
    """[equiv] ``arch`` (qwen3-moe-30b-a3b or deepseek-v2-lite-16b) at its
    published widths cut to 2 layers (deepseek: layer 0 and one MoE
    layer), fp32, its weights drawn on the card from seed 0 and copied
    to the host: the card against the port's CPU path on the [serve]
    prompts (the launcher's draw over its vocabulary: 871, 596, 1001 and
    802 ids, cut to 290, 198, 333, 267 by ``_equiv_prompts``). The
    fixed-batch engine's prefill logits within rtol = atol
    = 1e-4 and 8 greedy tokens equal (``equiv_serve_phase``; the CPU
    side reads every expert at each decode step), the
    experts every router call picks equal on both sides, in the same
    order, the ContinuousBatcher's
    8 greedy tokens of every request equal, and the cache-free loss
    within 1e-5 relative with its logits within 1e-4
    (``equiv_score_phase``); flash launches exact (qwen3-moe: one per
    layer in each cache-free pass on the card; deepseek: none, MLA)."""
    from repro_torch.configs import get_arch_config
    from repro_torch.launch.serve import draw_prompts
    from repro_torch.models import moe

    cfg = get_arch_config(arch).with_(n_layers=2, compute_dtype="float32")
    prompts = draw_prompts(cfg.vocab_size, 4, 1024, 0)
    params = _host_init(torch, cfg, 0)
    depth = "layer 0 + 1 MoE layer" if cfg.first_k_dense else "2 layers"
    routes = {"cpu": [], "cuda": []}
    plain_top_k = moe.top_k

    def recorded(probs, k):
        vals, idx = plain_top_k(probs, k)
        routes[probs.device.type].append(idx.cpu())
        return vals, idx

    moe.top_k = recorded
    try:
        equiv_serve_phase(torch, arch, prompts, (cfg, params), depth)
    finally:
        moe.top_k = plain_top_k
    calls = len(routes["cuda"])
    differ = sum(int((g != w).any(-1).sum())
                 for g, w in zip(routes["cuda"], routes["cpu"]))
    tokens = sum(int(w[..., 0].numel()) for w in routes["cpu"])
    ok = calls == len(routes["cpu"]) > 0 and differ == 0
    print(f"[equiv] experts {arch}: {calls} router calls (prefills and "
          f"decode steps) over {tokens} token rows, top-{cfg.moe.top_k} of "
          f"{cfg.moe.n_experts}: expert ids differ at {differ} tokens -> "
          + ("ok" if ok else "FAIL"))
    check(ok, f"card and CPU route tokens to other experts: {arch}")
    _equiv_continuous(torch, arch, cfg, params, prompts, depth)
    equiv_score_phase(torch, (cfg, params), arch, depth)
    print(f"[equiv] {arch}: card against CPU at its widths, {depth}, fp32: "
          f"serve, experts, continuous and score ok")


def _equiv_continuous(torch, arch, cfg, params, prompts, depth):
    """The ContinuousBatcher (2 slots, prompt_pad 16, 8 greedy tokens)
    on the card against the port's CPU path on the same weights: every
    request's tokens equal."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.serving import ContinuousBatcher, ServeConfig

    prompts = _equiv_prompts(prompts)
    serve = ServeConfig(max_len=serve_max_len(cfg), max_new_tokens=8)
    results, secs = {}, {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        results[dev] = ContinuousBatcher(
            cfg, tree_map(lambda t: t.to(dev), params), serve, batch_size=2,
            prompt_pad=16).run(prompts)
        secs[dev] = time.perf_counter() - t0
    same = results["cuda"] == results["cpu"]
    print(f"[equiv] continuous {arch} widths, {depth}, fp32, "
          f"{len(prompts)} requests x 8 greedy tokens through 2 slots "
          f"(prompt_pad 16: widths of up to "
          f"{max(len(p) for p in prompts)} ids), card vs CPU: tokens "
          f"equal {same}; CPU {secs['cpu']:.1f} s, card {secs['cuda']:.1f} s "
          f"-> {'ok' if same else 'FAIL'}")
    check(same, f"card and CPU continuous batchers disagree: {arch}")


def equiv_modal_phase(torch, arch):
    """[equiv] musicgen-medium (its published widths cut to 2 layers, the
    [serve] prompts cut to 290, 198, 333, 267 ids) or qwen2-vl-72b (its
    widths cut to 1 layer, so that the CPU side's 152064-wide head over
    the 256 vision positions of every prefill stays short; 3 prompts of
    the launcher's draw, seed 1, prompt-len 64, and one of 270 ids: a
    prefill's next-token row sits at index ``lengths − 1`` of the
    (vision + text) sequence, a row of the zero vision prefix for the
    short prompts, whose logits are 0 on both sides, and a text row for
    the long one), fp32 compute, weights
    drawn on the card from seed 0 and copied to the host: the
    fixed-batch engine's prefill logits within rtol = atol = 1e-4 and 8
    greedy tokens equal (``equiv_serve_phase``), the ContinuousBatcher's
    8 greedy tokens of every request equal, and the cache-free pass over
    2 x 320 positions (``_score_batch``: musicgen's non-zero ``cond``,
    qwen2-vl's vision prefix) within 1e-4, its loss within 1e-5
    relative, flash launched once per layer in each pass on the card
    (``equiv_score_phase``)."""
    from repro_torch.configs import get_arch_config
    from repro_torch.launch.serve import draw_prompts

    vlm = arch == QWEN_VL
    depth = "1 layer" if vlm else "2 layers"
    cfg = get_arch_config(arch).with_(n_layers=1 if vlm else 2,
                                      compute_dtype="float32")
    if vlm:
        import numpy as np
        prompts = draw_prompts(cfg.vocab_size, 3, 64, 1) + [list(
            np.random.default_rng(2).integers(0, cfg.vocab_size, 270))]
    else:
        prompts = draw_prompts(cfg.vocab_size, 4, 1024, 0)
    params = _host_init(torch, cfg, 0)
    equiv_serve_phase(torch, arch, prompts, (cfg, params), depth)
    _equiv_continuous(torch, arch, cfg, params, prompts, depth)
    equiv_score_phase(torch, (cfg, params), arch, depth)
    print(f"[equiv] {arch}: card against CPU at its widths, {depth}, fp32: "
          f"serve, continuous and score ok")


def nosync_decode_phase(torch, cfg, params):
    """ServeEngine.decode of llama3.2-3b or musicgen-medium at full width
    and depth (2 requests, 8 greedy tokens) under
    ``torch.cuda.set_sync_debug_mode("error")`` with the prompt lengths
    from the host: any call that synchronizes with the card raises.
    The mode is shown to bite first (a read-back under it raises)."""
    from repro_torch.serving import ServeConfig, ServeEngine, serve_batches

    engine = ServeEngine(cfg, params, ServeConfig(max_len=64,
                                                  max_new_tokens=8))
    toks, lens = serve_batches([[5, 9, 200, 31, 7], [11, 400, 3]], 2,
                               device="cpu")[0]
    logits, cache = engine.prefill(toks.to("cuda"), lens)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        try:
            float(logits[0, 0])
            bites = False
        except RuntimeError:
            bites = True
        out = engine.decode(logits, cache, lens)
        error = None
    except RuntimeError as exc:
        error = str(exc).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"[nosync] ServeEngine.decode {cfg.name}, full width, 2 requests "
          f"x 8 tokens under set_sync_debug_mode('error'): a read-back raises "
          f"{bites}, decode "
          + ("ran without a synchronizing call"
             if error is None else f"raised: {error}")
          + f" -> {'ok' if bites and error is None else 'FAIL'}")
    check(bites and error is None and out.shape == (2, 8),
          f"ServeEngine.decode synchronizes with the card: {error}")


DRYRUN_PAIRS = ((MAMBA, "prefill_32k"), (LLAMA, "decode_32k"))
DRYRUN_GATE = 0.10        # the measured peak within 10 % of the traced one
DRYRUN_TIMEOUT = 300      # s, the child's run


def _dryrun_args(torch, cfg, shape, inputs, gen):
    """The rank's inputs of a prefill or decode step (``step_inputs``'s
    ``meta`` tensors) drawn on the card: parameters N(0, 0.02²) from
    ``gen``, token ids below the vocabulary, positions 0 .. S − 1
    (prefill) or S / 2 (decode), other batch leaves N(0, 1), the cache
    empty (zeros, positions −1)."""
    from repro_torch.common.pytree import tree_map

    def param(x):
        return torch.empty(x.shape, dtype=x.dtype, device="cuda").normal_(
            0.0, 0.02, generator=gen)

    def feed(key, x):
        if key == "tokens":
            return torch.randint(0, cfg.vocab_size, tuple(x.shape),
                                 generator=gen, dtype=x.dtype,
                                 device="cuda")
        if key == "positions" and shape.kind == "prefill":
            return torch.arange(x.shape[-1], dtype=x.dtype,
                                device="cuda").expand(x.shape).contiguous()
        if key == "positions":
            return torch.full(tuple(x.shape), shape.seq_len // 2,
                              dtype=x.dtype, device="cuda")
        return torch.empty(x.shape, dtype=x.dtype, device="cuda").normal_(
            generator=gen)

    def empty(x):
        return torch.full(tuple(x.shape),
                          0 if x.dtype.is_floating_point else -1,
                          dtype=x.dtype, device="cuda")
    params, batch = tree_map(param, inputs[0]), {
        k: feed(k, v) for k, v in inputs[1].items()}
    return (params, batch) + tuple(tree_map(empty, c) for c in inputs[2:])


def dryrun_child(card: str) -> int:
    """The ``[dryrun]`` phase, in a process of its own (its own default
    process group): a fake 256-rank world (``launch.mesh.
    make_traced_mesh``) at rank (0, 0) of 16 x 16. For each of
    DRYRUN_PAIRS it traces the rank's step on ``meta`` tensors
    (``launch.dryrun_lib``), then runs the same step for real on the
    card with the rank's slices of random parameters, its rows and its
    cache: the collectives are the fake world's, so they move no bytes
    and a gathered buffer holds whatever it held. It runs the step twice
    (the first builds the kernels) and holds the second run's peak
    (``max_memory_allocated`` less what was allocated before the inputs
    were drawn) within DRYRUN_GATE of the traced
    ``total_bytes_per_device``, and each kernel's launches equal to the
    count the trace recorded. Exits non-zero on a failed gate."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import (INPUT_SHAPES, arch_for_shape,
                                     get_arch_config)
    from repro_torch.launch import dryrun_lib as DL
    from repro_torch.launch.mesh import make_traced_mesh

    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_traced_mesh()
    ok = True
    try:
        for arch, name in DRYRUN_PAIRS:
            cfg = arch_for_shape(get_arch_config(arch), name)
            shape = INPUT_SHAPES[name]
            t0 = time.perf_counter()
            trace = DL.trace(cfg, shape, mesh)
            trace_s = time.perf_counter() - t0
            inputs, step, _ = DL.step_inputs(cfg, shape, mesh)
            gen = torch.Generator(device="cuda").manual_seed(0)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            args = _dryrun_args(torch, cfg, shape, inputs, gen)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated() - base
            for _ in range(2):            # the first builds the kernels
                reset_launches()
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                out = step(*args)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t) * 1e3
                peak = torch.cuda.max_memory_allocated() - base
                counts = launch_counts()
                del out
            del args
            want = trace.peak_bytes
            err = (peak - want) / want
            same = all(n == trace.kernels.get(k, 0)
                       for k, n in counts.items())
            ran = {k: n for k, n in counts.items() if n}
            fine = abs(err) <= DRYRUN_GATE and same
            ok &= fine
            print(f"[dryrun] {arch} {name}, rank (0, 0) of 16 x 16 in a "
                  f"fake 256-rank world (collectives faked: no bytes "
                  f"move): traced {want / 2**30:.3f} GiB "
                  f"({trace.argument_bytes / 2**30:.3f} GiB arguments, "
                  f"traced in {trace_s:.1f} s), measured peak "
                  f"{peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB "
                  f"inputs), {err:+.2%} (gate ±{DRYRUN_GATE:.0%}); "
                  f"launches {ran or 'none'}, traced "
                  f"{trace.kernels or 'none'}; step {ms:.1f} ms on {card}, "
                  f"beside the [equiv] phases -> "
                  f"{'ok' if fine else 'FAIL'}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


def start_dryrun_run(card: str):
    """Starts :func:`dryrun_child` in a child process in the background;
    returns (the process, its start)."""
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)] + (
            [env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, chip_smoke; sys.exit(chip_smoke.dryrun_child("
         "sys.argv[1]))", card],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    return proc, time.perf_counter()


def dryrun_phase(run):
    """Waits for ``start_dryrun_run``'s child and passes its lines on;
    fails if it failed or ran past DRYRUN_TIMEOUT."""
    proc, t0 = run
    try:
        out, err = proc.communicate(timeout=max(
            1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        stop_mesh_run(proc)
        raise SmokeFailure(f"[dryrun]: the child ran past "
                           f"{DRYRUN_TIMEOUT} s")
    lines = [ln for ln in out.splitlines() if ln.startswith("[dryrun]")]
    for ln in lines:
        print(ln)
    check(proc.returncode == 0 and len(lines) == len(DRYRUN_PAIRS),
          f"[dryrun]: the child exited {proc.returncode}: "
          f"{out[-2000:]}{err[-2000:]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); the port's smoke run needs one", file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port's package is missing next to this "
              f"script ({exc}); run it from a checkout of the repo",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_arch_config
    from repro_torch.models import get_model
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    marks = [t_start]
    mesh_run = dry_run = None

    def lap(label):
        now = time.perf_counter()
        print(f"[time] {label}: {now - marks[-1]:.1f} s")
        marks.append(now)
    try:
        card = device_phase(torch)
        instances = build_phase()
        lap("build")
        table = kernel_phase(torch)
        table["grad_sketch"] = sketch_phase(torch)
        table["ddal_fused_wavg_q"] = wavg_q_phase(torch)
        stale_kernel_phase(torch)
        table["ssd_intra_chunk"] = ssd_kernel_phase(torch,
                                                    instances["ssd_scan"])
        table["flash_attention"] = flash_kernel_phase(torch)
        table["flash_attention"]["zamba2"] = flash_d112_phase(torch)
        table["flash_attention"]["qwen3_moe"] = flash_gqa8_phase(torch)
        table["flash_attention"]["qwen2_vl"] = flash_h64_phase(torch)
        table["flash_attention"]["musicgen"] = flash_d64_mha_phase(torch)
        lap("kernels")
        launches = main_path_phase(torch)
        lap("main paths")
        serve_launches, prompts = serve_phase(torch, SERVE_ARGV,
                                              SERVE_LABEL)
        llama_launches, _ = serve_phase(torch, LLAMA_SERVE_ARGV,
                                        LLAMA_SERVE_LABEL)
        lap("serve")
        # the scoring path and its profile share one full-width model
        llama = get_arch_config(LLAMA)
        params = get_model(llama).init(
            llama, torch.Generator(device="cuda").manual_seed(0), "cuda")
        score_launches = score_phase(torch, llama, params)
        profile_score_phase(torch, llama, params,
                            {"flash": instances["flash_attention"]})
        nosync_decode_phase(torch, llama, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        lap("score")
        # the hybrid: served, then scored with a profile of one pass
        # the same draw over zamba2's vocabulary: the same lengths
        zserve_launches, zprompts = serve_phase(torch, ZAMBA_SERVE_ARGV,
                                                ZAMBA_SERVE_LABEL)
        gc.collect()
        torch.cuda.empty_cache()
        zamba = get_arch_config(ZAMBA)
        params = get_model(zamba).init(
            zamba, torch.Generator(device="cuda").manual_seed(0), "cuda")
        zscore_launches = score_phase(torch, zamba, params,
                                      ZAMBA_SCORE_LABEL)
        profile_score_phase(torch, zamba, params,
                            {"flash": instances["flash_attention"],
                             "SSD": instances["ssd_scan"]},
                            ZAMBA_SCORE_LABEL)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        lap("zamba2")
        # the MoE pair, one model on the card at a time: qwen3-moe's bf16
        # weights take 56.9 GiB, deepseek's fp32 ones 58.5 GiB
        qwen = get_arch_config(QWEN).with_(param_dtype="bfloat16")
        params = get_model(qwen).init(
            qwen, torch.Generator(device="cuda").manual_seed(0), "cuda")
        library_serve_phase(torch, qwen, params)
        qscore_launches = score_phase(torch, qwen, params, QWEN_SCORE_LABEL)
        profile_score_phase(torch, qwen, params,
                            {"flash": instances["flash_attention"]},
                            QWEN_SCORE_LABEL)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        lap("qwen3-moe")
        dserve_launches, _ = serve_phase(torch, DEEPSEEK_SERVE_ARGV,
                                         DEEPSEEK_SERVE_LABEL)
        gc.collect()
        torch.cuda.empty_cache()
        deep = get_arch_config(DEEPSEEK)
        params = get_model(deep).init(
            deep, torch.Generator(device="cuda").manual_seed(0), "cuda")
        dscore_launches = score_phase(torch, deep, params,
                                      DEEPSEEK_SCORE_LABEL)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        lap("deepseek")
        # the audio pair's serving through the launcher (fp32 weights,
        # 7.4 GB), then its scoring and sync-free decode on one draw
        mserve_launches, _ = serve_phase(torch, MUSICGEN_SERVE_ARGV,
                                         MUSICGEN_SERVE_LABEL)
        gc.collect()
        torch.cuda.empty_cache()
        music = get_arch_config(MUSICGEN)
        params = get_model(music).init(
            music, torch.Generator(device="cuda").manual_seed(0), "cuda")
        mscore_launches = score_phase(torch, music, params,
                                      MUSICGEN_SCORE_LABEL)
        nosync_decode_phase(torch, music, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        lap("musicgen")
        # the VLM at 20 of its 80 layers with bf16 weights (~40 GB)
        vl = get_arch_config(QWEN_VL).with_(param_dtype="bfloat16",
                                            n_layers=VL_SCORE_LAYERS)
        params = get_model(vl).init(
            vl, torch.Generator(device="cuda").manual_seed(0), "cuda")
        vscore_launches = score_phase(torch, vl, params, VL_SCORE_LABEL)
        library_serve_phase(torch, vl, params, VL_SERVE_LABEL)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        lap("qwen2-vl")
        slot_launches = [continuous_phase(torch, n_layers=SLOT_LAYERS),
                         group_phase(torch, SLOT_ARCH, 4, 4, 16,
                                     n_layers=SLOT_LAYERS),
                         group_phase(torch, LLAMA, 2, 2, 4,
                                     n_layers=SLOT_LAYERS),
                         group_phase(torch, ZAMBA, 2, 2, 4, "bfloat16"),
                         group_phase(torch, DEEPSEEK, 2, 2, 4, "bfloat16",
                                     DEEPSEEK_GROUP_LAYERS),
                         continuous_phase(torch, MUSICGEN, 4, SLOT_LAYERS),
                         group_phase(torch, MUSICGEN, 2, 2, 4,
                                     n_layers=SLOT_LAYERS),
                         group_phase(torch, QWEN_VL, 2, 2, 4, "bfloat16",
                                     VL_GROUP_LAYERS)]
        lap("slot engines")
        slot_launches.append(load_phase(torch))
        lap("load")
        exact_slots_phase(torch, SLOT_ARCH, 4, SLOT_LAYERS)
        exact_slots_phase(torch, LLAMA, 2, SLOT_LAYERS)
        exact_slots_phase(torch, MUSICGEN, 2, SLOT_LAYERS)
        exact_slots_phase(torch, QWEN_VL, 2, VL_GROUP_LAYERS, "bfloat16")
        lap("exact")
        train_launches, largest_leaf = train_phase(torch)
        lap("train mamba2-780m")
        llama_train_launches = train_llama_phase(torch)
        lap("train llama")
        train_equiv_phase(torch)
        lap("train-equiv")
        pods_train_launches = train_pods_phase(torch)
        train_equiv_pods_phase(torch)
        lap("pods")
        tp_launches = model_axis_phases(torch, table)
        lap("model axis")
        table["grad_sketch"]["largest_leaf"] = sketch_leaf_phase(
            torch, largest_leaf)
        lap("sketch at the largest leaf")
        for paths in (serve_launches, llama_launches, score_launches,
                      zserve_launches, zscore_launches, qscore_launches,
                      dserve_launches, dscore_launches, mserve_launches,
                      mscore_launches, vscore_launches, *slot_launches,
                      train_launches, llama_train_launches,
                      pods_train_launches, tp_launches):
            for name, by_path in paths.items():
                launches[name].update(by_path)
        equivalence_phase(torch)
        dqn_equivalence_phase(torch)
        robust_equivalence_phase(torch)
        lap("equivalence")
        mesh_run = start_mesh_run()
        dry_run = start_dryrun_run(card)
        equiv_serve_phase(torch, "mamba2-780m", prompts)
        cut = _cut_to_two_layers(torch, LLAMA)
        equiv_score_phase(torch, cut)
        equiv_serve_phase(torch, LLAMA, prompts, cut)
        del cut
        for arch in (SLOT_ARCH, LLAMA):
            equiv_slots_phase(torch, arch)
        lap("serving equivalence, mamba2-780m and llama3.2-3b")
        cut = _cut_hybrid(torch)
        depth = "1 super-block of 1 Mamba2 layer + 1 tail layer"
        equiv_serve_phase(torch, ZAMBA, zprompts, cut, depth)
        equiv_score_phase(torch, cut, ZAMBA, depth)
        del cut
        print(f"[equiv] {ZAMBA}: card against CPU at its widths, {depth}, "
              f"fp32, LoRA b drawn: serve and score ok")
        lap("serving equivalence, zamba2-7b")
        for arch in (QWEN, DEEPSEEK):
            equiv_moe_phase(torch, arch)
        lap("serving equivalence, the MoE pair")
        for arch in (MUSICGEN, QWEN_VL):
            equiv_modal_phase(torch, arch)
        lap("serving equivalence, musicgen-medium and qwen2-vl-72b")
        mesh_phase(torch, mesh_run)
        mesh_run = None
        dryrun_phase(dry_run)
        dry_run = None
        lap("mesh and dryrun")
        spent = time.perf_counter() - t_start
        if spent > PROFILE_DEADLINE:
            print(f"[profile] skipped: {spent:.1f} s spent, past "
                  f"PROFILE_DEADLINE ({PROFILE_DEADLINE} s)")
        else:
            profile_phase(torch)
            lap("profiles, main paths")
            profile_serve_phase(torch, prompts, instances["ssd_scan"])
            lap("profiles, serving")
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        if mesh_run is not None:
            stop_mesh_run(mesh_run[0])
        if dry_run is not None:
            stop_mesh_run(dry_run[0])
    # "launches" is the count of the kernel's first path; every path
    # that drives it, each zeroed just before its run, is listed beside
    for name, row in table.items():
        first = next(iter(launches[name].values()))
        row.update(KERNELS[name], launches=first,
                   launches_by_path=launches[name])
    kernels = [dict(name=name, **{k: table[name][k] for k in (
        "route", "source", "replaces", "launches", "launches_by_path",
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")}, **{extra: table[name][extra]
                           for extra in ("zamba2", "qwen3_moe",
                                         "qwen2_vl", "musicgen", "strided",
                                         "rank_heads")
                           if extra in table[name]})
        for name in KERNELS]
    check_finite = all(math.isfinite(k["ms"]) for k in kernels)
    if not check_finite:
        print("chip_smoke: FAILED: non-finite kernel time", file=sys.stderr)
        return 1
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)                                  # name, power limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
