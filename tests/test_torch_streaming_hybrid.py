"""Port parity of the streaming DDAL trainer at ``.reduced()`` zamba2-7b
(one super-block of one Mamba2 layer, the shared attention block with
rank-8 LoRA, one tail layer): the streaming trainer takes the hybrid
family unchanged, through its loss (``hybrid_loss``). One exchange
configuration of ``test_torch_streaming.py``, with its harness
(``run_parity``) and its tolerances. The reference's LoRA ``b`` starts
at zero and its gradient (Aᵀ·∂W) does not, so the deltas move from the
first update on.

The reference's einsum SSD takes ``exp(cs_i − cs_j)`` over the whole
chunk before it selects the causal half (``repro/models/ssd.py``,
``_segsum_mask``; ROADMAP §3): here, after the first update, one
agent's full chunk of 32 overflows above the diagonal and that agent's
gradient is NaN on the reference's side only (its step-2 loss too).
The test holds the port against the reference with that select moved
before the exp, for this test's process only: the same forward values
and a finite gradient. The JAX package is not changed."""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.models.ssd as r_ssd  # noqa: E402
from test_torch_streaming import run_parity  # noqa: E402


def _segsum_mask_first(dA_cs):
    """``_segsum_mask`` with the causal select before the exp."""
    L = dA_cs.shape[-1]
    diff = dA_cs[..., :, None] - dA_cs[..., None, :]
    causal = jnp.tril(jnp.ones((L, L), bool))
    return jnp.where(causal, jnp.exp(jnp.where(causal, diff, 0.0)), 0.0)


@pytest.mark.parametrize("case", ["grad_cos"])
def test_train_steps_match_reference_hybrid(case, monkeypatch):
    monkeypatch.setattr(r_ssd, "_segsum_mask", _segsum_mask_first)
    run_parity("zamba2-7b", case)
