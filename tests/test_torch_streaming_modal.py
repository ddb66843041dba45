"""Port parity of the streaming DDAL trainer at ``.reduced()``
qwen2-vl-72b (M-RoPE and a vision prefix of 8, whose labels are −100)
and musicgen-medium (4 codebooks with the delay pattern, cross-attention
to a non-zero ``cond`` of 8 positions, a GELU MLP): the streaming
trainer takes both families unchanged, through their loss
(``transformer_loss`` on the reference's ``make_group_batch``), whose
gradient runs back through M-RoPE, the vision prefix's concatenation,
the cross-attention and the codebook tables. One exchange configuration
of ``test_torch_streaming.py``, with its harness (``run_parity``) and
its tolerances."""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from test_torch_streaming import run_parity  # noqa: E402


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "musicgen-medium"])
def test_train_steps_match_reference_modal(arch):
    run_parity(arch, "grad_cos")
