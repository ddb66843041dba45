"""Port parity of the streaming DDAL trainer at ``.reduced()``
qwen3-moe-30b-a3b (2 layers of 4 routed experts, top-2) and
deepseek-v2-lite-16b (Multi-head Latent Attention's expanded branch and
the leading dense ``layer0``, under autograd): the streaming trainer
takes the MoE family unchanged, through its loss (``transformer_loss``:
the cross-entropy plus the experts' load-balance and router z-losses),
whose gradient runs back through the dense dispatch's scatter and
gather. One exchange configuration of ``test_torch_streaming.py``, with
its harness (``run_parity``) and its tolerances."""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from test_torch_streaming import run_parity  # noqa: E402


@pytest.mark.parametrize("arch,case", [
    ("qwen3-moe-30b-a3b", "grad_cos"), ("deepseek-v2-lite-16b", "grad_cos")],
    ids=["grad_cos", "deepseek-v2-lite-16b-grad_cos"])
def test_train_steps_match_reference_moe(arch, case):
    run_parity(arch, case)
