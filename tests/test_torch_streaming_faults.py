"""Port parity of the streaming DDAL trainer at ``.reduced()``
llama3.2-3b, the three exchange configurations that
``test_torch_streaming.py`` leaves to this file (sketched relevance,
elastic kill / revive, the faulty transport), with its harness and
tolerances."""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from test_torch_streaming import run_parity  # noqa: E402


@pytest.mark.parametrize("case", ["grad_cos_sketch", "elastic", "faulty"])
def test_train_steps_match_reference_llama(case):
    run_parity("llama3.2-3b", case)
