"""Port parity of the streaming DDAL trainer at ``.reduced()``
mamba2-780m, the other three exchange configurations of
``test_torch_streaming.py`` (sketched relevance, elastic kill / revive,
the faulty transport) with its harness and tolerances."""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from test_torch_streaming import run_parity  # noqa: E402


@pytest.mark.parametrize("case", ["grad_cos_sketch", "elastic", "faulty"])
def test_train_steps_match_reference_mamba(case):
    run_parity("mamba2-780m", case)
