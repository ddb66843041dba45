"""Port parity of the hybrid at zamba2-7b's head dim of 112
(``tests/test_torch_hybrid.py``'s ``d112`` variant: d_model 224, 2 heads
of 112 in the shared block, 2 super-blocks of one Mamba2 layer and a
tail layer, drawn LoRA ``b`` factors): the cache-free pass runs the
plain attention at D = 112. The same tests and tolerances as the
``2x2`` variant there, in a file of their own so that each file stays
short."""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

import test_torch_hybrid as H  # noqa: E402


@pytest.mark.parametrize("name", ["d112"])
def test_loss_matches_reference(name):
    H.test_loss_matches_reference(name)


@pytest.mark.parametrize("name", ["d112"])
def test_prefill_logits_match_reference(name):
    H.test_prefill_logits_match_reference(name)


@pytest.mark.parametrize("name", ["d112"])
def test_prefill_cache_matches_reference(name):
    H.test_prefill_cache_matches_reference(name)


@pytest.mark.parametrize("name", ["d112"])
def test_decode_steps_match_reference(name):
    H.test_decode_steps_match_reference(name)
