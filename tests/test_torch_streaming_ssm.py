"""Port parity of the streaming DDAL trainer at ``.reduced()``
mamba2-780m: four of the seven exchange configurations of
``test_torch_streaming.py`` (its harness, ``run_parity``, and its
tolerances; the other three are in ``test_torch_streaming_ssm_faults.py``,
so each file stays short), through the SSM family's loss (``ssm_loss``:
the einsum SSD form under autograd)."""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from test_torch_streaming import run_parity  # noqa: E402


@pytest.mark.parametrize("case", ["full_uniform", "grad_cos", "ring",
                                  "int8"])
def test_train_steps_match_reference_mamba(case):
    run_parity("mamba2-780m", case)
