"""The sliced init on the card: a rank's slice of the streaming
trainer's state drawn by ``init_train_state(..., mesh=MeshPoint)`` with
the card's generator, at every coordinate of a (1, 1, 2) ``(pod, data,
model)`` description (no process group), for llama3.2-3b at its
published widths cut to 2 layers, 2 agents: the params bitwise
``launch.shardings.place`` of a whole draw, every leaf at the shape
``place`` gives it (the moments and the window are zeros). Every test
here needs a CUDA card and skips without one.

This file imports neither JAX nor the reference package, so it also
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \\
        tests/test_torch_multipod_gpu.py
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch import optim  # noqa: E402
from repro_torch.common.pytree import tree_leaves_with_paths  # noqa: E402
from repro_torch.common.sharding import MeshPoint  # noqa: E402
from repro_torch.configs import get_arch_config  # noqa: E402
from repro_torch.configs.base import GroupSpec  # noqa: E402
from repro_torch.core.exchange import build_exchange  # noqa: E402
from repro_torch.core.sharded_ddal import init_train_state  # noqa: E402
from repro_torch.launch import shardings as SH  # noqa: E402


@pytest.mark.gpu
def test_sliced_init_on_the_card_is_placed_whole_draw():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the draws run on the card's "
                    "generator")
    cfg = get_arch_config("llama3.2-3b").with_(n_layers=2)
    spec = GroupSpec(n_agents=2, knowledge_mode="streaming",
                     exchange_estimator="grad_cos+sketch",
                     relevance_sketch_dim=256)
    opt = optim.adamw(1e-3)
    ex = build_exchange(spec, kind="streaming")
    whole = init_train_state(cfg, spec, opt, seed=0, exchange=ex,
                             device="cuda").params
    points = MeshPoint(("pod", "data", "model"), (1, 1, 2),
                       (0, 0, 0)).points()
    assert len(points) == 2
    for pt in points:
        specs = SH.state_placement_specs(cfg, pt, True, 256)
        want = SH.place(whole, specs.params, pt, cfg)
        got = init_train_state(cfg, spec, opt, seed=0, exchange=ex,
                               device="cuda", mesh=pt)
        pairs = list(zip(tree_leaves_with_paths(got.params),
                         tree_leaves_with_paths(want)))
        assert len(pairs) == len(tree_leaves_with_paths(whole))
        for (path, a), (_, b) in pairs:
            assert a.shape == b.shape and torch.equal(a, b), (pt.coord, path)
        embed = got.params["embed"]
        assert embed.shape == (2, cfg.vocab_size // 2, cfg.d_model)
        for x in (got.opt_state["m"]["embed"], got.know.tg["embed"]):
            assert x.shape == embed.shape and not bool(x.any())
        del got, want
