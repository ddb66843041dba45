"""Serving on a mesh on the card: a one-rank NCCL group in the test
process (a ``FileStore`` in ``tmp_path``) and its (1, 1) ``(data,
model)`` mesh. ``repro_torch.launch.dryrun_lib``'s prefill and decode
steps (the KV-slot sweep, the gathered logits) against the one-device
model on the same weights, at llama3.2-3b and deepseek-v2-lite-16b
``reduced()`` in fp32: logits within rtol 1e-5 / atol 1e-6 (llama) or
within 1e-5 relative or 1e-5 of the largest logit (deepseek, as
``tests/test_torch_serve_mesh.py`` holds the MoE pair), greedy tokens
equal; the cache-free pass's full logits the same way, with the flash
kernel once per layer. Every test here needs a CUDA card and skips
without one.

This file imports neither JAX nor the reference package:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \\
        tests/test_torch_serve_mesh_gpu.py
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_arch_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

LENS = [9, 5, 12, 7]
SLOTS, STEPS = 24, 4


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    store = tmp_path_factory.mktemp("serve_mesh_gpu") / "store"
    torch.cuda.set_device(0)            # before the mesh, as NCCL asks
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        yield make_debug_mesh((1, 1), device_type="cuda")
    finally:
        dist.destroy_process_group()


def _inputs(arch):
    cfg = get_arch_config(arch).reduced()
    params = get_model(cfg).init(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    rng = np.random.default_rng(1)
    toks = np.zeros((len(LENS), max(LENS)), np.int32)
    for i, n in enumerate(LENS):
        toks[i, :n] = rng.integers(1, cfg.vocab_size, n)
    toks = torch.from_numpy(toks).cuda()
    pos = torch.arange(toks.shape[1], dtype=torch.int32,
                       device="cuda").expand(len(LENS), -1)
    return cfg, params, {"tokens": toks, "positions": pos}


def _close(arch, got, want):
    atol = 1e-6 if arch == "llama3.2-3b" else 1e-5 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-v2-lite-16b"])
def test_prefill_and_decode_on_a_one_rank_nccl_mesh(mesh, arch):
    from repro_torch.launch import dryrun_lib as DL
    from repro_torch.serving.api import decode_batch
    cfg, params, batch = _inputs(arch)
    model = get_model(cfg)
    shape = ShapeConfig("serve", SLOTS, len(LENS), "prefill")
    rows = torch.arange(len(LENS), device="cuda")
    pos = torch.tensor(LENS, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        got, cache = DL.prefill_on_mesh(cfg, shape, mesh, params, batch)
        want, ref_cache = model.forward(
            cfg, params, batch, model.make_cache(cfg, len(LENS), SLOTS,
                                                 "cuda"))
        _close(arch, got, want)
        tok = want[rows, pos.long() - 1].argmax(-1).to(torch.int32)
        assert torch.equal(got[rows, pos.long() - 1].argmax(-1).to(
            torch.int32), tok)
        for _ in range(STEPS):
            step = decode_batch(cfg, tok[:, None], pos[:, None])
            got, cache = DL.decode_on_mesh(cfg, shape, mesh, params, step,
                                           cache)
            want, ref_cache = model.decode(cfg, params, step, ref_cache)
            _close(arch, got, want)
            tok = want[:, -1].argmax(-1).to(torch.int32)
            assert torch.equal(got[:, -1].argmax(-1).to(torch.int32), tok)
            pos = pos + 1


@pytest.mark.gpu
def test_cache_free_full_logits_on_a_one_rank_nccl_mesh(mesh):
    from repro_torch.common.sharding import axis_rules, set_mesh
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.mesh import serve_rules
    cfg, params, batch = _inputs("llama3.2-3b")
    model = get_model(cfg)
    with torch.no_grad():
        want, _ = model.forward(cfg, params, batch, None)
        before = fa_ops.flash_attention.launches
        with set_mesh(mesh), axis_rules(serve_rules(mesh, len(LENS))):
            got, _ = model.forward(cfg, params, batch, None)
        assert fa_ops.flash_attention.launches - before == cfg.n_layers
    _close("llama3.2-3b", got, want)
