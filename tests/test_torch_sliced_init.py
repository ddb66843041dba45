"""The sliced init, restore and save of the streaming trainer's state
for the production meshes, without a process group: a rank's slices
drawn by ``init_train_state(..., mesh=MeshPoint)`` and read by
``checkpoint.restore_sliced`` at every coordinate of a ``(2, 2, 2)``
``(pod, data, model)`` mesh (agents over ``pod``) and of a ``(1, 1, 4)``
one (each rank every agent, the model axis 4 wide), for llama3.2-3b,
qwen3-moe-30b-a3b (experts split), mamba2-780m (SSD heads), zamba2-7b
(the LoRA factors of split targets) and musicgen-medium (codebook
tables), all at ``reduced()`` with 4 agents, an elastic mask, the
learned relevance and a sketch:

* the sliced state is bitwise ``shardings.place(init_train_state(...),
  state_placement_specs(...))``, every leaf at the shape ``place`` gives
  it (the draws keep their order: a rank draws the agents of other
  pods and drops them);
* a file written by ``save_train`` of a whole state (every leaf drawn
  distinct), restored through ``restore_sliced`` (llama in reads of
  16 KiB, so its leaves come in many blocks), is bitwise
  ``place(restore_train(...))`` with the file's step;
* a truncated file and a mismatched one (a group of 6 agents) raise the
  one ``ValueError`` that names every fault, as ``restore`` does.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import optim  # noqa: E402
from repro_torch.checkpoint import npz  # noqa: E402
from repro_torch.common.sharding import MeshPoint  # noqa: E402
from repro_torch.configs import get_arch_config  # noqa: E402
from repro_torch.configs.base import GroupSpec  # noqa: E402
from repro_torch.core import sharded_ddal as SD  # noqa: E402
from repro_torch.core.exchange import build_exchange  # noqa: E402
from repro_torch.launch import shardings as SH  # noqa: E402

ARCHS = ["llama3.2-3b", "qwen3-moe-30b-a3b", "mamba2-780m", "zamba2-7b",
         "musicgen-medium"]
MESHES = [(2, 2, 2), (1, 1, 4)]
AXES = ("pod", "data", "model")
D = 16
# bytes a restore reads at a time: 16 KiB cuts llama's leaves into many
# blocks (the block path), 1 MiB reads most reduced leaves whole
READ = {arch: 1 << 20 for arch in ARCHS}
READ["llama3.2-3b"] = 1 << 14


def _setup(arch, n=4):
    cfg = get_arch_config(arch).reduced()
    spec = GroupSpec(n_agents=n, knowledge_mode="streaming", elastic=True,
                     exchange_estimator="grad_cos+sketch",
                     relevance_sketch_dim=D)
    return cfg, spec, optim.adamw(1e-3), build_exchange(spec,
                                                        kind="streaming")


def _points(shape):
    return MeshPoint(AXES, shape, (0,) * len(shape)).points()


def _assert_same(got, want):
    g, w = npz._paths(got), npz._paths(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        if isinstance(b, torch.Tensor):
            assert tuple(a.shape) == tuple(b.shape), k
            assert a.dtype == b.dtype and torch.equal(a, b), k
        else:
            assert a == b, k


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_sliced_init_is_placed_whole_init(arch, shape):
    cfg, spec, opt, ex = _setup(arch)
    whole = SD.init_train_state(cfg, spec, opt, seed=5, exchange=ex,
                                device="cpu")
    for pt in _points(shape):
        specs = SH.state_placement_specs(cfg, pt, True, D)
        got = SD.init_train_state(cfg, spec, opt, seed=5, exchange=ex,
                                  device="cpu", mesh=pt)
        _assert_same(got, SH.place(whole, specs, pt, cfg))
        A = spec.n_agents // shape[0]
        assert got.know.tsum.shape == (A,) and got.know.sk.shape == (A, D)
        assert got.know.rel.shape == got.know.alive.shape * 2


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_sliced_restore_is_placed_whole_restore(tmp_path, arch, shape):
    cfg, spec, opt, ex = _setup(arch)
    whole = SD.init_train_state(cfg, spec, opt, seed=5, exchange=ex,
                                device="cpu")
    gen = torch.Generator().manual_seed(1)
    for _, x in npz._paths(whole):
        if isinstance(x, torch.Tensor) and x.dtype.is_floating_point:
            x.copy_(torch.randn(x.shape, generator=gen))
    whole.know.alive[1] = False
    whole = whole._replace(step=7)
    path = str(tmp_path / "whole.npz")
    npz.save_train(path, whole, step=7)
    back = npz.restore_train(path, whole)
    for pt in _points(shape):
        specs = SH.state_placement_specs(cfg, pt, True, D)
        like = SD.init_train_state(cfg, spec, opt, seed=0, exchange=ex,
                                   device="cpu", mesh=pt)
        got = npz.restore_sliced(path, like, specs, pt, cfg,
                                 read_bytes=READ[arch])
        assert got.step == 7
        _assert_same(got, SH.place(back, specs, pt, cfg))


def test_damaged_files_raise_one_value_error(tmp_path):
    cfg, spec, opt, ex = _setup("llama3.2-3b")
    whole = SD.init_train_state(cfg, spec, opt, seed=5, exchange=ex,
                                device="cpu")
    path = str(tmp_path / "whole.npz")
    npz.save_train(path, whole._replace(step=3), step=3)
    pt = MeshPoint(AXES, (2, 1, 2), (1, 0, 1))
    specs = SH.state_placement_specs(cfg, pt, True, D)
    like = SD.init_train_state(cfg, spec, opt, exchange=ex, device="cpu",
                               mesh=pt)
    with open(path, "rb") as f:
        data = f.read()
    cut = str(tmp_path / "cut.npz")
    with open(cut, "wb") as f:
        f.write(data[: len(data) // 2])
    with pytest.raises(ValueError, match="unreadable|truncated"):
        npz.restore_sliced(cut, like, specs, pt, cfg)
    # a wider group: every shape mismatch named, with both shapes
    cfg6, spec6, _, ex6 = _setup("llama3.2-3b", n=6)
    wide = SD.init_train_state(cfg6, spec6, opt, exchange=ex6, device="cpu",
                               mesh=pt)
    with pytest.raises(ValueError) as err:
        npz.restore_sliced(path, wide, specs, pt, cfg)
    msg = str(err.value)
    assert ("shape mismatch at \".params['embed']\": checkpoint "
            "(4, 512, 256) (the rank's slice (2, 256, 256)) vs template "
            "(3, 256, 256)") in msg
    assert "problems" in msg and "'.know.alive'" in msg
    # a missing leaf: named under strict, kept from the template without
    with np.load(path) as f:
        no_sk = {k: v for k, v in f.items() if k != ".know.sk"}
    part = str(tmp_path / "part.npz")
    np.savez(part, **no_sk)
    with pytest.raises(ValueError, match=r"missing leaf '\.know\.sk'"):
        npz.restore_sliced(part, like, specs, pt, cfg)
    like.know.sk.fill_(3.0)
    got = npz.restore_sliced(part, like, specs, pt, cfg, strict=False)
    assert bool((got.know.sk == 3.0).all()) and got.step == 3
