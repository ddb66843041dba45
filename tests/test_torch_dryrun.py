"""The port's dry run (``repro_torch.launch.dryrun``, ``dryrun_lib``):
one rank of the production meshes traced in a fake world, held against
the reference's placement arithmetic (the trace against a real XLA
compile: ``test_torch_roofline.py``)."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


@pytest.fixture
def world():
    """``world(shape, axes)``: a fake world's mesh at the origin; the
    process group is destroyed after the test (the file may share a
    worker with gloo tests)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import fake_world_mesh
    yield lambda shape, axes: fake_world_mesh(shape, axes)
    if dist.is_initialized():
        dist.destroy_process_group()


def _bytes(tree) -> int:
    from repro_torch.roofline.trace import device_tensors
    return sum(t.numel() * t.element_size() for t in device_tensors(tree))


class _AbstractMesh:
    """The reference's view of a mesh for ``train_rules`` / ``_sanitize``:
    axis names and sizes, no devices."""

    def __init__(self, names, sizes):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


def _reference_state_bytes(arch, names, sizes) -> int:
    """Σ of the reference's per-device shard sizes of its ``train_4k``
    ``TrainState``: ``train_state_partition_specs`` under
    ``train_rules``, each entry ``_sanitize`` d (the dry run's
    in_shardings), on an abstract mesh."""
    from repro.configs import get_arch_config
    from repro.configs.base import GroupSpec
    from repro.core.exchange import build_exchange
    from repro.core.sharded_ddal import train_state_specs
    from repro.launch.dryrun_lib import _sanitize
    from repro.launch.mesh import train_rules
    from repro.launch.shardings import train_state_partition_specs
    from repro.optim import adamw
    mesh = _AbstractMesh(names, sizes)
    cfg = get_arch_config(arch)
    spec = GroupSpec(n_agents=mesh.shape.get("pod", 1))
    est = build_exchange(spec, kind="streaming").estimator
    rules = train_rules(mesh)
    specs = train_state_partition_specs(
        cfg, rules, rules["agent"], learn_relevance=est.learns,
        sketch_dim=est.sketch_dim)
    shapes = train_state_specs(cfg, spec, adamw(3e-4))
    total = 0
    for s, x in zip(jax.tree.leaves(specs, is_leaf=lambda v: isinstance(
            v, P)), jax.tree.leaves(shapes)):
        n = x.dtype.itemsize
        for dim, axes in zip(x.shape, _sanitize(mesh, s, x.shape)):
            split = 1
            for a in ((axes,) if isinstance(axes, str) else axes or ()):
                split *= mesh.shape[a]
            n *= dim // split
        total += n
    return total


def _placement_bytes(cfg, spec, exchange, point):
    """(Σ of the rank's slices under ``state_placement_specs`` on a
    ``MeshPoint``, the part of it that the whole-heads rule adds over
    ``_sanitize`` alone)."""
    from repro_torch import optim
    from repro_torch.common.pytree import tree_leaves_with_paths
    from repro_torch.core.sharded_ddal import init_train_state
    from repro_torch.launch import shardings as SH
    full = init_train_state(cfg, spec, optim.adamw(3e-4), exchange=exchange,
                            device="meta")
    specs = SH.state_placement_specs(cfg, point, exchange.estimator.learns,
                                     exchange.sketch_dim)
    total = heads = 0

    def walk(tree, sp, path=()):
        nonlocal total, heads
        if hasattr(tree, "_fields"):
            for name, x, s in zip(tree._fields, tree, sp):
                if isinstance(x, torch.Tensor) or hasattr(x, "_fields") or \
                        isinstance(x, dict):
                    walk(x, s, path + (name,))
            return
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], sp[k], path + (k,))
            return
        keys = tuple(k for k in path if isinstance(k, str))
        if sp is None:
            total += tree.numel() * tree.element_size()
            return
        shape = tuple(tree.shape)
        for rule, into in ((SH.placement_spec(cfg, point, keys, tuple(sp),
                                              shape), "total"),
                           (SH._sanitize(point, tuple(sp), shape), "san")):
            n = tree.element_size()
            for s in SH.local_slices(point, rule, shape):
                n *= s.stop - s.start
            if into == "total":
                total += n
                heads += n
            else:
                heads -= n
    walk(full, specs)
    assert tree_leaves_with_paths(full.params)
    return total, heads


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_state_bytes_equal_the_placement(arch, world):
    """The traced argument bytes of the ``train_4k`` state at rank
    (0, 0) of 16 x 16 and (0, 0, 0) of 2 x 16 x 16 are Σ of the rank's
    slices by the placement specs on a ``MeshPoint``, and that is the
    reference's per-device Σ (``train_state_partition_specs`` and
    ``_sanitize`` on an abstract mesh) less its 4-byte int32 step (the
    port's step is a host int) plus what the whole-heads rule keeps
    whole: attention heads that do not divide the model axis (llama's 24
    query / 8 kv heads over 16, …) lie whole on every rank, as the
    port's layers need them. Families without such leaves (mamba2,
    zamba2, deepseek) are the reference's less 4 bytes exactly."""
    import torch.distributed as dist

    from repro_torch.common.sharding import MeshPoint
    from repro_torch.configs import INPUT_SHAPES, get_arch_config
    from repro_torch.configs.base import GroupSpec
    from repro_torch.core.exchange import build_exchange
    from repro_torch.launch import dryrun_lib as DL
    cfg = get_arch_config(arch)
    for names, sizes in MESHES.values():
        mesh = world(sizes, names)
        spec = GroupSpec(n_agents=dict(zip(names, sizes)).get("pod", 1))
        state, _, _ = DL.train_inputs(cfg, INPUT_SHAPES["train_4k"], mesh,
                                      spec)
        traced = DL._run_traced((state,), lambda s: None)
        exchange = build_exchange(spec, kind="streaming")
        point = MeshPoint(names, sizes, (0,) * len(sizes))
        placed, heads = _placement_bytes(cfg, spec, exchange, point)
        assert traced.argument_bytes == placed == _bytes(state)
        ref = _reference_state_bytes(arch, names, sizes)
        assert placed == ref - 4 + heads, (names, placed, ref, heads)
        if arch in ("mamba2-780m", "zamba2-7b", "deepseek-v2-lite-16b"):
            assert heads == 0 and placed == ref - 4
        else:
            assert heads > 0
        dist.destroy_process_group()


def test_dryrun_pair_records_and_failures(world):
    """mamba2-780m prefill_32k at rank (0, 0) of 16 x 16: the record's
    memory keys, the SSD kernel in each of 48 layers, the roofline
    terms from the rank's counts x 256 chips; a pair that raises is
    recorded ``ok=False`` with its error, not skipped."""
    from repro_torch.configs.base import GroupSpec
    from repro_torch.launch import dryrun_lib as DL
    from repro_torch.launch.mesh import production_shape
    from repro_torch.roofline import constants as C
    mesh = world(*production_shape(False))
    res = DL.dryrun_pair("mamba2-780m", "prefill_32k", mesh)
    assert res.ok, res.error
    assert res.mesh_name == "16x16" and res.kernels == {"ssd_intra_chunk": 48}
    mem, roof = res.memory, res.roofline
    assert mem["total_bytes_per_device"] == (
        mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"])
    assert 0 < mem["argument_size_in_bytes"] < mem["total_bytes_per_device"]
    assert roof["bytes_per_device"] == mem["total_bytes_per_device"]
    assert roof["t_compute"] == roof["hlo_flops"] / (256 * C.PEAK_FLOPS_BF16)
    assert roof["hlo_flops"] % 256 == 0 and roof["coll_bytes"] > 0
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert set(res.to_dict()) >= {"arch", "shape", "mesh_name", "ok",
                                  "error", "memory", "roofline",
                                  "compile_s"}
    import torch.distributed as dist
    dist.destroy_process_group()
    mesh = world(*production_shape(True))      # 3 agents over 2 pods
    bad = DL.dryrun_pair("llama3.2-3b", "train_4k", mesh,
                         group=GroupSpec(n_agents=3))
    assert not bad.ok and bad.memory is None
    assert bad.error.startswith("ValueError"), bad.error


def test_cli_traces_one_pair():
    """``python -m repro_torch.launch.dryrun --arch mamba2-780m --shape
    decode_32k`` prints ``[OK]`` and exits 0, with no card."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-780m", "--shape", "decode_32k"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("[OK]   mamba2-780m"), res.stdout
    assert "1/1 pairs traced OK" in res.stdout
