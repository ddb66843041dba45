"""The port's roofline (``repro_torch.roofline``) against the reference's
(``repro.roofline``): parameter counts, model FLOPs and per-shape
variants equal at published widths, the three-term arithmetic, the
collectives a rank issues in a fake world, the FLOP counter's closed
form, the kernels' fake paths, and a traced step's argument bytes
against a real XLA compile."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import (ARCH_IDS, arch_for_shape as ref_arch_for_shape,  # noqa: E402
                           get_arch_config as ref_config)
from repro.configs.base import INPUT_SHAPES as REF_SHAPES  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro import roofline as R  # noqa: E402
from repro_torch import roofline as T  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, arch_for_shape, get_arch_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.roofline import constants as C  # noqa: E402


@pytest.fixture
def fake_world():
    """A fake 4-rank world at rank 0 of a (2, 2) mesh, destroyed after
    the test (the file may share a worker with gloo tests)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import fake_world_mesh
    mesh = fake_world_mesh((2, 2), ("data", "model"))
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_and_model_flops_equal_the_reference(arch):
    """Exact: N, N_active and 6·N·D / 2·N·D for every shape, one and
    two agents, at published widths (the meta tree against the
    reference's eval_shape tree)."""
    ref, port = ref_config(arch), get_arch_config(arch)
    assert T.param_count(port) == R.param_count(ref)
    assert T.active_param_count(port) == R.active_param_count(ref)
    if port.moe is not None:
        assert T.active_param_count(port) < T.param_count(port)
    for name in INPUT_SHAPES:
        for n_agents in (1, 2):
            assert T.model_flops(port, INPUT_SHAPES[name], n_agents) == \
                R.model_flops(ref, REF_SHAPES[name], n_agents)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_for_shape_equals_the_reference(arch):
    for name in INPUT_SHAPES:
        got = arch_for_shape(get_arch_config(arch), name)
        want = ref_arch_for_shape(ref_config(arch), name)
        assert got.sliding_window == want.sliding_window, name
    from repro.configs import LONG_CONTEXT_WINDOW as REF_WINDOW

    from repro_torch.configs import LONG_CONTEXT_WINDOW
    assert LONG_CONTEXT_WINDOW == REF_WINDOW == 8_192


def test_roofline_terms_equal_the_reference_formula():
    """``tests/test_infra.py``'s inputs through both ``analyze``s: the
    same formulas, the port's at the H100's constants."""
    args = ("a", None, "2x2", 4, {"flops": 4e12, "bytes accessed": 8e9},
            {"all-reduce": 1e9, "total": 1e9})
    got = T.analyze(args[0], ShapeConfig("t", 128, 4, "train"), *args[2:],
                    mflops=2e12)
    want = R.analyze(args[0], RefShape("t", 128, 4, "train"), *args[2:],
                     mflops=2e12)
    assert got.t_compute == 4e12 / (4 * C.PEAK_FLOPS_BF16)
    assert got.t_memory == 8e9 / (4 * C.HBM_BW)
    assert got.t_collective == 1e9 / (4 * C.ICI_BW_PER_LINK)
    assert want.t_compute == 4e12 / (4 * 197e12)        # v5e's
    # 1.0e-3 s compute, 6.0e-4 s memory, 1.0e-2 s over one link
    assert got.dominant == "collective" and want.dominant == "compute"
    assert got.useful_ratio == want.useful_ratio == 0.5
    d = got.to_dict()
    assert set(d) == set(want.to_dict())
    assert d["coll_breakdown"] == {"all-reduce": 1e9}
    assert (C.PEAK_FLOPS_BF16, C.PEAK_FLOPS_FP32, C.HBM_BW,
            C.ICI_BW_PER_LINK, C.VMEM_BYTES) == (989e12, 67e12, 3.35e12,
                                                 25e9, 228 * 1024)


def test_collective_bytes_in_a_fake_world(fake_world):
    """The recorder counts operand bytes as the reference's HLO parse:
    test_infra.py's tuple all-reduce (f32 64, (8, 2), 4 x (4,)) is 384
    bytes; an all-gather counts the rank's piece, a reduce-scatter and
    an all-to-all the whole input, a broadcast has a key of its own and
    counts in ``total``."""
    import torch.distributed as dist

    from repro_torch.roofline.collectives import CollectiveRecorder
    from repro.roofline.hlo import collective_bytes as ref_bytes
    hlo = """
ENTRY %m {
  %a = f32[64]{0} parameter(0)
  %b = f32[8,2]{1,0} parameter(1)
  %c = f32[4]{0} parameter(2)
  %d = f32[4]{0} parameter(3)
  %e = f32[4]{0} parameter(4)
  %f = f32[4]{0} parameter(5)
  %ar = (f32[64]{0}, f32[8,2]{1,0}, f32[4]{0}, f32[4]{0}, f32[4]{0}, /*index=5*/f32[4]{0}) all-reduce(%a, %b, %c, %d, %e, %f), replica_groups={}
  ROOT %t = f32[64]{0} get-tuple-element(%ar), index=0
}
"""
    group = fake_world.get_group("model")
    shapes = [(64,), (8, 2), (4,), (4,), (4,), (4,)]
    with CollectiveRecorder() as rec:
        for s in shapes:
            dist.all_reduce(torch.zeros(s), group=group)
    got = T.collective_bytes(rec.records)
    assert got["all-reduce"] == ref_bytes(hlo)["all-reduce"] == 384
    assert T.count_ops(rec.records, "all-reduce") == 6

    x = torch.zeros(10, 3)                     # 120 bytes
    with CollectiveRecorder() as rec:
        dist.all_gather([torch.empty_like(x) for _ in range(2)], x,
                        group=group)
        gather = getattr(dist, "all_gather_single",
                         dist.all_gather_into_tensor)   # by torch version
        scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)
        gather(torch.empty(20, 3), x, group=group)
        scatter(torch.empty(5, 3), x, group=group)
        dist.all_to_all_single(torch.empty_like(x), x, group=group)
        dist.broadcast(x, src=0, group=group)
    got = T.collective_bytes(rec.records)
    assert got["all-gather"] == 2 * 120
    assert got["reduce-scatter"] == 120
    assert got["all-to-all"] == 120
    assert got["broadcast"] == 120
    assert got["collective-permute"] == 0
    assert got["total"] == 5 * 120
    assert T.count_ops(rec.records, "all-gather") == 2
    assert T.count_ops(rec.records, "c10d.broadcast_") == 1


def test_flop_counter_closed_form_on_a_dense_mlp():
    """Forward plus backward of a two-layer MLP with the input
    requiring grad: exactly 3 x Σ 2·M·N·K; the traced bytes and the
    live peak from the op list."""
    from repro_torch.roofline.trace import traced
    M, K, N, O = 8, 16, 32, 4
    with traced() as tr:
        x = torch.empty(M, K, device="meta", requires_grad=True)
        w1 = torch.empty(K, N, device="meta", requires_grad=True)
        w2 = torch.empty(N, O, device="meta", requires_grad=True)
        loss = (torch.relu(x @ w1) @ w2).sum()
        loss.backward()
    assert tr.flops == 3 * (2 * M * N * K + 2 * M * O * N)
    assert tr.counter.ops["aten.mm"] == 6
    assert tr.counter.peak >= 4 * (M * K + K * N + N * O + M * N + M * O)
    assert tr.counter.bytes_accessed > 0


def _no_plain_ops(log):
    """The ops a fake kernel call dispatched: its own op, allocations,
    and nothing of the plain version's arithmetic."""
    arith = [op for op in log if not op.startswith(
        ("repro_torch.", "aten.empty", "aten.new_empty", "aten.detach",
         "prim."))]
    assert not arith, arith


@pytest.mark.parametrize("device", ["fake_cuda", "meta"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_fake_path_counts_the_kernel(device, dtype):
    """Fake card tensors (``FakeTensorMode``) and meta tensors through
    ``flash_attention`` (and its VJP wrapper's forward): the kernel's
    output shape and dtype, its own FLOPs (the causal half and the
    window), no plain-version op in the dispatch log."""
    import contextlib

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.roofline.trace import StepCounter
    B, S, H, K, D, W = 2, 300, 8, 2, 64, 100
    fake = device == "fake_cuda"
    dev = "cuda" if fake else "meta"
    with (FakeTensorMode() if fake else contextlib.nullcontext()):
        q = torch.empty(B, S, H, D, dtype=dtype, device=dev)
        k = torch.empty(B, S, K, D, dtype=dtype, device=dev)
        v = torch.empty(B, S, K, D, dtype=dtype, device=dev)
        launches = ops.flash_attention.launches
        with FlopCounterMode(display=False) as fc, StepCounter() as cnt:
            o = ops.flash_attention(q, k, v, window=W)
            o2 = ops.flash_attention_with_vjp(q, k, v)
    assert ops.flash_attention.launches == launches        # nothing ran
    assert o.shape == o2.shape == (B, S, H, D) and o.dtype == dtype
    bf16 = dtype == torch.bfloat16
    want = (ops.flash_flops(B, S, H, D, W, bf16)
            + ops.flash_flops(B, S, H, D, None, bf16))
    assert fc.get_total_flops() == want
    mask = np.tril(np.ones((S, S), bool)) & ~np.tril(np.ones((S, S), bool),
                                                     -W)
    assert ops.flash_pairs(S, W) == int(mask.sum())
    assert ops.flash_pairs(S, None) == S * (S + 1) // 2
    assert cnt.ops["repro_torch.flash_attention"] == 2
    _no_plain_ops(list(cnt.ops))
    assert cnt.op_bytes["repro_torch.flash_attention"] == 2 * \
        ops.flash_bytes(B, S, H, K, D, q.element_size())


@pytest.mark.parametrize("device", ["fake_cuda", "meta"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_fake_path_counts_the_kernel(device, dtype):
    import contextlib

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.roofline.trace import StepCounter
    b, nc, l, h, p, g, n = 2, 4, 64, 8, 32, 2, 16
    fake = device == "fake_cuda"
    dev = "cuda" if fake else "meta"
    f32 = torch.float32
    with (FakeTensorMode() if fake else contextlib.nullcontext()):
        xc = torch.empty(b, nc, l, h, p, dtype=dtype, device=dev)
        dt = torch.empty(b, nc, l, h, dtype=f32, device=dev)
        Bc = torch.empty(b, nc, l, g, n, dtype=dtype, device=dev)
        launches = ops.ssd_intra_chunk.launches
        with FlopCounterMode(display=False) as fc, StepCounter() as cnt:
            y = ops.ssd_intra_chunk_with_vjp(xc, dt, dt, Bc, Bc)
    assert ops.ssd_intra_chunk.launches == launches
    assert y.shape == (b, nc, l, h, p) and y.dtype == f32
    esize = xc.element_size()
    assert fc.get_total_flops() == ops.ssd_flops(b * nc, l, h, p, n, g,
                                                 esize)
    assert cnt.ops["repro_torch.ssd_intra_chunk"] == 1
    _no_plain_ops(list(cnt.ops))
    assert cnt.op_bytes["repro_torch.ssd_intra_chunk"] == ops.ssd_bytes(
        b * nc, l, h, p, n, g, esize)


def test_constants_load_without_the_rest_of_the_package():
    """The kernels' ops read ``roofline.constants`` and load no other
    module of the package (not the collective recorder, the report or
    the tracer); the reference's exports load on first use."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    code = ("import sys, repro_torch.kernels.flash_attention.ops, "
            "repro_torch.kernels.ssd_scan.ops; print(sorted(m for m in "
            "sys.modules if m.startswith('repro_torch.roofline')))")
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == [
        "['repro_torch.roofline',", "'repro_torch.roofline.constants']"]
    from repro_torch.roofline import collectives, report
    assert T.constants is C
    assert (T.Roofline, T.analyze, T.param_count) == (
        report.Roofline, report.analyze, report.param_count)
    assert T.collective_bytes is collectives.collective_bytes
    with pytest.raises(AttributeError):
        T.hlo


def test_shape_descriptions_are_not_device_memory():
    """The meta trees of ``param_specs`` and ``cache_specs`` (made under
    ``common.describe.describing``) add no op, bytes, live or peak to a
    traced block, and another dispatch mode in force still sees them; a
    tensor the block makes for itself counts live."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models.model import cache_specs, param_specs
    from repro_torch.roofline.trace import traced

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    cfg = get_arch_config("llama3.2-3b").reduced()
    shape = ShapeConfig("t", 64, 2, "decode")
    with Seen() as seen, traced() as tr:
        trees = (param_specs(cfg), cache_specs(cfg, shape))
        seen_specs = seen.n
        cnt = tr.counter
        assert (cnt.live, cnt.peak, cnt.bytes_accessed, sum(
            cnt.ops.values())) == (0, 0, 0, 0)
        assert tr.flops == 0 and not tr.recorder.records
        x = torch.zeros(1024, device="meta")
        assert cnt.live == cnt.peak == x.nbytes
    assert seen_specs > 0 and trees[0]


def test_kernel_bounds_price_the_counted_work():
    """The bounds ``chip_smoke.py`` prints are the counted work at the
    constants' rates (flash at llama3.2-3b's scoring shape, SSD at
    mamba2-780m's prefill chunk)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd
    ms, by = fa.flash_bound(2, 4096, 24, 8, 128, None, 2)
    assert by == "operations"
    assert ms == fa.flash_flops(2, 4096, 24, 128, None, True) \
        / C.PEAK_FLOPS_BF16 * 1e3
    assert fa.flash_mma_flops(2, 4096, 24, 128, None, True) >= \
        fa.flash_flops(2, 4096, 24, 128, None, True)
    ms, by = ssd.ssd_bound(8, 256, 48, 64, 128, 1, 4)
    assert ms == max(ssd.ssd_flops(8, 256, 48, 64, 128, 1, 4)
                     / C.PEAK_FLOPS_FP32,
                     ssd.ssd_bytes(8, 256, 48, 64, 128, 1, 4) / C.HBM_BW) \
        * 1e3


@pytest.mark.multi_device
def test_argument_bytes_equal_an_xla_compile(multi_device):
    """reduced() llama3.2-3b and mamba2-780m on a (2, 2) mesh: the
    port's traced ``argument_size_in_bytes`` against the reference's
    ``memory_analysis()`` of its compiled step. Equal, but for the
    reference's int32 step (4 bytes, train) and the positions the SSM
    never reads, which ``jax.jit`` drops from its arguments (it keeps
    no unused input). The reference is compiled with its layers
    unrolled, as its dry run compiles for costs (a scanned layer's body
    counts once in ``cost_analysis``); the port's FLOPs (matmuls only,
    every layer) are 0.9–1.0 of ``cost_analysis()["flops"]`` (which
    also counts elementwise work), printed."""
    import torch.distributed as dist

    from repro.configs import get_arch_config as ref_config
    from repro.configs.base import GroupSpec as RefGroup
    from repro.configs.base import ShapeConfig as RefShape
    from repro.launch import dryrun_lib as RD
    from repro_torch.configs import get_arch_config
    from repro_torch.configs.base import GroupSpec, ShapeConfig
    from repro_torch.launch import dryrun_lib as DL
    from repro_torch.launch.mesh import fake_world_mesh
    jmesh = jax.sharding.Mesh(np.array(multi_device[:4]).reshape(2, 2),
                              ("data", "model"))
    mesh = fake_world_mesh((2, 2), ("data", "model"))
    try:
        for arch in ("llama3.2-3b", "mamba2-780m"):
            ref = ref_config(arch).reduced().with_(unroll_layers=True)
            cfg = get_arch_config(arch).reduced()
            for kind in ("train", "prefill", "decode"):
                rs, ps = RefShape("t", 64, 4, kind), ShapeConfig("t", 64, 4,
                                                                 kind)
                if kind == "train":
                    low = RD.lower_train(ref, rs, jmesh, RefGroup(n_agents=1))
                    tr = DL.trace_train(cfg, ps, mesh, GroupSpec(n_agents=1))
                elif kind == "prefill":
                    low = RD.lower_prefill(ref, rs, jmesh)
                    tr = DL.trace_prefill(cfg, ps, mesh)
                else:
                    low = RD.lower_decode(ref, rs, jmesh)
                    tr = DL.trace_decode(cfg, ps, mesh)
                comp = low.compile()
                want = comp.memory_analysis().argument_size_in_bytes
                # the rank's rows of the positions, unread by the SSM
                rows = 2 * (1 if kind == "decode" else 64) * 4
                unused = rows if cfg.family == "ssm" else 0
                step = 4 if kind == "train" else 0
                assert tr.argument_bytes == want - step + unused, (
                    arch, kind, tr.argument_bytes, want)
                xla = comp.cost_analysis()["flops"]
                print(f"{arch} {kind}: port {tr.flops} FLOPs, XLA {xla:.0f}, "
                      f"ratio {tr.flops / xla:.3f}")
                assert 0.9 <= tr.flops / xla <= 1.0, (arch, kind)
    finally:
        dist.destroy_process_group()
