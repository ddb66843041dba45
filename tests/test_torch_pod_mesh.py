"""The pod dispatch and the streaming trainer over ``torch.distributed``
on a ``("pod", "agent")`` device mesh, in several processes on the host
(gloo, a ``FileStore`` in ``tmp_path``): the collectives that NCCL runs
on the card, held against the port's single-device paths.

Two spawns serve every test of the file (module fixtures): two ranks,
on a (1, 2) and a (2, 1) mesh, and four ranks on a (2, 2) mesh. The
workers import only torch and the port.

* The sharded dispatch (8 agents; one pod of 8 on (1, 2), two pods of 4
  on (2, 1) and (2, 2)): the all-reduce fast path (a uniform leader
  clique), the point-to-point rotation (a weighted clique or a
  relevance override), a dead leader and int8 planes, each within
  rtol 1e-5 / atol 1e-6 of the single-device dispatch and of the flat
  ``_combine_topo``; with one pod bitwise ``_combine_topo``. The flat
  combiner on a mesh is bitwise the single-device one. The placement
  contract raises the reference's messages.
* The rank order: global rank p·A_dev + a holds agents [(p·A_dev +
  a)·blk, … + blk).
* The streaming step on the (2, 2) mesh (pods = 2, four configurations:
  uniform, exact grad_cos, grad_cos+sketch with int8 planes, elastic
  with a dead leader) against the port's single-process flat path
  (rtol 1e-5 / atol 1e-6), and against the single-process pod path; the
  sketch rows of every step bitwise the single-process rows, the
  learned relevance the same on every rank and bitwise the single
  process's.
"""
from __future__ import annotations

import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch.configs.base import GroupSpec, NotPortedError  # noqa: E402
from repro_torch.core import pod_dispatch as PD  # noqa: E402
from repro_torch.core import sharded_ddal as SD  # noqa: E402
from repro_torch.core import topology as T  # noqa: E402
from repro_torch.core.exchange import build_exchange  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
N = 8
# (rel_seed, relevance override, dead agents, q_block)
DISPATCH = {
    "uniform": (None, False, (), 0),
    "weighted": (11, False, (), 0),
    "override": (None, True, (), 0),
    "dead_leader": (None, False, (4, 1), 0),
    "int8": (13, False, (), 128),
}
FLAT = {"ring": dict(topology="ring"),
        "full": dict(),
        "ring_int8_dead": dict(topology="ring", knowledge_quant_block=128,
                               elastic=True)}
STEP = {"uniform": dict(),
        "grad_cos": dict(relevance_mode="grad_cos"),
        "sketch_int8": dict(exchange_estimator="grad_cos+sketch",
                            relevance_sketch_dim=16,
                            knowledge_quant_block=128),
        "elastic": dict(elastic=True, relevance_mode="grad_cos")}
STEPS = 7
KILL_AT, REVIVE_AT, VICTIM = 3, 5, 4          # a pod leader


# ---------------------------------------------------------------------
# inputs, made the same way in the workers and in the test process
# ---------------------------------------------------------------------
def _knowledge(seed, p=300, dtype=torch.float32):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dtype)
    return SD.Knowledge(tg={"a": t(N, p), "b": t(N, 3, 2)},
                        tsum=torch.from_numpy(rng.uniform(1, 3, N).astype(
                            np.float32)),
                        rg={"a": t(N, p), "b": t(N, 3, 2)},
                        rsum=torch.from_numpy(rng.uniform(1, 3, N).astype(
                            np.float32)))


def _rows(know, rows):
    def f(x):
        return x[rows].clone()
    return know._replace(tg={k: f(v) for k, v in know.tg.items()},
                         rg={k: f(v) for k, v in know.rg.items()},
                         tsum=f(know.tsum), rsum=f(know.rsum))


def _dispatch_inputs(name, pods):
    rel_seed, override, dead, qb = DISPATCH[name]
    topo = T.hierarchical(N, N // pods)
    if rel_seed is not None:
        R = np.random.default_rng(rel_seed).uniform(0.2, 1.0, (N, N))
        topo = topo.with_relevance(R.astype(np.float32))
    rel = None
    if override:
        r = np.random.default_rng(3).uniform(0.1, 1.0, (N, topo.degree))
        rel = torch.from_numpy(np.where(topo.mask, r, 0.0).astype(np.float32))
    alive = None
    if dead:
        alive = torch.ones(N, dtype=torch.bool)
        alive[list(dead)] = False
    return topo, T.hierarchical_layout(N, N // pods), rel, alive, qb


def _toy(spec, mesh=None):
    """(step, state) of a toy streaming group: two leaves, a quadratic
    loss, AdamW; on ``mesh`` the rank's rows of the group's state."""
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.normal(size=(N, 5)).astype(
        np.float32)), "v": torch.from_numpy(rng.normal(size=(N, 5000)).astype(
            np.float32))}
    opt = optim.adamw(0.05)
    ex = build_exchange(spec, kind="streaming", mesh=mesh)
    alive = torch.ones(N, dtype=torch.bool) if spec.elastic else None
    state = SD.TrainState(params=params, opt_state=opt.tree_init(params),
                          know=SD.init_knowledge(
                              params, rel=ex.streaming_rel_init("cpu"),
                              sketch_dim=ex.sketch_dim, alive=alive),
                          step=0)
    if mesh is not None:
        from repro_torch.launch.shardings import agent_sharded_state
        state = agent_sharded_state(state, mesh)

    def loss_fn(p, b):
        return (torch.mean((p["w"] - b["x"][:5]) ** 2)
                + torch.mean((p["v"] - b["x"].mean()) ** 2))
    return SD.make_group_train_step(None, spec, opt, loss_fn=loss_fn,
                                    exchange=ex), state


def _toy_run(spec, rows=slice(0, N), mesh=None):
    """Per step: (losses, sk rows, rel); then the final state."""
    step, state = _toy(spec, mesh)
    data = np.random.default_rng(7)
    trace = []
    for t in range(STEPS):
        if spec.elastic and t == KILL_AT:
            state = SD.kill_agents(state, torch.arange(N) == VICTIM)
        if spec.elastic and t == REVIVE_AT:
            state = SD.revive_agents(state, torch.arange(N) == VICTIM)
        x = torch.from_numpy(data.normal(size=(N, 64)).astype(np.float32))
        state, m = step(state, {"x": x[rows]})
        k = state.know
        trace.append((m["loss"].clone(), m["shared"],
                      None if k.sk is None else k.sk.clone(),
                      None if k.rel is None else k.rel.clone()))
    return trace, state


def _spec(pods, **kw):
    return GroupSpec(n_agents=N, threshold=1, minibatch=2,
                     knowledge_mode="streaming", topology="hierarchical",
                     degree=4, pods=pods, **kw)


# ---------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------
def _entry(rank, world, store, out_dir, name):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        out = globals()[name](rank, world)
        torch.save(out, os.path.join(out_dir, f"{name}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, name, world, timeout=240.0):
    ctx = mp.spawn(_entry, args=(world, str(tmp_path / f"store_{name}"),
                                 str(tmp_path), name), nprocs=world,
                   join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"{name}: {world} workers still running "
                               f"after {timeout} s")
    return [torch.load(tmp_path / f"{name}_{r}.pt", weights_only=False)
            for r in range(world)]


def _error(fn):
    try:
        fn()
    except (ValueError, NotPortedError) as exc:
        return f"{type(exc).__name__}: {exc}"
    return None


def _dispatch_worker(mesh, shapes_out):
    from repro_torch.launch.shardings import ddal_agent_axis
    n_pod = mesh.size(0)
    shard = SD.agent_shard(mesh, N)
    res = {"rank": dist.get_rank(), "coord": (mesh.get_local_rank("pod"),
                                              mesh.get_local_rank("agent")),
           "rows": (shard.rows.start, shard.rows.stop),
           "axis": ddal_agent_axis(mesh)}
    for name in DISPATCH:
        topo, layout, rel, alive, qb = _dispatch_inputs(name, n_pod)
        know = _rows(_knowledge(list(DISPATCH).index(name)), shard.rows)
        got = PD.make_pod_dispatch(topo, layout, mesh=mesh)(
            know, rel, alive=alive, q_block=qb)
        res[name] = {k: v.numpy() for k, v in got.items()}
    for name, kw in FLAT.items():
        spec = GroupSpec(n_agents=N, knowledge_mode="streaming", **kw)
        ex = build_exchange(spec, kind="streaming", mesh=mesh)
        alive = torch.arange(N) != 2 if spec.elastic else None
        know = _rows(_knowledge(5), shard.rows)
        got = ex.combine(know, None, 0, alive=alive)
        res["flat_" + name] = {k: v.numpy() for k, v in got.items()}
    shapes_out[tuple(mesh.mesh.shape)] = res


def world2(rank, world):
    from repro_torch.launch.mesh import make_pod_mesh
    out = {}
    for n_pod in (1, 2):
        _dispatch_worker(make_pod_mesh(n_pod, device_type="cpu"), out)
    return out


def world4(rank, world):
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.launch.shardings import gather_agent_state
    out = {}
    mesh = make_pod_mesh(2, device_type="cpu")
    _dispatch_worker(mesh, out)
    # the placement contract
    out["errors"] = {
        "pods": _error(lambda: PD.make_pod_dispatch(
            T.hierarchical(8, 2), T.hierarchical_layout(8, 2), mesh=mesh)),
        "divide": _error(lambda: PD.make_pod_dispatch(
            T.hierarchical(6, 3), T.hierarchical_layout(6, 3), mesh=mesh)),
        "split": _error(lambda: build_exchange(GroupSpec(
            n_agents=6, knowledge_mode="streaming", topology="ring"),
            kind="streaming", mesh=mesh)),
        "shape": _error(lambda: make_pod_mesh(3, device_type="cpu")),
    }
    shard = SD.agent_shard(mesh, N)
    for name, kw in STEP.items():
        trace, state = _toy_run(_spec(2, **kw), shard.rows, mesh)
        full = gather_agent_state(state, mesh)
        out["step_" + name] = (trace, {k: v.numpy() for k, v in
                                       full.params.items()})
    trace, state = _toy_run(_spec(0), shard.rows, mesh)
    out["step_flat"] = (trace, {k: v.numpy() for k, v in
                                gather_agent_state(state, mesh).params.items()})
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("world2"), "world2", 2)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("world4"), "world4", 4)


def _ranks(request, shape):
    return request.getfixturevalue("four_ranks" if shape == (2, 2)
                                   else "two_ranks")


# ---------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------
SHAPES = [(1, 2), (2, 1), (2, 2)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_rank_order_is_pod_major(request, shape):
    ranks = _ranks(request, shape)
    blk = N // (shape[0] * shape[1])
    for r, res in enumerate(ranks):
        got = res[shape]
        p, a = got["coord"]
        assert got["rank"] == r == p * shape[1] + a
        assert got["rows"] == (r * blk, (r + 1) * blk)
        assert got["axis"] == ("pod", "agent")


@pytest.mark.parametrize("case", list(DISPATCH))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_sharded_dispatch_matches_single_device(request, shape, case):
    ranks = _ranks(request, shape)
    pods = shape[0]
    topo, layout, rel, alive, qb = _dispatch_inputs(case, pods)
    know = _knowledge(list(DISPATCH).index(case))
    single = PD.make_pod_dispatch(topo, layout)(know, rel, alive=alive,
                                                q_block=qb)
    flat = SD._combine_topo(know, topo if rel is None else
                            topo._replace(relevance=rel), alive=alive,
                            q_block=qb)
    live = np.ones(N, bool) if alive is None else alive.numpy()
    for k in ("a", "b"):
        got = np.concatenate([res[shape][case][k] for res in ranks])
        if pods == 1:
            np.testing.assert_array_equal(got, flat[k].numpy())
            np.testing.assert_array_equal(got, single[k].numpy())
        np.testing.assert_allclose(got[live], single[k].numpy()[live], **TOL)
        np.testing.assert_allclose(got[live], flat[k].numpy()[live], **TOL)


@pytest.mark.parametrize("case", list(FLAT))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_flat_combiner_on_a_mesh_is_bitwise(request, shape, case):
    ranks = _ranks(request, shape)
    spec = GroupSpec(n_agents=N, knowledge_mode="streaming", **FLAT[case])
    alive = torch.arange(N) != 2 if spec.elastic else None
    want = build_exchange(spec, kind="streaming").combine(
        _knowledge(5), None, 0, alive=alive)
    for k in ("a", "b"):
        got = np.concatenate([res[shape]["flat_" + case][k]
                              for res in ranks])
        np.testing.assert_array_equal(got, want[k].numpy())


def test_placement_contract_errors(four_ranks):
    err = four_ranks[0]["errors"]
    assert all(r["errors"] == err for r in four_ranks)
    assert err["pods"] == (
        "ValueError: topology has 4 pods but mesh axis 'pod' has 2 devices "
        "— pods must map 1:1 onto the pod axis")
    assert err["divide"] == (
        "ValueError: pod size 3 does not divide over the 2-device 'agent' "
        "axis")
    assert err["split"] == (
        "ValueError: 6 agents do not split evenly over the mesh's 4 devices")
    assert err["shape"].startswith("ValueError: 4 devices do not split "
                                   "into 3 pods")


def test_production_meshes_need_their_world_and_multipod_is_taken():
    """The production meshes are built over a world of their size only,
    and the trainer takes the (pod, data, model) mesh (``mesh_kind``
    ``"pod_model"``; its runs: ``test_torch_multipod_mesh.py``); the
    (data, model) meshes are held in ``test_torch_tp_mesh.py``."""
    from repro_torch.launch import mesh as M

    class ProdMesh:
        mesh_dim_names = ("pod", "data", "model")
    with pytest.raises(ValueError, match="needs 512 devices"):
        M.make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(ValueError, match="needs 256 devices"):
        M.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        M.make_debug_mesh(device_type="cpu")
    assert SD.mesh_kind(ProdMesh()) == "pod_model"
    with pytest.raises(NotPortedError, match="none of the meshes"):
        SD.mesh_kind(ProdMesh(), pod_axis="pods")


def _assert_trace(got_ranks, want, bitwise_sketch=True):
    for t, (loss, shared, sk, rel) in enumerate(want):
        for res in got_ranks:
            g_loss, g_shared, _, g_rel = res[t]
            assert g_shared == shared, t
            np.testing.assert_allclose(g_loss.numpy(), loss.numpy(), **TOL)
            if rel is not None:
                np.testing.assert_array_equal(g_rel.numpy(),
                                              got_ranks[0][t][3].numpy())
                np.testing.assert_allclose(g_rel.numpy(), rel.numpy(),
                                           atol=1e-6)
        if sk is not None:
            g_sk = torch.cat([res[t][2] for res in got_ranks])
            if bitwise_sketch:
                np.testing.assert_array_equal(g_sk.numpy(), sk.numpy())


@pytest.mark.parametrize("case", list(STEP))
def test_train_step_on_mesh_tracks_flat_path(four_ranks, case):
    """Mirrors the reference's ``test_train_step_pod_dispatch_on_mesh``
    (red on a one-device host): the (2, 2) mesh with the pod combiner
    against the single-process flat path and the single-process pod
    path, step by step."""
    traces = [r["step_" + case][0] for r in four_ranks]
    params = four_ranks[0]["step_" + case][1]
    assert all(r["step_" + case][0][t][1] == traces[0][t][1]
               for r in four_ranks for t in range(STEPS))
    assert sum(s for _, s, _, _ in traces[0]) >= 3
    flat_trace, flat = _toy_run(_spec(0, **STEP[case]))
    pod_trace, pod = _toy_run(_spec(2, **STEP[case]))
    _assert_trace(traces, pod_trace)          # sketches bitwise, same rel
    _assert_trace(traces, flat_trace, bitwise_sketch=False)
    for k in ("w", "v"):
        np.testing.assert_allclose(params[k], flat.params[k].numpy(), **TOL)
        np.testing.assert_allclose(params[k], pod.params[k].numpy(), **TOL)


def test_flat_train_step_on_mesh_is_bitwise(four_ranks):
    traces = [r["step_flat"][0] for r in four_ranks]
    want_trace, want = _toy_run(_spec(0))
    _assert_trace(traces, want_trace)
    for k in ("w", "v"):
        np.testing.assert_array_equal(four_ranks[0]["step_flat"][1][k],
                                      want.params[k].numpy())


def test_rows_batch_is_the_group_batch_rows():
    from repro_torch.configs import get_arch_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import StreamSpec, make_group_batch, make_rows_batch
    for arch in ("llama3.2-3b", "musicgen-medium"):
        cfg = get_arch_config(arch).reduced()
        shape = ShapeConfig("rows", 16, 2, "train")
        whole = make_group_batch(cfg, shape, StreamSpec(seed=3), 4, 5, "cpu")
        for rows in (slice(0, 2), slice(2, 4), slice(1, 2)):
            part = make_rows_batch(cfg, shape, StreamSpec(seed=3), rows, 5,
                                   "cpu")
            assert part.keys() == whole.keys()
            for k in whole:
                assert torch.equal(part[k], whole[k][rows]), (arch, k)
