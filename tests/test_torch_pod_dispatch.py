"""Port parity of the pod dispatch on one device
(``repro_torch.core.pod_dispatch``, the pod placement of
``repro_torch.core.topology`` and the ``pod`` combiner) against
``repro.core.pod_dispatch`` on the same numpy inputs.

The placement tables (``PodLayout``, ``edge_pod_ids``,
``cross_pod_mask``, ``split_topology``) are bitwise and raise the same
errors; the byte counts are equal integers. The single-device dispatch
is bitwise the port's ``_combine_topo`` with one pod, and within
rtol 1e-5 / atol 1e-6 (the reference's own tolerance,
``tests/test_pod_dispatch.py``) of the reference's
``make_pod_dispatch(mesh=None)`` with several pods, a per-edge
relevance override, a dead leader and int8 planes. ``GroupSpec``'s pod
validation has the reference's messages, the ``pod`` combiner refuses
a faulty transport and a resampling schedule as the reference's does,
and a toy streaming run with ``pods=2`` tracks the flat path and the
reference's own pod run.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import optim as ref_optim  # noqa: E402
from repro.configs.base import GroupSpec as RefSpec  # noqa: E402
from repro.core import pod_dispatch as RPD  # noqa: E402
from repro.core import sharded_ddal as RSD  # noqa: E402
from repro.core import topology as RT  # noqa: E402
from repro.core.exchange import build_exchange as ref_build  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs.base import GroupSpec  # noqa: E402
from repro_torch.core import pod_dispatch as PD  # noqa: E402
from repro_torch.core import sharded_ddal as SD  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402
from repro_torch.core.exchange import build_exchange  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
# the reference's (n, pod_size) cases (tests/test_pod_dispatch.py) and
# two more with several pods
LAYOUTS = [(9, 3), (15, 5), (8, 4), (12, 3), (12, 4), (8, 2)]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _knowledge(rng, A, p):
    """numpy planes → (port Knowledge, reference Knowledge), two leaves."""
    arrs = dict(tg={"a": rng.normal(size=(A, p)), "b": rng.normal(size=(A, 3))},
                rg={"a": rng.normal(size=(A, p)), "b": rng.normal(size=(A, 3))},
                tsum=rng.uniform(1, 3, A), rsum=rng.uniform(1, 3, A))

    def f32(x):
        return (np.asarray(x, np.float32) if not isinstance(x, dict)
                else {k: f32(v) for k, v in x.items()})
    arrs = {k: f32(v) for k, v in arrs.items()}
    port = SD.Knowledge(**{k: (torch.from_numpy(v.copy()) if not isinstance(
        v, dict) else {q: torch.from_numpy(w.copy()) for q, w in v.items()})
        for k, v in arrs.items()})
    ref = RSD.Knowledge(**{k: jax.tree.map(jnp.asarray, v)
                           for k, v in arrs.items()})
    return port, ref


def _hier(n, pod_size, rel_seed=None):
    """(port topology, reference topology, port layout, reference layout)."""
    pt, rt = PT.hierarchical(n, pod_size), RT.hierarchical(n, pod_size)
    if rel_seed is not None:
        R = np.random.default_rng(rel_seed).uniform(0.2, 1.0, (n, n))
        pt = pt.with_relevance(R.astype(np.float32))
        rt = rt.with_relevance(jnp.asarray(R, jnp.float32))
    return pt, rt, PT.hierarchical_layout(n, pod_size), \
        RT.hierarchical_layout(n, pod_size)


def _close(got, want, **tol):
    for k in ("a", "b"):
        if tol:
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), **tol)
        else:
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))


# ---------------------------------------------------------------------
# placement tables and traffic accounting
# ---------------------------------------------------------------------
@pytest.mark.parametrize("n,pod_size", LAYOUTS)
def test_layout_tables_bitwise(n, pod_size):
    pt, rt, pl, rl = _hier(n, pod_size)
    for name in ("pod_id", "leader_mask", "leaders"):
        got, want = getattr(pl, name), np.asarray(getattr(rl, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, name)
    assert (pl.pod_size, pl.n_agents, pl.n_pods) == \
        (rl.pod_size, rl.n_agents, rl.n_pods)
    np.testing.assert_array_equal(PT.edge_pod_ids(pt, pl),
                                  np.asarray(RT.edge_pod_ids(rt, rl)))
    np.testing.assert_array_equal(PT.cross_pod_mask(pt, pl),
                                  np.asarray(RT.cross_pod_mask(rt, rl)))
    pe, re_ = PD.split_topology(pt, pl), RPD.split_topology(rt, rl)
    for name in PD.PodEdges._fields:
        got, want = getattr(pe, name), np.asarray(getattr(re_, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, name)


def test_layout_errors_match_reference():
    def message(fn, *args):
        with pytest.raises(ValueError) as info:
            fn(*args)
        return str(info.value)
    assert message(PT.hierarchical_layout, 10, 4) == \
        message(RT.hierarchical_layout, 10, 4)
    assert message(PT.hierarchical_layout, 4, 0) == \
        message(RT.hierarchical_layout, 4, 0)
    assert message(PD.split_topology, PT.ring(8),
                   PT.hierarchical_layout(8, 4)) == \
        message(RPD.split_topology, RT.ring(8), RT.hierarchical_layout(8, 4))
    assert message(PD.split_topology, PT.hierarchical(8, 4),
                   PT.hierarchical_layout(12, 4)) == \
        message(RPD.split_topology, RT.hierarchical(8, 4),
                RT.hierarchical_layout(12, 4))


@pytest.mark.parametrize("n,pod_size", [(16, 4), (32, 4), (64, 16), (12, 3)])
def test_byte_counts_equal_reference(n, pod_size):
    pt, rt, pl, rl = _hier(n, pod_size)
    pe, re_ = PD.split_topology(pt, pl), RPD.split_topology(rt, rl)
    for P in (10_000, 9155, 1):
        for dtype_bytes, qb in ((4, 0), (2, 0), (4, 128), (4, 512)):
            got = PD.cross_pod_bytes(pe, P, dtype_bytes, qb)
            assert type(got) is int
            assert got == RPD.cross_pod_bytes(re_, P, dtype_bytes, qb)
            got = PD.flat_exchange_bytes(pt, P, dtype_bytes, qb)
            assert type(got) is int
            assert got == RPD.flat_exchange_bytes(rt, P, dtype_bytes, qb)
        for d in (0, 64, 256):
            assert PD.relevance_exchange_bytes(n, P, d) == \
                RPD.relevance_exchange_bytes(n, P, d)


# ---------------------------------------------------------------------
# the single-device dispatch
# ---------------------------------------------------------------------
@pytest.mark.parametrize("q_block,dead", [(0, None), (128, None), (0, 0),
                                          (128, 3)])
def test_one_pod_is_bitwise_combine_topo(q_block, dead):
    rng = np.random.default_rng(0)
    pt, _, pl, _ = _hier(8, 8)
    know, _ = _knowledge(rng, 8, 300)
    alive = None
    if dead is not None:
        alive = torch.ones(8, dtype=torch.bool)
        alive[dead] = False
    want = SD._combine_topo(know, pt, alive=alive, q_block=q_block)
    got = PD.make_pod_dispatch(pt, pl)(know, alive=alive, q_block=q_block)
    _close(got, want)


@pytest.mark.parametrize("n,pod_size,rel_seed", [
    (8, 4, None), (12, 4, None), (8, 2, 3), (12, 3, 5), (16, 4, 7)])
def test_several_pods_match_reference(n, pod_size, rel_seed):
    rng = np.random.default_rng(1)
    pt, rt, pl, rl = _hier(n, pod_size, rel_seed)
    know, rknow = _knowledge(rng, n, 6)
    want = RPD.make_pod_dispatch(rt, rl)(rknow)
    got = PD.make_pod_dispatch(pt, pl)(know)
    _close(got, want, **TOL)
    # and the port's flat combine, as the reference holds its own
    _close(got, SD._combine_topo(know, pt), **TOL)


def test_relevance_override_matches_reference():
    rng = np.random.default_rng(2)
    pt, rt, pl, rl = _hier(8, 4)
    know, rknow = _knowledge(rng, 8, 5)
    rel = rng.uniform(0.1, 1.0, (8, pt.degree)).astype(np.float32)
    rel = np.where(pt.mask, rel, 0.0).astype(np.float32)
    combine = RPD.make_pod_dispatch(rt, rl)
    want = jax.jit(lambda k, r: combine(k, r))(rknow, jnp.asarray(rel))
    got = PD.make_pod_dispatch(pt, pl)(know, torch.from_numpy(rel))
    _close(got, want, **TOL)


@pytest.mark.parametrize("dead", [[4], [0, 5], [1]])
def test_dead_agents_match_reference(dead):
    """A dead leader (4, or 0) sends a zero plane across the pods; a dead
    member (5, 1) adds nothing to its pod."""
    rng = np.random.default_rng(3)
    pt, rt, pl, rl = _hier(12, 4, 9)
    know, rknow = _knowledge(rng, 12, 7)
    alive = np.ones(12, bool)
    alive[dead] = False
    want = RPD.make_pod_dispatch(rt, rl)(rknow, alive=jnp.asarray(alive))
    got = PD.make_pod_dispatch(pt, pl)(know, alive=torch.from_numpy(alive))
    live = alive                     # dead rows are garbage on both sides
    for k in ("a", "b"):
        np.testing.assert_allclose(_np(got[k])[live],
                                   np.asarray(want[k])[live], **TOL)


def test_int8_planes_match_reference():
    """``q_block`` takes the planes through the int8 round trip a column
    chunk at a time, as ``quantize_knowledge_roundtrip`` does on the
    whole window in the reference's ``pod`` combiner."""
    from repro.kernels.ddal_wavg import ops as ref_wavg_ops
    rng = np.random.default_rng(4)
    pt, rt, pl, rl = _hier(8, 4, 2)
    know, rknow = _knowledge(rng, 8, 700)
    quant = jax.jit(lambda k: RSD.quantize_knowledge_roundtrip(k, 128))
    del ref_wavg_ops
    want = RPD.make_pod_dispatch(rt, rl)(quant(rknow))
    got = PD.make_pod_dispatch(pt, pl)(know, q_block=128)
    _close(got, want, **TOL)


def test_out_tree_receives_the_result():
    rng = np.random.default_rng(5)
    pt, _, pl, _ = _hier(8, 4)
    know, _ = _knowledge(rng, 8, 9)
    out = {k: torch.full_like(v, float("nan")) for k, v in know.tg.items()}
    got = PD.make_pod_dispatch(pt, pl)(know, out=out)
    assert got is out
    _close(out, PD.make_pod_dispatch(pt, pl)(know))


def test_multipod_mesh_takes_the_plain_dispatch():
    """The (pod, data, model) mesh is taken: the dispatch goes to its
    placement (agents over ``pod``), which needs the process group the
    mesh spans (its runs: ``test_torch_multipod_mesh.py``)."""
    from repro_torch.core.sharded_ddal import mesh_kind

    class ProdMesh:
        mesh_dim_names = ("pod", "data", "model")

        def size(self, dim=None):
            return 2 if dim is not None else 8
    pt, _, pl, _ = _hier(8, 4)
    assert mesh_kind(ProdMesh()) == "pod_model"
    with pytest.raises(ValueError, match="span the whole process group"):
        PD.make_pod_dispatch(pt, pl, mesh=ProdMesh())


def test_data_model_mesh_places_no_agents():
    """Every rank of a (data, model) mesh holds every agent: the pod
    dispatch refuses the mesh and ``agent_shard`` places nothing on it."""
    from repro_torch.configs.base import NotPortedError
    from repro_torch.core.sharded_ddal import agent_shard

    class DataModelMesh:
        mesh_dim_names = ("data", "model")
    pt, _, pl, _ = _hier(8, 4)
    with pytest.raises(NotPortedError, match="places none"):
        PD.make_pod_dispatch(pt, pl, mesh=DataModelMesh())
    with pytest.raises(ValueError, match="places no agents"):
        agent_shard(DataModelMesh(), 8)


# ---------------------------------------------------------------------
# GroupSpec and the pod combiner
# ---------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(pods=-1), dict(topology="ring", pods=2),
    dict(topology="hierarchical", degree=4, pods=3),
    dict(topology="hierarchical", degree=4, pods=2, pod_axis="agent"),
    dict(topology="hierarchical", degree=4, pods=2, pod_axis=""),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_groupspec_pod_validation_messages(kw):
    with pytest.raises(ValueError) as ref_err:
        RefSpec(n_agents=8, **kw)
    with pytest.raises(ValueError) as port_err:
        GroupSpec(n_agents=8, **kw)
    assert str(port_err.value) == str(ref_err.value)


def test_pods_build_the_pod_combiner():
    """``GroupSpec(n_agents=8, topology="hierarchical", degree=4, pods=2)``
    constructs; ``auto`` picks ``pod`` for the streaming trainer (and
    ``store`` for the buffer trainer), as the reference's build does."""
    kw = dict(n_agents=8, topology="hierarchical", degree=4, pods=2,
              knowledge_mode="streaming")
    ex = build_exchange(GroupSpec(**kw), kind="streaming")
    assert ex.combiner.__qualname__.startswith("make_pod_combiner")
    ex = build_exchange(GroupSpec(exchange_combiner="pod", **dict(
        kw, pods=0)), kind="streaming")
    assert ex.combiner.__qualname__.startswith("make_pod_combiner")
    ex = build_exchange(GroupSpec(**dict(kw, pods=0)), kind="streaming")
    assert ex.combiner.__qualname__.startswith("make_flat_combiner")


@pytest.mark.parametrize("kw,match", [
    (dict(topology="hierarchical", degree=2, pods=2, transport_loss=0.1),
     "transport faults"),
    (dict(topology="random_k", degree=2, resample_every=2,
          exchange_combiner="pod"), "static hierarchical"),
])
def test_pod_combiner_refusals(kw, match):
    spec_kw = dict(n_agents=4, knowledge_mode="streaming", **kw)
    with pytest.raises(ValueError, match=match) as ref_err:
        ref_build(RefSpec(**spec_kw), kind="streaming")
    with pytest.raises(ValueError, match=match) as port_err:
        build_exchange(GroupSpec(**spec_kw), kind="streaming")
    assert str(port_err.value) == str(ref_err.value)


# ---------------------------------------------------------------------
# the streaming train step with pods > 0 (no mesh)
# ---------------------------------------------------------------------
N, P, STEPS, LR = 8, 5, 6, 0.05


def _port_run(spec):
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.normal(size=(N, P)).astype(
        np.float32))}
    opt = optim.adamw(LR)
    ex = build_exchange(spec, kind="streaming")
    state = SD.TrainState(params=params, opt_state=opt.tree_init(params),
                          know=SD.init_knowledge(
                              params, rel=ex.streaming_rel_init("cpu")),
                          step=0)

    def loss_fn(p, b):
        return torch.mean((p["w"] - b["x"]) ** 2)
    step = SD.make_group_train_step(None, spec, opt, loss_fn=loss_fn,
                                    exchange=ex)
    data = np.random.default_rng(7)
    shared = 0
    for _ in range(STEPS):
        x = torch.from_numpy(data.normal(size=(N, P)).astype(np.float32))
        state, m = step(state, {"x": x})
        shared += m["shared"]
    return state, shared


def _ref_run(spec):
    rng = np.random.default_rng(0)
    params = {"w": jnp.asarray(rng.normal(size=(N, P)), jnp.float32)}
    opt = ref_optim.adamw(LR)
    ex = ref_build(spec, kind="streaming")
    state = RSD.TrainState(params=params,
                           opt_state=jax.vmap(opt.init)(params),
                           know=RSD.init_knowledge(
                               params, rel=ex.streaming_rel_init()),
                           step=jnp.zeros((), jnp.int32))

    def loss_fn(p, b):
        return jnp.mean((p["w"] - b["x"]) ** 2)
    step = jax.jit(RSD.make_group_train_step(None, spec, opt, loss_fn=loss_fn,
                                             exchange=ex))
    data = np.random.default_rng(7)
    for _ in range(STEPS):
        x = jnp.asarray(data.normal(size=(N, P)), jnp.float32)
        state, _ = step(state, {"x": x})
    return state


@pytest.mark.parametrize("extra", [dict(), dict(relevance_mode="grad_cos")],
                         ids=["uniform", "grad_cos"])
def test_train_step_pods_matches_flat_path_and_reference(extra):
    base = dict(n_agents=N, threshold=2, minibatch=2,
                knowledge_mode="streaming", topology="hierarchical",
                degree=4, **extra)
    s_flat, shared_flat = _port_run(GroupSpec(**base))
    s_pod, shared_pod = _port_run(GroupSpec(pods=2, **base))
    assert shared_flat == shared_pod >= 2
    np.testing.assert_allclose(_np(s_pod.params["w"]), _np(s_flat.params["w"]),
                               **TOL)
    ref = _ref_run(RefSpec(pods=2, **base))
    np.testing.assert_allclose(_np(s_pod.params["w"]),
                               np.asarray(ref.params["w"]), **TOL)
    if ref.know.rel is not None:
        np.testing.assert_allclose(_np(s_pod.know.rel),
                                   np.asarray(ref.know.rel), atol=1e-6)
