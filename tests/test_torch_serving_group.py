"""Port parity: multi-tenant group serving (``repro_torch.serving.group``,
``repro_torch.serving.metrics``) against ``repro.serving.group`` and
``repro.serving.metrics``, at llama3.2-3b and mamba2-780m ``reduced()``
(2 layers, fp32), both sides on the reference's stacked planes
(``jax.vmap`` of the reference's init, carried over by
``repro_torch.interop``), the same requests and greedy sampling.

Greedy tokens are held exactly; each decode step's logits of the live
slots at rtol = atol = 1e-4, the serving tolerance of the dense family
(``tests/test_torch_transformer_serving.py``): the port runs the slots'
products as one batched matmul over per-slot weights, the reference as
a vmap of B = 1 products, and both sum in other orders. Checkpoints
and the store's buffers are held bitwise.
"""
from __future__ import annotations

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serving as r_serving  # noqa: E402
from repro.configs import get_arch_config as r_get_arch_config  # noqa: E402
from repro.models import get_model as r_get_model  # noqa: E402
from repro_torch import interop, serving  # noqa: E402
from repro_torch.common.pytree import tree_map  # noqa: E402
from repro_torch.configs import get_arch_config  # noqa: E402
from repro_torch.configs.base import NotPortedError  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serving import group  # noqa: E402

PAD = 8
TOL = dict(rtol=1e-4, atol=1e-4)


def _ref_planes(rcfg, n_agents, seed=0):
    model = r_get_model(rcfg)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_agents)
    return jax.tree.map(np.asarray,
                        jax.vmap(lambda k: model.init(rcfg, k))(keys))


def _port(cfg, tree):
    return (interop.ssm_params if cfg.family == "ssm"
            else interop.transformer_params)(tree)


def _cfgs(arch):
    return r_get_arch_config(arch).reduced(), get_arch_config(arch).reduced()


def _requests(mod, n, n_agents):
    return [mod.GroupRequest(rid, rid % n_agents,
                             [(7 * rid + j) % 500 + 1
                              for j in range(2 + rid % 5)])
            for rid in range(n)]


def _alone(cfg, params, serve, prompt):
    """The port's fixed-batch engine on one prompt, padded to PAD."""
    toks = torch.zeros((1, PAD), dtype=torch.int32)
    toks[0, :len(prompt)] = torch.tensor(prompt, dtype=torch.int32)
    return serving.ServeEngine(cfg, params, serve).generate(
        toks, [len(prompt)])[0].tolist()


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-780m"])
def test_single_tenant_matches_serve_engine(arch):
    """One agent: the group engine's tokens equal the port's fixed-batch
    engine's and the reference group engine's."""
    rcfg, cfg = _cfgs(arch)
    planes = _ref_planes(rcfg, 1)
    serve_kw = dict(max_len=64, max_new_tokens=5)
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
    want = r_serving.GroupServeEngine(
        rcfg, jax.tree.map(jnp.asarray, planes),
        r_serving.ServeConfig(**serve_kw), batch_size=2,
        prompt_pad=PAD).run([r_serving.GroupRequest(i, 0, p)
                             for i, p in enumerate(prompts)])
    port = _port(cfg, planes)
    got = serving.GroupServeEngine(
        cfg, port, serving.ServeConfig(**serve_kw), batch_size=2,
        prompt_pad=PAD).run([serving.GroupRequest(i, 0, p)
                             for i, p in enumerate(prompts)])
    assert got == {k: [int(t) for t in v] for k, v in want.items()}
    params = tree_map(lambda t: t[0], port)
    for rid, pr in enumerate(prompts):
        assert got[rid] == _alone(cfg, params,
                                  serving.ServeConfig(**serve_kw), pr)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-780m"])
def test_four_agents_in_one_step_match_the_reference(arch):
    """Four tenants live in one batch, a second wave refilling the freed
    slots: every request's tokens equal the reference engine's, and
    every decode step's logits of the live slots agree within TOL (the
    reference's recorded from inside its jitted step, by a
    ``jax.debug.callback`` in its sampler)."""
    rcfg, cfg = _cfgs(arch)
    A = 4
    planes = _ref_planes(rcfg, A)
    serve_kw = dict(max_len=64, max_new_tokens=4)
    waves = [[[10 + a, 20 + a, 30 + a] for a in range(A)],
             [[30 + a, 20 + a, 10 + a, 5] for a in range(A)]]

    ref = r_serving.GroupServeEngine(
        rcfg, jax.tree.map(jnp.asarray, planes),
        r_serving.ServeConfig(**serve_kw), batch_size=A, prompt_pad=PAD)
    ref_steps = []
    greedy = ref.sampler

    def recording(logits, key=None):
        if logits.ndim == 2:                     # a decode step's (B, V)
            jax.debug.callback(lambda x: ref_steps.append(np.asarray(x)),
                               logits)
        return greedy(logits, key)

    ref.sampler = recording
    port = serving.GroupServeEngine(
        cfg, _port(cfg, planes), serving.ServeConfig(**serve_kw),
        batch_size=A, prompt_pad=PAD)
    port_steps, live = [], []
    decode = port.decode_step

    def recorded(planes_, batch, cache):
        live.append([i for i, s in enumerate(port._slots) if not s.done])
        logits, cache = decode(planes_, batch, cache)
        port_steps.append(logits[:, -1].numpy())
        return logits, cache

    port.decode_step = recorded
    for wave in range(2):
        base = wave * A
        for eng, mod in ((ref, r_serving), (port, serving)):
            for a in range(A):
                eng.submit(mod.GroupRequest(base + a, a, waves[wave][a]))
            eng.step()
            assert eng.live == A           # all four tenants in one batch
            eng.drain()
    assert port.results == {k: [int(t) for t in v]
                            for k, v in ref.results.items()}
    assert len(port_steps) == len(ref_steps) == 6
    for got, want, rows in zip(port_steps, ref_steps, live):
        np.testing.assert_allclose(got[rows], want[rows], **TOL)


def test_routing_determinism():
    """Same submission order → identical results, fifo and fair, and
    the reference's results."""
    rcfg, cfg = _cfgs("llama3.2-3b")
    planes = _ref_planes(rcfg, 3)
    serve_kw = dict(max_len=32, max_new_tokens=3)
    for policy in ("fifo", "fair"):
        want = r_serving.GroupServeEngine(
            rcfg, jax.tree.map(jnp.asarray, planes),
            r_serving.ServeConfig(**serve_kw), batch_size=2,
            prompt_pad=PAD, router=r_serving.Router(policy)).run(
                _requests(r_serving, 7, 3))
        eng = serving.GroupServeEngine(
            cfg, _port(cfg, planes), serving.ServeConfig(**serve_kw),
            batch_size=2, prompt_pad=PAD, router=serving.Router(policy))
        out1 = eng.run(_requests(serving, 7, 3))
        eng.reset()
        out2 = eng.run(_requests(serving, 7, 3))
        assert out1 == out2 == {k: [int(t) for t in v]
                                for k, v in want.items()}


@pytest.mark.parametrize("policy,agents", [
    ("fair", [0, 0, 0, 1, 2]), ("fifo", [0, 0, 1, 0]),
    ("fair", [2, 2, 1, 0, 1, 2])])
def test_routers_pop_in_the_reference_order(policy, agents):
    orders, depths = [], []
    for mod in (r_serving, serving):
        r = mod.Router(policy)
        for rid, aid in enumerate(agents):
            r.push(mod.GroupRequest(rid, aid, (1,)))
        depths.append([r.depth(a) for a in range(3)] + [len(r)])
        orders.append([r.pop().rid for _ in agents])
        assert r.pop() is None and len(r) == 0
    assert orders[0] == orders[1] and depths[0] == depths[1]
    if policy == "fair" and agents == [0, 0, 0, 1, 2]:
        assert orders[1] == [0, 3, 4, 1, 2]      # no starvation by agent 0
    with pytest.raises(ValueError, match="router policy"):
        serving.Router("lifo")


def test_agent_id_out_of_range_and_mesh():
    _, cfg = _cfgs("llama3.2-3b")
    planes = tree_map(lambda t: torch.stack([t, t]), get_model(cfg).init(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    serve = serving.ServeConfig(max_len=32, max_new_tokens=2)
    eng = serving.GroupServeEngine(cfg, planes, serve, batch_size=2,
                                   prompt_pad=PAD)
    with pytest.raises(ValueError, match="agent_id"):
        eng.submit(serving.GroupRequest(0, 2, [1, 2]))
    assert eng.run([]) == {}
    # not a device mesh: a bad argument; a (data, model) mesh: the
    # reference places group planes over its agent axes only
    with pytest.raises(ValueError, match="DeviceMesh"):
        serving.GroupServeEngine(cfg, planes, serve, batch_size=2,
                                 mesh=object())

    class _DataModelMesh:
        mesh_dim_names = ("data", "model")

        def get_group(self, axis=None):
            return None
    with pytest.raises(NotPortedError, match="agent axes"):
        serving.GroupServeEngine(cfg, planes, serve, batch_size=2,
                                 mesh=_DataModelMesh())


def test_param_store_double_buffer():
    """A publish never writes a buffer: what a reader acquired stays
    bitwise intact across two publishes; the planes given are copied,
    so a trainer's in-place update after ``publish`` does not reach the
    served planes; ``donate=True`` hands them over."""
    planes0 = {"w": torch.arange(4.0).reshape(2, 2)}
    store = serving.ParamStore(planes0)
    held, v0 = store.acquire()
    assert v0 == 0 and store.n_agents == 2
    planes0["w"].add_(100.0)                 # the caller's tensor moves on
    np.testing.assert_array_equal(held["w"].numpy(), [[0, 1], [2, 3]])
    trainer = {"w": torch.full((2, 2), 5.0)}
    assert store.publish(trainer) == 1
    trainer["w"].mul_(-1.0)                  # in-place update after publish
    live, v1 = store.acquire()
    assert v1 == 1
    np.testing.assert_array_equal(live["w"].numpy(), 5.0)
    assert store.publish({"w": torch.full((2, 2), 7.0)}) == 2
    np.testing.assert_array_equal(held["w"].numpy(), [[0, 1], [2, 3]])
    np.testing.assert_array_equal(live["w"].numpy(), 5.0)
    mine = {"w": torch.full((2, 2), 9.0)}
    assert store.publish(mine, donate=True) == 3
    assert store.acquire()[0]["w"] is mine["w"]
    assert store.version == 3


def test_hot_swap_mid_stream_matches_the_reference():
    """A publish mid-decode: the in-flight request runs to completion,
    the request admitted after it serves the new planes from its first
    prefill; tokens and the versions in the metrics equal the
    reference's."""
    rcfg, cfg = _cfgs("llama3.2-3b")
    planes = [_ref_planes(rcfg, 2, seed=s) for s in (0, 1)]
    serve_kw = dict(max_len=64, max_new_tokens=8)
    out, traces = [], []
    for mod, conv in ((r_serving, lambda p: jax.tree.map(jnp.asarray, p)),
                      (serving, lambda p: _port(cfg, p))):
        metrics = mod.ServeMetrics()
        store = mod.ParamStore(conv(planes[0]))
        eng = mod.GroupServeEngine(rcfg if mod is r_serving else cfg, store,
                                   mod.ServeConfig(**serve_kw), batch_size=2,
                                   prompt_pad=PAD, metrics=metrics)
        eng.submit(mod.GroupRequest(0, 0, [1, 2, 3]))
        for _ in range(3):
            eng.step()
        store.publish(conv(planes[1]))
        eng.submit(mod.GroupRequest(1, 1, [4, 5]))
        out.append({k: [int(t) for t in v] for k, v in eng.drain().items()})
        traces.append([metrics.traces[r].version for r in (0, 1)])
    assert out[1] == out[0] and len(out[1][0]) == 8
    assert traces[1] == traces[0] == [0, 1]
    fresh = serving.GroupServeEngine(cfg, _port(cfg, planes[1]),
                                     serving.ServeConfig(**serve_kw),
                                     batch_size=2, prompt_pad=PAD)
    assert out[1][1] == fresh.run([serving.GroupRequest(1, 1, [4, 5])])[1]


def test_checkpoints_cross_both_ways(tmp_path):
    """A store saved by either package loads in the other: planes
    bitwise, the version from ``__step__``."""
    rcfg, cfg = _cfgs("mamba2-780m")
    planes = _ref_planes(rcfg, 2)
    ref = r_serving.ParamStore(jax.tree.map(jnp.asarray, planes))
    ref.publish(jax.tree.map(lambda a: jnp.asarray(a) * 2, planes))
    ref.save(str(tmp_path / "ref.npz"))
    template = tree_map(lambda t: t.expand((2,) + tuple(t.shape)),
                        get_model(cfg).init(cfg, None, "meta"))
    port = serving.ParamStore.load(str(tmp_path / "ref.npz"), template,
                                   device="cpu")
    assert port.version == 1 and port.n_agents == 2
    for (pth, got), want in zip(
            interop.tree_leaves_with_paths(port.acquire()[0]),
            jax.tree.leaves(jax.tree.map(lambda a: a * 2, planes))):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(pth))
    port.publish(tree_map(lambda t: t + 1, port.acquire()[0]))
    port.save(str(tmp_path / "port.npz"))
    back = r_serving.ParamStore.load(
        str(tmp_path / "port.npz"),
        jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                     planes))
    assert back.version == 2
    for got, want in zip(jax.tree.leaves(back.acquire()[0]),
                         jax.tree.leaves(jax.tree.map(lambda a: a * 2 + 1,
                                                      planes))):
        np.testing.assert_array_equal(np.asarray(got), want)


def test_metrics_summary_with_fake_clock_equals_the_reference():
    """The reference test's fake-clock script on both sides: equal
    summaries and rows, and the reference test's numbers."""
    summaries, rows = [], []
    for mod in (r_serving, serving):
        t = [0.0]
        m = mod.ServeMetrics(clock=lambda: t[0])
        m.enqueue(0, agent_id=1)
        t[0] = 0.5
        m.admitted(0, version=3)
        m.first_token(0)
        t[0] = 2.5
        m.finish(0, n_tokens=4)
        m.enqueue(1, at=1.0)
        t[0] = 3.0
        m.admitted(1)
        m.first_token(1)
        t[0] = 5.0
        m.finish(1, n_tokens=4)
        m.observe_step(2, 1)
        m.observe_swap()
        summaries.append(m.summary())
        rows.append(m.rows())
    assert summaries[1] == summaries[0]
    assert rows[1] == rows[0]
    s = summaries[1]
    assert s["completed"] == 2 and s["tokens"] == 8
    assert s["span_s"] == pytest.approx(5.0)
    assert s["latency_p50"] == pytest.approx((2.5 + 4.0) / 2)
    assert s["per_agent_completed"] == {1: 1, 0: 1}
    assert np.isnan(serving.ServeMetrics().summary()["latency_p50"])


def test_publish_from_trainer_copies_a_stacked_tree():
    """The train→serve handoff of a stacked parameter nest (a state
    whose ``params`` carry the agent axis): published as a copy, served
    per agent. The streaming trainer's own handoff waits for Slice D
    (its ``TrainState`` is not ported)."""
    rcfg, cfg = _cfgs("llama3.2-3b")
    trained = _port(cfg, _ref_planes(rcfg, 2, seed=3))
    store = serving.ParamStore(_port(cfg, _ref_planes(rcfg, 2, seed=7)))
    state = types.SimpleNamespace(params=trained)
    assert serving.publish_from_trainer(store, state) == 1
    serve = serving.ServeConfig(max_len=32, max_new_tokens=3)
    want = [_alone(cfg, tree_map(lambda t: t[a], trained), serve, pr)
            for a, pr in ((0, [1, 2, 3]), (1, [4, 5]))]
    tree_map(lambda t: t.zero_(), trained)            # the trainer moves on
    out = serving.GroupServeEngine(cfg, store, serve, batch_size=2,
                                   prompt_pad=PAD).run(
        [serving.GroupRequest(0, 0, [1, 2, 3]),
         serving.GroupRequest(1, 1, [4, 5])])
    assert [out[0], out[1]] == want


def test_launcher_serves_group_and_restores_a_checkpoint(tmp_path, capsys):
    """``engine=group`` on the host, then ``--ckpt``: the restored
    version is printed and its planes are served."""
    argv = ["--device", "cpu", "--requests", "4", "--prompt-len", "9",
            "--serve", "engine=group", "--serve", "agents=2", "--serve",
            "max_new_tokens=3", "--serve", "router=fair"]
    report = launch.main(argv)
    cfg = get_arch_config("llama3.2-3b").reduced()
    planes = launch.agent_planes(cfg, 2, 0, "cpu")
    reqs = [serving.GroupRequest(i, i % 2, p)
            for i, p in enumerate(report["prompts"])]
    want = serving.GroupServeEngine(
        cfg, planes, serving.ServeConfig(max_len=128, max_new_tokens=3),
        batch_size=2, prompt_pad=16, router=serving.Router("fair")).run(reqs)
    assert report["outputs"] == [want[i] for i in range(4)]
    assert report["summary"]["completed"] == 4
    assert "p50=" in capsys.readouterr().out
    store = serving.ParamStore(tree_map(lambda t: t * 0.5, planes))
    for _ in range(3):
        store.publish(store.acquire()[0])
    store.save(str(tmp_path / "planes.npz"))
    report = launch.main(argv + ["--ckpt", str(tmp_path / "planes.npz")])
    assert report["version"] == 3
    assert f"restored planes v3 from {tmp_path / 'planes.npz'}" in \
        capsys.readouterr().out
    want = serving.GroupServeEngine(
        cfg, store, serving.ServeConfig(max_len=128, max_new_tokens=3),
        batch_size=2, prompt_pad=16, router=serving.Router("fair")).run(reqs)
    assert report["outputs"] == [want[i] for i in range(4)]


def test_store_template_of_numpy_and_meta_agree(tmp_path):
    """``ParamStore.load`` reads only shapes and dtypes of its template:
    numpy arrays and ``meta`` tensors restore the same planes."""
    store = serving.ParamStore({"a": {"w": torch.randn(2, 3, 4)},
                                "b": torch.arange(6.0).reshape(2, 3)})
    store.save(str(tmp_path / "s.npz"))
    meta = {"a": {"w": torch.empty(2, 3, 4, device="meta")},
            "b": torch.empty(2, 3, device="meta")}
    arrays = {"a": {"w": np.zeros((2, 3, 4), np.float32)},
              "b": np.zeros((2, 3), np.float32)}
    for template in (meta, arrays):
        got = serving.ParamStore.load(str(tmp_path / "s.npz"), template,
                                      device="cpu").acquire()[0]
        for (_, g), (_, w) in zip(group.tree_leaves_with_paths(got),
                                  group.tree_leaves_with_paths(
                                      store.acquire()[0])):
            assert torch.equal(g, w)
