"""The ``(pod, data, model)`` mesh (agents over ``pod`` beside the model
axis) over ``torch.distributed``: the streaming trainer, its elastic
masks, the launcher's ``--mesh prod-multipod`` and prefill / decode on
meshes of spawned processes on the host (gloo, a ``FileStore`` in
``tmp_path``), held against the port's one-process paths and, for one
case, against the reference's ``make_group_train_step``. The workers
import only torch and the port; the reference runs in the test process.

Two spawns, started together, serve the file (module fixtures): two
ranks ((2, 1, 1)) and four ((2, 1, 2) and (2, 2, 1)); llama3.2-3b at
``reduced()``, fp32, 4 agents (2 a pod):

* The step with fed gradients (``tests/test_torch_tp_mesh.py``'s
  construction: a linear ``loss_fn`` whose gradient is a drawn tree,
  each data rank fed its share), five steps with share steps 2 and 4,
  in four cases: exact ``grad_cos`` (ring), ``grad_cos+sketch`` with
  int8 blocks of 128 that straddle the 64-column slices at m = 2 (ring),
  ``full`` + uniform, and the ``pod`` combiner (hierarchical, 2 pods of
  2), on all three meshes. Against the one-process port step with the
  (2, 2) test's gates: losses and step flags bitwise, the learned
  relevance within 1e-6, the window sketch within 1e-5 of the window's
  Σ|g| per row, parameters within rtol 1e-5 / atol 1e-6. The exact
  ``grad_cos`` case on (2, 1, 2) also against the reference's step on
  the same initial state and gradients (``tests/test_torch_streaming.
  py``'s gates: losses bitwise, relevance within 1e-6, parameters within
  1e-6).
* The step with the port's own model on (2, 1, 2), both estimator
  cases, with the (2, 2) test's own-model gates.
* Elastic: ``kill_agents`` / ``revive_agents`` with a global mask and
  the rank's ``AgentShard`` on (2, 1, 2): the agent a rank freezes is
  the one-process run's (a kill without the shard is refused there).
* The launcher: ``launch.mesh.production_shape`` patched to (2, 1, 2)
  inside the workers, ``--mesh prod-multipod`` with ``--ckpt-full``
  against ``--mesh cpu``'s file (its own model: the gates of
  ``test_launcher_prod_multipod``); ``--restore`` of that file on the
  same mesh continues as the one-process run does.
* Serving: ``prefill_on_mesh`` and 4 greedy ``decode_on_mesh`` steps on
  (2, 1, 2) (rows over ``("pod", "data")``): tokens equal to one
  process, logits within rtol 1e-5 / atol 1e-6.
"""
from __future__ import annotations

import contextlib
import io
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch.common.pytree import (tree_from_paths,  # noqa: E402
                                       tree_leaves_with_paths, tree_map)
from repro_torch.configs import get_arch_config  # noqa: E402
from repro_torch.configs.base import GroupSpec, ShapeConfig  # noqa: E402
from repro_torch.core import sharded_ddal as SD  # noqa: E402
from repro_torch.core.exchange import build_exchange  # noqa: E402
from repro_torch.data import (StreamSpec, make_data_batch,  # noqa: E402
                              make_group_batch)
from repro_torch.launch import shardings as SH  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh, train_rules  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

LLAMA = "llama3.2-3b"
AXES = ("pod", "data", "model")
B, S = 4, 16
N, STEPS, LR = 4, 5, 1e-3
CASES = {"grad_cos": dict(relevance_mode="grad_cos"),
         "sketch_int8": dict(exchange_estimator="grad_cos+sketch",
                             relevance_sketch_dim=16,
                             knowledge_quant_block=128),
         "full_uniform": dict(topology="full"),
         "pod": dict(topology="hierarchical", degree=2, pods=2)}
MESHES = {(2, 1, 1): "world2", (2, 1, 2): "world4", (2, 2, 1): "world4"}
OWN = ("grad_cos", "sketch_int8")
TOL = dict(rtol=1e-5, atol=1e-6)
KILL_AT, REVIVE_AT, VICTIM = 3, 4, 2
LAUNCH = ["--device", "cpu", "--agents", "4", "--batch", "2", "--seq", "16",
          "--threshold", "1", "--minibatch", "2", "--elastic",
          "--exchange", "topology=hierarchical", "--exchange", "degree=2",
          "--exchange", "pods=2", "--exchange", "estimator=grad_cos+sketch",
          "--exchange", "relevance_sketch_dim=16"]
LENS, SLOTS, DECODE = [9, 5, 12, 7], 24, 4


# ---------------------------------------------------------------------
# inputs, made the same way in the workers and in the test process
# ---------------------------------------------------------------------
def _cfg():
    return get_arch_config(LLAMA).reduced()


def _spec(kw, **more):
    base = dict(n_agents=N, threshold=2, minibatch=2,
                knowledge_mode="streaming", topology="ring")
    base.update(kw)
    base.update(more)
    return GroupSpec(**base)


def _flat(tree):
    return {"/".join(map(str, p)): x for p, x in tree_leaves_with_paths(tree)}


def _feed(cfg, t):
    """Step ``t``'s fed gradients (a tree of (N, *param) leaves) and
    losses (N,)."""
    rng = np.random.default_rng(100 + t)
    shapes = SH.full_shapes(get_model(cfg).init(cfg, None, "meta"))
    pairs = [(p, torch.from_numpy((rng.normal(size=(N,) + tuple(x.shape))
                                   * 1e-2).astype(np.float32)))
             for p, x in tree_leaves_with_paths(shapes)]
    return tree_from_paths(pairs), torch.from_numpy(
        rng.uniform(1, 2, N).astype(np.float32))


def _linear(p, b):
    pl, gl = ([x for _, x in tree_leaves_with_paths(t)] for t in (p, b["g"]))
    a = sum((x * y).sum() for x, y in zip(pl, gl))
    c = sum((x.detach() * y).sum() for x, y in zip(pl, gl))
    return b["loss"] + (a - c)


def _train(kw, fed, mesh=None, steps=STEPS, elastic=False):
    """(per step: losses, shared, the group's sketch, relevance, the
    window's Σ|g| per row; the final params, gathered) of the streaming
    trainer; on ``mesh`` the state is drawn sliced (``init_train_state(
    mesh=)``) and gathered at the end."""
    cfg = _cfg()
    spec = _spec(kw, elastic=elastic)
    opt = optim.adamw(LR)
    ex = build_exchange(spec, kind="streaming", mesh=mesh)
    shard = ex.shard
    if mesh is None:
        state = SD.init_train_state(cfg, spec, opt, seed=0, exchange=ex,
                                    device="cpu")
    else:
        like = SH.full_shapes(SD.init_train_state(
            cfg, spec, opt, seed=0, exchange=ex, device="meta"))
        specs = SH.state_placement_specs(cfg, mesh, ex.estimator.learns,
                                         ex.sketch_dim)
        state = SD.init_train_state(cfg, spec, opt, seed=0, exchange=ex,
                                    device="cpu", mesh=mesh)
        pspecs = SH.param_partition_specs(cfg, train_rules(mesh),
                                          ("pod",))
        d = mesh.size(1)
    step = SD.make_group_train_step(cfg, spec, opt, exchange=ex, mesh=mesh,
                                    loss_fn=_linear if fed else None)
    shape = ShapeConfig("t", S // 2, B, "train")
    trace, saved, refused = [], None, None
    for t in range(steps):
        if elastic and t == KILL_AT:
            saved = SD.clone_state(state)
            dead = torch.arange(N) == VICTIM
            if shard is not None:
                try:
                    SD.kill_agents(state, dead)
                except ValueError as exc:
                    refused = str(exc)
            state = SD.kill_agents(state, dead, shard=shard)
        if elastic and t == REVIVE_AT:
            state = SD.revive_agents(state, torch.arange(N) == VICTIM,
                                     saved, shard=shard)
        if fed:
            g, losses = _feed(cfg, t)
            if mesh is not None:
                g = tree_map(lambda x: x / d, SH.place(g, pspecs, mesh, cfg))
                losses = losses[shard.rows]
            batch = {"g": g, "loss": losses}
        elif mesh is None:
            batch = make_group_batch(cfg, shape, StreamSpec(seed=0), N, t,
                                     "cpu")
        else:
            batch = make_data_batch(cfg, shape, StreamSpec(seed=0), N, t,
                                    mesh, "cpu", rows=shard.rows)
        state, m = step(state, batch)
        k = state.know
        sk = k.sk
        if sk is not None and shard is not None:
            sk = shard.gather(sk)
        trace.append((m["loss"].numpy().copy(), m["shared"],
                      None if sk is None else sk.numpy().copy(),
                      None if k.rel is None else k.rel.numpy().copy(),
                      {p: v.abs().sum(1).numpy() for p, v in
                       _flat(tree_map(lambda x: x.reshape(x.shape[0], -1),
                                      k.rg)).items()}))
    if mesh is not None:
        state = SH.gather(state, specs, mesh, like, cfg)
    params = {p: v.numpy() for p, v in _flat(state.params).items()}
    return trace, params, refused


def _serve(mesh=None):
    """Prefill of ``LENS``' prompts into a ``SLOTS``-slot cache and
    ``DECODE`` greedy steps: the rank's rows' logits and tokens."""
    from repro_torch.launch import dryrun_lib as DL
    from repro_torch.serving import api
    cfg = _cfg()
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    toks = np.zeros((len(LENS), max(LENS)), np.int32)
    for i, n in enumerate(LENS):
        toks[i, :n] = rng.integers(1, cfg.vocab_size, n)
    batch = api.build_prefill_batch(cfg, torch.from_numpy(toks))
    shape = ShapeConfig("serve", SLOTS, len(LENS), "prefill")
    rows = slice(0, len(LENS))
    if mesh is not None:
        index, size = SH._coord(mesh, ("pod", "data"))
        n = len(LENS) // size
        rows = slice(index * n, (index + 1) * n)
    out = {"logits": [], "tokens": [], "rows": (rows.start, rows.stop)}
    with torch.no_grad():
        if mesh is None:
            logits, cache = model.forward(
                cfg, params, batch, model.make_cache(cfg, len(LENS), SLOTS,
                                                     "cpu"))
        else:
            logits, cache = DL.prefill_on_mesh(cfg, shape, mesh, params,
                                               batch)
        lens = torch.tensor(LENS)[rows]
        tok = logits[torch.arange(logits.shape[0]), lens - 1].argmax(-1)
        tok, pos = tok.to(torch.int32), lens.to(torch.int32)
        out["logits"].append(logits.numpy())
        out["tokens"].append(tok.numpy())
        for _ in range(DECODE):
            step = api.decode_batch(cfg, tok[:, None], pos[:, None])
            if mesh is None:
                logits, cache = model.decode(cfg, params, step, cache)
            else:
                logits, cache = DL.decode_on_mesh(cfg, shape, mesh, params,
                                                  step, cache)
            tok = logits[:, -1].argmax(-1).to(torch.int32)
            pos = pos + 1
            out["logits"].append(logits.numpy())
            out["tokens"].append(tok.numpy())
    return out


def _launch(argv):
    """``launch.train.main(argv)``: (its stdout, the step it ended at)."""
    from repro_torch.launch import train
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        out = train.main(argv)
    return text.getvalue(), int(out["state"].step)


# ---------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------
def _entry(rank, world, store, out_dir, name):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        out = globals()[name](rank, world, out_dir)
        torch.save(out, os.path.join(out_dir, f"{name}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, worlds, meanwhile, timeout=240.0):
    """Every ``{name: world size}`` spawn started at once; ``meanwhile()``
    runs in this process while they work; then they are joined:
    ({name: each rank's result}, what ``meanwhile`` returned)."""
    ctxs = {name: mp.spawn(_entry, args=(world,
                                         str(tmp_path / f"store_{name}"),
                                         str(tmp_path), name),
                           nprocs=world, join=False)
            for name, world in worlds.items()}
    try:
        here = meanwhile()
    except BaseException:
        for c in ctxs.values():
            for proc in c.processes:
                proc.kill()
        raise
    deadline = time.monotonic() + timeout
    for name, ctx in ctxs.items():
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for c in ctxs.values():
                    for proc in c.processes:
                        proc.kill()
                raise TimeoutError(f"{name}: workers still running after "
                                   f"{timeout} s")
    return {name: [torch.load(tmp_path / f"{name}_{r}.pt",
                              weights_only=False) for r in range(world)]
            for name, world in worlds.items()}, here


def _steps(shape):
    mesh = make_debug_mesh(shape, AXES, device_type="cpu")
    return {case: _train(kw, True, mesh) for case, kw in CASES.items()}


def world2(rank, world, out_dir):
    return {(2, 1, 1): _steps((2, 1, 1))}


def world4(rank, world, out_dir):
    from repro_torch.launch import mesh as M
    out = {shape: _steps(shape) for shape in ((2, 1, 2), (2, 2, 1))}
    mesh = make_debug_mesh((2, 1, 2), AXES, device_type="cpu")
    out["own"] = {case: _train(CASES[case], False, mesh) for case in OWN}
    out["elastic"] = _train(CASES["grad_cos"], True, mesh, elastic=True)
    out["serve"] = _serve(mesh)
    M.production_shape = lambda multi_pod=False: (
        ((2, 1, 2), AXES) if multi_pod else ((16, 16), ("data", "model")))
    f = {k: os.path.join(out_dir, f"{k}.npz") for k in ("mesh", "mesh2")}
    out["launch"] = _launch(LAUNCH + ["--mesh", "prod-multipod", "--steps",
                                      "4", "--ckpt-full", f["mesh"]])
    out["restore"] = _launch(LAUNCH + ["--mesh", "prod-multipod", "--steps",
                                       "2", "--restore", f["mesh"],
                                       "--ckpt-full", f["mesh2"]])
    return out


def _one_process(d):
    """The one-process runs the workers are held against, computed here
    while they work: the fed and own-model steps, the elastic run,
    serving and the launcher's two ``--mesh cpu`` files."""
    from repro_torch.launch import train
    want = {("fed", case): _train(kw, True) for case, kw in CASES.items()}
    want.update({("own", case): _train(CASES[case], False) for case in OWN})
    want["elastic"] = _train(CASES["grad_cos"], True, elastic=True)
    want["serve"] = _serve()
    with contextlib.redirect_stdout(io.StringIO()):
        train.main(LAUNCH + ["--steps", "4", "--ckpt-full",
                             str(d / "one.npz")])
    return want


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    d = tmp_path_factory.mktemp("multipod")
    out, want = _spawn(d, {"world2": 2, "world4": 4},
                       lambda: _one_process(d))
    out["dir"], out["want"] = d, want
    return out


# ---------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------
def _assert_step(got, want, exact=True):
    """The (2, 2) test's gates: fed gradients (``exact``) or the port's
    own model."""
    trace, params, _ = got
    want_trace, want_params, _ = want
    for t, (g, w) in enumerate(zip(trace, want_trace)):
        if exact:
            np.testing.assert_array_equal(g[0], w[0])
        else:
            np.testing.assert_allclose(g[0], w[0], rtol=1e-5, atol=1e-5)
        assert g[1] == w[1], t
        if w[3] is not None:
            np.testing.assert_allclose(g[3], w[3], atol=1e-6)
        if w[2] is not None:
            gate = 1e-5 * sum(w[4].values())[:, None]
            assert bool((np.abs(g[2] - w[2]) <= gate).all()), t
    if exact:
        for k, p in params.items():
            np.testing.assert_allclose(p, want_params[k], err_msg=k, **TOL)
        return 0, 0
    over = total = 0
    for k, p in params.items():
        d = np.abs(p - want_params[k])
        assert d.max() <= 0.5 * LR, (k, float(d.max()))
        over += int((d > 0.01 * LR).sum())
        total += d.size
    return over, total


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("shape", list(MESHES), ids=str)
def test_step_fed_gradients(spawned, shape, case):
    want = spawned["want"][("fed", case)]
    assert sum(t[1] for t in want[0]) == 2
    for res in spawned[MESHES[shape]]:
        _assert_step(res[shape][case], want)


@pytest.mark.parametrize("case", OWN)
def test_step_own_model(spawned, case):
    want = spawned["want"][("own", case)]
    over = total = 0
    for res in spawned["world4"]:
        o, n = _assert_step(res["own"][case], want, exact=False)
        over, total = over + o, total + n
    assert over <= 1e-3 * total, (over, total)


def test_step_matches_reference(spawned):
    """Exact ``grad_cos`` on (2, 1, 2) against the reference's
    ``make_group_train_step`` from the same initial state, fed the same
    gradients."""
    import jax
    import jax.numpy as jnp

    from repro import optim as ref_optim
    from repro.configs import get_arch_config as ref_arch
    from repro.configs.base import GroupSpec as RefSpec
    from repro.core import sharded_ddal as RSD
    from repro.core.exchange import build_exchange as ref_build
    cfg = _cfg()
    spec = _spec(CASES["grad_cos"])
    state = SD.init_train_state(cfg, spec, optim.adamw(LR), seed=0,
                                device="cpu")
    rcfg = ref_arch(LLAMA).reduced()
    rspec = RefSpec(**{f: getattr(spec, f) for f in (
        "n_agents", "threshold", "minibatch", "knowledge_mode", "topology",
        "relevance_mode")})
    rex = ref_build(rspec, kind="streaming")
    params = jax.tree.map(lambda x: jnp.asarray(x.numpy()), state.params)
    rstate = RSD.TrainState(
        params=params, opt_state=jax.vmap(ref_optim.adamw(LR).init)(params),
        know=RSD.init_knowledge(params, rel=rex.streaming_rel_init(),
                                sketch_dim=0),
        step=jnp.zeros((), jnp.int32))

    def linear(p, feed):
        def dot(a):
            return sum(jnp.vdot(x, y) for x, y in
                       zip(jax.tree.leaves(a), jax.tree.leaves(feed["g"])))
        return feed["loss"] + (dot(p) - dot(jax.lax.stop_gradient(p)))
    ref_step = jax.jit(RSD.make_group_train_step(
        rcfg, rspec, ref_optim.adamw(LR), loss_fn=linear))
    want = []
    for t in range(STEPS):
        g, losses = _feed(cfg, t)
        rstate, rm = ref_step(rstate, {
            "g": jax.tree.map(lambda x: jnp.asarray(x.numpy()), g),
            "loss": jnp.asarray(losses.numpy())})
        want.append((np.asarray(rm["loss"]), int(rm["shared"]),
                     np.asarray(rstate.know.rel)))
    ref_params = {"/".join(str(getattr(k, "key", k)) for k in path):
                  np.asarray(v) for path, v in
                  jax.tree_util.tree_leaves_with_path(rstate.params)}
    for res in spawned["world4"]:
        trace, got, _ = res[(2, 1, 2)]["grad_cos"]
        for t, (g, w) in enumerate(zip(trace, want)):
            np.testing.assert_array_equal(g[0], w[0])
            assert g[1] == w[1], t
            np.testing.assert_allclose(g[3], w[2], atol=1e-6)
        assert sorted(got) == sorted(ref_params)
        for k, p in got.items():
            np.testing.assert_allclose(p, ref_params[k], rtol=0, atol=1e-6,
                                       err_msg=k)


def test_elastic_rows_are_the_ranks_agents(spawned):
    """The victim (agent 2, pod 1) is frozen from step 3 and revived at
    step 4 on the ranks that hold it; the gathered run equals the
    one-process one, and a kill without the rank's shard is refused."""
    want = spawned["want"]["elastic"]
    for res in spawned["world4"]:
        got = res["elastic"]
        _assert_step(got, want)
        assert "pass the rank's AgentShard" in got[2]


def test_launcher_prod_multipod(spawned):
    """``--mesh prod-multipod`` on a (2, 1, 2) mesh: rank 0 prints the
    mesh line and its ``--ckpt-full`` file matches ``--mesh cpu``'s; a
    ``--restore`` of it there continues as the one-process run does.
    The launcher trains the port's own model, whose model-axis partial
    sums part from one process's by ulps: the parameters take the (2,
    2) test's own-model gates, the window and the AdamW moments agree
    to 1e-4 of their leaf's largest entry (2.2e-5 on the host), every
    other leaf (counts, masks, relevance, steps) within rtol 1e-5 /
    atol 1e-6."""
    from repro_torch.launch import train
    d = spawned["dir"]
    train.main(LAUNCH + ["--steps", "2", "--restore", str(d / "mesh.npz"),
                         "--ckpt-full", str(d / "one2.npz")])
    ranks = spawned["world4"]
    text, step = ranks[0]["launch"]
    assert ("pod x data x model = (2, 1, 2) over gloo: 2 agents a rank, 2 "
            "rows of each agent's batch and its model-axis slices") in text
    assert text.count("saved full TrainState") == 1
    assert all(r["launch"][0] == "" for r in ranks[1:])
    assert step == 4 and all(r["restore"][1] == 6 for r in ranks)
    for a, b in (("mesh", "one"), ("mesh2", "one2")):
        fa, fb = dict(np.load(d / f"{a}.npz")), dict(np.load(d / f"{b}.npz"))
        assert sorted(fa) == sorted(fb)
        over = total = 0
        for k in fa:
            if k.startswith(".params"):
                diff = np.abs(fa[k] - fb[k])
                assert diff.max() <= 0.5 * LR, (k, float(diff.max()))
                over += int((diff > 0.01 * LR).sum())
                total += diff.size
            elif k.startswith((".opt_state['m']", ".opt_state['v']",
                               ".know.tg", ".know.rg", ".know.sk")):
                np.testing.assert_allclose(
                    fa[k], fb[k], rtol=0,
                    atol=1e-4 * float(np.abs(fb[k]).max()), err_msg=k)
            else:
                np.testing.assert_allclose(fa[k], fb[k], err_msg=k, **TOL)
        assert over <= 1e-3 * total, (a, over, total)
    assert int(np.load(d / "mesh2.npz")[".step"]) == 6


def test_serving_on_the_multipod_mesh(spawned):
    want = spawned["want"]["serve"]
    seen = set()
    for res in spawned["world4"]:
        got = res["serve"]
        rows = slice(*got["rows"])
        seen.add(got["rows"])
        for g, w in zip(got["tokens"], want["tokens"]):
            np.testing.assert_array_equal(g, w[rows])
        for g, w in zip(got["logits"], want["logits"]):
            np.testing.assert_allclose(g, w[rows], **TOL)
    assert seen == {(0, 2), (2, 4)}


def test_rules_on_the_multipod_mesh_are_the_references():
    """``train_rules`` on the 2 x 16 x 16 ``(pod, data, model)`` mesh
    puts the agents over ``pod`` and the batch over ``data``;
    ``serve_rules`` spreads the batch over ``("pod", "data")`` where it
    divides: the reference's tables (read from a plain description of
    the mesh, here a ``MeshPoint``)."""
    from repro.launch import mesh as r_mesh
    from repro_torch.common.sharding import MeshPoint
    from repro_torch.launch.mesh import serve_rules
    mesh = MeshPoint(AXES, (2, 16, 16), (1, 3, 5))
    rules = train_rules(mesh)
    assert rules == r_mesh.train_rules(mesh)
    assert rules["agent"] == "pod" and rules["batch"] == "data"
    for batch, axes in ((64, ("pod", "data")), (48, None)):
        got = serve_rules(mesh, batch)
        assert got == r_mesh.serve_rules(mesh, batch)
        assert got["batch"] == axes and got["agent"] is None
