"""Serving on the production meshes over ``torch.distributed``: prefill
and decode on ``(data, model)`` meshes of spawned processes on the host
(gloo, a ``FileStore`` in ``tmp_path``) through
``repro_torch.launch.dryrun_lib`` (the KV-slot sweep over ``model``, the
full logits from the vocab-parallel head, MLA split by head), and
``GroupServeEngine(mesh=)`` on a ``(pod, "agent")`` mesh, held against
the reference on one device and against the port's one-process paths.
The workers import only torch and the port; the reference runs in the
test process on the port's weights (seeded draws carried across as
numpy, the transformer's pytree being the reference's).

Two spawns, started together, serve the file (module fixtures): two
ranks ((1, 2) and (2, 1)) and four ((2, 2), (1, 4) and the (2, 2) pod
mesh); every model at ``reduced()`` in fp32:

* llama3.2-3b, qwen3-moe-30b-a3b and deepseek-v2-lite-16b: a prefill of
  4 right-padded prompts into a 24-slot cache and 4 greedy decode steps
  on each mesh. Logits within rtol = atol = 2e-4 of the reference's
  ``model.forward`` with a cache and ``model.decode`` (the serving
  tolerance of ``tests/test_torch_serving.py``) and of the port's
  one-process path within rtol 1e-5 / atol 1e-6 (llama) or within 1e-5
  relative or 1e-5 of the largest logit (the MoE pair: the MoE tests'
  gate, ``tests/test_torch_moe.py::close_out``; their expert outputs run
  to the hundreds at these widths and turn an ulp of the attention
  probabilities into ~5e-6 of a logit, at (2, 1) too, where only the
  sweep's exp / sum / divide differs from ``torch.softmax``); greedy
  tokens equal to both.
* Each rank's cache leaves at the shapes ``cache_partition_specs``
  names (rows over ``data``, slots over ``model``: T/m); the decode
  step's collectives, counted by site and by the numbers they carry,
  the same at ``max_len`` 24 and 48; a cache gathered by
  ``shardings.gather`` and placed back by ``dryrun_lib.place_cache``
  (24 and 23 slots); ``serving.api.prefill`` under ``serve_rules`` on
  (1, 2) and (2, 1).
* Edge cases: a sliding window of 8 (4 slots a rank, the ring wrapping
  while decoding); 23 slots at m = 2, which stay whole and lie on model
  rank 0; 2 kv heads at m = 4 (``wk`` / ``wv`` whole); a global batch
  of 3 on (2, 1), replicated; qwen3-moe's right-padded prefill past a
  10-slot cache split over 2 ranks, its writes past the cache dropped;
  qwen3-moe with ``moe_dispatch="dense"`` on its split experts.
* The cache-free pass's full logits on (1, 2) and (1, 4) against the
  reference; deepseek-v2-lite's loss and gradients on (1, 2) against
  ``jax.grad`` (``tests/test_torch_tp_mesh.py``'s gates).
* ``GroupServeEngine(mesh=)`` on the (2, 2) pod mesh, 8 agents of
  llama3.2-3b: tokens equal to the port's one-process engine and to the
  reference's ``GroupServeEngine`` on the same planes; each rank holds
  its 2 agents' rows; a publish from an agent-sharded trainer state
  issues no collective, and the engine then serves the trainer's
  planes.
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

from repro_torch import optim, serving  # noqa: E402
from repro_torch.common.pytree import (tree_leaves_with_paths,  # noqa: E402
                                       tree_map)
from repro_torch.configs import get_arch_config  # noqa: E402
from repro_torch.configs.base import GroupSpec, ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun_lib as DL  # noqa: E402
from repro_torch.launch import shardings as SH  # noqa: E402
from repro_torch.launch.mesh import (make_debug_mesh,  # noqa: E402
                                     make_pod_mesh, serve_rules)
from repro_torch.models import get_model  # noqa: E402
from test_torch_tp_mesh import _assert_matches_reference  # noqa: E402
from test_torch_tp_mesh import _batch as _train_batch  # noqa: E402
from test_torch_tp_mesh import _loss_grads  # noqa: E402

LLAMA, QWEN, DEEP = "llama3.2-3b", "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"
ARCHS = [LLAMA, QWEN, DEEP]
SHAPES = [(1, 2), (2, 1), (2, 2), (1, 4)]
REF_TOL = dict(rtol=2e-4, atol=2e-4)
LENS = [9, 5, 12, 7]
T, STEPS = 24, 4
N_AGENTS, PAD = 8, 8
GROUP_SERVE = dict(max_len=32, max_new_tokens=4)
# edge cases: (arch, cfg overrides, mesh shape, slots, prompt lengths,
# decode steps)
EDGES = {
    "window": (LLAMA, dict(sliding_window=8), (1, 2), T, [5, 3, 8, 6], 4),
    "whole_slots": (LLAMA, {}, (1, 2), 23, LENS, 4),
    "kv2": (LLAMA, dict(n_kv_heads=2), (1, 4), T, LENS, 4),
    "batch3": (LLAMA, {}, (2, 1), T, [9, 5, 12], 4),
    "moe_drop": (QWEN, {}, (1, 2), 10, [9, 5, 10, 7], 0),
    "moe_dense": (QWEN, dict(moe_dispatch="dense"), (1, 2), T, LENS, 4),
}


# ---------------------------------------------------------------------
# inputs, made the same way in the workers and in the test process
# ---------------------------------------------------------------------
def _cfg(arch, **kw):
    return get_arch_config(arch).reduced().with_(**kw)


def _params(cfg):
    return get_model(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu")


def _prompts(cfg, lens):
    """(B, max(lens)) right-padded ids drawn by numpy, seed 1."""
    rng = np.random.default_rng(1)
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, cfg.vocab_size, n)
    return toks


def _flat(tree):
    return {"/".join(map(str, p)): x for p, x in tree_leaves_with_paths(tree)}


def _rows_of(mesh, n_rows):
    """The rows the calling rank serves: its share over ``data`` where
    the global batch divides it, every row where it does not."""
    if mesh is None:
        return slice(0, n_rows)
    d = mesh.size(0)
    if n_rows % d:
        return slice(0, n_rows)
    r = mesh.get_local_rank("data")
    return slice(r * n_rows // d, (r + 1) * n_rows // d)


class _Traffic:
    """Counts the collectives of ``torch.distributed`` the code calls
    and the numbers they carry, while installed."""
    NAMES = ("all_reduce", "all_gather", "broadcast", "send", "recv",
             "all_to_all", "reduce_scatter_tensor", "all_gather_into_tensor")

    def __enter__(self):
        self.calls, self.numbers, self._saved = 0, 0, {}
        for name in self.NAMES:
            fn = getattr(dist, name, None)
            if fn is None:
                continue
            self._saved[name] = fn

            def counted(t, *a, _fn=fn, **kw):
                self.calls += 1
                self.numbers += sum(x.numel() for x in t) if isinstance(
                    t, list) else t.numel()
                return _fn(t, *a, **kw)
            setattr(dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(dist, name, fn)


def _serve(cfg, mesh, slots=T, lens=LENS, steps=STEPS):
    """Prefill of ``lens``' prompts into a ``slots``-slot cache, then
    ``steps`` greedy decode steps (on ``mesh`` through ``dryrun_lib``,
    else the one-process model): the rank's rows' logits per step, their
    tokens, the cache's leaf shapes and (mesh) the last decode step's
    collectives by site, calls and numbers carried."""
    from repro_torch.common.sharding import COLLECTIVES
    from repro_torch.serving import api
    model = get_model(cfg)
    params = _params(cfg)
    B = len(lens)
    rows = _rows_of(mesh, B)
    toks = torch.from_numpy(_prompts(cfg, lens))
    batch = api.build_prefill_batch(cfg, toks)
    shape = ShapeConfig("serve", slots, B, "prefill")
    out, traffic = {"logits": [], "tokens": []}, None
    with torch.no_grad():
        if mesh is None:
            logits, cache = model.forward(
                cfg, params, batch, model.make_cache(cfg, B, slots, "cpu"))
        else:
            logits, cache = DL.prefill_on_mesh(cfg, shape, mesh, params,
                                               batch)
        out["logits"].append(logits.numpy())
        lens_r = torch.tensor(lens)[rows]
        tok = logits[torch.arange(logits.shape[0]), lens_r - 1].argmax(-1)
        tok = tok.to(torch.int32)
        pos = lens_r.to(torch.int32)
        out["tokens"].append(tok.numpy())
        for _ in range(steps):
            step = api.decode_batch(cfg, tok[:, None], pos[:, None])
            if mesh is None:
                logits, cache = model.decode(cfg, params, step, cache)
            else:
                COLLECTIVES.clear()
                with _Traffic() as traffic:
                    logits, cache = DL.decode_on_mesh(cfg, shape, mesh,
                                                      params, step, cache)
                traffic = (dict(COLLECTIVES), traffic.calls, traffic.numbers)
            tok = logits[:, -1].argmax(-1).to(torch.int32)
            pos = pos + 1
            out["logits"].append(logits.numpy())
            out["tokens"].append(tok.numpy())
    out["rows"] = (rows.start, rows.stop)
    out["shapes"] = {k: tuple(v.shape) for k, v in _flat(cache).items()}
    out["cache"] = {k: v.numpy() for k, v in _flat(cache).items()}
    out["traffic"] = traffic
    return out


def _score(cfg, mesh):
    """The cache-free pass's logits over the 4 padded prompts (the rank's
    rows), under ``serve_rules`` on ``mesh``."""
    from repro_torch.common.sharding import axis_rules, set_mesh
    from repro_torch.serving import api
    toks = torch.from_numpy(_prompts(cfg, LENS))
    batch = api.build_prefill_batch(cfg, toks)
    shape = ShapeConfig("score", toks.shape[1], len(LENS), "prefill")
    params = DL.place_params(cfg, shape, mesh, _params(cfg))
    rows = _rows_of(mesh, len(LENS))
    batch = {k: v[rows] for k, v in batch.items()}
    with torch.no_grad(), set_mesh(mesh), axis_rules(
            serve_rules(mesh, len(LENS))):
        logits, _ = get_model(cfg).forward(cfg, params, batch, None)
    return logits.numpy()


def _api_prefill(cfg, mesh):
    """``serving.api.prefill`` of the rank's rows of the 4 padded prompts
    (tokens and lengths) under ``serve_rules`` on ``mesh`` (no mesh: all
    rows, one process): the next-token logits, their greedy tokens and
    the cache's leaf shapes."""
    from repro_torch.common.sharding import axis_rules, set_mesh
    from repro_torch.serving import api
    toks = torch.from_numpy(_prompts(cfg, LENS))
    model = get_model(cfg)
    rows = _rows_of(mesh, len(LENS))
    if mesh is None:
        with torch.no_grad():
            nl, cache = api.prefill(cfg, model, _params(cfg), toks, LENS, T)
    else:
        shape = ShapeConfig("serve", T, len(LENS), "prefill")
        params = DL.place_params(cfg, shape, mesh, _params(cfg))
        with torch.no_grad(), set_mesh(mesh), axis_rules(
                serve_rules(mesh, len(LENS))):
            nl, cache = api.prefill(cfg, model, params, toks[rows],
                                    LENS[rows], T)
    return dict(logits=nl.numpy(), tokens=api.Sampler()(nl).numpy(),
                rows=(rows.start, rows.stop),
                shapes={k: tuple(v.shape) for k, v in _flat(cache).items()})


def _cache_roundtrip(mesh, slots):
    """A prefill on ``mesh`` into ``slots`` slots, its cache gathered
    (``shardings.gather``) and the gathered cache placed again
    (``dryrun_lib.place_cache``): (the gathered cache, whether the
    placed one equals the rank's cache leaf by leaf)."""
    cfg = _cfg(LLAMA)
    shape = ShapeConfig("serve", slots, len(LENS), "prefill")
    from repro_torch.serving import api
    batch = api.build_prefill_batch(cfg, torch.from_numpy(
        _prompts(cfg, LENS)))
    with torch.no_grad():
        _, cache = DL.prefill_on_mesh(cfg, shape, mesh, _params(cfg),
                                      batch)
    rules = serve_rules(mesh, len(LENS))
    full = get_model(cfg).make_cache(cfg, len(LENS), slots, "meta")
    specs = SH.cache_partition_specs(cfg, shape, rules["batch"],
                                     slots_axis=rules["kv_slots"])
    gathered = SH.gather(cache, specs, mesh, full, cfg)
    placed = DL.place_cache(cfg, shape, mesh, gathered)
    same = all(torch.equal(a, b) for a, b in zip(
        _flat(placed).values(), _flat(cache).values()))
    return {k: v.numpy() for k, v in _flat(gathered).items()}, same


def _planes(cfg):
    """8 agents' stacked planes: agent a drawn from seed a."""
    draws = [get_model(cfg).init(cfg, torch.Generator().manual_seed(a),
                                 "cpu") for a in range(N_AGENTS)]
    return tree_map(lambda *ts: torch.stack(ts), *draws)


def _requests():
    return [serving.GroupRequest(rid, rid % N_AGENTS,
                                 [(7 * rid + j) % 500 + 1
                                  for j in range(2 + rid % 5)])
            for rid in range(10)]


def _trainer_state(cfg):
    """A streaming trainer's state of the 8 agents (seed 0)."""
    from repro_torch.core import sharded_ddal as SD
    from repro_torch.core.exchange import build_exchange
    spec = GroupSpec(n_agents=N_AGENTS, knowledge_mode="streaming")
    ex = build_exchange(spec, kind="streaming")
    return SD.init_train_state(cfg, spec, optim.adamw(1e-3), seed=0,
                               exchange=ex, device="cpu")


def _group(mesh, path):
    """``GroupServeEngine(mesh=)`` on the pod mesh: its results, the
    rank's planes, the store saved to ``path`` (every rank's rows), a
    publish from the agent-sharded trainer state and the results served
    after it."""
    from repro_torch.common.sharding import COLLECTIVES
    cfg = _cfg(LLAMA)
    planes = _planes(cfg)
    eng = serving.GroupServeEngine(cfg, planes,
                                   serving.ServeConfig(**GROUP_SERVE),
                                   batch_size=4, prompt_pad=PAD, mesh=mesh)
    COLLECTIVES.clear()
    results = eng.run(_requests())
    held = {k: v.numpy() for k, v in _flat(eng.store.acquire()[0]).items()}
    counts = dict(COLLECTIVES)
    eng.store.save(path)
    state = SH.agent_sharded_state(_trainer_state(cfg), mesh)
    with _Traffic() as traffic:
        version = serving.publish_from_trainer(eng.store, state)
    moved = traffic.calls
    live = {k: v.numpy() for k, v in _flat(eng.store.acquire()[0]).items()}
    mine = {k: v.numpy() for k, v in _flat(state.params).items()}
    eng.reset()
    after = eng.run(_requests())
    return dict(results=results, held=held, counts=counts, moved=moved,
                version=version, live=live, mine=mine, after=after,
                n_agents=eng.n_agents)


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
    """Every ``{name: world size}`` spawn started at once, ``meanwhile()``
    run in this process, then the spawns joined: {name: each rank's
    result}."""
    ctxs = {name: mp.spawn(_entry, args=(world,
                                         str(tmp_path / f"store_{name}"),
                                         str(tmp_path), name),
                           nprocs=world, join=False)
            for name, world in worlds.items()}
    meanwhile()
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
            for name, world in worlds.items()}


def _edges(shapes):
    out = {}
    for case, (arch, kw, shape, slots, lens, steps) in EDGES.items():
        if shape in shapes:
            mesh = make_debug_mesh(shape, device_type="cpu")
            out[case] = _serve(_cfg(arch, **kw), mesh, slots, lens, steps)
    return out


def world2(rank, world, out_dir):
    out = {"serve": {}, "score": {}}
    for shape in ((1, 2), (2, 1)):
        mesh = make_debug_mesh(shape, device_type="cpu")
        for arch in ARCHS:
            out["serve"][arch, shape] = _serve(_cfg(arch), mesh)
    mesh = make_debug_mesh((1, 2), device_type="cpu")
    for arch in ARCHS:
        out["serve_2t", arch] = _serve(_cfg(arch), mesh, 2 * T, steps=1)
        out["score"][arch, (1, 2)] = _score(_cfg(arch), mesh)
    out["edges"] = _edges(((1, 2), (2, 1)))
    for slots in (T, 23):
        out["roundtrip", slots] = _cache_roundtrip(mesh, slots)
    for shape in ((1, 2), (2, 1)):
        out["api", shape] = _api_prefill(
            _cfg(LLAMA), make_debug_mesh(shape, device_type="cpu"))
    out["deep_grads"] = _loss_grads(_cfg(DEEP), mesh)
    return out


def world4(rank, world, out_dir):
    out = {"serve": {}, "score": {}}
    for shape in ((2, 2), (1, 4)):
        mesh = make_debug_mesh(shape, device_type="cpu")
        for arch in ARCHS:
            out["serve"][arch, shape] = _serve(_cfg(arch), mesh)
    mesh = make_debug_mesh((1, 4), device_type="cpu")
    for arch in ARCHS:
        out["score"][arch, (1, 4)] = _score(_cfg(arch), mesh)
    out["edges"] = _edges(((1, 4),))
    out["group"] = _group(make_pod_mesh(2, device_type="cpu"),
                          os.path.join(out_dir, "planes.npz"))
    return out


_SPAWN_DIR: list = []


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    _SPAWN_DIR[:] = [tmp_path_factory.mktemp("serve_mesh")]
    return _spawn(_SPAWN_DIR[0], {"world2": 2, "world4": 4}, _references)


def _ranks(spawned, shape):
    return spawned["world2" if shape[0] * shape[1] == 2 else "world4"]


# ---------------------------------------------------------------------
# the reference and the one-process port, in the test process
# ---------------------------------------------------------------------
def _jax_params(cfg):
    import jax.numpy as jnp
    return tree_map(lambda x: jnp.asarray(x.numpy()), _params(cfg))


def _rcfg(arch, **kw):
    from repro.configs import get_arch_config as r_arch
    rcfg = r_arch(arch).reduced().with_(**kw)
    return rcfg.with_(moe_dispatch="dense") if rcfg.moe is not None else rcfg


_MEMO: dict = {}


def _memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def _ref_serve(arch, kw, slots=T, lens=LENS, steps=STEPS):
    """The reference's prefill with a cache and greedy decode steps on
    one device: (per-step logits, tokens, the cache as numpy)."""
    def run():
        import jax
        import jax.numpy as jnp

        from repro.models import get_model as r_model
        from repro.serving import api as r_api
        rcfg = _rcfg(arch, **kw)
        model = r_model(rcfg)
        forward = jax.jit(model.forward, static_argnums=0)
        decode = jax.jit(model.decode, static_argnums=0)
        params = _jax_params(_cfg(arch, **kw))
        toks = jnp.asarray(_prompts(rcfg, lens))
        cache = model.make_cache(rcfg, len(lens), slots)
        logits, cache = forward(
            rcfg, params, r_api.build_prefill_batch(rcfg, toks), cache)
        out_l, out_t = [np.asarray(logits)], []
        tok = np.asarray(logits)[np.arange(len(lens)),
                                 np.asarray(lens) - 1].argmax(-1)
        pos = np.asarray(lens, np.int32)
        out_t.append(tok)
        for _ in range(steps):
            step = {"tokens": jnp.asarray(tok[:, None].astype(np.int32)),
                    "positions": jnp.asarray(pos[:, None])}
            logits, cache = decode(rcfg, params, step, cache)
            tok = np.asarray(logits)[:, -1].argmax(-1)
            pos = pos + 1
            out_l.append(np.asarray(logits))
            out_t.append(tok)
        flat = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
                for p, v in jax.tree_util.tree_leaves_with_path(cache)}
        return out_l, out_t, flat
    return _memo(("ref", arch, tuple(sorted(kw.items())), slots,
                  tuple(lens), steps), run)


def _ref_score(arch):
    """The reference's cache-free logits over the 4 padded prompts."""
    def run():
        import jax
        import jax.numpy as jnp

        from repro.models import get_model as r_model
        from repro.serving import api as r_api
        rcfg = _rcfg(arch)
        batch = r_api.build_prefill_batch(
            rcfg, jnp.asarray(_prompts(rcfg, LENS)))
        logits, _ = jax.jit(r_model(rcfg).forward, static_argnums=0)(
            rcfg, _jax_params(_cfg(arch)), batch, None)
        return np.asarray(logits)
    return _memo(("score", arch), run)


def _ref_grads(arch):
    """(loss, {path: gradient}) of the reference's jitted
    ``jax.value_and_grad`` of its loss on ``tests/test_torch_tp_mesh.py``'s
    batch and the port's weights (its dense dispatch)."""
    def run():
        import jax
        import jax.numpy as jnp

        from repro.models import get_model as r_model
        rcfg = _rcfg(arch)
        batch = {k: jnp.asarray(v)
                 for k, v in _train_batch(_cfg(arch)).items()}
        model = r_model(rcfg)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: model.loss(rcfg, p, batch)))(_jax_params(_cfg(arch)))
        flat = {"/".join(str(getattr(k, "key", k)) for k in path):
                np.asarray(v)
                for path, v in jax.tree_util.tree_leaves_with_path(grads)}
        return float(loss), flat
    return _memo(("grads", arch), run)


def _references():
    """Every reference and one-process result the tests read, computed
    while the workers run."""
    for arch in ARCHS:
        _ref_serve(arch, {})
        _port_serve(arch, {})
        _ref_score(arch)
    for arch, kw, _, slots, lens, steps in EDGES.values():
        _ref_serve(arch, kw, slots, lens, steps)
        _port_serve(arch, kw, slots, lens, steps)
    _ref_grads(DEEP)
    _memo("api", lambda: _api_prefill(_cfg(LLAMA), None))
    for slots in (T, 23):
        _port_serve(LLAMA, {}, slots, LENS, 0)
    planes = _planes(_cfg(LLAMA))
    _memo("group_port", lambda: _one_process_group(planes))
    _memo("group_ref", lambda: _ref_group_tokens(planes))
    _memo("group_trainer", lambda: _one_process_group(
        _trainer_state(_cfg(LLAMA)).params))


def _port_serve(arch, kw, slots=T, lens=LENS, steps=STEPS):
    return _memo(("port", arch, tuple(sorted(kw.items())), slots,
                  tuple(lens), steps),
                 lambda: _serve(_cfg(arch, **kw), None, slots, lens, steps))


def _one_process_gate(arch, got, want):
    """rtol 1e-5 / atol 1e-6 (llama); the MoE pair within 1e-5 relative
    or 1e-5 of the largest logit (module docstring)."""
    atol = 1e-6 if arch == LLAMA else 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def _check_serve(arch, kw, res, slots=T, lens=LENS, steps=STEPS):
    """A rank's run against the reference and the one-process port: the
    logits of the rank's rows at every step, the greedy tokens."""
    rows = slice(*res["rows"])
    ref_l, ref_t, _ = _ref_serve(arch, kw, slots, lens, steps)
    port = _port_serve(arch, kw, slots, lens, steps)
    for t, got in enumerate(res["logits"]):
        np.testing.assert_allclose(got, ref_l[t][rows], err_msg=f"step {t}",
                                   **REF_TOL)
        _one_process_gate(arch, got, port["logits"][t][rows])
        np.testing.assert_array_equal(res["tokens"][t], ref_t[t][rows])
        np.testing.assert_array_equal(res["tokens"][t],
                                      port["tokens"][t][rows])


def _want_shapes(arch, kw, shape, slots, B):
    """Each cache leaf's shape on a rank of a ``shape`` (data, model)
    mesh, by ``cache_partition_specs`` under ``serve_rules``: a dim over
    an axis that divides it is cut by the axis's size, else whole."""
    cfg = _cfg(arch, **kw)
    sizes = {"data": shape[0], "model": shape[1]}
    rules = serve_rules(type("M", (), {"axis_names": ("data", "model"),
                                       "shape": sizes})(), B)
    cshape = ShapeConfig("c", slots, B, "decode")
    specs = {"/".join(p): spec for p, spec in SH._dict_leaves(
        SH.cache_partition_specs(cfg, cshape, rules["batch"],
                                 slots_axis=rules["kv_slots"]))}
    full = _flat(get_model(cfg).make_cache(cfg, B, slots, "meta"))
    out = {}
    for k, x in full.items():
        out[k] = tuple(n // sizes[a] if a is not None and n % sizes[a] == 0
                       else n for n, a in zip(x.shape, specs[k]))
    return out


# ---------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_and_one_process(
        spawned, arch, shape):
    for res in _ranks(spawned, shape):
        _check_serve(arch, {}, res["serve"][arch, shape])


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_slices_have_the_placed_shapes(spawned, arch, shape):
    """Every rank's cache leaves at ``cache_partition_specs``' shapes: a
    split slot dim holds T/m slots, never the whole T."""
    want = _want_shapes(arch, {}, shape, T, len(LENS))
    for res in _ranks(spawned, shape):
        got = res["serve"][arch, shape]["shapes"]
        assert got == want
        for k, s in got.items():
            if k.endswith(("/k", "/v", "/pos", "/ckv", "/k_rope")):
                assert s[2] == T // shape[1], (k, s)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_collectives_do_not_grow_with_max_len(spawned, arch):
    """One decode step at (1, 2): the same collectives, calls and numbers
    carried at 24 and at 48 slots; one ``kv_max`` and one ``kv_sum`` a
    layer."""
    cfg = _cfg(arch)
    for res in spawned["world2"]:
        at_t = res["serve"][arch, (1, 2)]["traffic"]
        at_2t = res["serve_2t", arch]["traffic"]
        assert at_t == at_2t
        sites = at_t[0]
        assert sites["kv_max"] == sites["kv_sum"] == cfg.n_layers
        assert sites["attn_out"] == cfg.n_layers and sites["logits"] == 1


@pytest.mark.parametrize("case", list(EDGES))
def test_edge_cases(spawned, case):
    """The window's ring, a slot count that stays whole, whole kv
    projections, a replicated batch of 3, MoE writes dropped past a
    split cache, the dense dispatch on split experts: against the reference and the one-process port, the
    cache at its placed shapes; the whole-slot cache on model rank 0
    (the other rank's copy empty); the split MoE cache, gathered, equal
    to the reference's."""
    arch, kw, shape, slots, lens, steps = EDGES[case]
    want = _want_shapes(arch, kw, shape, slots, len(lens))
    for res in _ranks(spawned, shape):
        got = res["edges"][case]
        _check_serve(arch, kw, got, slots, lens, steps)
        assert got["shapes"] == want
    ranks = [r["edges"][case] for r in _ranks(spawned, shape)]
    if case == "whole_slots":
        assert (ranks[0]["cache"]["layers/kv/pos"] >= 0).any()
        assert (ranks[1]["cache"]["layers/kv/pos"] == -1).all()
    if case == "batch3":
        assert all(r["rows"] == (0, 3) for r in ranks)
    if case == "moe_drop":
        _, _, ref_cache = _ref_serve(arch, kw, slots, lens, steps)
        for k, want_leaf in ref_cache.items():
            got_leaf = np.concatenate([r["cache"][k] for r in ranks], axis=2)
            if k.endswith("pos"):
                np.testing.assert_array_equal(got_leaf, want_leaf)
            else:
                np.testing.assert_allclose(got_leaf, want_leaf, **REF_TOL)
        assert ranks[1]["cache"]["layers/kv/pos"].max() == slots - 1


@pytest.mark.parametrize("slots", [T, 23])
def test_gather_and_place_a_cache(spawned, slots):
    """A (1, 2) prefill's cache gathered by ``shardings.gather`` is the
    one-process prefill's (split slots concatenated; whole slots model
    rank 0's: positions bitwise, keys and values within 1e-5 relative or
    1e-5 of the largest), and ``place_cache`` of it gives each rank its
    cache back, bitwise (the whole dim's copy empty on rank 1)."""
    want = _port_serve(LLAMA, {}, slots, LENS, 0)["cache"]
    for res in spawned["world2"]:
        got, same = res["roundtrip", slots]
        assert same
        for k, v in want.items():
            if k.endswith("pos"):
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:      # layer 1's keys carry layer 0's sweep rounding
                np.testing.assert_allclose(
                    got[k], v, rtol=1e-5, atol=1e-5 * np.abs(v).max(),
                    err_msg=k)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)], ids=str)
def test_api_prefill_on_a_mesh_selects_rows_of_the_full_logits(
        spawned, shape):
    """``serving.api.prefill`` under ``serve_rules``: the rank's rows (its
    share over ``data``), a cache of the global batch's slice, the
    ``lengths − 1`` rows of the full logits and their greedy tokens as
    the one-process prefill's rows."""
    want = _memo("api", lambda: _api_prefill(_cfg(LLAMA), None))
    B = len(LENS)
    for res in spawned["world2"]:
        got = res["api", shape]
        rows = slice(*got["rows"])
        _one_process_gate(LLAMA, got["logits"], want["logits"][rows])
        np.testing.assert_array_equal(got["tokens"], want["tokens"][rows])
        assert got["shapes"]["layers/kv/k"][1:3] == (
            B // shape[0], T // shape[1])


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_free_full_logits_match_reference(spawned, arch, shape):
    """``transformer_forward`` on a model axis: the full rows of logits
    on every rank (flash on the rank's heads), against the reference's
    cache-free pass."""
    want = _ref_score(arch)
    for res in _ranks(spawned, shape):
        got = res["score"][arch, shape]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **REF_TOL)


def test_mla_loss_and_grads_on_the_model_axis(spawned):
    """deepseek-v2-lite (MLA split by head, its experts over ``model``,
    ``layer0`` dense) trains on (1, 2): loss and gradients against the
    reference's ``jax.grad`` at ``tests/test_torch_tp_mesh.py``'s gates."""
    want = _ref_grads(DEEP)
    for res in spawned["world2"]:
        _assert_matches_reference(res["deep_grads"], want)


def _ref_group_tokens(planes):
    import jax
    import jax.numpy as jnp

    from repro import serving as r_serving
    rcfg = _rcfg(LLAMA)
    eng = r_serving.GroupServeEngine(
        rcfg, jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(),
                                                 planes)),
        r_serving.ServeConfig(**GROUP_SERVE), batch_size=4, prompt_pad=PAD)
    out = eng.run([r_serving.GroupRequest(r.rid, r.agent_id, list(r.prompt))
                   for r in _requests()])
    return {k: [int(t) for t in v] for k, v in out.items()}


def _one_process_group(planes):
    cfg = _cfg(LLAMA)
    return serving.GroupServeEngine(
        cfg, planes, serving.ServeConfig(**GROUP_SERVE), batch_size=4,
        prompt_pad=PAD).run(_requests())


def test_group_engine_on_a_pod_mesh_matches_one_process_and_reference(
        spawned):
    want = _MEMO["group_port"]
    assert want == _MEMO["group_ref"]
    for res in spawned["world4"]:
        assert res["group"]["results"] == want
        assert res["group"]["n_agents"] == N_AGENTS
        assert res["group"]["counts"]["plane_rows"] > 0


def test_group_engine_ranks_hold_their_agents_rows(spawned):
    """Rank (p, a) of the 2 x 2 pod mesh holds agents 2·(2p + a) and
    2·(2p + a) + 1 of every plane, bitwise; the store's checkpoint holds
    every agent's (the ranks' rows gathered, written once)."""
    from repro_torch.serving import ParamStore
    planes = _planes(_cfg(LLAMA))
    full = {k: v.numpy() for k, v in _flat(planes).items()}
    saved = ParamStore.load(str(_SPAWN_DIR[0] / "planes.npz"),
                            SH.full_shapes(planes), device="cpu")
    for k, v in _flat(saved.acquire()[0]).items():
        np.testing.assert_array_equal(v.numpy(), full[k], err_msg=k)
    block = N_AGENTS // 4
    for rank, res in enumerate(spawned["world4"]):
        held = res["group"]["held"]
        assert sorted(held) == sorted(full)
        for k, v in held.items():
            np.testing.assert_array_equal(
                v, full[k][rank * block:(rank + 1) * block], err_msg=k)


def test_group_engine_publish_from_a_sharded_trainer_moves_no_plane(
        spawned):
    """``publish_from_trainer`` with an agent-sharded ``TrainState``: no
    collective; each rank's live planes are its trainer rows; the engine
    then serves the trainer's planes, as the one-process engine does."""
    want = _MEMO["group_trainer"]
    for res in spawned["world4"]:
        grp = res["group"]
        assert grp["moved"] == 0 and grp["version"] == 1
        for k, v in grp["live"].items():
            np.testing.assert_array_equal(v, grp["mine"][k], err_msg=k)
        assert grp["after"] == want
