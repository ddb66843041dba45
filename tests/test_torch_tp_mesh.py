"""The model axis over ``torch.distributed`` (tensor parallelism): the
dense and MoE transformers and the streaming trainer on ``(data,
model)`` meshes of spawned processes on the host (gloo, a ``FileStore``
in ``tmp_path``), held against the reference and against the port's
one-process paths. The workers import only torch and the port; the
reference runs in the test process.

Two spawns, started together, serve the file (module fixtures): two
ranks ((1, 2) and (2, 1)) and four ((2, 2) and (1, 4)); and a one-rank
group in the test process ((1, 1)); every case at ``reduced()``:

* llama3.2-3b: ``model.loss`` and its gradients (the rank's slices
  gathered, summed over ``data``) against the reference's ``model.loss``
  / ``jax.grad`` on the same weights, rtol 1e-5 and rtol 3e-4 / atol
  3e-5, at (1, 2), (2, 1) and (2, 2); with 2 kv heads at (1, 4), where
  the placement keeps ``wk`` / ``wv`` whole and each rank takes the kv
  head its query head reads (a wrong backward collective would show as
  an m-fold gradient there).
* qwen3-moe-30b-a3b: the expert-parallel dispatch at m = 2 and 4, and
  ``moe_dispatch="dense"`` on split experts at m = 2, against the
  reference's dense dispatch with ``tests/test_moe_dispatch.py``'s
  tolerances (loss rtol 1e-5; gradients rtol 3e-4 / atol 3e-5); one
  ``moe_combine`` all-reduce per MoE layer in the forward.
* The streaming step on (2, 2), 4 agents, ring, two share steps, as
  ``tests/test_torch_streaming.py`` holds the trainer: (A) fed gradients
  (a linear ``loss_fn`` whose gradient is a drawn tree, each data rank
  fed half), exact ``grad_cos`` and ``grad_cos+sketch`` with int8
  planes (blocks of 128 straddle the ranks' 64-column slices at these
  widths), against the one-process step: losses and step flags
  bitwise, the learned relevance within 1e-6, the window sketch within
  1e-5 of the window's Σ|g| per row (partial sums over the model axis
  change the order of the adds), parameters within rtol 1e-5 / atol
  1e-6; (B) the port's own model, in both cases: losses within rtol
  1e-5 / atol 1e-5, step flags, relevance and sketch rows as in (A),
  parameters within lr / 2 each and within lr / 100 but for at most
  1e-3 of the elements (AdamW's first steps divide g by |g| + eps, so
  an element whose gradient is near eps, or whose int8 code sits at a
  rounding edge, moves by a share of lr on an ulp-level difference of
  the model-axis partial sums).
* (1, 1): mamba2-780m and llama3.2-3b, loss, gradients and three steps
  of the trainer (``grad_cos+sketch``) equal to their runs with no mesh.
* (1, 2): llama with 6 query heads over 3 kv heads (a rank's query
  heads read kv heads 0, 0, 1); the ssm, hybrid, VLM and audio families
  no longer refuse the model axis: their trainer step builds and (the
  transformer families) their loss runs, with no ``NotPortedError``.
  (MLA and the full logits on the axis:
  ``tests/test_torch_serve_mesh.py``; those four families against the
  reference: ``tests/test_torch_family_mesh.py``.)
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
from repro_torch.common.pytree import (tree_from_paths,  # noqa: E402
                                       tree_leaves_with_paths, tree_map)
from repro_torch.configs import get_arch_config  # noqa: E402
from repro_torch.configs.base import GroupSpec, NotPortedError  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import sharded_ddal as SD  # noqa: E402
from repro_torch.core.exchange import build_exchange  # noqa: E402
from repro_torch.data import (StreamSpec, make_data_batch,  # noqa: E402
                              make_group_batch)
from repro_torch.launch import shardings as SH  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh, train_rules  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

LLAMA, QWEN, MAMBA = "llama3.2-3b", "qwen3-moe-30b-a3b", "mamba2-780m"
LOSS_TOL = dict(rtol=1e-5)
GRAD_TOL = dict(rtol=3e-4, atol=3e-5)
B, S = 4, 16
N, STEPS, LR = 4, 5, 1e-3
STEP_CASES = {"grad_cos": dict(relevance_mode="grad_cos"),
              "sketch_int8": dict(exchange_estimator="grad_cos+sketch",
                                  relevance_sketch_dim=16,
                                  knowledge_quant_block=128)}
SPLIT_LATER = [MAMBA, "zamba2-7b", "qwen2-vl-72b", "musicgen-medium"]


# ---------------------------------------------------------------------
# inputs, made the same way in the workers and in the test process
# ---------------------------------------------------------------------
def _cfg(arch, **kw):
    return get_arch_config(arch).reduced().with_(**kw)


def _params(cfg):
    return get_model(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu")


def _batch(cfg):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :5] = -100                 # the data ranks count differently
    labels[3, 2] = -100
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return {"tokens": toks, "labels": labels, "positions": pos}


def _flat(tree):
    return {"/".join(map(str, p)): x for p, x in tree_leaves_with_paths(tree)}


def _loss_grads(cfg, mesh=None):
    """(loss, {path: full gradient}) of ``cfg``'s loss on ``_params`` /
    ``_batch``; on ``mesh`` the rank's slices and rows, the gradients
    summed over ``data`` and gathered."""
    from repro_torch.common.sharding import COLLECTIVES, axis_rules, set_mesh
    params = _params(cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    specs = like = None
    if mesh is not None:
        rules = train_rules(mesh)
        specs = SH.param_partition_specs(cfg, rules)
        like = SH.full_shapes(params)
        params = SH.place(params, specs, mesh, cfg)
        d, r = mesh.size(0), mesh.get_local_rank("data")
        batch = {k: v[r * B // d:(r + 1) * B // d] for k, v in batch.items()}
    pairs = tree_leaves_with_paths(params)
    leaves = [x.requires_grad_(True) for _, x in pairs]
    COLLECTIVES.clear()
    if mesh is None:
        loss = get_model(cfg).loss(cfg, params, batch)
        grads = torch.autograd.grad(loss, leaves)
    else:
        with set_mesh(mesh), axis_rules(rules):
            loss = get_model(cfg).loss(cfg, params, batch)
            grads = torch.autograd.grad(loss, leaves)
        for g in grads:
            dist.all_reduce(g, group=mesh.get_group("data"))
    grads = tree_from_paths([(p, g) for (p, _), g in zip(pairs, grads)])
    if mesh is not None:
        grads = SH.gather(grads, specs, mesh, like, cfg)
    return (float(loss.detach()), {k: v.numpy() for k, v in _flat(grads).items()},
            dict(COLLECTIVES))


def _feed(cfg, t):
    """Step ``t``'s fed gradients (a tree of (N, *param) leaves) and
    losses (N,)."""
    rng = np.random.default_rng(100 + t)
    shapes = SH.full_shapes(_params(cfg))
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


def _train(cfg, kw, fed, mesh=None, steps=STEPS):
    """(per step: losses, shared, sketch, relevance; the final params,
    gathered) of the streaming trainer."""
    spec = GroupSpec(n_agents=N, threshold=2, minibatch=2,
                     knowledge_mode="streaming", topology="ring", **kw)
    opt = optim.adamw(LR)
    ex = build_exchange(spec, kind="streaming", mesh=mesh)
    state = SD.init_train_state(cfg, spec, opt, seed=0, exchange=ex,
                                device="cpu")
    if mesh is not None:
        specs = SH.train_state_partition_specs(
            cfg, train_rules(mesh), None, ex.estimator.learns, ex.sketch_dim)
        like = SH.full_shapes(state)
        state = SH.place(state, specs, mesh, cfg)
        pspecs = SH.param_partition_specs(cfg, train_rules(mesh), (None,))
    step = SD.make_group_train_step(cfg, spec, opt, exchange=ex, mesh=mesh,
                                    loss_fn=_linear if fed else None)
    shape = ShapeConfig("t", S // 2, B, "train")
    trace = []
    for t in range(steps):
        if fed:
            g, losses = _feed(cfg, t)
            if mesh is not None:
                g = SH.place(g, pspecs, mesh, cfg)
                g = {k: v for k, v in tree_map(
                    lambda x: x / mesh.size(0), g).items()}
            batch = {"g": g, "loss": losses}
        elif mesh is None:
            batch = make_group_batch(cfg, shape, StreamSpec(seed=0), N, t,
                                     "cpu")
        else:
            batch = make_data_batch(cfg, shape, StreamSpec(seed=0), N, t,
                                    mesh, "cpu")
        state, m = step(state, batch)
        k = state.know
        trace.append((m["loss"].numpy().copy(), m["shared"],
                      None if k.sk is None else k.sk.numpy().copy(),
                      None if k.rel is None else k.rel.numpy().copy(),
                      {p: v.abs().sum(1).numpy() for p, v in
                       _flat(tree_map(lambda x: x.reshape(N, -1),
                                         k.rg)).items()}))
    if mesh is not None:
        state = SH.gather(state, specs, mesh, like, cfg)
    return trace, {p: v.numpy() for p, v in _flat(state.params).items()}


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


def _spawn(tmp_path, worlds, timeout=240.0):
    """Every ``{name: world size}`` spawn started at once, then joined:
    {name: each rank's result}."""
    ctxs = {name: mp.spawn(_entry, args=(world,
                                         str(tmp_path / f"store_{name}"),
                                         str(tmp_path), name),
                           nprocs=world, join=False)
            for name, world in worlds.items()}
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


def _error(fn):
    try:
        fn()
    except NotPortedError as exc:
        return str(exc)
    return None


def world1(rank, world):
    mesh = make_debug_mesh((1, 1), device_type="cpu")
    sketch = STEP_CASES["sketch_int8"]
    return {arch: (_loss_grads(_cfg(arch), mesh),
                   _train(_cfg(arch), sketch, False, mesh, steps=3))
            for arch in (MAMBA, LLAMA)}


def world2(rank, world):
    out = {}
    for shape in ((1, 2), (2, 1)):
        mesh = make_debug_mesh(shape, device_type="cpu")
        out[shape] = {"llama": _loss_grads(_cfg(LLAMA), mesh)}
    mesh = make_debug_mesh((1, 2), device_type="cpu")
    out["llama_h6_kv3"] = _loss_grads(_cfg(LLAMA, n_heads=6, n_kv_heads=3),
                                      mesh)
    out["qwen_ep_2"] = _loss_grads(_cfg(QWEN), mesh)
    out["qwen_dense_2"] = _loss_grads(_cfg(QWEN, moe_dispatch="dense"), mesh)
    from repro_torch.common.sharding import axis_rules, set_mesh
    errors = {}
    for arch in SPLIT_LATER:
        cfg = _cfg(arch)
        spec = GroupSpec(n_agents=2, knowledge_mode="streaming")
        errors[arch] = [_error(lambda: SD.make_group_train_step(
            cfg, spec, optim.adamw(LR), mesh=mesh))]
        if cfg.family in ("moe", "vlm", "audio"):
            from repro_torch.models.model import input_specs
            batch = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
                     input_specs(cfg, ShapeConfig("t", 16, 2,
                                                  "train")).items()}
            params = SH.place(_params(cfg), SH.param_partition_specs(
                cfg, train_rules(mesh)), mesh, cfg)
            with set_mesh(mesh), axis_rules(train_rules(mesh)):
                errors[arch].append(_error(lambda: get_model(cfg).loss(
                    cfg, params, batch)))
    out["errors"] = errors
    return out


def world4(rank, world):
    out = {}
    mesh = make_debug_mesh((2, 2), device_type="cpu")
    out["llama_2x2"] = _loss_grads(_cfg(LLAMA), mesh)
    for case, kw in STEP_CASES.items():
        out["fed_" + case] = _train(_cfg(LLAMA), kw, True, mesh)
    for case, kw in STEP_CASES.items():
        out["own_" + case] = _train(_cfg(LLAMA), kw, False, mesh)
    mesh = make_debug_mesh((1, 4), device_type="cpu")
    out["llama_kv2_1x4"] = _loss_grads(_cfg(LLAMA, n_kv_heads=2), mesh)
    out["qwen_ep_4"] = _loss_grads(_cfg(QWEN), mesh)
    return out


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The (1, 1) mesh in this process: a one-rank gloo group, destroyed
    after the runs."""
    store = tmp_path_factory.mktemp("tp1") / "store"
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    try:
        return [world1(0, 1)]
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("tp"), {"world2": 2, "world4": 4})


@pytest.fixture(scope="module")
def two_ranks(spawned):
    return spawned["world2"]


@pytest.fixture(scope="module")
def four_ranks(spawned):
    return spawned["world4"]


# ---------------------------------------------------------------------
# the reference, in the test process
# ---------------------------------------------------------------------
def _reference(cfg_kw, arch):
    """(loss, {path: gradient}) of the reference's loss on the port's
    weights and batch (the reference's dense dispatch for the MoE)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch_config as r_arch
    from repro.models import get_model as r_model
    cfg = _cfg(arch, **cfg_kw)
    rcfg = r_arch(arch).reduced().with_(**cfg_kw)
    if rcfg.moe is not None:
        rcfg = rcfg.with_(moe_dispatch="dense")
    params = jax.tree_util.tree_map(
        jnp.asarray, tree_map(lambda x: x.numpy(), _params(cfg)))
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    model = r_model(rcfg)
    loss, grads = jax.value_and_grad(
        lambda p: model.loss(rcfg, p, batch))(params)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(grads)}
    return float(loss), flat


def _assert_matches_reference(got, want):
    loss, grads, _ = got
    np.testing.assert_allclose(loss, want[0], **LOSS_TOL)
    assert sorted(grads) == sorted(want[1])
    for k, g in grads.items():
        np.testing.assert_allclose(g, want[1][k], err_msg=k, **GRAD_TOL)


# ---------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2)], ids=str)
def test_llama_loss_and_grads_match_reference(request, shape):
    if shape == (2, 2):
        got = request.getfixturevalue("four_ranks")[0]["llama_2x2"]
    else:
        got = request.getfixturevalue("two_ranks")[0][shape]["llama"]
    _assert_matches_reference(got, _reference({}, LLAMA))
    assert got[2]["attn_out"] == got[2]["mlp_out"] == 2   # one a layer


def test_llama_whole_kv_projection_at_m4(four_ranks):
    want = _reference(dict(n_kv_heads=2), LLAMA)
    for res in four_ranks:
        _assert_matches_reference(res["llama_kv2_1x4"], want)


def test_llama_query_heads_across_kv_groups_at_m2(two_ranks):
    """6 query heads over 3 kv heads at m = 2: ``wk`` / ``wv`` stay whole
    and rank 0's query heads 0–2 read kv heads 0, 0, 1 (not one GQA
    group a rank: the rank gathers a kv head per query head)."""
    want = _reference(dict(n_heads=6, n_kv_heads=3), LLAMA)
    for res in two_ranks:
        _assert_matches_reference(res["llama_h6_kv3"], want)


@pytest.mark.parametrize("case", ["qwen_ep_2", "qwen_ep_4", "qwen_dense_2"])
def test_moe_dispatch_on_split_experts_matches_reference_dense(
        two_ranks, four_ranks, case):
    ranks = four_ranks if case.endswith("4") else two_ranks
    want = _reference({}, QWEN)
    for res in ranks:
        _assert_matches_reference(res[case], want)
        assert res[case][2]["moe_combine"] == 2      # one a MoE layer


def test_families_without_a_model_axis_refuse_it(two_ranks):
    """No family is without a model axis any more: the ssm, hybrid, VLM
    and audio families build their trainer step on (1, 2), and the VLM
    and audio losses run there, without ``NotPortedError``."""
    errors = two_ranks[0]["errors"]
    for arch in SPLIT_LATER:
        for msg in errors[arch]:
            assert msg is None, (arch, msg)
    assert len(errors["qwen2-vl-72b"]) == len(errors["musicgen-medium"]) == 2


@pytest.mark.parametrize("arch", [MAMBA, LLAMA])
def test_one_rank_mesh_equals_no_mesh(one_rank, arch):
    (loss, grads, _), (trace, params) = one_rank[0][arch]
    cfg = _cfg(arch)
    want_loss, want_grads, _ = _loss_grads(cfg)
    assert loss == want_loss
    for k, g in grads.items():
        np.testing.assert_array_equal(g, want_grads[k], err_msg=k)
    want_trace, want_params = _train(cfg, STEP_CASES["sketch_int8"], False,
                                     steps=3)
    for t, (got_t, want_t) in enumerate(zip(trace, want_trace)):
        np.testing.assert_array_equal(got_t[0], want_t[0])
        assert got_t[1] == want_t[1]
        np.testing.assert_array_equal(got_t[2], want_t[2])
    for k, p in params.items():
        np.testing.assert_array_equal(p, want_params[k], err_msg=k)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_streaming_step_fed_gradients_on_2x2(four_ranks, case):
    want_trace, want_params = _train(_cfg(LLAMA), STEP_CASES[case], True)
    assert sum(t[1] for t in want_trace) == 2
    for res in four_ranks:
        trace, params = res["fed_" + case]
        for t, (got, want) in enumerate(zip(trace, want_trace)):
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1], t
            if want[3] is not None:
                np.testing.assert_allclose(got[3], want[3], atol=1e-6)
            if want[2] is not None:
                gate = 1e-5 * sum(want[4].values())[:, None]
                assert bool((np.abs(got[2] - want[2]) <= gate).all()), t
        for k, p in params.items():
            np.testing.assert_allclose(p, want_params[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_streaming_step_own_model_on_2x2(four_ranks, case):
    want_trace, want_params = _train(_cfg(LLAMA), STEP_CASES[case], False)
    assert sum(t[1] for t in want_trace) == 2
    over = total = 0
    for res in four_ranks:
        trace, params = res["own_" + case]
        for t, (got, want) in enumerate(zip(trace, want_trace)):
            np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
            assert got[1] == want[1], t
            if want[3] is not None:
                np.testing.assert_allclose(got[3], want[3], atol=1e-6)
            if want[2] is not None:
                gate = 1e-5 * sum(want[4].values())[:, None]
                assert bool((np.abs(got[2] - want[2]) <= gate).all()), t
        for k, p in params.items():
            d = np.abs(p - want_params[k])
            assert d.max() <= 0.5 * LR, (k, float(d.max()))
            over += int((d > 0.01 * LR).sum())
            total += d.size
    assert over <= 1e-3 * total, (over, total)
