"""The model axis for the ssm, hybrid, VLM and audio families over
``torch.distributed``: mamba2-780m (Mamba2 split by SSD heads), zamba2-7b
(its Mamba2 layers, the shared block's split attention and SwiGLU with
each call site's LoRA delta formed on the rank's slice), qwen2-vl-72b
(M-RoPE on the rank's heads, the vision prefix replicated) and
musicgen-medium (codebook tables and heads split by vocabulary, the
cross-attention by heads, the GELU MLP), on ``(data, model)`` meshes of
spawned processes on the host (gloo, a ``FileStore`` in ``tmp_path``),
held against the reference on one device and the port's one-process
paths. The workers import only torch and the port; the reference runs
in the test process on the port's weights (the hybrid's LoRA ``b``
drawn, so every factor has a gradient).

Two spawns, started together, serve the file (module fixtures): two
ranks ((1, 2) and (2, 1)) and four ((2, 2) and (1, 4)); every model at
``reduced()`` in fp32:

* Serving on every mesh: a prefill of 4 right-padded prompts into a
  24-slot cache through ``launch.dryrun_lib`` and 4 greedy decode
  steps. Logits within rtol = atol = 2e-4 of the reference's
  ``model.forward`` with a cache and ``model.decode``, and within 1e-5
  relative or 1e-5 of the largest logit of the port's one-process path
  (``tests/test_torch_serve_mesh.py``'s gate for the MoE pair: the split
  out-projections' partial sums and the KV-slot sweep's exp / sum /
  divide, at (2, 1) too, move a logit by up to ~1e-5 at these widths);
  greedy tokens equal to both. Each rank's cache leaves at the shapes
  ``cache_partition_specs`` names (rows over ``data``, KV slots,
  ``ck`` / ``cv`` heads, ``conv_x`` channels and ``ssm`` heads over
  ``model``, ``conv_B`` / ``conv_C`` whole).
* Training on (1, 2) and (1, 4): the loss and its gradients (the rank's
  slices gathered) against the reference's ``jax.grad`` at
  ``tests/test_torch_tp_mesh.py``'s gates (loss rtol 1e-5, gradients
  rtol 3e-4 / atol 3e-5; the reference's SSD takes the causal select
  before its exp in this process, as ``tests/
  test_torch_streaming_hybrid.py`` explains). Every replicated leaf's
  gradient (Mamba2's ``w_B``, ``w_C``, ``w_dt``, ``conv_B``, ``conv_C``,
  ``dt_bias``, ``A_log``, ``D``; the LoRA ``a`` / ``b``; the GELU MLP's
  ``b2``; the norms) is the same on every rank, bitwise. Two streaming
  trainer steps on (2, 2), 4 agents on a ring, against the one-process
  steps (the gates of ``test_torch_tp_mesh.py``'s own-model case).
* The cache-free pass's full logits on (1, 2) and (1, 4) against the
  reference's.
* Edge cases: ``n_groups = 2`` at m = 2 and m = 4 (a rank's heads read
  their global group); a ``head_dim`` of 256 (H = 2 at m = 4: every
  ``ssm_inner`` leaf and the ``conv_x`` / ``ssm`` cache stay whole, the
  same result); musicgen with 2 heads at m = 4 (``xattn`` whole); the
  audio family's split embedding, bitwise the one-process rows.

``ssd_chunked`` / ``ssd_decode_step`` on a block of heads
(``head0=``) against the whole layer's heads, in this process.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.launch import dryrun_lib as DL  # noqa: E402
from repro_torch.launch import shardings as SH  # noqa: E402
from repro_torch.launch.mesh import (make_debug_mesh,  # noqa: E402
                                     serve_rules, train_rules)
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import ssd as ssd_lib  # noqa: E402
from test_torch_serve_mesh import _prompts, _rows_of  # noqa: E402
from test_torch_tp_mesh import GRAD_TOL, LOSS_TOL  # noqa: E402

MAMBA, ZAMBA, VL, MUSIC = ("mamba2-780m", "zamba2-7b", "qwen2-vl-72b",
                           "musicgen-medium")
ARCHS = [MAMBA, ZAMBA, VL, MUSIC]
SHAPES = [(1, 2), (2, 1), (2, 2), (1, 4)]
REF_TOL = dict(rtol=2e-4, atol=2e-4)
LENS = [9, 5, 12, 7]
T, STEPS = 24, 4
B, S = 4, 16
N, LR, TRAIN_STEPS = 4, 1e-3, 2
# edge cases: (arch, cfg overrides, mesh shape); ``ssm`` overrides the
# SSMConfig's fields
EDGES = {
    "groups2_m2": (MAMBA, (("ssm", (("n_groups", 2),)),), (1, 2)),
    "groups2_m4": (MAMBA, (("ssm", (("n_groups", 2),)),), (1, 4)),
    "ssm_h2_m4": (MAMBA, (("ssm", (("head_dim", 256),)),), (1, 4)),
    "xattn_h2_m4": (MUSIC, (("n_heads", 2), ("n_kv_heads", 2)), (1, 4)),
}
# leaves every rank holds whole; their gradients must agree bitwise
REPLICATED = ("w_B", "w_C", "w_dt", "conv_B/w", "conv_B/b", "conv_C/w",
              "conv_C/b", "dt_bias", "A_log", "D", "/a", "/b", "b2", "ln",
              "norm")


# ---------------------------------------------------------------------
# inputs, made the same way in the workers and in the test process
# ---------------------------------------------------------------------
def _with(cfg, kw):
    """``cfg`` with the overrides ``kw`` ((name, value) pairs; ``ssm``'s
    value: pairs of SSMConfig fields)."""
    return cfg.with_(**{k: dataclasses.replace(cfg.ssm, **dict(v))
                        if k == "ssm" else v for k, v in kw})


def _cfg(arch, kw=()):
    return _with(get_arch_config(arch).reduced(), kw)


def _params(cfg):
    """Seed-0 weights; the hybrid's LoRA ``b`` drawn (seed 5), so each
    call site's delta and both factors' gradients are nonzero."""
    params = get_model(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu")
    if cfg.family == "hybrid":
        gen = torch.Generator().manual_seed(5)
        for fac in params["lora"].values():
            fac["b"] = torch.randn(fac["b"].shape, generator=gen) * 0.05
    return params


def _flat(tree):
    return {"/".join(map(str, p)): x for p, x in tree_leaves_with_paths(tree)}


def _next(cfg, logits, idx):
    """Each row's next-token logits at sequence index ``idx`` (B,):
    codebook 0 for the audio family."""
    rows = torch.arange(logits.shape[0])
    if cfg.family == "audio":
        return logits[rows, 0, idx]
    return logits[rows, idx]


def _last(cfg, logits):
    return logits[:, 0, -1] if cfg.family == "audio" else logits[:, -1]


def _serve(cfg, mesh):
    """Prefill of the 4 prompts into a T-slot cache, then STEPS greedy
    decode steps (on ``mesh`` through ``dryrun_lib``, else the
    one-process model): the rank's rows' logits per step, their tokens
    and the cache's leaf shapes."""
    from repro_torch.serving import api
    model = get_model(cfg)
    params = _params(cfg)
    rows = _rows_of(mesh, len(LENS))
    batch = api.build_prefill_batch(cfg, torch.from_numpy(
        _prompts(cfg, LENS)))
    shape = ShapeConfig("serve", T, len(LENS), "prefill")
    out = {"logits": [], "tokens": []}
    with torch.no_grad():
        if mesh is None:
            logits, cache = model.forward(
                cfg, params, batch, model.make_cache(cfg, len(LENS), T,
                                                     "cpu"))
        else:
            logits, cache = DL.prefill_on_mesh(cfg, shape, mesh, params,
                                               batch)
        lens = torch.tensor(LENS)[rows]
        nl = _next(cfg, logits, lens - 1)
        tok, pos = nl.argmax(-1).to(torch.int32), lens.to(torch.int32)
        out["logits"].append(nl.numpy())
        out["tokens"].append(tok.numpy())
        for _ in range(STEPS):
            step = api.decode_batch(cfg, tok[:, None], pos[:, None])
            if mesh is None:
                logits, cache = model.decode(cfg, params, step, cache)
            else:
                logits, cache = DL.decode_on_mesh(cfg, shape, mesh, params,
                                                  step, cache)
            nl = _last(cfg, logits)
            tok, pos = nl.argmax(-1).to(torch.int32), pos + 1
            out["logits"].append(nl.numpy())
            out["tokens"].append(tok.numpy())
    out["rows"] = (rows.start, rows.stop)
    out["shapes"] = {k: tuple(v.shape) for k, v in _flat(cache).items()}
    return out


def _prefill_batch(cfg):
    from repro_torch.serving import api
    return api.build_prefill_batch(cfg, torch.from_numpy(
        _prompts(cfg, LENS)))


def _score(cfg, mesh):
    """The cache-free pass's logits over the 4 padded prompts (the rank's
    rows) under ``serve_rules`` on ``mesh``."""
    from repro_torch.common.sharding import axis_rules, set_mesh
    batch = _prefill_batch(cfg)
    shape = ShapeConfig("score", T, len(LENS), "prefill")
    params = DL.place_params(cfg, shape, mesh, _params(cfg))
    rows = _rows_of(mesh, len(LENS))
    batch = {k: v[rows] for k, v in batch.items()}
    with torch.no_grad(), set_mesh(mesh), axis_rules(
            serve_rules(mesh, len(LENS))):
        logits, _ = get_model(cfg).forward(cfg, params, batch, None)
    return logits.numpy()


def _train_batch(cfg):
    """A training batch of the family drawn by numpy (seed 1): tokens,
    labels (a few −100; the VLM's vision rows −100), positions, the
    VLM's vision rows and the audio family's ``cond``."""
    rng = np.random.default_rng(1)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    if cfg.family == "audio":
        C = cfg.n_codebooks
        toks = rng.integers(0, cfg.vocab_size, (B, C, S)).astype(np.int32)
        labels = rng.integers(0, cfg.vocab_size, (B, C, S)).astype(np.int32)
        labels[0, :, :5] = -100
        cond = (rng.normal(size=(B, cfg.cond_len, cfg.d_model))
                * 0.5).astype(np.float32)
        return {"tokens": toks, "labels": labels, "positions": pos,
                "cond": cond}
    vp = cfg.vision_prefix if cfg.family == "vlm" else 0
    toks = rng.integers(0, cfg.vocab_size, (B, S - vp)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :5] = -100
    labels[3, 2 + vp] = -100
    out = {"tokens": toks, "labels": labels, "positions": pos}
    if vp:
        labels[:, :vp] = -100
        out["vision"] = (rng.normal(size=(B, vp, cfg.d_model))
                         * 0.5).astype(np.float32)
        out["positions"] = np.broadcast_to(pos[:, None, :], (B, 3, S)).copy()
    return out


def _loss_grads(cfg, mesh):
    """(loss, {path: full gradient}, {path: the rank's gradient of each
    replicated leaf}) of ``cfg``'s loss on ``_params`` / ``_train_batch``
    on a (1, m) mesh under ``train_rules``."""
    from repro_torch.common.sharding import axis_rules, set_mesh
    rules = train_rules(mesh)
    specs = SH.param_partition_specs(cfg, rules)
    full = _params(cfg)
    params = SH.place(full, specs, mesh, cfg)
    batch = {k: torch.from_numpy(v) for k, v in _train_batch(cfg).items()}
    pairs = tree_leaves_with_paths(params)
    leaves = [x.requires_grad_(True) for _, x in pairs]
    with set_mesh(mesh), axis_rules(rules):
        loss = get_model(cfg).loss(cfg, params, batch)
        grads = torch.autograd.grad(loss, leaves)
    tree = tree_from_paths([(p, g) for (p, _), g in zip(pairs, grads)])
    whole = {"/".join(map(str, p)): g.numpy()
             for (p, x), g in zip(pairs, grads)
             if tuple(x.shape) == tuple(SH._at(full, p).shape)}
    gathered = SH.gather(tree, specs, mesh, SH.full_shapes(full), cfg)
    return (float(loss.detach()),
            {k: v.numpy() for k, v in _flat(gathered).items()}, whole)


def _train(cfg, mesh=None):
    """(per step: losses and the share flag; the final params, gathered)
    of TRAIN_STEPS streaming steps of the port's own model, 4 agents on
    a ring, ``grad_cos`` relevance."""
    spec = GroupSpec(n_agents=N, threshold=2, minibatch=2,
                     knowledge_mode="streaming", topology="ring",
                     relevance_mode="grad_cos")
    opt = optim.adamw(LR)
    ex = build_exchange(spec, kind="streaming", mesh=mesh)
    state = SD.init_train_state(cfg, spec, opt, seed=0, exchange=ex,
                                device="cpu")
    if mesh is not None:
        specs = SH.train_state_partition_specs(
            cfg, train_rules(mesh), None, ex.estimator.learns, ex.sketch_dim)
        like = SH.full_shapes(state)
        state = SH.place(state, specs, mesh, cfg)
    step = SD.make_group_train_step(cfg, spec, opt, exchange=ex, mesh=mesh)
    shape = ShapeConfig("t", S, B, "train")
    trace = []
    for t in range(TRAIN_STEPS):
        if mesh is None:
            batch = make_group_batch(cfg, shape, StreamSpec(seed=0), N, t,
                                     "cpu")
        else:
            batch = make_data_batch(cfg, shape, StreamSpec(seed=0), N, t,
                                    mesh, "cpu")
        state, m = step(state, batch)
        trace.append((m["loss"].numpy().copy(), m["shared"]))
    if mesh is not None:
        state = SH.gather(state, specs, mesh, like, cfg)
    return trace, {p: v.numpy() for p, v in _flat(state.params).items()}


def _audio_rows(mesh):
    """musicgen's embedding rows of (B, C, S) drawn tokens: on ``mesh``
    the vocab-split tables under ``train_rules``, else whole."""
    from repro_torch.common.sharding import axis_rules, set_mesh
    from repro_torch.models.common import embed_rows, vocab_split
    cfg = _cfg(MUSIC)
    params = _params(cfg)
    toks = torch.from_numpy(_train_batch(cfg)["tokens"])
    if mesh is None:
        return embed_rows(cfg, params, toks).numpy()
    rules = train_rules(mesh)
    params = SH.place(params, SH.param_partition_specs(cfg, rules), mesh,
                      cfg)
    with set_mesh(mesh), axis_rules(rules):
        vocab = vocab_split(cfg)
        assert vocab is not None and vocab.size == mesh.size(1)
        return embed_rows(cfg, params, toks, vocab=vocab).numpy()


# ---------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------
def _edges(shapes):
    out = {}
    for case, (arch, kw, shape) in EDGES.items():
        if shape in shapes:
            mesh = make_debug_mesh(shape, device_type="cpu")
            out[case] = _serve(_cfg(arch, kw), mesh)
            if arch == MAMBA:
                out[case, "grads"] = _loss_grads(_cfg(arch, kw), mesh)
    return out


def world2(rank, world):
    out = {"serve": {}, "score": {}, "grads": {}}
    for shape in ((1, 2), (2, 1)):
        mesh = make_debug_mesh(shape, device_type="cpu")
        for arch in ARCHS:
            out["serve"][arch, shape] = _serve(_cfg(arch), mesh)
    mesh = make_debug_mesh((1, 2), device_type="cpu")
    for arch in ARCHS:
        out["score"][arch, (1, 2)] = _score(_cfg(arch), mesh)
        out["grads"][arch, (1, 2)] = _loss_grads(_cfg(arch), mesh)
    out["edges"] = _edges(((1, 2),))
    out["audio_rows"] = _audio_rows(mesh)
    return out


def world4(rank, world):
    out = {"serve": {}, "score": {}, "grads": {}, "train": {}}
    for shape in ((2, 2), (1, 4)):
        mesh = make_debug_mesh(shape, device_type="cpu")
        for arch in ARCHS:
            out["serve"][arch, shape] = _serve(_cfg(arch), mesh)
    mesh = make_debug_mesh((1, 4), device_type="cpu")
    for arch in ARCHS:
        out["score"][arch, (1, 4)] = _score(_cfg(arch), mesh)
        out["grads"][arch, (1, 4)] = _loss_grads(_cfg(arch), mesh)
    out["edges"] = _edges(((1, 4),))
    out["audio_rows"] = _audio_rows(mesh)
    mesh = make_debug_mesh((2, 2), device_type="cpu")
    for arch in ARCHS:
        out["train"][arch] = _train(_cfg(arch), mesh)
    return out


def _entry(rank, world, store, out_dir, name):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        out = globals()[name](rank, world)
        torch.save(out, os.path.join(out_dir, f"{name}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, worlds, meanwhile, timeout=300.0):
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


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("family_mesh"),
                  {"world2": 2, "world4": 4}, _references)


def _ranks(spawned, shape):
    return spawned["world2" if shape[0] * shape[1] == 2 else "world4"]


# ---------------------------------------------------------------------
# the reference and the one-process port, in the test process
# ---------------------------------------------------------------------
_MEMO: dict = {}


def _memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def _rcfg(arch, kw=()):
    from repro.configs import get_arch_config as r_arch
    return _with(r_arch(arch).reduced(), kw)


def _jax_params(cfg):
    import jax.numpy as jnp
    return tree_map(lambda x: jnp.asarray(x.numpy()), _params(cfg))


def _segsum_mask_first(dA_cs):
    """The reference's ``_segsum_mask`` with the causal select before
    the exp (``tests/test_torch_streaming_hybrid.py``)."""
    import jax.numpy as jnp
    L = dA_cs.shape[-1]
    diff = dA_cs[..., :, None] - dA_cs[..., None, :]
    causal = jnp.tril(jnp.ones((L, L), bool))
    return jnp.where(causal, jnp.exp(jnp.where(causal, diff, 0.0)), 0.0)


def _ref_serve(arch, kw=()):
    """The reference's prefill with a cache and greedy decode steps on
    one device: (next-token logits per step, tokens)."""
    def run():
        import jax
        import jax.numpy as jnp

        from repro.models import get_model as r_model
        from repro.serving import api as r_api
        rcfg = _rcfg(arch, kw)
        model = r_model(rcfg)
        forward = jax.jit(model.forward, static_argnums=0)
        decode = jax.jit(model.decode, static_argnums=0)
        params = _jax_params(_cfg(arch, kw))
        toks = jnp.asarray(_prompts(rcfg, LENS))
        logits, cache = forward(rcfg, params,
                                r_api.build_prefill_batch(rcfg, toks),
                                model.make_cache(rcfg, len(LENS), T))
        idx = np.asarray(LENS) - 1
        nl = np.asarray(logits)
        nl = (nl[np.arange(len(LENS)), 0, idx] if rcfg.family == "audio"
              else nl[np.arange(len(LENS)), idx])
        tok, pos = nl.argmax(-1), np.asarray(LENS, np.int32)
        out_l, out_t = [nl], [tok]
        for _ in range(STEPS):
            step = r_api.decode_batch(
                rcfg, jnp.asarray(tok[:, None].astype(np.int32)),
                jnp.asarray(pos[:, None]))
            logits, cache = decode(rcfg, params, step, cache)
            nl = np.asarray(r_api.last_logits(rcfg, logits))
            tok, pos = nl.argmax(-1), pos + 1
            out_l.append(nl)
            out_t.append(tok)
        return out_l, out_t
    return _memo(("ref", arch, kw), run)


def _port_serve(arch, kw=()):
    return _memo(("port", arch, kw), lambda: _serve(_cfg(arch, kw), None))


def _ref_score(arch):
    def run():
        import jax
        import jax.numpy as jnp

        from repro.models import get_model as r_model
        from repro.serving import api as r_api
        rcfg = _rcfg(arch)
        batch = r_api.build_prefill_batch(rcfg,
                                          jnp.asarray(_prompts(rcfg, LENS)))
        logits, _ = jax.jit(r_model(rcfg).forward, static_argnums=0)(
            rcfg, _jax_params(_cfg(arch)), batch, None)
        return np.asarray(logits)
    return _memo(("score", arch), run)


def _ref_grads(arch, kw=()):
    """(loss, {path: gradient}) of the reference's jitted
    ``jax.value_and_grad`` of its loss on ``_train_batch`` and the port's
    weights, the SSD's causal select before its exp."""
    def run():
        import jax
        import jax.numpy as jnp

        import repro.models.ssd as r_ssd
        from repro.models import get_model as r_model
        rcfg = _rcfg(arch, kw)
        batch = {k: jnp.asarray(v)
                 for k, v in _train_batch(_cfg(arch, kw)).items()}
        model = r_model(rcfg)
        saved = r_ssd._segsum_mask
        r_ssd._segsum_mask = _segsum_mask_first
        try:
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: model.loss(rcfg, p, batch)))(
                    _jax_params(_cfg(arch, kw)))
        finally:
            r_ssd._segsum_mask = saved
        flat = {"/".join(str(getattr(k, "key", k)) for k in path):
                np.asarray(v)
                for path, v in jax.tree_util.tree_leaves_with_path(grads)}
        return float(loss), flat
    return _memo(("grads", arch, kw), run)


def _port_train(arch):
    return _memo(("train", arch), lambda: _train(_cfg(arch)))


def _references():
    """Every reference and one-process result the tests read, computed
    while the workers run."""
    for arch in ARCHS:
        _ref_serve(arch)
        _port_serve(arch)
        _ref_score(arch)
        _ref_grads(arch)
        _port_train(arch)
    for arch, kw, _ in EDGES.values():
        _ref_serve(arch, kw)
        _port_serve(arch, kw)
        if arch == MAMBA:
            _ref_grads(arch, kw)
    _memo("audio_rows", lambda: _audio_rows(None))


# ---------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------
def _check_serve(arch, kw, res):
    rows = slice(*res["rows"])
    ref_l, ref_t = _ref_serve(arch, kw)
    port = _port_serve(arch, kw)
    for t, got in enumerate(res["logits"]):
        np.testing.assert_allclose(got, ref_l[t][rows], err_msg=f"step {t}",
                                   **REF_TOL)
        want = port["logits"][t][rows]
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=f"step {t}")
        np.testing.assert_array_equal(res["tokens"][t], ref_t[t][rows])
        np.testing.assert_array_equal(res["tokens"][t],
                                      port["tokens"][t][rows])


def _want_shapes(cfg, shape):
    """Each cache leaf's shape on a rank of a ``shape`` (data, model)
    mesh, by ``cache_partition_specs`` under ``serve_rules``: a dim over
    an axis that divides it is cut by the axis's size, else whole; the
    Mamba2 ``conv_x`` channels only where the SSD heads divide."""
    sizes = {"data": shape[0], "model": shape[1]}
    rules = serve_rules(type("M", (), {"axis_names": ("data", "model"),
                                       "shape": sizes})(), len(LENS))
    cshape = ShapeConfig("c", T, len(LENS), "decode")
    specs = {"/".join(p): spec for p, spec in SH._dict_leaves(
        SH.cache_partition_specs(cfg, cshape, rules["batch"],
                                 slots_axis=rules["kv_slots"]))}
    full = _flat(get_model(cfg).make_cache(cfg, len(LENS), T, "meta"))
    heads = (cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
             if cfg.ssm is not None else 0)
    out = {}
    for k, x in full.items():
        dims = []
        for d, (n, a) in enumerate(zip(x.shape, specs[k])):
            cut = a is not None and n % sizes[a] == 0
            if k.endswith("conv_x") and d == x.ndim - 1:
                cut = cut and heads % sizes[a] == 0
            dims.append(n // sizes[a] if cut else n)
        out[k] = tuple(dims)
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_and_one_process(
        spawned, arch, shape):
    for res in _ranks(spawned, shape):
        _check_serve(arch, (), res["serve"][arch, shape])


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_slices_have_the_placed_shapes(spawned, arch, shape):
    """Every rank's cache leaves at ``cache_partition_specs``' shapes:
    the KV slots, ``ck`` / ``cv`` heads, ``conv_x`` channels and ``ssm``
    heads cut by m where they split, ``conv_B`` / ``conv_C`` whole."""
    cfg = _cfg(arch)
    want = _want_shapes(cfg, shape)
    m = shape[1]
    for res in _ranks(spawned, shape):
        got = res["serve"][arch, shape]["shapes"]
        assert got == want
        for k, s in got.items():
            full = _flat(get_model(cfg).make_cache(cfg, 4, T, "meta"))[k]
            if k.endswith(("conv_B", "conv_C")):
                assert s[-1] == full.shape[-1], k
            if k.endswith("/ssm") or k == "ssm":
                assert s[-3] == full.shape[-3] // m, k
            if k.endswith(("/ck", "/cv")):
                assert s[3] == cfg.n_heads // m, k


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_free_full_logits_match_reference(spawned, arch, shape):
    """A scoring pass on the model axis: the full rows of logits on every
    rank (the SSD and flash kernels' plain versions on the rank's heads),
    against the reference's cache-free pass."""
    want = _ref_score(arch)
    for res in _ranks(spawned, shape):
        got = res["score"][arch, shape]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **REF_TOL)


def _assert_grads(got, want):
    loss, grads, _ = got
    np.testing.assert_allclose(loss, want[0], **LOSS_TOL)
    assert sorted(grads) == sorted(want[1])
    for k, g in grads.items():
        np.testing.assert_allclose(g, want[1][k], err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(spawned, arch, shape):
    want = _ref_grads(arch)
    for res in _ranks(spawned, shape):
        _assert_grads(res["grads"][arch, shape], want)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_replicated_leaves_have_the_same_gradient_on_every_rank(
        spawned, arch, shape):
    """A leaf every rank holds whole gets the full gradient on each rank,
    bitwise the same (``copy_to_model`` where it enters split work), so
    the trainer's partial sums may count it on model rank 0 only."""
    ranks = [res["grads"][arch, shape][2] for res in _ranks(spawned, shape)]
    names = sorted(ranks[0])
    checked = [k for k in names if any(s in k for s in REPLICATED)]
    assert checked, names
    if arch in (MAMBA, ZAMBA):
        assert any(k.endswith("w_B") for k in checked)
    if arch == ZAMBA:
        assert any(k.endswith("wq/a") for k in checked)
    if arch == MUSIC:
        assert any(k.endswith("b2") for k in checked)
    for rank in ranks[1:]:
        assert sorted(rank) == names
        for k in names:
            np.testing.assert_array_equal(rank[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_streaming_steps_on_2x2_match_one_process(spawned, arch):
    """Two steps of the streaming trainer on (2, 2) against the same steps
    in one process: losses within rtol 1e-5 / atol 1e-5, the same share
    flags, parameters within lr / 2 and within lr / 100 but for at most
    1e-3 of the elements (``test_torch_tp_mesh.py``'s own-model gates)."""
    want_trace, want_params = _port_train(arch)
    over = total = 0
    for res in spawned["world4"]:
        trace, params = res["train"][arch]
        for t, (got, want) in enumerate(zip(trace, want_trace)):
            np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
            assert got[1] == want[1], t
        assert sorted(params) == sorted(want_params)
        for k, p in params.items():
            d = np.abs(p - want_params[k])
            assert d.max() <= 0.5 * LR, (k, float(d.max()))
            over += int((d > 0.01 * LR).sum())
            total += d.size
    assert over <= 1e-3 * total, (over, total)


@pytest.mark.parametrize("case", list(EDGES))
def test_edge_cases(spawned, case):
    """Two SSD groups at m = 2 and m = 4, whole ``ssm_inner`` leaves at
    H = 2 over m = 4, a whole cross-attention at 2 heads over m = 4:
    serving against the reference and the one-process port, the cache at
    its placed shapes; the SSM cases' loss and gradients against
    ``jax.grad``."""
    arch, kw, shape = EDGES[case]
    cfg = _cfg(arch, kw)
    want = _want_shapes(cfg, shape)
    for res in _ranks(spawned, shape):
        got = res["edges"][case]
        _check_serve(arch, kw, got)
        assert got["shapes"] == want
        if (case, "grads") in res["edges"]:
            _assert_grads(res["edges"][case, "grads"], _ref_grads(arch, kw))
    if case == "ssm_h2_m4":
        full = _flat(get_model(cfg).make_cache(cfg, 4, T, "meta"))
        for k in ("conv_x", "ssm"):
            assert want[k][1:] == tuple(full[k].shape[1:]), k
    if case == "xattn_h2_m4":
        assert want["layers/xkv/ck"] == (cfg.n_layers, 4, cfg.cond_len, 2,
                                         cfg.head_dim)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=str)
def test_audio_split_embedding_is_the_one_process_rows(spawned, shape):
    """musicgen's (C, V/m, E) codebook tables: each codebook's rows
    looked up where they lie, assembled by one all-reduce and summed in
    codebook order — bitwise the one-process rows."""
    want = _memo("audio_rows", lambda: _audio_rows(None))
    for res in _ranks(spawned, shape):
        np.testing.assert_array_equal(res["audio_rows"], want)


# ---------------------------------------------------------------------
# in this process: the SSD on a block of heads
# ---------------------------------------------------------------------
@pytest.mark.parametrize("H,g,h,head0", [(8, 2, 4, 4), (8, 2, 2, 6),
                                         (12, 2, 4, 4), (8, 1, 4, 4)])
def test_ssd_on_a_block_of_heads_reads_its_global_groups(H, g, h, head0):
    """``ssd_chunked`` and ``ssd_decode_step`` on heads head0 .. head0 +
    h − 1 of H (``head0=``, ``total_heads=``) with the layer's g groups:
    within 1e-6 of the same heads of the whole layer's result (heads 4 –
    7 of 12 over 2 groups read groups 0, 0, 1, 1)."""
    gen = torch.Generator().manual_seed(H * 100 + head0)
    b, s, p, n, chunk = 2, 24, 4, 8, 8
    x = torch.randn((b, s, H, p), generator=gen)
    dt = torch.nn.functional.softplus(torch.randn((b, s, H), generator=gen))
    A = -torch.exp(torch.randn((H,), generator=gen))
    Bm, Cm = (torch.randn((b, s, g, n), generator=gen) for _ in range(2))
    state = torch.randn((b, H, p, n), generator=gen)
    cut = slice(head0, head0 + h)
    with torch.no_grad():
        y, fs = ssd_lib.ssd_chunked(x, dt, A, Bm, Cm, chunk,
                                    initial_state=state)
        y_r, fs_r = ssd_lib.ssd_chunked(
            x[:, :, cut], dt[:, :, cut], A[cut], Bm, Cm, chunk,
            initial_state=state[:, cut], head0=head0, total_heads=H)
        d, ds = ssd_lib.ssd_decode_step(state, x[:, 0], dt[:, 0], A,
                                        Bm[:, 0], Cm[:, 0])
        d_r, ds_r = ssd_lib.ssd_decode_step(
            state[:, cut], x[:, 0, cut], dt[:, 0, cut], A[cut], Bm[:, 0],
            Cm[:, 0], head0, H)
    for got, want in ((y_r, y[:, :, cut]), (fs_r, fs[:, cut]),
                      (d_r, d[:, cut]), (ds_r, ds[:, cut])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
