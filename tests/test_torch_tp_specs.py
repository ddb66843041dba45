"""Port parity of the model axis's tables (``repro_torch.launch.mesh``,
``repro_torch.launch.shardings``, ``repro_torch.common.sharding``,
``repro_torch.models.model``) and of the expert-parallel dispatch's
slots (``repro_torch.models.moe._dispatch_indices``), against the
reference, on the CPU in this process.

* The spec functions, entry for entry (a port spec tuple against
  ``tuple(PartitionSpec)``): ``param_partition_specs``,
  ``batch_partition_specs``, ``cache_partition_specs``,
  ``group_plane_partition_specs`` and ``train_state_partition_specs``,
  for every arch id of the zoo, published and ``reduced()``, under
  ``train_rules`` and ``serve_rules`` of a 16 x 16 ``(data, model)`` and
  a 2 x 16 x 16 ``(pod, data, model)`` stub mesh (both sides read the
  stub's ``axis_names`` and ``shape``); the placement's ``_sanitize``
  on every parameter leaf too.
* The reference's own cases of ``_sanitize`` (``tests/test_infra.py``)
  and of ``axis_rules`` scoping.
* ``_dispatch_indices`` bitwise (token slots, gates, sources, valid
  mask) on drawn routings with and without overflow.
* The strided sketch's position maps on the CPU: the sum of the shard
  sketches of a leaf cut into column, row and expert slices equals the
  whole leaf's sketch within the sketch's gate, and its signs are the
  full leaf's signs, bitwise.
* The production mesh's size message in a world of one process.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.common import sharding as r_sharding  # noqa: E402
from repro.configs import get_arch_config as r_arch  # noqa: E402
from repro.configs.base import INPUT_SHAPES as R_SHAPES  # noqa: E402
from repro.launch import dryrun_lib as r_dryrun  # noqa: E402
from repro.launch import mesh as r_mesh  # noqa: E402
from repro.launch import shardings as r_shardings  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro.models.moe import _dispatch_indices as r_dispatch  # noqa: E402
from repro_torch.common import sharding as sharding  # noqa: E402
from repro_torch.common.pytree import tree_leaves_with_paths  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_arch_config  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.kernels.grad_sketch import ops as sketch_ops  # noqa: E402
from repro_torch.kernels.grad_sketch import ref as sketch_ref  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import shardings  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models.moe import _dispatch_indices  # noqa: E402


class StubMesh:
    """A mesh description both packages read: axis names and sizes."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


MESHES = {"data_model": StubMesh((16, 16), ("data", "model")),
          "pod_data_model": StubMesh((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module", autouse=True)
def cached_shapes():
    """Each side's parameter and cache shapes computed once per config:
    the spec functions rebuild them on every call."""
    mp = pytest.MonkeyPatch()
    r_params = functools.lru_cache(maxsize=None)(r_model.param_specs)
    r_cache = functools.lru_cache(maxsize=None)(r_model.cache_specs)
    p_params = functools.lru_cache(maxsize=None)(model_lib.param_specs)
    p_cache = functools.lru_cache(maxsize=None)(model_lib.cache_specs)
    mp.setattr(r_shardings, "param_specs", r_params)
    mp.setattr(r_shardings, "cache_specs", r_cache)
    mp.setattr("repro.models.param_specs", r_params)
    mp.setattr(model_lib, "param_specs", p_params)
    mp.setattr(model_lib, "cache_specs", p_cache)
    yield
    mp.undo()


def _cfgs(arch):
    return [(get_arch_config(arch), r_arch(arch)),
            (get_arch_config(arch).reduced(), r_arch(arch).reduced())]


def _rules(kind, mesh, lib):
    if kind == "train":
        return lib.train_rules(mesh)
    return lib.serve_rules(mesh, 256)


def _spec_tree(tree):
    """A reference tree of PartitionSpecs as nested dicts of tuples (and
    the paths of its leaves)."""
    out = {}
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    for path, spec in leaves:
        node = out
        keys = [getattr(k, "key", getattr(k, "name", None)) for k in path]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = tuple(spec)
    return out


def _flat(tree):
    """(path, spec tuple) of a port spec tree, keys sorted."""
    out = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + (k,))
        else:
            out.append((prefix, node))
    walk(tree, ())
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("kind", ["train", "serve"])
def test_rule_tables_equal_the_reference(kind, mesh):
    m = MESHES[mesh]
    assert _rules(kind, m, mesh_lib) == _rules(kind, m, r_mesh)
    assert mesh_lib.serve_rules(m, 3) == r_mesh.serve_rules(m, 3)
    assert sharding.DEFAULT_RULES == r_sharding.DEFAULT_RULES


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_plane_specs_equal_the_reference(arch, mesh):
    m = MESHES[mesh]
    for cfg, rcfg in _cfgs(arch):
        for kind in ("train", "serve"):
            rules = _rules(kind, m, mesh_lib)
            rrules = _rules(kind, m, r_mesh)
            for lead in ((), (rules["agent"],)):
                got = shardings.param_partition_specs(cfg, rules, lead)
                want = _spec_tree(r_shardings.param_partition_specs(
                    rcfg, rrules, lead))
                assert got == want, (arch, kind, lead)
            # the placement's _sanitize, leaf by leaf
            shapes = dict(tree_leaves_with_paths(model_lib.param_specs(cfg)))
            for path, spec in _flat(got):
                shape = tuple(shapes[path].shape)
                assert shardings._sanitize(m, spec, shape) == tuple(
                    r_dryrun._sanitize(m, P(*spec), shape)), (arch, path)
        got = shardings.group_plane_partition_specs(cfg, m)
        want = _spec_tree(r_shardings.group_plane_partition_specs(rcfg, m))
        assert got == want, arch


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_cache_and_state_specs_equal_the_reference(arch, mesh):
    m = MESHES[mesh]
    for cfg, rcfg in _cfgs(arch):
        rules, rrules = (mesh_lib.serve_rules(m, 128),
                         r_mesh.serve_rules(m, 128))
        for name in ("train_4k", "prefill_32k", "decode_32k"):
            sh, rsh = INPUT_SHAPES[name], R_SHAPES[name]
            for lead in ((), ("pod",)):
                got = shardings.batch_partition_specs(cfg, sh,
                                                      rules["batch"], lead)
                want = {k: tuple(v) for k, v in
                        r_shardings.batch_partition_specs(
                            rcfg, rsh, rrules["batch"], lead).items()}
                assert got == want, (arch, name, lead)
        dec, rdec = INPUT_SHAPES["decode_32k"], R_SHAPES["decode_32k"]
        for axes in (dict(), dict(model_axis=None, slots_axis="model")):
            got = shardings.cache_partition_specs(cfg, dec, rules["batch"],
                                                  **axes)
            want = _spec_tree(r_shardings.cache_partition_specs(
                rcfg, rdec, rrules["batch"], **axes))
            assert got == want, arch
        train, rtrain = mesh_lib.train_rules(m), r_mesh.train_rules(m)
        for learn, d in ((False, 0), (True, 0), (True, 256)):
            got = shardings.train_state_partition_specs(
                cfg, train, train["agent"], learn, d)
            want = r_shardings.train_state_partition_specs(
                rcfg, rtrain, rtrain["agent"], learn, d)
            assert got.params == _spec_tree(want.params), arch
            assert got.opt_state["m"] == _spec_tree(want.opt_state["m"])
            assert got.opt_state["count"] == tuple(want.opt_state["count"])
            assert got.step == tuple(want.step)
            for field in ("tg", "rg"):
                assert getattr(got.know, field) == _spec_tree(
                    getattr(want.know, field)), (arch, field)
            for field in ("tsum", "rsum", "rel", "sk", "alive"):
                w = getattr(want.know, field)
                assert getattr(got.know, field) == (
                    None if w is None else tuple(w)), (arch, field)


def test_input_specs_and_logical_axes_equal_the_reference():
    for arch in ARCH_IDS:
        for cfg, rcfg in _cfgs(arch):
            for name in ("train_4k", "prefill_32k", "decode_32k"):
                got = model_lib.input_specs(cfg, INPUT_SHAPES[name])
                want = r_model.input_specs(rcfg, R_SHAPES[name])
                assert sorted(got) == sorted(want)
                for k, v in got.items():
                    assert v.device.type == "meta"
                    assert tuple(v.shape) == tuple(want[k].shape), (arch, k)
                    assert str(v.dtype).split(".")[-1] == str(
                        want[k].dtype), (arch, k)
            got = model_lib.param_logical_axes(
                cfg, model_lib.param_specs(cfg))
            want = r_model.param_logical_axes(rcfg,
                                              r_model.param_specs(rcfg))
            flat_want = {tuple(getattr(k, "key", None) for k in path): v
                         for path, v in jax.tree_util.tree_leaves_with_path(
                             want, is_leaf=lambda x: isinstance(x, tuple))}
            assert dict(_flat(got)) == flat_want, arch
    assert model_lib._COLUMN == r_model._COLUMN
    assert model_lib._ROW == r_model._ROW
    assert model_lib._COLUMN_BIAS == r_model._COLUMN_BIAS
    assert model_lib._VEC_SHARDED == r_model._VEC_SHARDED


def test_sanitize_partition_specs():
    """The reference's cases (``tests/test_infra.py``)."""
    class FakeMesh:
        shape = {"model": 16, "data": 4}
    assert shardings._sanitize(FakeMesh, (None, "model"), (10, 8)) == (
        None, None)
    assert shardings._sanitize(FakeMesh, ("data", "model"), (8, 32)) == (
        "data", "model")
    assert shardings._sanitize(FakeMesh, (("data", "model"),), (64, 3)) == (
        ("data", "model"), None)


def test_axis_rules_scoping():
    assert sharding.get_rules() is None
    with sharding.axis_rules({"batch": "data"}):
        assert sharding.logical_spec("batch", None) == ("data", None)
        assert sharding.shard("x", "batch") == "x"
    assert sharding.get_rules() is None
    assert sharding.logical_spec("batch") == ()
    assert sharding.mesh_axis("batch") is None


def test_head_rule_replicates_a_split_head():
    """The placement splits an attention projection in whole heads only:
    llama at reduced() (4 query heads of 32, 2 kv heads) on a 4-rank
    model axis keeps ``wk`` / ``wv`` whole (their 64 columns divide, the
    2 heads do not), ``wq`` and the MLP split."""
    cfg = get_arch_config("llama3.2-3b").reduced().with_(n_kv_heads=2)
    m = StubMesh((1, 4), ("data", "model"))
    spec = (None, None, "model")
    assert shardings._sanitize(m, spec, (2, 256, 64)) == spec
    assert shardings.placement_spec(cfg, m, ("layers", "attn", "wk"), spec,
                                    (2, 256, 64)) == (None, None, None)
    assert shardings.placement_spec(cfg, m, ("layers", "attn", "wq"), spec,
                                    (2, 256, 128)) == spec
    assert shardings.placement_spec(cfg, m, ("layers", "mlp", "w_gate"),
                                    spec, (2, 256, 512)) == spec


def _placed(cfg, mesh, kind="train"):
    """{path: placement spec} of every parameter leaf (``kind``
    "cache": of the decode cache's leaves, under serve_rules)."""
    if kind == "cache":
        rules = mesh_lib.serve_rules(mesh, 256)
        shape = INPUT_SHAPES["decode_32k"]
        specs = shardings.cache_partition_specs(
            cfg, shape, rules["batch"], slots_axis=rules["kv_slots"])
        full = model_lib.cache_specs(cfg, shape)
    else:
        specs = shardings.param_partition_specs(
            cfg, mesh_lib.train_rules(mesh))
        full = model_lib.param_specs(cfg)
    flat = dict(shardings._dict_leaves(specs))
    return {"/".join(p): shardings.placement_spec(
        cfg, mesh, p, flat[p], tuple(x.shape))
        for p, x in tree_leaves_with_paths(full)}


def _split_dims(spec):
    return [d for d, a in enumerate(spec) if a == "model"]


# (arch, {leaf suffix: the dim from the end split over "model", or None
# for a leaf placed whole}) at m = 16
_M16_CASES = {
    # 48 SSD heads, 3 a rank: every ssm_inner leaf splits
    "mamba2-780m": {"mamba/w_z": -1, "mamba/w_x": -1, "mamba/norm_w": -1,
                    "mamba/out_proj": -2, "conv_x/w": -1, "conv_x/b": -1,
                    "mamba/w_B": None, "mamba/w_dt": None,
                    "conv_B/w": None, "mamba/A_log": None},
    # 112 SSD heads, 7 a rank; the shared block's 32 heads, 2 a rank
    "zamba2-7b": {"mamba/w_z": -1, "mamba/out_proj": -2, "conv_x/w": -1,
                  "shared/attn/wq": -1, "shared/attn/wk": -1,
                  "shared/attn/wo": -2, "shared/mlp/w_down": -2,
                  "lora/wq/a": None, "lora/wq/b": None},
    # 24 heads do not divide 16: the self- and cross-attention's heads
    # stay whole (the self-attention's wo splits by rows, as for llama)
    "musicgen-medium": {"attn/wq": None, "attn/wk": None, "attn/wv": None,
                        "xattn/wq": None, "xattn/wk": None, "xattn/wv": None,
                        "xattn/wo": None, "layers/attn/wo": -2, "mlp/w1": -1,
                        "mlp/b1": -1, "mlp/w2": -2, "mlp/b2": None,
                        "embed": -2, "lm_head": -1},
}


@pytest.mark.parametrize("arch", list(_M16_CASES))
def test_whole_heads_placement_at_m16(arch):
    """The placement on the 16 x 16 (data, model) mesh splits a leaf made
    of heads (Mamba2's ``ssm_inner`` leaves by the SSD heads, attention
    and cross-attention by theirs) only where the heads divide 16, while
    ``param_partition_specs`` keeps the reference's entries."""
    cfg = get_arch_config(arch)
    mesh = MESHES["data_model"]
    placed = _placed(cfg, mesh)
    for suffix, dim in _M16_CASES[arch].items():
        hits = [k for k in placed if k.endswith(suffix)]
        assert hits, suffix
        for k in hits:
            split = _split_dims(placed[k])
            want = [] if dim is None else [len(placed[k]) + dim]
            assert split == want, (k, placed[k])
    cache = _placed(cfg, mesh, "cache")
    whole = arch == "musicgen-medium"
    for k, spec in cache.items():
        if k.endswith(("conv_x", "ssm", "/ck", "/cv")):
            assert bool(_split_dims(spec)) != whole, (k, spec)
        if k.endswith(("conv_B", "conv_C")):
            assert not _split_dims(spec), (k, spec)


def test_ssm_inner_leaves_stay_whole_where_the_heads_do_not_divide():
    """mamba2-780m at reduced() with a head_dim of 256: d_inner 512
    divides 4, its 2 SSD heads do not, so ``w_z`` / ``w_x`` / ``conv_x``
    / ``norm_w`` / ``out_proj`` and the cache's ``conv_x`` / ``ssm`` are
    placed whole on a 4-rank model axis; ``_sanitize`` alone would cut
    them."""
    import dataclasses
    cfg = get_arch_config("mamba2-780m").reduced()
    cfg = cfg.with_(ssm=dataclasses.replace(cfg.ssm, head_dim=256))
    mesh = StubMesh((1, 4), ("data", "model"))
    placed = _placed(cfg, mesh)
    for k, spec in placed.items():
        assert not _split_dims(spec) or k.endswith(("embed", "lm_head")), (
            k, spec)
    assert shardings._sanitize(mesh, (None, None, "model"),
                               (2, 256, 512)) == (None, None, "model")
    for k, spec in _placed(cfg, mesh, "cache").items():
        assert not _split_dims(spec), (k, spec)


@pytest.mark.parametrize("B,S,k,Ne,C", [(3, 16, 2, 4, 5), (2, 24, 2, 4, 12),
                                        (2, 64, 8, 16, 40), (1, 7, 1, 3, 1)])
def test_dispatch_indices_match_the_reference_bitwise(B, S, k, Ne, C):
    rng = np.random.default_rng(B * 1000 + S)
    e = rng.integers(0, Ne, (B, S * k)).astype(np.int32)
    e[0, : S * k // 2] = 0               # an expert past its capacity
    gate = rng.uniform(0.1, 1.0, (B, S * k)).astype(np.float32)
    want = r_dispatch(jnp.asarray(e), jnp.asarray(gate), Ne, C, k)
    got = _dispatch_indices(torch.from_numpy(e), torch.from_numpy(gate),
                            Ne, C, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("m", [2, 4])
def test_shard_sketches_sum_to_the_leaf_sketch(m):
    """A stacked (n, L, E, F) leaf cut on F (columns), on E (rows of a
    layer: still strided over L) and on L (a contiguous range): each
    rank's sketch at its slice's positions, summed, is the whole leaf's
    within the sketch's gate, and a one-hot slice's sketch is the full
    leaf's sign row at that position, bitwise."""
    g = torch.Generator().manual_seed(m)
    n, shape = 3, (4, 8, 12)
    full = torch.randn((n,) + shape, generator=g)
    seed, d, offset = -77, 24, 12345
    want = sketch_ops.sketch_leaf(full, seed, d, offset)
    for dim in (0, 1, 2):
        blk = shape[dim] // m
        acc = torch.zeros((n, d))
        for r in range(m):
            sl = [slice(None)] * 4
            sl[dim + 1] = slice(r * blk, (r + 1) * blk)
            leaf = sharding.LeafShard(shape, dim, r * blk, blk)
            acc += sketch_ops.sketch_leaf(full[tuple(sl)].contiguous(), seed,
                                          d, offset, leaf)
        gate = 1e-5 * full.abs().reshape(n, -1).sum(1, keepdim=True)
        assert bool(((acc - want).abs() <= gate).all()), dim
    # signs: a one-hot local element at (l, e, f) of rank r's column slice
    r, l_, e_, f_ = m - 1, 3, 5, 2
    blk = shape[2] // m
    local = torch.zeros((1, 4, 8, blk))
    local[0, l_, e_, f_] = 1.0
    got = sketch_ops.sketch_leaf(local, seed, d, offset,
                                 sharding.LeafShard(shape, 2, r * blk, blk))
    pos = offset + (l_ * 8 + e_) * 12 + r * blk + f_
    assert torch.equal(got, sketch_ref.sign_block(seed, pos, 1, d))


def test_leaf_position_maps():
    assert sharding.LeafShard((4, 8, 12), 2, 6, 3).position_map() == (
        12, 6, 3)
    assert sharding.LeafShard((4, 8, 12), 0, 2, 2).position_map() == (
        384, 192, 192)
    assert sharding.LeafShard((4, 8, 12), None, 0, 0).position_map() == (
        384, 0, 384)
    with pytest.raises(ValueError, match="position map"):
        sketch_ops.sketch_flat(torch.zeros((1, 10)), 0, 4,
                               position_map=(12, 6, 4))


def test_production_mesh_names_the_world_it_needs():
    with pytest.raises(ValueError, match="needs 256 devices"):
        mesh_lib.make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="needs 512 devices"):
        mesh_lib.make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(ValueError, match=r"needs 4 devices"):
        mesh_lib.make_debug_mesh((2, 2), device_type="cpu")
