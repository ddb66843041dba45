"""The streaming trainer's launcher, ``repro_torch.launch.train`` (the
twin of ``repro.launch.train``), on the CPU: it runs a reduced arch
with the reference's flags and lines, warns on the legacy spellings,
refuses a production mesh in a world of another size, trains the pod
dispatch on one device (``--pods``; the pod mesh is held in
``test_torch_train_launch_mesh.py``), and its
``--ckpt-full`` files cross-load with the reference launcher's both
ways (``--restore``)."""
from __future__ import annotations

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.checkpoint import restore as ref_restore  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro_torch.common.pytree import tree_leaves_with_paths  # noqa: E402
from repro_torch.launch import train  # noqa: E402

ARGS = ["--device", "cpu", "--agents", "2", "--batch", "2", "--seq", "32",
        "--threshold", "2", "--minibatch", "2"]


def _leaves(tree):
    return [x for _, x in tree_leaves_with_paths(tree)]


def test_launcher_runs_on_the_cpu(capsys):
    out = train.main(ARGS + ["--steps", "5", "--exchange", "topology=ring",
                             "--exchange", "estimator=grad_cos+sketch",
                             "--exchange", "relevance_sketch_dim=32"])
    text = capsys.readouterr().out
    assert "arch=llama3.2-3b reduced=True params/agent=" in text
    assert text.count("<shared>") == 2 and "tokens/s" in text
    assert out["shared"] == [2, 4]
    assert np.isfinite(np.asarray(out["losses"])).all()
    assert len(out["losses"]) == 5 and len(out["losses"][0]) == 2
    state = out["state"]
    assert state.step == 5 and float(state.know.rsum.sum()) == 0.0
    assert float(state.know.sk.abs().sum()) == 0.0     # reset at step 4
    assert out["spec"].topology == "ring" and out["leaves"] == 11


def test_legacy_flags_warn_and_unported_meshes_refused():
    with pytest.warns(DeprecationWarning, match="--topology"):
        out = train.main(ARGS + ["--steps", "1", "--topology", "ring"])
    assert out["spec"].topology == "ring"
    # the production meshes need a world of their size
    with pytest.raises(ValueError, match="needs 256 devices"):
        train.main(ARGS + ["--steps", "1", "--mesh", "prod"])
    with pytest.raises(ValueError, match="needs 512 devices"):
        train.main(ARGS + ["--steps", "1", "--mesh", "prod-multipod"])
    # the pod dispatch trains on one device (the single-device dispatch)
    out = train.main(ARGS + ["--steps", "3", "--exchange",
                             "topology=hierarchical", "--exchange", "degree=1",
                             "--exchange", "pods=2"])
    assert out["spec"].pods == 2 and out["shared"] == [2]
    assert np.isfinite(np.asarray(out["losses"])).all()
    with pytest.raises(SystemExit):
        train.main(ARGS + ["--exchange", "no_such_knob=1"])


def test_the_card_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--steps", "1"])


def test_ckpt_full_cross_loads_with_the_reference(tmp_path, capsys):
    """The port's --ckpt-full restores in the reference launcher
    (--restore) and the reference's in the port's, with every leaf
    equal; elastic + sketched relevance, so the file carries rel, sk and
    alive."""
    flags = ["--agents", "2", "--batch", "2", "--seq", "16",
             "--threshold", "1", "--minibatch", "2", "--elastic",
             "--exchange", "estimator=grad_cos+sketch", "--exchange",
             "relevance_sketch_dim=16"]
    port_file = str(tmp_path / "port.npz")
    ref_file = str(tmp_path / "ref.npz")
    out = train.main(["--device", "cpu", "--steps", "2",
                      "--ckpt-full", port_file] + flags)
    ref_train.main(["--steps", "1", "--restore", port_file,
                    "--ckpt-full", ref_file] + flags)
    assert "restored full TrainState" in capsys.readouterr().out
    # the reference continued one step from the port's state
    from repro.configs import get_arch_config
    from repro.configs.base import GroupSpec
    from repro.core import init_train_state
    from repro import optim
    spec = GroupSpec(n_agents=2, threshold=1, minibatch=2,
                     knowledge_mode="streaming", elastic=True,
                     exchange_estimator="grad_cos+sketch",
                     relevance_sketch_dim=16)
    like = init_train_state(get_arch_config("llama3.2-3b").reduced(), spec,
                            optim.adamw(1e-3), jax.random.PRNGKey(0))
    port_saved = ref_restore(port_file, like)
    assert int(port_saved.step) == 2
    for x, y in zip(jax.tree.leaves(port_saved.params),
                    _leaves(out["state"].params)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    ref_saved = ref_restore(ref_file, like)
    assert int(ref_saved.step) == 3
    back = train.main(["--device", "cpu", "--steps", "1", "--restore",
                       ref_file] + flags)
    assert back["state"].step == 4
    assert back["state"].know.alive.tolist() == [True, True]
