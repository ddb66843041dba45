"""The training launcher on the pod mesh: ``python -m
torch.distributed.run --standalone --nproc-per-node 2 -m
repro_torch.launch.train --device cpu --mesh pods`` (two ranks over
gloo, one pod each) against the single-process ``--mesh cpu`` run of
the same spec, and the checkpoints of each kind of run restored in the
other. The launcher runs in subprocesses that import only torch and the
port. Also: the production meshes need a world of their size, and
``--device cuda`` never falls back to gloo or the host."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.launch import train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FLAGS = ["--device", "cpu", "--agents", "4", "--batch", "1", "--seq", "16",
         "--threshold", "1", "--minibatch", "2", "--elastic",
         "--exchange", "topology=hierarchical", "--exchange", "degree=2",
         "--exchange", "pods=2", "--exchange", "estimator=grad_cos+sketch",
         "--exchange", "relevance_sketch_dim=16"]
TOL = dict(rtol=1e-5, atol=1e-6)


def _torchrun(argv, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
           "--mesh", "pods"] + argv
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Fresh 2-rank and 1-process runs of 4 steps, then each one's
    checkpoint continued 2 steps by the other kind of run."""
    d = tmp_path_factory.mktemp("launch_mesh")
    f = {k: str(d / f"{k}.npz") for k in ("mesh", "one", "mesh2", "one2")}
    out = {"mesh_stdout": _torchrun(FLAGS + ["--steps", "4",
                                             "--ckpt-full", f["mesh"]])}
    out["one"] = train.main(FLAGS + ["--steps", "4", "--ckpt-full", f["one"]])
    out["mesh2_stdout"] = _torchrun(FLAGS + ["--steps", "2", "--restore",
                                             f["one"], "--ckpt-full",
                                             f["mesh2"]])
    out["one2"] = train.main(FLAGS + ["--steps", "2", "--restore", f["mesh"],
                                      "--ckpt-full", f["one2"]])
    out["files"] = {k: dict(np.load(v)) for k, v in f.items()}
    return out


def _assert_files(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **TOL)


def test_two_ranks_equal_one_process(runs):
    """The 2-rank launcher's gathered --ckpt-full equals the 1-process
    run's, leaf by leaf (params, moments, window, sketch, rel, alive)."""
    files = runs["files"]
    _assert_files(files["mesh"], files["one"])
    assert int(files["mesh"][".step"]) == 4


def test_rank_zero_prints_the_reference_lines(runs):
    text = runs["mesh_stdout"]
    assert text.count("arch=llama3.2-3b reduced=True params/agent=") == 1
    assert "mesh pod x agent = (2, 1) over gloo: 2 agents a rank" in text
    assert text.count("<shared>") == 1 and text.count("tokens/s") == 1
    assert text.count("saved full TrainState") == 1
    one = runs["one"]
    assert one["shared"] == [2]
    for i, row in enumerate(one["losses"]):
        line = next(ln for ln in text.splitlines()
                    if ln.startswith(f"step {i:4d} "))
        got = [float(x) for x in line.split("[")[1].split("]")[0].split()]
        np.testing.assert_allclose(got, row, atol=1e-3)


def test_checkpoints_restore_across_kinds(runs):
    """The 1-process file restored under 2 ranks and the 2-rank file
    restored in 1 process continue the same way."""
    files = runs["files"]
    assert "restored full TrainState" in runs["mesh2_stdout"]
    assert int(files["mesh2"][".step"]) == int(files["one2"][".step"]) == 6
    _assert_files(files["mesh2"], files["one2"])
    assert runs["one2"]["state"].know.alive.tolist() == [True] * 4


def test_production_meshes_refused_and_no_fallback():
    base = ["--device", "cpu", "--agents", "2", "--steps", "1"]
    for mesh, need in (("prod", 256), ("prod-multipod", 512)):
        with pytest.raises(ValueError, match=f"needs {need} devices"):
            train.main(base + ["--mesh", mesh])
    with pytest.raises(SystemExit):
        train.main(base + ["--mesh", "pods"])          # no --pods
    import torch.distributed as dist
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(["--device", "cuda", "--mesh", "pods", "--agents",
                        "2", "--steps", "1", "--exchange",
                        "topology=hierarchical", "--exchange", "degree=2",
                        "--exchange", "pods=1"])
        assert not dist.is_initialized()           # no gloo fallback
