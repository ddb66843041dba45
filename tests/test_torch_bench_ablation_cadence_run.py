"""The twins of ``benchmarks/ablation_ddal.py``,
``bench_train_throughput.py`` and ``run.py`` against the reference's,
on the CPU, with nothing trained at the ablation's size.

Held: the ablation's eight cells (names, ``GroupSpec`` fields, delay
matrices) equal the reference's, captured by patching ``_run`` on both
sides, and its cut budgets keep sharing from 40 %; a delayed cell
counts the pieces heard by its last share step; the cadence rows'
keys include the reference's and their share counts equal the share
steps the reference's trainer reports, at ``reduced()`` cut to one
layer; ``run.py``'s roofline table prints the reference's rows from the
same records, and its quick path drives the port's twins."""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from benchmarks import ablation_ddal as ref_abl  # noqa: E402
from benchmarks import bench_train_throughput as ref_cad  # noqa: E402
from benchmarks import run as ref_run  # noqa: E402
from repro_torch.benchmarks import ablation_ddal as abl  # noqa: E402
from repro_torch.benchmarks import bench_train_throughput as cad  # noqa: E402
from repro_torch.benchmarks import run  # noqa: E402


def _captured(module, monkeypatch, result):
    calls = []

    def fake(spec, delay=None, **kw):
        calls.append((spec, None if delay is None else np.asarray(delay),
                      kw))
        return result
    monkeypatch.setattr(module, "_run", fake)
    return calls


def test_ablation_cells_equal_the_reference(monkeypatch):
    ref_calls = _captured(ref_abl, monkeypatch, (1.0, 0.0))
    ref_rows = ref_abl.main(verbose=False)
    calls = _captured(abl, monkeypatch, (1.0, 0.0, 0, 0, 1.0))
    rows = abl.main(verbose=False)
    assert [r[0] for r in rows] == [r[0] for r in ref_rows]
    assert len(calls) == len(ref_calls) == 8
    for (spec, delay, kw), (rspec, rdelay, _) in zip(calls, ref_calls):
        want = dataclasses.asdict(rspec)
        got = dataclasses.asdict(spec)
        for field in want.keys() & got.keys():
            assert got[field] == want[field], (field, spec)
        if rdelay is None:
            assert delay is None
        else:
            np.testing.assert_array_equal(delay, rdelay)
        assert kw["epochs"] == 2_500


def test_ablation_cut_budget_and_cell_filter(monkeypatch):
    calls = _captured(abl, monkeypatch, (1.0, 0.0, 0, 0, 1.0))
    rows = abl.main(verbose=False, epochs=250,
                    which=["2", "T=sqrt (stale)", "7"])
    assert [r[0] for r in rows] == ["delay=150", "T=sqrt (stale)",
                                    "topology=ring (4 agents)"]
    assert [c[0].threshold for c in calls] == [100] * 3
    assert [c[0].minibatch for c in calls] == [100] * 3
    assert calls[1][0].t_weighting == "sqrt"
    assert all(c[2]["epochs"] == 250 for c in calls)


def test_ablation_cell_runs_on_the_host():
    mean, std, launches, heard, eps = abl._run(abl.cells(20)[7][1],
                                               epochs=20, device="cpu")
    assert np.isfinite(mean) and np.isfinite(std) and launches == 0
    assert heard == 0                 # sharing from epoch 8, cadence 100
    assert eps > 0


def test_ablation_counts_pieces_heard_by_the_last_share_step():
    # delay 50, sharing from 100: the other agent's pieces of 100..150
    # arrive at 150..200, by the share step at 200
    _, spec, delay = abl.cells(250)[1]
    mean, _, _, heard, _ = abl._run(spec, delay=delay, epochs=250,
                                    device="cpu")
    assert np.isfinite(mean)
    assert heard == 51


class _OneLayer:
    """An arch config whose ``reduced()`` keeps one layer."""

    def __init__(self, cfg):
        self.cfg = cfg

    def reduced(self):
        return dataclasses.replace(self.cfg.reduced(), n_layers=1)


def test_cadence_rows_match_reference(monkeypatch):
    steps = 4
    real_get = ref_cad.get_arch_config
    monkeypatch.setattr(ref_cad, "get_arch_config",
                        lambda arch: _OneLayer(real_get(arch)))
    shared = []

    class RecordingJax:
        """``jax`` with ``jit`` wrapped to record each step's share flag
        (the reference jits its step)."""

        def __getattr__(self, name):
            return getattr(jax, name)

        def jit(self, fn):
            step = jax.jit(fn)
            seen = []
            shared.append(seen)

            def wrapped(state, batch):
                state, m = step(state, batch)
                seen.append(int(m["shared"]))
                return state, m
            return wrapped
    monkeypatch.setattr(ref_cad, "jax", RecordingJax())
    ref_rows = ref_cad.main(steps=steps, verbose=False)

    real_config = cad.bench_config
    monkeypatch.setattr(cad, "bench_config", lambda *a, **k: real_config(
        *a, **k).with_(n_layers=1))
    rows = cad.main(steps=steps, verbose=False, device="cpu")
    assert [r["cadence"] for r in rows] == [r["cadence"] for r in ref_rows]
    for r, want, seen in zip(rows, ref_rows, shared):
        assert set(want) <= set(r)
        assert r["exchanges_per_step"] == want["exchanges_per_step"]
        assert r["shares"] == sum(seen[1:]) == r["planned_shares"]
        assert r["tokens_per_s"] > 0


RECORDS = [
    {"arch": "llama3.2-3b", "shape": "decode_32k", "ok": True,
     "roofline": {"dominant": "memory", "t_compute": 1.56e-05,
                  "t_memory": 0.023, "t_collective": 0.000231,
                  "useful_ratio": 0.21},
     "memory": {"total_bytes_per_device": 8.1e9}},
    {"arch": "mamba2-780m", "shape": "prefill_32k", "ok": True,
     "roofline": {"dominant": "collective", "t_compute": 0.0196,
                  "t_memory": 0.164, "t_collective": 0.387,
                  "useful_ratio": 0.36},
     "memory": None},
    {"arch": "yi-34b", "shape": "train_4k", "ok": False, "error": "x"},
]


def _printed(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


def test_roofline_table_prints_the_references_rows(tmp_path):
    path = tmp_path / "dry.json"
    path.write_text(json.dumps(RECORDS))
    assert _printed(run._roofline_table, str(path)) == _printed(
        ref_run._roofline_table, str(path))


def test_run_quick_drives_the_twins(monkeypatch, tmp_path):
    from repro_torch.benchmarks import bench_train_throughput, \
        bench_wavg_kernel
    called = []
    monkeypatch.setattr(bench_wavg_kernel, "main",
                        lambda argv: called.append(("wavg", argv)))
    monkeypatch.setattr(bench_train_throughput, "main",
                        lambda **kw: called.append(("cadence", kw)))
    path = tmp_path / "dry.json"
    path.write_text(json.dumps(RECORDS))
    out = _printed(run.main, ["--quick", "--skip-rl", "--device", "cpu",
                              "--dryrun", str(path)])
    assert called == [("wavg", ["--device", "cpu", "--smoke"]),
                      ("cadence", {"steps": 4, "device": "cpu"})]
    assert "2/3 pairs" in out and "mamba2-780m" in out
