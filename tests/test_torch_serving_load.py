"""Port parity: the serving load bench's twin
(``repro_torch.benchmarks.bench_serving``) against
``benchmarks/bench_serving.py``: the same request stream for a seed,
the same three gates on the same fixed numbers (PASS and FAIL), and a
tiny run on the host that completes every request and writes the
reference's JSON keys. Timing gates are not asserted here: on a shared
host they measure the host, so ``chip_smoke.py``'s ``[load]`` phase
holds them on the card.
"""
from __future__ import annotations

import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from benchmarks import bench_serving as r_bench  # noqa: E402
from repro import serving as r_serving  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.benchmarks import bench_serving as bench  # noqa: E402
from repro_torch.configs import get_arch_config  # noqa: E402

ARGS = types.SimpleNamespace(requests=12, agents=4, prompt_pad=8,
                             new_tokens=8, slack_p50=6.0, slack_p99=15.0)


@pytest.mark.parametrize("seed", [0, 3])
def test_request_stream_equals_the_reference(seed):
    cfg = get_arch_config("llama3.2-3b").reduced()
    want = r_bench.make_requests(cfg, ARGS, np.random.default_rng(seed))
    got = bench.make_requests(cfg, ARGS, np.random.default_rng(seed))
    assert [(r.rid, r.agent_id, r.prompt) for r in got] == \
        [(r.rid, r.agent_id, r.prompt) for r in want]
    assert all(isinstance(r, serving.GroupRequest) for r in got)


SUMMARIES = {
    "pass": dict(throughput_tok_s=30.0, latency_p50=2.0, latency_p99=5.0),
    "slow": dict(throughput_tok_s=10.0, latency_p50=9.0, latency_p99=30.0),
    "edge": dict(throughput_tok_s=12.0, latency_p50=6.0, latency_p99=15.0),
}


@pytest.mark.parametrize("case", sorted(SUMMARIES))
def test_gates_equal_the_reference(case):
    """Throughput and latency gates on fixed numbers (on their bounds
    in ``edge``): the same verdicts and fields as the reference's."""
    summary = SUMMARIES[case]
    load = {"offered_tok_s": 30.0}
    calib = {"t_prefill_s": 0.2, "t_step_s": 0.1}
    for gate, args in (("gate_throughput", (summary, load, 0.4)),
                       ("gate_latency", (summary, calib, ARGS))):
        assert getattr(bench, gate)(*args) == getattr(r_bench, gate)(*args)
    verdicts = (bench.gate_throughput(summary, load, 0.4)["pass"],
                bench.gate_latency(summary, calib, ARGS)["pass"])
    assert verdicts == {"pass": (True, True), "slow": (False, False),
                        "edge": (True, True)}[case]


@pytest.mark.parametrize("results,ok", [
    ({0: [1, 2], 1: [3]}, True),
    ({0: [1, 2]}, False),                       # request 1 never finished
    ({0: [], 1: [3]}, False),                   # no token
    ({0: [1] * 9, 1: [3]}, False)])             # past max_new_tokens
def test_completeness_gate_equals_the_reference(results, ok):
    engine = types.SimpleNamespace(results=results)
    got = bench.gate_completeness(
        engine, [serving.GroupRequest(i, 0, [1]) for i in range(2)], 8)
    want = r_bench.gate_completeness(
        engine, [r_serving.GroupRequest(i, 0, [1]) for i in range(2)], 8)
    assert got == want and got["pass"] is ok


def test_a_tiny_run_on_the_host_completes(tmp_path):
    """``--smoke --device cpu``: every request completes across the
    mid-run swap and the JSON carries the reference's keys (a timing
    gate that fails on a loaded host exits non-zero after writing it)."""
    path = tmp_path / "bench.json"
    try:
        bench.main(["--smoke", "--device", "cpu", "--agents", "2",
                    "--slots", "2", "--requests", "6", "--json",
                    str(path)])
    except SystemExit as exc:
        assert "serving load gate FAILED" in str(exc)
    payload = json.loads(path.read_text())
    for key in ("bench", "arch", "agents", "slots", "requests",
                "new_tokens", "load", "router", "calibration", "open_loop",
                "summary", "rows", "gates"):
        assert key in payload, key
    assert payload["device"] == "cpu" and payload["full"] is False
    assert payload["gates"]["completeness"]["pass"]
    assert payload["open_loop"]["swapped"]
    assert payload["summary"]["swaps"] == 1
    assert len(payload["rows"]) == payload["requests"] == 6
    assert sorted(payload["gates"]) == ["completeness", "latency",
                                        "throughput"]
