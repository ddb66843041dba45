"""The paper's figures (Figs. 2–5) and the quickstart on the torch path,
held against the reference scripts: on the same fixed returns (the group
runners replaced) each twin computes the reference's ``checks`` and the
quickstart prints the reference's lines; each runner builds the
reference's group (environment, ``GroupSpec``, ``DQNConfig``, AdamW).
At a tiny budget on the CPU each twin runs end to end with finite
rewards of the reference's shapes, and it runs on the card unless told
otherwise (with no card and no ``device="cpu"`` it raises). The checks'
verdicts need the reference's budgets: minutes a figure (README).

Run as a script, it measures how often the figures' outcomes occur on
each side, with many groups in one run on the CPU, reference and port,
each with its own draws (``common.run_disjoint_groups``: ``--groups``
disjoint groups of ``--size`` A2C or DQN agents (``--agent``), each
group one figure's group):

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/test_torch_paper_figs.py \
        --groups 16 --size 2 --epochs 5000 --seeds 0 1

The port's side alone, on the card, is
``python -m repro_torch.benchmarks.group_outcomes``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import io
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from benchmarks import common as ref_common  # noqa: E402
from benchmarks import paper_fig2_a2c as ref_fig2  # noqa: E402
from benchmarks import paper_fig5_dqn as ref_fig5  # noqa: E402
from benchmarks import paper_fig34_scaling as ref_fig34  # noqa: E402
from repro_torch.benchmarks import common, group_outcomes, \
    paper_fig2_a2c, paper_fig5_dqn, paper_fig34_scaling  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs.base import GroupSpec  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.rl import dqn, envs  # noqa: E402


def _assert_reference_keys(module, checks, tail=False):
    """Each check name stands in the reference script's ``main`` (its
    checks need the paper's budget to run); ``tail``: an f-string key,
    matched after its ``{n}``."""
    src = inspect.getsource(module.main)
    for key in checks:
        assert (key[1:] if tail else f'"{key}"') in src, key


def _finite(res, epochs, n):
    assert isinstance(res, common.RunResult)
    assert res.rewards.shape == (epochs, n)
    assert np.isfinite(res.rewards).all() and res.epochs_per_s > 0
    assert res.device == "cpu"


def test_fig2_twin_runs_and_returns_the_reference_checks(capsys):
    out = paper_fig2_a2c.main(epochs=30, device="cpu")
    _assert_reference_keys(ref_fig2, out["checks"])
    assert len(out["checks"]) == 3
    _finite(out["single"], 30, 1)
    _finite(out["group"], 30, 2)
    assert "epochs/s on cpu" in capsys.readouterr().out


def test_fig34_twin_runs_and_returns_the_reference_checks():
    out = paper_fig34_scaling.main(epochs4=24, epochs6=16, device="cpu",
                                   verbose=False)
    assert list(out["checks"]) == [
        "4-agent: majority of agents near-optimal",
        "6-agent: majority of agents near-optimal"]
    _assert_reference_keys(ref_fig34, out["checks"], tail=True)
    _finite(out[4], 24, 4)
    _finite(out[6], 16, 6)


def test_fig5_twin_runs_and_returns_the_reference_checks():
    """60 epochs: sharing from epoch 25 and one share step at epoch 50
    (minibatch max(50, 60 // 10))."""
    out = paper_fig5_dqn.main(epochs=60, device="cpu", verbose=False)
    _assert_reference_keys(ref_fig5, out["checks"])
    assert len(out["checks"]) == 2
    _finite(out["single"], 60, 1)
    _finite(out["group"], 60, 2)


def test_quickstart_twin_prints_the_reference_lines(capsys):
    rewards = quickstart.main(epochs=30, threshold=10, device="cpu")
    assert rewards.shape == (30, 2) and np.isfinite(rewards).all()
    out = capsys.readouterr().out
    assert "agent 1: mean reward" in out and "(after group sharing)" in out
    assert "knowledge sharing starts at epoch 10" in out
    assert quickstart.EPOCHS == 1_500 and quickstart.THRESHOLD == 600


@pytest.mark.parametrize("run", [
    lambda: paper_fig2_a2c.main(epochs=2, verbose=False),
    lambda: paper_fig5_dqn.main(epochs=2, verbose=False),
    lambda: paper_fig34_scaling.main(2, 2, verbose=False),
    lambda: quickstart.main(epochs=2),
    lambda: dqn.make_dqn_group(envs.CartPole(), optim.adamw(1e-3),
                               GroupSpec(n_agents=2), torch.Generator()),
], ids=["fig2", "fig5", "fig34", "quickstart", "make_dqn_group"])
def test_twins_default_to_the_card(run, monkeypatch):
    """With no card and no ``device="cpu"`` the twins and the DDADQN
    entry point raise, rather than run on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run()


def _rewards(scenario, n, epochs):
    """Fixed (epochs, n) returns: per agent, a floor of 0, 40 or 85 under
    uniform rewards in [9, 100], and 100 at a rate from 0 to 1, so that
    across scenarios every figure's check both holds and fails; some
    agents sit on a check's edge (a tail mean of exactly 80, or exactly
    90 % or 99 % of the tail at 100)."""
    rng = np.random.default_rng((scenario, n, epochs))
    r = rng.uniform(9.0, 100.0, (epochs, n))
    r = np.maximum(r, rng.choice([0.0, 40.0, 85.0], size=n))
    locked = rng.choice([0.0, 0.5, 0.85, 0.95, 0.995, 1.0], size=n)
    r[rng.random((epochs, n)) < locked] = 100.0
    tail = max(1, int(epochs * 0.2))
    for a, edge in enumerate(rng.choice(4, size=n, p=[.55, .15, .15, .15])):
        if edge == 1:
            r[:, a] = 80.0
        elif edge > 1:
            r[-tail:, a] = 100.0
            r[-tail:][:round(tail * (0.1 if edge == 2 else 0.01)), a] = 50.0
    return r.astype(np.float32)


def _fake_runner(real, result, scenario, calls):
    """A stand-in for ``real`` (a ``run_*_group``) that records its bound
    arguments (all but ``device``) and returns the scenario's rewards."""
    sig = inspect.signature(real)

    def run(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        got = {k: v for k, v in bound.arguments.items() if k != "device"}
        calls.append(got)
        rewards = _rewards(scenario, got["n_agents"], got["epochs"])
        extra = {"device": "cpu"} if "device" in sig.parameters else {}
        return result(rewards=rewards, wall_s=1.0, spec=None, **extra)

    return run


FIGURES = {
    "fig2": (ref_fig2, paper_fig2_a2c, "run_a2c_group",
             [dict(epochs=500, seed=0), dict(epochs=1_000, seed=3)]),
    "fig5": (ref_fig5, paper_fig5_dqn, "run_dqn_group",
             [dict(epochs=500, seed=0), dict(epochs=2_000, seed=2)]),
    "fig34": (ref_fig34, paper_fig34_scaling, "run_a2c_group",
              [dict(epochs4=500, epochs6=400, seed=0),
               dict(epochs4=800, epochs6=600, seed=5)]),
}


@pytest.mark.parametrize("fig", sorted(FIGURES))
def test_twin_checks_equal_the_reference_on_the_same_returns(fig,
                                                             monkeypatch):
    """Both sides' ``main`` run on the same fixed returns (the group
    runners replaced): the same runner arguments and the same ``checks``
    on every scenario, with each check seen both to hold and to fail."""
    ref_mod, port_mod, runner, kwargs_list = FIGURES[fig]
    seen = {}
    for kwargs in kwargs_list:
        for scenario in range(24):
            out = {}
            for side, mod, real, result in (
                    ("reference", ref_mod, getattr(ref_common, runner),
                     ref_common.RunResult),
                    ("port", port_mod, getattr(common, runner),
                     common.RunResult)):
                calls = []
                monkeypatch.setattr(mod, runner, _fake_runner(
                    real, result, scenario, calls))
                kw = dict(kwargs, verbose=False)
                if side == "port":
                    kw["device"] = "cpu"
                checks = mod.main(**kw)["checks"]
                out[side] = calls, {k: bool(v) for k, v in checks.items()}
            assert out["port"] == out["reference"], (kwargs, scenario)
            for k, v in out["port"][1].items():
                seen.setdefault(k, set()).add(v)
    assert seen and all(v == {True, False} for v in seen.values()), seen


@pytest.mark.parametrize("fig", sorted(FIGURES))
def test_disjoint_schedule_is_the_reference_figures(fig, monkeypatch):
    """The outcome study's groups share on their figure's schedule: the
    threshold (and, where a group shares, the minibatch) the reference
    script gives its runner for a group of that size."""
    ref_mod, _, runner, kwargs_list = FIGURES[fig]
    agent = "dqn" if runner == "run_dqn_group" else "a2c"
    calls = []
    monkeypatch.setattr(ref_mod, runner, _fake_runner(
        getattr(ref_common, runner), ref_common.RunResult, 0, calls))
    for kwargs in kwargs_list:
        ref_mod.main(**kwargs, verbose=False)
    assert calls
    for c in calls:
        threshold, minibatch = common.disjoint_schedule(
            agent, c["n_agents"], c["epochs"])
        assert threshold == c["threshold"], c
        if c["n_agents"] > 1:
            assert minibatch == c["minibatch"], c


@pytest.mark.parametrize("runner,n,epochs,threshold,kw", [
    ("run_a2c_group", 1, 5_000, 5_001, {}),
    ("run_a2c_group", 4, 4_000, 2_000, dict(minibatch=50, seed=3)),
    ("run_dqn_group", 1, 4_000, 4_001, {}),
    ("run_dqn_group", 2, 7_000, 3_010, dict(minibatch=700, seed=1)),
    ("run_dqn_group", 2, 300, 129, dict(lr=3e-4, m_pieces=8)),
])
def test_runners_build_the_reference_group(runner, n, epochs, threshold,
                                           kw, monkeypatch):
    """Each side's runner hands its group builder the same environment,
    ``GroupSpec``, ``DQNConfig`` and AdamW arguments."""
    builder = runner.replace("run_", "make_")

    class Built(Exception):
        pass

    got = {}
    for side, mod in (("reference", ref_common), ("port", common)):
        rec = got[side] = {}

        def build(env, opt, spec, key, cfg=None, rec=rec, **_):
            rec.update(env=dataclasses.asdict(env),
                       spec=dataclasses.asdict(spec), opt=opt,
                       cfg=cfg and dataclasses.asdict(cfg))
            raise Built

        monkeypatch.setattr(mod, builder, build)
        monkeypatch.setattr(mod, "optim", types.SimpleNamespace(
            adamw=lambda *a, **k: (a, k)))
        extra = {"device": "cpu"} if side == "port" else {}
        with pytest.raises(Built):
            getattr(mod, runner)(n, epochs, threshold, **kw, **extra)
    assert got["port"] == got["reference"]
    if runner == "run_dqn_group":
        assert got["port"]["cfg"]["eps_decay"] == max(500, epochs // 4)


@pytest.mark.parametrize("epochs,frac", [(7, 0.2), (500, 0.2), (1, 0.2),
                                         (333, 0.5)])
def test_run_result_tail_and_summary_equal_the_reference(epochs, frac):
    r = _rewards(epochs, 3, epochs)
    ref = ref_common.RunResult(rewards=r, wall_s=2.0, spec=None)
    port = common.RunResult(rewards=r, wall_s=2.0, spec=None,
                            device="cpu")
    np.testing.assert_array_equal(port.tail(frac), ref.tail(frac))
    # the agent lines; the port's header adds the epochs/s and device
    assert (port.summary("x").splitlines()[1:]
            == ref.summary("x").splitlines()[1:])


def test_quickstart_prints_the_reference_lines_on_the_same_returns(
        monkeypatch):
    """The reference quickstart's printing code, run on the returns the
    port's quickstart got, prints the port's lines."""
    rewards = np.full((900, 2), 50.0, np.float32) + [0.0, 7.0]
    rewards[-300:] = [100.0, 93.0]     # an edge at each end of the two
    rewards[-301] = rewards[300] = 0.0  # means the lines print
    monkeypatch.setattr(quickstart, "run_a2c_group", lambda *a, **k:
                        common.RunResult(rewards, 3.0, None, "cpu"))
    port_out = io.StringIO()
    with contextlib.redirect_stdout(port_out):
        quickstart.main(epochs=900, threshold=300, device="cpu")
    src = (Path(ref_fig2.__file__).parents[1] / "examples" /
           "quickstart.py").read_text()
    ref_out = io.StringIO()
    with contextlib.redirect_stdout(ref_out):
        exec(src[src.index("for a in range(spec.n_agents)"):],
             {"spec": types.SimpleNamespace(n_agents=2),
              "rewards": rewards, "THRESHOLD": 300})
    assert (port_out.getvalue().splitlines()[:-1]
            == ref_out.getvalue().splitlines())


def test_runs_of_different_sizes_draw_independent_streams():
    """A run's stream is fixed by (seed, n_agents): the same pair draws
    the same, another group size or seed draws otherwise."""
    def draws(seed, n):
        return torch.rand(16, generator=common.run_generator(seed, n,
                                                             "cpu"))

    assert torch.equal(draws(0, 2), draws(0, 2))
    assert not torch.equal(draws(0, 1), draws(0, 2))
    assert not torch.equal(draws(0, 2), draws(1, 2))


def test_group_outcomes_counts_each_outcome():
    r = np.full((10, 6), 50.0, np.float32)   # 3 groups of 2
    r[:, 0] = 100.0                          # group 0: one locked agent,
    r[:, 1] = 90.0                           # both above 80
    r[:, 2] = 9.0                            # group 1: one stuck agent
    r[-1, 4] = 100.0                         # group 2: one 100 in 2 rows
    got = common.group_outcomes(r, 3, 2)
    assert got == {
        "groups with an agent at frac@100 > 0.9": 1,
        "groups with a majority above 80": 1,
        "agents at frac@100 > 0.9": 1,
        "agents below 50": 1,
        "agents stuck below 12": 1,
        "tail mean": float(r[-2:].mean()),
    }


@pytest.mark.parametrize("agent", ["a2c", "dqn"])
def test_outcome_study_runs_disjoint_groups(agent):
    out = group_outcomes.main(groups=3, size=2, epochs=12, seeds=(0,),
                              device="cpu", verbose=False, agent=agent)
    counts = out[0]
    assert 0 <= counts["agents below 50"] <= 6
    assert np.isfinite(counts["tail mean"])
    with pytest.raises(ValueError, match="agent must be"):
        common.disjoint_schedule("ppo", 2, 12)


def _disjoint_groups(side, groups, size, epochs, seed, agent="a2c"):
    """The (epochs, groups · size) returns of one run of ``groups``
    disjoint groups of ``size`` ``agent`` agents on ``side``, on the
    CPU."""
    if side == "port":
        return common.run_disjoint_groups(groups, size, epochs, seed=seed,
                                          device="cpu", agent=agent).rewards
    import jax
    from benchmarks.common import DQNConfig as RefDQNConfig
    from repro import optim as ref_optim
    from repro.configs.base import GroupSpec as RefSpec
    from repro.core.topology import _from_neighbor_lists
    from repro.rl import CartPole, make_a2c_group, make_dqn_group
    n = groups * size
    nbrs = [[size * (i // size) + j for j in range(size)]
            for i in range(n)]
    threshold, minibatch = common.disjoint_schedule(agent, size, epochs)
    spec = RefSpec(n_agents=n, threshold=threshold, minibatch=minibatch,
                   m_pieces=32)
    key = jax.random.PRNGKey(seed)
    topology = _from_neighbor_lists(nbrs)
    if agent == "dqn":
        ddal, gs = make_dqn_group(
            CartPole(), ref_optim.adamw(1e-3), spec, key,
            RefDQNConfig(capacity=10_000, eps_decay=max(500, epochs // 4)),
            topology=topology)
    else:
        ddal, gs = make_a2c_group(CartPole(), ref_optim.adamw(3e-3), spec,
                                  key, topology=topology)
    _, m = jax.jit(lambda g, k: ddal.run(g, k, epochs))(
        gs, jax.random.fold_in(key, 1))
    return np.asarray(m["return"])


def main():
    import argparse
    import time
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--groups", type=int, default=16)
    ap.add_argument("--size", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=5_000)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--agent", default="a2c", choices=["a2c", "dqn"])
    ap.add_argument("--sides", nargs="+", default=["reference", "port"],
                    choices=["reference", "port"])
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    print(f"{args.groups} disjoint groups of {args.size} {args.agent} "
          f"agents, {args.epochs} epochs, on the CPU; over the tail "
          f"(last 20 %)")
    for seed in args.seeds:
        for side in args.sides:
            t0 = time.perf_counter()
            r = _disjoint_groups(side, args.groups, args.size, args.epochs,
                                 seed, args.agent)
            counts = common.group_outcomes(r, args.groups, args.size)
            print(f"seed {seed} {side} ({time.perf_counter() - t0:.0f} s): "
                  + ", ".join(f"{k}: {v}" for k, v in counts.items()))


if __name__ == "__main__":
    main()
