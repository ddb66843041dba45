"""Topology scaling sweep on the torch path — the twin of
``benchmarks/bench_topology_scaling.py``: epoch time + delay-line
memory vs group size for the sparse neighbor-indexed delay line.

The dense all-to-all delay line is O(n²·D·|params|); the sparse one is
O(n·k·D). The sweep runs the real DDAL loop (toy quadratic agents, so
agent compute is negligible and the exchange dominates) over
n ∈ {4, 16, 64, 256} × topology and reports per-epoch time (host
clock, the card synchronised) plus the delay line's bytes, summed over
the ``SparseInFlight`` planes, next to the dense-equivalent footprint.
``dynamic_k`` rows resample the gossip table every 5 epochs
(``GroupSpec.resample_every``) — the same (n, k, D) delay-line shape
as static ``random_k``, so their memory must match exactly. The
``dense(seed)`` baseline runs the port's dense ``InFlight`` / ``send``
/ ``deliver`` (``core/knowledge.py``) through the same toy loop, the
share step (``weighted_average``, the fused kernel on the card) every
epoch as the reference's does.

The reference's acceptance targets: n=64 with random_k(k=4) must beat
the dense n=16 epoch time, its delay-line bytes must be < 10 % of the
dense n=64 equivalent, and n=64 dynamic_k delay-line bytes must equal
static random_k's. These lines are printed, never a non-zero exit, as
in the reference.

``--hetero`` adds the adaptive-wiring ablation: a heterogeneous
CartPole + GridWorld DDA3C group (observations padded to a shared
space of 25, actions folded back by a modulus), static vs dynamic
gossip × uniform vs learned (grad-cosine) relevance, reporting per-env
mean return and the learned within-env / cross-env relevance split.
The port's envs are batched over agents, so each agent steps both
padded envs and keeps the one its ``env_id`` names (the reference's
``lax.cond``).

``--pods`` runs the pod dispatch sweep instead: the hierarchical
combine decomposed onto a (pod, agent) placement
(``core.pod_dispatch``), the analytic cross-pod bytes per share step
against the flat combine's, plus the combine time of both (CUDA events
on the card). Acceptance, which exits non-zero: at fixed pod count the
dispatched cross-pod bytes do not grow with agent count, and they
scale as pods · (pods − 1).

``--churn`` runs the elastic-membership overhead rows instead: epoch
time with the alive mask threaded (all alive, and with ~25 % of the
roster dead) vs the non-elastic program; gate (non-zero exit):
all-alive overhead ≤ 2 %.

Draws: ``random_k`` tables are numpy's on both packages; ``dynamic_k``
tables come from the port's own round draws
(``core.topology.gossip_uniforms``), the hetero groups' weights and
episodes from ``torch.Generator`` seeds, so those runs are held by
their own numbers, not the reference's. Every run writes
``BENCH_topology_scaling[_pods]_torch.json`` next to this file
(override with ``--json``).

    python -m repro_torch.benchmarks.bench_topology_scaling [--smoke]
        [--hetero] [--pods] [--churn] [--device cuda|cpu] [--json PATH]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.benchmarks import common
from repro_torch.benchmarks.common import (best_ms, clone_state,
                                           device_info, epoch_ms,
                                           pair_best_s)
from repro_torch.common.device import resolve_device
from repro_torch.configs.base import GroupSpec
from repro_torch.core.ddal import DDAL


def _default_json(mode: str) -> str:
    """Per-mode default path so the --pods sweep does not clobber the
    topology sweep's results."""
    tag = "" if mode == "sweep" else f"_{mode}"
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"BENCH_topology_scaling{tag}_torch.json")


def write_json(path: str, mode: str, rows: list, device) -> None:
    common.write_json(path, {"bench": "topology_scaling", "mode": mode,
                             **device_info(device), "rows": rows})


def flight_bytes(flight) -> int:
    """Bytes of a delay line's planes (every tensor field)."""
    return sum(x.numel() * x.element_size() for x in flight
               if isinstance(x, torch.Tensor))


def dense_equiv_bytes(n: int, max_delay: int, n_params: int) -> int:
    """What the dense (n_dst, D+1, n_src, P) layout would hold (grads
    fp32 + T / R fp32 + valid bool)."""
    d1 = max_delay + 1
    return n * n * d1 * (n_params * 4 + 4 + 4 + 1)


def make_toy_group(spec: GroupSpec, n_params: int, device="cpu"):
    """Quadratic agents: grads = w - target (a scalar target per agent,
    so the exchange, not agent state traffic, dominates)."""
    def gen(state, g):
        del g
        return state["w"] - state["t"], {}, state

    def app(state, g):
        return {"w": state["w"] - 0.1 * g, "t": state["t"]}

    ddal = DDAL(spec, gen, app, lambda s: s["w"], device=device)
    n = spec.n_agents
    gs = ddal.init({
        "w": torch.zeros((n, n_params), dtype=torch.float32, device=device),
        "t": torch.arange(1, n + 1, dtype=torch.float32,
                          device=device)[:, None],
    })
    return ddal, gs


def _dense_seed_thunk(n: int, n_params: int, epochs: int,
                      max_delay: int, minibatch: int,
                      m_pieces: int = 8, device="cpu"):
    """A runner of the dense all-to-all delay line (``K.InFlight``)
    through the same toy epoch loop — the baseline the sparse delay
    line replaces. Returns (thunk, flight)."""
    from repro_torch.core import knowledge as K
    from repro_torch.core.weighting import training_experience

    w0 = torch.zeros((n, n_params), dtype=torch.float32, device=device)
    tgt = torch.arange(1, n + 1, dtype=torch.float32, device=device)[:, None]
    stores0 = K.make_store(n, m_pieces, n_params, device)
    flight0 = K.make_inflight(n, max_delay, n_params, device)
    delay = np.zeros((n, n), np.int32)
    R = torch.ones((n, n), dtype=torch.float32, device=device)

    def run():
        w, stores, flight = w0, stores0, flight0
        for e in range(epochs):
            grads = w - tgt
            Tw = torch.full((n,), training_experience(e, "epochs"),
                            dtype=torch.float32, device=device)
            flight = K.send(flight, grads, Tw, R, delay, e, True)
            flight, stores = K.deliver(flight, stores, e)
            gbar, wsum = K.weighted_average(stores)
            upd = w - 0.1 * gbar
            do = (wsum > 0) & ((e % minibatch) == 0)
            w = torch.where(do[:, None], upd, w)
        return w

    return run, flight0


def bench_dense_seed(n: int, n_params: int, epochs: int,
                     max_delay: int, minibatch: int, device="cpu") -> dict:
    thunk, flight0 = _dense_seed_thunk(n, n_params, epochs, max_delay,
                                       minibatch, device=device)
    ms = epoch_ms(thunk, epochs, device)
    fb = flight_bytes(flight0)
    return {"n": n, "topology": "dense(seed)", "k": n,
            "epoch_ms": ms, "flight_mb": fb / 2**20,
            "dense_mb": fb / 2**20, "mem_ratio": 1.0}


def sparse_spec(n: int, topology: str, degree: int, epochs: int,
                max_delay: int, minibatch: int, m_pieces: int = 8,
                resample_every: int = 0) -> GroupSpec:
    """The reference's spec of one sweep cell."""
    name = "random_k" if topology == "dynamic_k" else topology
    if name == "random_k":
        degree = min(degree, n - 1)    # gossip degree must be < n
    return GroupSpec(n_agents=n, threshold=0, minibatch=minibatch,
                     m_pieces=m_pieces, topology=name,
                     degree=degree, max_delay=max_delay,
                     resample_every=(resample_every
                                     if topology == "dynamic_k" else 0))


def _sparse_thunk(n: int, topology: str, degree: int, n_params: int,
                  epochs: int, max_delay: int, minibatch: int,
                  m_pieces: int = 8, resample_every: int = 0,
                  device="cpu"):
    spec = sparse_spec(n, topology, degree, epochs, max_delay, minibatch,
                       m_pieces, resample_every)
    ddal, gs = make_toy_group(spec, n_params, device)

    def run():
        return ddal.run(clone_state(gs), None, epochs)[0].agent_states["w"]
    return run, ddal, gs


def acceptance_pair(n_params: int, epochs: int, max_delay: int,
                    minibatch: int, degree: int, device="cpu",
                    repeats: int = 20):
    """Interleaved best-of-``repeats`` timing of the two acceptance
    configs (dense(seed) n=16 vs sparse random_k n=64)."""
    td, _ = _dense_seed_thunk(16, n_params, epochs, max_delay,
                              minibatch, device=device)
    ts, _, _ = _sparse_thunk(64, "random_k", degree, n_params, epochs,
                             max_delay, minibatch, device=device)
    best_d, best_s = pair_best_s(td, ts, device, repeats)
    return best_d / epochs * 1e3, best_s / epochs * 1e3


def bench_one(n: int, topology: str, degree: int, n_params: int,
              epochs: int, max_delay: int, minibatch: int = 5,
              resample_every: int = 5, device="cpu") -> dict:
    thunk, ddal, gs = _sparse_thunk(n, topology, degree, n_params,
                                    epochs, max_delay, minibatch,
                                    resample_every=resample_every,
                                    device=device)
    ms = epoch_ms(thunk, epochs, device)
    fb = flight_bytes(gs.flight)
    db = dense_equiv_bytes(n, ddal.max_delay, n_params)
    return {
        "n": n, "topology": topology, "k": ddal.static_topology.degree,
        "epoch_ms": ms, "flight_mb": fb / 2**20,
        "dense_mb": db / 2**20, "mem_ratio": fb / db,
    }


# ---------------------------------------------------------------------
# the pod dispatch sweep
# ---------------------------------------------------------------------
def pod_knowledge(n: int, n_params: int, device="cpu"):
    """The sweep's window: numpy draws seeded 0, as the reference's."""
    from repro_torch.core.sharded_ddal import Knowledge
    rng = np.random.default_rng(0)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    return Knowledge(
        tg={"w": f32(rng.normal(size=(n, n_params)))},
        tsum=f32(rng.uniform(1, 3, n)),
        rg={"w": f32(rng.normal(size=(n, n_params)))},
        rsum=f32(rng.uniform(1, 3, n)))


def pod_bytes(pods: int, pod_size: int, n_params: int) -> dict:
    """The analytic traffic of one pod cell: directed leader edges,
    dispatched cross-pod bytes and flat-combine bytes per share step."""
    from repro_torch.core import topology as T
    from repro_torch.core.pod_dispatch import (cross_pod_bytes,
                                               flat_exchange_bytes,
                                               split_topology)
    n = pods * pod_size
    topo = T.hierarchical(n, pod_size)
    lay = T.hierarchical_layout(n, pod_size)
    edges = split_topology(topo, lay)
    return {"pods": pods, "n": n, "pod_size": pod_size,
            "l_edges": int(np.asarray(edges.ledge).sum()),
            "cross_mb": cross_pod_bytes(edges, n_params) / 2**20,
            "flat_mb": flat_exchange_bytes(topo, n_params) / 2**20}


def bench_pod_row(pods: int, pod_size: int, n_params: int,
                  device="cpu") -> dict:
    """One cell of the pod sweep: hierarchical(n = pods · pod_size)
    combined flat vs pod-dispatched (the one-device decomposition),
    with the analytic cross-pod traffic of both placements."""
    from repro_torch.core import topology as T
    from repro_torch.core.pod_dispatch import make_pod_dispatch
    from repro_torch.core.sharded_ddal import _combine_topo

    row = pod_bytes(pods, pod_size, n_params)
    n = row["n"]
    topo = T.hierarchical(n, pod_size)
    lay = T.hierarchical_layout(n, pod_size)
    know = pod_knowledge(n, n_params, device)
    pod = make_pod_dispatch(topo, lay)
    row["flat_ms"] = best_ms(lambda: _combine_topo(know, topo), device)
    row["pod_ms"] = best_ms(lambda: pod(know), device)
    return row


def pod_sweep(args, json_path=None, device="cpu") -> list:
    """Pod-count sweep at fixed n, then agent-count sweep at fixed pods
    — the second is the scaling acceptance: dispatched cross-pod bytes
    must be flat in n. The JSON record is written before the acceptance
    check, so a failing run still leaves its numbers behind."""
    n = 16 if args.smoke else 64
    pod_counts = [p for p in (1, 2, 4, 8) if p <= n // 2]
    rows = []
    print(f"pod dispatch sweep (n={n}, {args.params} params/agent):")
    print(f"{'pods':>5} {'n':>4} {'pod_sz':>6} {'l_edges':>7} "
          f"{'cross MB':>9} {'flat MB':>8} {'flat ms':>8} "
          f"{'pod ms':>7}")

    def show(r):
        rows.append(r)
        print(f"{r['pods']:5d} {r['n']:4d} {r['pod_size']:6d} "
              f"{r['l_edges']:7d} {r['cross_mb']:9.2f} "
              f"{r['flat_mb']:8.2f} {r['flat_ms']:8.2f} "
              f"{r['pod_ms']:7.2f}")

    for pods in pod_counts:
        show(bench_pod_row(pods, n // pods, args.params, device))

    fixed_pods = 4 if n >= 16 else 2
    print(f"\nfixed pods={fixed_pods}, growing agents:")
    sizes = (2, 4) if args.smoke else (4, 8, 16)
    agent_rows = [bench_pod_row(fixed_pods, s, args.params, device)
                  for s in sizes]
    for r in agent_rows:
        show(r)
    if json_path:
        write_json(json_path, "pods", rows, device)
    ok_n, ok_p = pod_acceptance(rows[:len(pod_counts)], agent_rows)
    print(f"\nacceptance: cross-pod bytes at pods={fixed_pods} flat "
          f"in n ({[round(r['cross_mb'], 3) for r in agent_rows]} MB "
          f"for n={[r['n'] for r in agent_rows]}) → "
          f"{'PASS' if ok_n else 'FAIL'}")
    print(f"acceptance: cross-pod bytes ∝ pods · k_leader "
          f"(= pods · (pods − 1) directed leader edges) → "
          f"{'PASS' if ok_p else 'FAIL'}")
    if not (ok_n and ok_p):
        raise SystemExit("pod dispatch traffic scaling FAILED")
    return rows


def pod_acceptance(pod_rows, agent_rows):
    """(flat in n, ∝ pods · (pods − 1)) of the sweep's rows."""
    ok_n = len({r["cross_mb"] for r in agent_rows}) == 1
    by_pods = {r["pods"]: r for r in pod_rows}
    counts = sorted(by_pods)
    ok_p = all(
        abs(by_pods[p]["cross_mb"]
            - p * (p - 1) / (q * (q - 1)) * by_pods[q]["cross_mb"])
        < 1e-9
        for p in counts for q in counts if p > q > 1)
    return ok_n, ok_p


# ---------------------------------------------------------------------
# elastic-membership churn overhead
# ---------------------------------------------------------------------
def _churn_thunk(n: int, elastic: bool, n_params: int, epochs: int,
                 minibatch: int, degree: int, dead=None, device="cpu"):
    """A toy-group runner, elastic or not; ``dead`` (bool mask)
    pre-kills agents so the steady-state cost with corpses on the
    roster is measurable too."""
    spec = GroupSpec(n_agents=n, threshold=0, minibatch=minibatch,
                     m_pieces=8, topology="random_k",
                     degree=min(degree, n - 1), elastic=elastic)
    ddal, gs = make_toy_group(spec, n_params, device)
    if dead is not None and dead.any():
        gs = ddal.kill(gs, dead)

    def run():
        return ddal.run(clone_state(gs), None, epochs)[0].agent_states["w"]
    return run


def churn_sweep(args, json_path=None, device="cpu") -> list:
    """The alive-mask tax: per-epoch time of the elastic exchange — all
    alive, and at steady state with ~25 % of the roster dead — against
    the non-elastic program on the same config, interleaved best-of-N.
    Gate: elastic with everyone alive costs ≤ 2 % over non-elastic.
    Rows merge into the topology-sweep JSON."""
    from repro_torch.core.chaos import chaos_schedule

    n = 16 if args.smoke else 64
    epochs = args.epochs or (10 if args.smoke else 50)
    repeats = 30 if args.smoke else 20
    base = _churn_thunk(n, False, args.params, epochs, args.minibatch,
                        args.degree, device=device)
    live = _churn_thunk(n, True, args.params, epochs, args.minibatch,
                        args.degree, device=device)
    best_b, best_l = pair_best_s(base, live, device, repeats)
    base_ms = best_b / epochs * 1e3
    live_ms = best_l / epochs * 1e3

    # steady state with corpses: the injector's most lethal epoch
    sched = chaos_schedule(0, n, 32, kill_prob=0.3, revive_after=6,
                           min_alive=max(1, n // 2))
    dead = ~sched[int(np.argmin(sched.sum(axis=1)))]
    dead_ms = epoch_ms(
        _churn_thunk(n, True, args.params, epochs, args.minibatch,
                     args.degree, dead=dead, device=device), epochs, device)

    overhead = live_ms / base_ms - 1.0
    rows = [
        {"n": n, "topology": "churn_off", "k": args.degree,
         "epoch_ms": base_ms, "alive": n},
        {"n": n, "topology": "churn_all_alive", "k": args.degree,
         "epoch_ms": live_ms, "alive": n,
         "overhead_pct": overhead * 100.0},
        {"n": n, "topology": "churn_dead", "k": args.degree,
         "epoch_ms": dead_ms, "alive": int(n - dead.sum())},
    ]
    print(f"elastic membership churn (n={n}, random_k(k="
          f"{args.degree}), {args.params} params/agent):")
    print(f"{'row':>16} {'alive':>6} {'epoch ms':>9}")
    for r in rows:
        print(f"{r['topology']:>16} {r['alive']:6d} "
              f"{r['epoch_ms']:9.3f}")
    if json_path:
        merged = rows
        if os.path.exists(json_path):
            with open(json_path) as f:
                old = json.load(f).get("rows", [])
            merged = [r for r in old if not str(
                r.get("topology", "")).startswith("churn")] + rows
        write_json(json_path, "sweep", merged, device)
    ok = overhead <= 0.02
    print(f"\nacceptance: all-alive elastic epoch {live_ms:.3f} ms vs "
          f"non-elastic {base_ms:.3f} ms (+{overhead:.2%}) "
          f"→ {'PASS' if ok else 'FAIL'} (gate ≤ 2%)")
    if not ok:
        raise SystemExit("elastic membership overhead gate FAILED")
    return rows


# ---------------------------------------------------------------------
# heterogeneous CartPole/GridWorld adaptive-wiring ablation
# ---------------------------------------------------------------------
_OBS_DIM, _N_ACT, _MAX_STEPS = 25, 4, 100


class _MixedState(NamedTuple):
    cart: Any                # the CartPole state of every agent
    grid: Any                # the GridWorld state of every agent
    done: torch.Tensor       # (n,) bool — the picked env's


@dataclasses.dataclass(frozen=True)
class _Mixed:
    """CartPole and GridWorld agents in one batched env over the shared
    (obs_dim=25, n_actions=4) space: observations zero-padded, surplus
    actions folded back with a modulus. Every agent steps both inner
    envs; ``env_id`` (n,) picks whose observation, reward and end it
    sees. Bench-local scaffolding, not a library env."""
    env_id: tuple
    obs_dim: int = _OBS_DIM
    n_actions: int = _N_ACT
    max_steps: int = _MAX_STEPS

    @property
    def inner(self):
        from repro_torch.rl.envs import CartPole, GridWorld
        return CartPole(), GridWorld(max_steps=_MAX_STEPS)

    def _grid(self, device) -> torch.Tensor:
        return torch.as_tensor(self.env_id, device=device) == 1

    def _pad(self, o):
        return torch.nn.functional.pad(o, (0, self.obs_dim - o.shape[-1]))

    def reset(self, gen, n):
        cart, grid = self.inner
        c = cart.reset(gen, n)
        return _MixedState(c, grid.reset(gen, n), c.done)

    def obs(self, s):
        cart, grid = self.inner
        g = self._grid(s.done.device)[:, None]
        return torch.where(g, self._pad(grid.obs(s.grid)),
                           self._pad(cart.obs(s.cart)))

    def step(self, s, a):
        cart, grid = self.inner
        cs, co, cr, cd = cart.step(s.cart, a % cart.n_actions)
        gs_, go, gr, gd = grid.step(s.grid, a % grid.n_actions)
        g = self._grid(a.device)
        done = torch.where(g, gd, cd)
        obs = torch.where(g[:, None], self._pad(go), self._pad(co))
        return _MixedState(cs, gs_, done), obs, torch.where(g, gr, cr), done


def bench_hetero(n: int, epochs: int, degree: int,
                 resample_every: int, relevance_mode: str,
                 seed: int = 0, device="cpu") -> dict:
    """One cell of the adaptive-wiring ablation: n/2 CartPole + n/2
    GridWorld A2C agents gossiping over random_k(degree), static or
    dynamic, uniform or learned relevance. Returns per-env tail mean
    return and the learned within-env vs cross-env relevance means."""
    from repro_torch import optim
    from repro_torch.benchmarks.common import run_generator
    from repro_torch.rl import make_a2c_group

    env_id = tuple(int(i % 2) for i in range(n))      # interleaved
    env = _Mixed(env_id)
    spec = GroupSpec(n_agents=n, threshold=min(20, max(1, epochs // 2)),
                     minibatch=5, m_pieces=16, topology="random_k",
                     degree=min(degree, n - 1),
                     resample_every=resample_every,
                     relevance_mode=relevance_mode)
    dev = resolve_device(device)
    gen = run_generator(seed, n, dev)
    ddal, gs = make_a2c_group(env, optim.adamw(3e-3), spec, gen,
                              device=dev, hidden=64)
    gs, metrics = ddal.run(gs, gen, epochs)
    rets = metrics["return"].cpu().numpy()            # (epochs, n)
    tail = rets[-max(1, epochs // 4):]
    ids = np.asarray(env_id)
    same = np.equal.outer(ids, ids)
    rel = gs.relevance.cpu().numpy()
    off = ~np.eye(n, dtype=bool)
    return {
        "resample": resample_every, "relevance": relevance_mode,
        "cart_ret": float(tail[:, ::2].mean()),
        "grid_ret": float(tail[:, 1::2].mean()),
        "rel_within": float(rel[same & off].mean()),
        "rel_cross": float(rel[~same].mean()),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--smoke", action="store_true",
                   help="CI fast path: n ≤ 16, few epochs")
    p.add_argument("--hetero", action="store_true",
                   help="run the heterogeneous CartPole/GridWorld "
                        "static-vs-dynamic × uniform-vs-learned "
                        "relevance ablation")
    p.add_argument("--pods", action="store_true",
                   help="run the pod dispatch sweep instead: cross-pod "
                        "bytes + combine time, flat vs two-level "
                        "placement")
    p.add_argument("--churn", action="store_true",
                   help="run the elastic-membership overhead rows "
                        "instead (gate: ≤ 2%% all-alive overhead)")
    p.add_argument("--hetero-epochs", type=int, default=None,
                   help="epochs per hetero ablation cell")
    p.add_argument("--resample-every", type=int, default=5,
                   help="dynamic_k gossip resample period")
    p.add_argument("--params", type=int, default=4096,
                   help="toy agent parameter count")
    p.add_argument("--epochs", type=int, default=None,
                   help="epochs per timing run")
    p.add_argument("--degree", type=int, default=4)
    p.add_argument("--minibatch", type=int, default=5,
                   help="eq. 4 update cadence (paper uses 100)")
    p.add_argument("--max-delay", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", default=None,
                   help="machine-readable results path (defaults to "
                        "BENCH_topology_scaling[_pods]_torch.json next "
                        "to this file)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    if args.pods:
        return pod_sweep(args, args.json or _default_json("pods"), dev)
    if args.churn:
        return churn_sweep(args, args.json or _default_json("sweep"), dev)

    t0 = time.perf_counter()
    sizes = [4, 16] if args.smoke else [4, 16, 64, 256]
    epochs = args.epochs or (5 if args.smoke else 20)
    topologies = ["full", "ring", "torus2d", "random_k", "dynamic_k",
                  "hierarchical"]

    # the head-to-head acceptance measurement first, interleaved
    # best-of-N so load drift cannot bias either side
    head = None
    if not args.smoke:
        head = acceptance_pair(args.params, max(epochs, 50),
                               args.max_delay, args.minibatch,
                               args.degree, dev)

    rows = []
    print(f"{'n':>4} {'topology':>13} {'k':>4} {'epoch ms':>9} "
          f"{'flight MB':>10} {'dense MB':>9} {'mem':>7}")

    def show(r):
        rows.append(r)
        print(f"{r['n']:4d} {r['topology']:>13} {r['k']:4d} "
              f"{r['epoch_ms']:9.2f} {r['flight_mb']:10.2f} "
              f"{r['dense_mb']:9.2f} {r['mem_ratio']:6.1%}")

    for n in sizes:
        if n <= 64:
            show(bench_dense_seed(n, args.params, epochs,
                                  args.max_delay, args.minibatch, dev))
        else:
            # the dense n=256 delay line alone is ~0.8 GiB — the layout
            # the sparse line retires; report the footprint, skip the run
            print(f"{n:4d} {'dense(seed)':>13}    —  (skipped: "
                  f"delay line ≈ "
                  f"{dense_equiv_bytes(n, args.max_delay, args.params) / 2**30:.1f} GiB)")
        for topo in topologies:
            if topo == "full" and n > 64:
                continue
            show(bench_one(n, topo, args.degree, args.params, epochs,
                           args.max_delay, args.minibatch,
                           resample_every=args.resample_every,
                           device=dev))

    by = {(r["n"], r["topology"]): r for r in rows}
    gossip64 = by.get((64, "random_k"))
    dyn64 = by.get((64, "dynamic_k"))
    if head is not None and gossip64:
        t_d, t_s = head
        ok_t = t_s < t_d
        ok_m = gossip64["mem_ratio"] < 0.10
        rows.append({"n": 64, "topology": "acceptance", "k": args.degree,
                     "dense16_epoch_ms": t_d, "random_k64_epoch_ms": t_s,
                     "faster": ok_t, "mem_under_10pct": ok_m})
        print(f"\nacceptance: n=64 random_k(k={args.degree}) epoch "
              f"{t_s:.3f} ms vs dense(seed) n=16 {t_d:.3f} ms → "
              f"{'PASS' if ok_t else 'FAIL'}")
        print(f"acceptance: n=64/k={args.degree} delay-line memory "
              f"{gossip64['mem_ratio']:.1%} of dense n=64 equivalent "
              f"→ {'PASS' if ok_m else 'FAIL'}")
    if gossip64 and dyn64:
        ok_d = dyn64["flight_mb"] == gossip64["flight_mb"]
        print(f"acceptance: n=64 dynamic_k delay-line "
              f"{dyn64['flight_mb']:.2f} MB == static random_k "
              f"{gossip64['flight_mb']:.2f} MB → "
              f"{'PASS' if ok_d else 'FAIL'}")

    if args.hetero or args.smoke:
        h_epochs = args.hetero_epochs or (10 if args.smoke else 400)
        n_h = 8
        print(f"\nheterogeneous CartPole/GridWorld group (n={n_h}, "
              f"{h_epochs} epochs/cell):")
        print(f"{'gossip':>8} {'relevance':>10} {'cart ret':>9} "
              f"{'grid ret':>9} {'R within':>9} {'R cross':>8}")
        for resample in (0, args.resample_every):
            for mode in ("uniform", "grad_cos"):
                r = bench_hetero(n_h, h_epochs, args.degree, resample,
                                 mode, device=dev)
                rows.append({"n": n_h, "topology": "hetero", **r})
                gossip = "static" if resample == 0 else "dynamic"
                print(f"{gossip:>8} {mode:>10} {r['cart_ret']:9.2f} "
                      f"{r['grid_ret']:9.3f} {r['rel_within']:9.3f} "
                      f"{r['rel_cross']:8.3f}")
    print(f"sweep: {time.perf_counter() - t0:.1f} s")
    json_path = args.json or _default_json("sweep")
    # the churn rows (--churn) share this file: keep them
    if os.path.exists(json_path):
        with open(json_path) as f:
            old = json.load(f).get("rows", [])
        rows = rows + [r for r in old if str(
            r.get("topology", "")).startswith("churn")]
    write_json(json_path, "sweep", rows, dev)
    return rows


if __name__ == "__main__":
    main()
