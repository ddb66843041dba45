"""Serving launcher — the port of ``repro.launch.serve``: batched,
continuous and multi-tenant group serving.

    # fixed-batch
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
        --full --requests 4 --prompt-len 1024 --serve engine=batch \\
        --serve slots=2 --serve max_new_tokens=32 --serve max_len=1056
    # multi-tenant: 4 agents' policies through one engine
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
        --requests 12 --serve engine=group --serve agents=4 \\
        --serve slots=4 --serve max_new_tokens=16

Flags, the ``--serve key=value`` vocabulary
(``repro_torch.serving.cli_options``) and the numpy prompt draw are
the reference's, so one seed gives the same prompts on both sides; the
weights are drawn from a ``torch.Generator`` of that seed (agent a of
a group from seed + a), so they are not the reference's. ``--ckpt``
restores a group's planes from a ``ParamStore`` checkpoint (written by
either package) and prints the restored version. ``--device``
(default ``cuda``) picks the card or the host. Without ``--full`` the
arch runs ``reduced()``.
``--arch`` defaults to the reference's, ``llama3.2-3b``; ``mamba2-780m``
is the other ported arch. A transformer's KV cache holds ``max_len``
positions (default 128), so a longer prompt plus its new tokens needs
``--serve max_len=``.

``main`` prints the reference's per-request lines. ``engine=batch``
then prints the prefill time of each batch and the decode rate (host
clock, the card synchronised around each phase); ``engine=continuous``
and ``engine=group`` print per-request p50 / p99 latency and the mean
queue depth from ``ServeMetrics``. It returns the numbers as a dict.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List

import numpy as np


def _serve_kv(text: str):
    """Parse one ``--serve key=value`` item against the serving
    vocabulary, values coerced to the declared type."""
    from repro_torch.serving import cli_options
    opts = cli_options()
    key, sep, value = text.partition("=")
    if not sep:
        raise argparse.ArgumentTypeError(
            f"--serve wants key=value, got {text!r}")
    if key not in opts:
        raise argparse.ArgumentTypeError(
            f"unknown serve option {key!r}; valid keys: "
            f"{', '.join(sorted(opts))}")
    field, typ = opts[key]
    try:
        return field, typ(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--serve {key} wants a {typ.__name__}, got {value!r}")


def draw_prompts(vocab_size: int, requests: int, prompt_len: int,
                 seed: int) -> List[List[int]]:
    """The reference launcher's prompt draw: ``requests`` prompts of
    2 .. prompt_len − 1 ids each, from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, vocab_size, rng.integers(2, prompt_len)))
            for _ in range(requests)]


def _parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="llama3.2-3b")
    p.add_argument("--requests", type=int, default=6)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--serve", action="append", default=[],
                   type=_serve_kv, metavar="KEY=VALUE",
                   help="serving configuration "
                        "(repro_torch.serving.cli_options): any "
                        "ServeConfig field (max_len= max_new_tokens= "
                        "temperature= eos_id=) or engine knob "
                        "(engine=batch|continuous|group, slots=, "
                        "prompt_pad=, agents=, router=fifo|fair). "
                        "Repeatable; later spellings win")
    p.add_argument("--ckpt", default=None,
                   help="group engine: restore the published param "
                        "planes from a ParamStore checkpoint instead "
                        "of random init")
    p.add_argument("--full", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p


def agent_planes(cfg, n_agents: int, seed: int, device):
    """Stacked planes (leaves (A, ...)) of ``n_agents`` agents, agent a
    drawn from ``torch.Generator`` seed ``seed + a`` one at a time into
    its row."""
    import torch

    from repro_torch.common.pytree import tree_map
    from repro_torch.models import get_model
    model = get_model(cfg)
    planes = None
    for a in range(n_agents):
        one = model.init(cfg, torch.Generator(device=device)
                         .manual_seed(seed + a), device)
        if planes is None:
            planes = tree_map(lambda t: t.new_empty(
                (n_agents,) + tuple(t.shape)), one)
        tree_map(lambda dst, src: dst[a].copy_(src), planes, one)
        del one
    return planes


def _serve_group(cfg, serve, knobs, prompts, args, device):
    from repro_torch.models import get_model
    from repro_torch.serving import (GroupRequest, GroupServeEngine,
                                     ParamStore, Router, ServeMetrics)
    A = knobs["agents"]
    if args.ckpt:
        from repro_torch.common.pytree import tree_map
        one = get_model(cfg).init(cfg, None, "meta")
        template = tree_map(lambda t: t.expand((A,) + tuple(t.shape)), one)
        store = ParamStore.load(args.ckpt, template, device=device)
        print(f"restored planes v{store.version} from {args.ckpt}")
    else:
        store = ParamStore(agent_planes(cfg, A, args.seed, device),
                           donate=True)
    metrics = ServeMetrics()
    engine = GroupServeEngine(cfg, store, serve, batch_size=knobs["slots"],
                              prompt_pad=knobs["prompt_pad"],
                              router=Router(knobs["router"]),
                              metrics=metrics, seed=args.seed)
    reqs = [GroupRequest(rid, rid % A, pr) for rid, pr in enumerate(prompts)]
    out = engine.run(reqs)
    for req in reqs:
        print(f"req {req.rid} agent {req.agent_id}: "
              f"prompt={np.asarray(req.prompt)} -> {np.asarray(out[req.rid])}")
    return [out[r.rid] for r in reqs], metrics, store.version


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)

    import torch

    from repro_torch.common.device import resolve_device
    from repro_torch.configs import get_arch_config
    from repro_torch.models import get_model
    from repro_torch.serving import (ContinuousBatcher, ServeConfig,
                                     ServeEngine, serve_batches)

    knobs = {"engine": "batch", "slots": 2, "prompt_pad": 16,
             "agents": 1, "router": "fifo"}
    serve_kw = {}
    serve_fields = {f.name for f in dataclasses.fields(ServeConfig)}
    for field, value in args.serve:
        (serve_kw if field in serve_fields else knobs)[field] = value
    serve = ServeConfig(**{"max_len": 128, "max_new_tokens": 16,
                           **serve_kw})
    if knobs["engine"] not in ("batch", "continuous", "group"):
        raise ValueError(f"engine={knobs['engine']!r}: expected batch, "
                         f"continuous or group")

    device = resolve_device(args.device)
    cfg = get_arch_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    model = get_model(cfg)
    prompts = draw_prompts(cfg.vocab_size, args.requests, args.prompt_len,
                           args.seed)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    if knobs["engine"] != "batch":
        if knobs["engine"] == "group":
            outs, metrics, version = _serve_group(cfg, serve, knobs,
                                                  prompts, args, device)
        else:
            params = model.init(
                cfg, torch.Generator(device=device).manual_seed(args.seed),
                device)
            metrics, version = None, None
            batcher = ContinuousBatcher(cfg, params, serve,
                                        batch_size=knobs["slots"],
                                        prompt_pad=knobs["prompt_pad"])
            res = batcher.run(prompts)
            outs = [res[rid] for rid in range(len(prompts))]
            for rid, pr in enumerate(prompts):
                print(f"req {rid}: prompt={np.asarray(pr)} "
                      f"-> {np.asarray(outs[rid])}")
        sync()
        secs = time.perf_counter() - t0
        n_out = sum(len(o) for o in outs)
        report = {"prompts": prompts, "outputs": outs, "tokens": n_out,
                  "version": version}
        if metrics is not None:
            s = metrics.summary()
            report["summary"] = s
            print(f"agents={knobs['agents']} slots={knobs['slots']} "
                  f"p50={s['latency_p50'] * 1e3:.0f}ms "
                  f"p99={s['latency_p99'] * 1e3:.0f}ms "
                  f"queue_depth_mean={s['queue_depth_mean']:.1f}")
        print(f"{n_out} tokens in {secs:.1f}s ({n_out / secs:,.0f} tok/s, "
              f"incl. init and the kernel build)")
        return report

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(cfg, gen, device)
    engine = ServeEngine(cfg, params, serve)
    report = {"prompts": prompts, "batches": [], "prefill_ms": [],
              "decode_s": [], "first_logits": [], "outputs": []}
    n_out = n_decoded = 0
    for bi, (toks, lens) in enumerate(
            serve_batches(prompts, knobs["slots"], device="cpu")):
        toks = toks.to(device)
        sync()
        t1 = time.perf_counter()
        first_logits, cache = engine.prefill(toks, lens)
        sync()
        t2 = time.perf_counter()
        # host lengths: decode reads nothing back from the card
        out = engine.decode(first_logits, cache, lens,
                            torch.Generator(device=device).manual_seed(bi))
        sync()
        t3 = time.perf_counter()
        report["prefill_ms"].append((t2 - t1) * 1e3)
        report["decode_s"].append(t3 - t2)
        report["batches"].append((toks, lens))
        report["first_logits"].append(first_logits)
        report["outputs"].append(out)
        n_out += out.shape[0] * out.shape[1]
        n_decoded += out.shape[0] * (out.shape[1] - 1)
        out_np, toks_np, lens_np = (out.cpu().numpy(), toks.cpu().numpy(),
                                    lens.numpy())
        for row in range(out_np.shape[0]):
            print(f"batch {bi} slot {row}: "
                  f"prompt={toks_np[row][:int(lens_np[row])]} "
                  f"-> {out_np[row]}")
    secs = time.perf_counter() - t0
    decode_s = sum(report["decode_s"])
    report.update(prefill_calls=len(report["batches"]), tokens=n_out,
                  decode_tok_s=n_decoded / decode_s if decode_s else 0.0)
    print(f"prefill ms per batch: "
          + ", ".join(f"{ms:.2f}" for ms in report["prefill_ms"])
          + f"; decode {n_decoded} tokens in {decode_s:.3f} s "
          f"({report['decode_tok_s']:,.1f} tok/s)")
    print(f"{n_out} tokens in {secs:.1f}s ({n_out / secs:,.0f} tok/s, "
          f"incl. init and the kernel build)")
    return report


if __name__ == "__main__":
    main()
