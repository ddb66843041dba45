"""Serving launcher — the port of ``repro.launch.serve`` for the
fixed-batch engine:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
        --full --requests 4 --prompt-len 1024 --serve engine=batch \\
        --serve slots=2 --serve max_new_tokens=32 --serve max_len=1056

Flags, the ``--serve key=value`` vocabulary
(``repro_torch.serving.cli_options``) and the numpy prompt draw are
the reference's, so one seed gives the same prompts on both sides; the
weights are drawn from a ``torch.Generator`` of that seed, so they are
not the reference's. ``--device`` (default ``cuda``) picks the card or
the host; ``engine=continuous`` and ``engine=group`` raise
``NotPortedError``. Without ``--full`` the arch runs ``reduced()``.
``--arch`` defaults to the reference's, ``llama3.2-3b``; ``mamba2-780m``
is the other ported arch. A transformer's KV cache holds ``max_len``
positions (default 128), so a longer prompt plus its new tokens needs
``--serve max_len=``.

``main`` prints the reference's per-slot lines, then the prefill time
of each batch and the decode rate (host clock, the card synchronised
around each phase), and returns the same numbers as a dict.
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
                        "(engine=batch, slots=, prompt_pad=). "
                        "Repeatable; later spellings win")
    p.add_argument("--ckpt", default=None,
                   help="group engine only (not ported)")
    p.add_argument("--full", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)

    import torch

    from repro_torch.common.device import resolve_device
    from repro_torch.configs import get_arch_config
    from repro_torch.configs.base import NotPortedError
    from repro_torch.models import get_model
    from repro_torch.serving import ServeConfig, ServeEngine, serve_batches

    knobs = {"engine": "batch", "slots": 2, "prompt_pad": 16,
             "agents": 1, "router": "fifo"}
    serve_kw = {}
    serve_fields = {f.name for f in dataclasses.fields(ServeConfig)}
    for field, value in args.serve:
        (serve_kw if field in serve_fields else knobs)[field] = value
    serve = ServeConfig(**{"max_len": 128, "max_new_tokens": 16,
                           **serve_kw})
    if knobs["engine"] != "batch":
        raise NotPortedError(
            f"engine={knobs['engine']!r} is not ported to repro_torch "
            f"yet; the port serves engine=batch")

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
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(cfg, gen, device)
    engine = ServeEngine(cfg, params, serve)
    report = {"prompts": prompts, "batches": [], "prefill_ms": [],
              "decode_s": [], "first_logits": [], "outputs": []}
    n_out = n_decoded = 0
    for bi, (toks, lens) in enumerate(
            serve_batches(prompts, knobs["slots"], device=device)):
        sync()
        t1 = time.perf_counter()
        first_logits, cache = engine.prefill(toks, lens)
        sync()
        t2 = time.perf_counter()
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
                                    lens.cpu().numpy())
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
