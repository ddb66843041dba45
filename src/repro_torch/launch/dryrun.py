"""Multi-pod dry-run CLI — the port of ``repro.launch.dryrun``
(deliverable e).

Traces every (architecture × input shape) pair's step on one rank of
the production meshes — 16 x 16 single-pod and 2 x 16 x 16 multi-pod —
in a fake world of 256 or 512 ranks on ``meta`` tensors (nothing
allocated, no card needed; ``launch.dryrun_lib``), printing the rank's
memory and the roofline terms at the H100's constants
(``roofline.constants``) and writing the records to JSON.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
"""
import argparse
import json
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--arch", default=None)
    parser.add_argument("--shape", default=None)
    parser.add_argument("--all", action="store_true")
    parser.add_argument("--multi-pod", action="store_true",
                        help="2×16×16 (512-chip) mesh instead of 16×16")
    parser.add_argument("--out", default=None, help="JSON output path")
    parser.add_argument("--verbose", action="store_true",
                        help="print the memory and roofline records")
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.configs import ARCH_IDS, INPUT_SHAPES
    from repro_torch.launch.dryrun_lib import dryrun_pair
    from repro_torch.launch.mesh import make_traced_mesh

    if args.all:
        pairs = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            parser.error("need --arch and --shape, or --all")
        pairs = [(args.arch, args.shape)]

    mesh = make_traced_mesh(multi_pod=args.multi_pod)
    results = []
    n_fail = 0
    try:
        for arch_id, shape_name in pairs:
            res = dryrun_pair(arch_id, shape_name, mesh)
            results.append(res.to_dict())
            if res.ok:
                r = res.roofline
                print(f"[OK]   {arch_id:22s} {shape_name:12s} "
                      f"mesh={res.mesh_name:8s} "
                      f"trace={res.compile_s:6.1f}s "
                      f"mem/dev={res.memory['total_bytes_per_device']/2**30:7.2f}GiB "
                      f"t_comp={r['t_compute']:.3e}s "
                      f"t_mem={r['t_memory']:.3e}s "
                      f"t_coll={r['t_collective']:.3e}s "
                      f"dom={r['dominant']:10s} "
                      f"useful={r['useful_ratio']:.2f}")
                if args.verbose:
                    print(json.dumps(res.memory, indent=2))
                    print(json.dumps(r, indent=2))
                    print(json.dumps(res.kernels))
            else:
                n_fail += 1
                print(f"[FAIL] {arch_id:22s} {shape_name:12s}\n{res.error}")
            sys.stdout.flush()
    finally:
        dist.destroy_process_group()

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
        print(f"wrote {len(results)} records to {args.out}")
    print(f"{len(pairs) - n_fail}/{len(pairs)} pairs traced OK")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
