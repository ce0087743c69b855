"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The counterpart of the JAX package's ``launch/train.py``: the config
registry, AdamW (its moment dtype from ``--moments``; the arch's step
re-encodes the moments by its own dtype, as in the reference), async
atomic checkpointing and a deterministic resume, on the reduced config
unless ``--full``. It runs on the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --steps 4 \\
        --device cpu

``--lr`` is parsed and, as in the reference, unused: the arch's step
carries its own ``AdamWConfig``.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.core.range_daat import resolve_device
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.train.checkpoint import Checkpointer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, help="train shape (gnn/recsys)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--moments", default="fp32", choices=["fp32", "bf16", "int8"])
    ap.add_argument("--full", action="store_true",
                    help="full published config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the plain path)")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    cfg = arch.model_config(reduced=not args.full)
    shape = args.shape or {
        "lm": "train_4k", "gnn": "full_graph_sm", "recsys": "train_batch",
    }.get(arch.family)
    if shape is None:
        ap.error(f"{args.arch} has no train shape")
    if arch.family == "gnn":
        cfg = arch._resolved(cfg, shape)
    dev = resolve_device(args.device)

    params = arch.init_params(0, cfg, device=dev)
    n = sum(p.numel() for p in params.parameters())
    print(f"arch={args.arch} shape={shape} params={n/1e6:.2f}M "
          f"({'full' if args.full else 'reduced'}) on {dev}")

    step, kind = arch.build_step(cfg, shape)
    if kind != "train":
        ap.error(f"{shape} is not a train shape")

    def data_fn(s):  # deterministic in the step counter -> exact resume
        return arch.make_batch(cfg, shape, seed=s)

    ckpt = Checkpointer(args.ckpt_dir, keep_last=3) if args.ckpt_dir else None

    # Drive the arch step directly (it already includes the optimizer).
    opt_state = init_opt_state(params, AdamWConfig(moment_dtype=args.moments))
    start = 0
    if ckpt:
        restored = ckpt.restore_latest(device=dev)
        if restored:
            params = arch.params_from_numpy(restored["params"], cfg, device=dev)
            opt_state = arch.opt_state_from_numpy(restored["opt_state"], cfg, device=dev)
            start = int(opt_state["step"])
            print(f"resumed from step {start}")
    for s in range(start, args.steps):
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, data_fn(s))
        if s % 20 == 0 or s == args.steps - 1:
            loss = float(metrics["loss"])  # waits for the step
            print(f"step {s:5d}  loss {loss:.4f}  "
                  f"{(time.perf_counter()-t0)*1e3:.0f} ms")
        if ckpt and (s + 1) % args.ckpt_every == 0:
            ckpt.save({"params": arch.params_to_numpy(params, cfg),
                       "opt_state": arch.opt_state_to_numpy(opt_state, cfg)}, step=s + 1)
    if ckpt:
        ckpt.save({"params": arch.params_to_numpy(params, cfg),
                   "opt_state": arch.opt_state_to_numpy(opt_state, cfg)},
                  step=args.steps, blocking=True)
    print("done")


if __name__ == "__main__":
    main()
