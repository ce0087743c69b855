"""Roofline collation: three terms per (arch x shape x mesh) cell, on H100.

The counterpart of the JAX package's ``launch/roofline.py``. Reads the dry
run's JSONs (``launch/dryrun.py``) and derives, per cell:

    compute term    = FLOPs        / (chips * PEAK_FLOPS)
    memory term     = bytes        / (chips * HBM_BW)
    collective term = coll. bytes  / LINK_BW
                      (collective bytes are per-device landed bytes, so the
                       per-GPU link rate is the right denominator)

FLOPs sources, both reported:
  * analytic MODEL_FLOPS (6*N_active*D for LM training, per-shape formulas
    below for serving/GNN/recsys cells), the primary compute term
    (``model_flops_for``, the reference's functions unchanged);
  * the counted FLOPs (``FlopCounterMode`` over the whole step), secondary:
    ``compute_s_counted``. The port counts every loop trip and the remat
    recomputation, where XLA's CPU cost analysis counts a loop body once
    (the reference's ``compute_s_hlo``), so MODEL_FLOPS / counted FLOPs is
    at most 1 and says how much of the counted work is the model's.

The memory term reads ``per_device_bytes_accessed``, each aten op's input
and output bytes: an upper bound on a fused program's traffic.

Only records of a dry run on fake ``cuda`` tensors are read (a run on
fake CPU tensors, ``dryrun --device cpu``, is skipped). The constants are an H100 SXM5's
data-sheet peaks (``chip_smoke.py`` prints rates measured on the card
beside them and does not replace them).

Output: ``chiprun_out/roofline.json`` and a markdown table.
"""

from __future__ import annotations

import glob
import json
import os

# NVIDIA H100 SXM5 data sheet: dense BF16 tensor-core peak (1,979 TFLOP/s
# with 2:4 sparsity, half that dense).
PEAK_FLOPS = 989.4e12
# NVIDIA H100 SXM5 data sheet: HBM3 bandwidth, 3.35 TB/s.
HBM_BW = 3.35e12
# One 400 Gb/s NDR InfiniBand port per GPU (ConnectX-7): 50 GB/s a
# direction. Both 16-wide axes of the production meshes span two 8-GPU
# NVLink nodes (NVLink 4: 450 GB/s a direction), so the inter-node link
# bounds a ring over either axis.
LINK_BW = 50e9

RESULTS_DIR = os.path.join("chiprun_out", "dryrun")
OUT = os.path.join("chiprun_out", "roofline.json")

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "RESULTS_DIR", "OUT", "model_flops_for",
           "collate", "to_markdown", "main"]

# ---------------------------------------------------------------- analytic


def _lm_flops(arch_cfg, shape: str, kind: str, n_dev: int) -> float:
    """Whole-step MODEL_FLOPS (global), then divided by devices by caller."""
    from repro_torch.configs.registry import get_arch

    arch = get_arch(arch_cfg)
    cfg = arch.model_config()
    fpt = arch.model_flops_per_token(cfg)  # 6*N_active (train)
    dims = {
        "train_4k": (256, 4096), "prefill_32k": (32, 32768),
        "decode_32k": (128, 1), "long_500k": (1, 1),
    }[shape]
    tokens = dims[0] * dims[1]
    if kind == "train":
        return fpt * tokens  # 6*N*D includes fwd+bwd
    # Serving: forward only = 2*N_active per token (+ attention reads).
    return fpt / 3.0 * tokens


def _gnn_flops(shape: str) -> float:
    dims = {
        "full_graph_sm": (10752, 1433, 7),
        "ogb_products": (61860352, 100, 47),
        "minibatch_lg": (15360 + 163840, 602, 41),
        "molecule": (128 * 64, 64, 32),
    }[shape]
    e, d, c = dims
    d_h = 128
    # 2 layers: per-edge gather+add (~2*d per edge) + per-node matmuls;
    # dominate: layer matmuls 2*(d*d_h + d_h*c) per node, edges: copies.
    # Rough per-edge 2*d flops * 2 layers + node matmul terms folded in:
    train_mult = 3.0  # fwd + bwd
    return train_mult * (2 * e * (d + d_h) + 2 * e * (d_h + c))


def _rec_flops(arch: str, shape: str) -> float:
    B = {"train_batch": 65536, "serve_p99": 512, "serve_bulk": 262144,
         "retrieval_cand": 1_000_000}[shape]
    per = {
        # rough per-example forward flops
        "bst": 2 * (21 * 32 * 32 * 4 + 21 * 21 * 32 * 2 + 1024 * 832 + 1024 * 512 + 512 * 256),
        "mind": 2 * (50 * 64 * 64 * 3 + 4 * 64 * 50 * 3),
        "autoint": 2 * 3 * (39 * 16 * 64 * 3 + 39 * 39 * 64 * 2),
        "bert4rec": 2 * 2 * (200 * 64 * 64 * 4 + 200 * 200 * 64 * 2 + 200 * 64 * 256),
    }[arch]
    mult = 3.0 if shape == "train_batch" else 1.0
    return mult * per * B


def model_flops_for(arch: str, shape: str, kind: str, n_dev: int) -> float:
    try:
        if arch in ("qwen3-4b", "qwen2.5-3b", "deepseek-67b",
                    "deepseek-v3-671b", "moonshot-v1-16b-a3b"):
            return _lm_flops(arch, shape, kind, n_dev)
        if arch == "graphsage-reddit":
            return _gnn_flops(shape)
        if arch in ("bst", "mind", "autoint", "bert4rec"):
            return _rec_flops(arch, shape)
        if arch == "anytime-ir":
            # 256 queries x budgeted postings x ~2 flops/posting (+ top-k).
            return 256.0 * 4e6 * 2
    except Exception:  # noqa: BLE001
        return 0.0
    return 0.0


def collate(results_dir: str = RESULTS_DIR):
    """One row per ``ok`` record of a dry run on fake card tensors. Others
    are skipped: the peaks are a card's, and a run on fake CPU tensors
    takes the kernels' plain routes, so its census is not the card's."""
    rows = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            d = json.load(f)
        if not d.get("ok") or d.get("device") != "cuda":
            continue
        n = d["n_devices"]
        model_flops = model_flops_for(d["arch"], d["shape"], d["kind"], n)
        counted_flops_total = d["per_device_flops"] * n
        compute_term = model_flops / (n * PEAK_FLOPS)
        compute_term_counted = d["per_device_flops"] / PEAK_FLOPS
        memory_term = d["per_device_bytes_accessed"] / HBM_BW
        coll_term = d["collectives"]["total_bytes"] / LINK_BW
        terms = {
            "compute_s": compute_term,
            "memory_s": memory_term,
            "collective_s": coll_term,
        }
        dominant = max(terms, key=terms.get)
        bound_time = max(terms.values())
        rows.append(
            {
                "arch": d["arch"],
                "shape": d["shape"],
                "mesh": d["mesh"],
                "variant": d.get("variant", "baseline"),
                "kind": d["kind"],
                "n_devices": n,
                "model_flops": model_flops,
                "counted_flops_total": counted_flops_total,
                "useful_ratio": (
                    model_flops / counted_flops_total if counted_flops_total else None
                ),
                **{k: round(v, 6) for k, v in terms.items()},
                "compute_s_counted": round(compute_term_counted, 6),
                "dominant": dominant.replace("_s", ""),
                "roofline_fraction": (
                    round(compute_term / bound_time, 4) if bound_time else None
                ),
                "peak_gib_per_dev": round(
                    d["memory"].get("peak_memory_in_bytes", 0) / 2**30, 2
                ),
                "collective_breakdown": d["collectives"]["bytes_by_kind"],
                "kernel_launches": d.get("kernel_launches", {}),
            }
        )
    return rows


def to_markdown(rows, mesh: str = "single") -> str:
    lines = [
        "| arch | shape | dom. bottleneck | compute_s | memory_s | collective_s "
        "| roofline frac | peak GiB/dev |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["mesh"] != mesh:
            continue
        tag = "" if r["variant"] == "baseline" else f" [{r['variant']}]"
        lines.append(
            f"| {r['arch']}{tag} | {r['shape']} | {r['dominant']} "
            f"| {r['compute_s']:.2e} | {r['memory_s']:.2e} "
            f"| {r['collective_s']:.2e} | {r['roofline_fraction']} "
            f"| {r['peak_gib_per_dev']} |"
        )
    return "\n".join(lines)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--results-dir", default=RESULTS_DIR)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    rows = collate(args.results_dir)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    tmp = args.out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rows, f, indent=1)
    os.replace(tmp, args.out)
    print(to_markdown(rows, "single"))
    print(f"\n{len(rows)} cells collated -> {args.out}")


if __name__ == "__main__":
    main()
