"""Per-layer collectives of the placed dry run: each cell's record
(``repro_torch.launch.dryrun.run_cell``, full width, production mesh) at
two and at three layers (a VLM: groups of ``cross_attn_every`` layers);
the difference is what one more layer (group) adds.  The first layer
differs (its input comes from the embedding, not from a layer), so the
two-layer record is printed beside it.  Prints one JSON line per cell.

  PYTHONPATH=src python tools/dryrun_per_layer.py \\
      mistral-7b:decode_32k phi3.5-moe-42b-a6.6b:decode_32k \\
      mamba2-2.7b:prefill_32k [--multi-pod]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def _sub(a, b):
    if isinstance(a, dict):
        return {k: _sub(a[k], b[k]) for k in a}
    return a - b


def per_layer(arch, shape, multi_pod=False):
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    cfg = get_config(arch)
    unit = cfg.cross_attn_every if cfg.family == "vlm" else 1
    recs = [dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                            cfg_overrides={"n_layers": n * unit})
            for n in (2, 3)]

    def part(r):
        c = r["collectives"]
        return {"counts": c["counts"], "per_op_bytes": c["per_op_bytes"],
                "by_link": c["by_link"], "total_bytes": c["total_bytes"],
                "flops": r["flops_per_device"],
                "bytes_accessed": r["bytes_accessed_per_device"]}

    two, three = part(recs[0]), part(recs[1])
    return {"cell": f"{arch}|{shape}|{'multi' if multi_pod else 'single'}",
            "layers_per_unit": unit, "n_layers": cfg.n_layers,
            "per_layer": _sub(three, two), "at_two": two}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("cells", nargs="+", help="arch:shape")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    for cell in args.cells:
        arch, shape = cell.split(":")
        print(json.dumps(per_layer(arch, shape, args.multi_pod)), flush=True)


if __name__ == "__main__":
    main()
