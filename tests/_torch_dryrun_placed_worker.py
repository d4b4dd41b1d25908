"""One process of ``tests/test_torch_dryrun_placed.py``: the placed dry
run (``repro_torch.launch.dryrun.run_cell``, which starts and ends its own
fake process group per cell) of a list of cells.  Run as

  python tests/_torch_dryrun_placed_worker.py <cells.json> <out.json>

``cells.json`` is a list of ``run_cell`` keyword dicts (``arch``,
``shape_name`` and the rest); ``out.json`` gets each cell's record, or its
error and traceback, in that order."""
import json
import os
import sys
import traceback
import warnings

warnings.filterwarnings("ignore")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

import torch  # noqa: E402

torch.set_num_threads(1)


def main():
    from repro_torch.launch import dryrun

    cells_path, out_path = sys.argv[1:3]
    out = []
    for kw in json.load(open(cells_path)):
        kw = dict(kw)
        arch, shape = kw.pop("arch"), kw.pop("shape_name")
        try:
            out.append(dryrun.run_cell(arch, shape, **kw))
        except Exception as e:
            out.append({"error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()})
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
