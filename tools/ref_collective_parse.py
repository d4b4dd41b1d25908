"""What the reference's collective parser (``repro.launch.dryrun
.collective_bytes``) reads on this JAX: the reduced Mistral-7B decode step
jitted with the reference's shardings on a (1, 2) ("data", "model") XLA
CPU mesh, compiled, its post-SPMD HLO parsed.  Prints the parser's counts
and bytes, the JAX version, and each collective's HLO line (operands
printed with or without their shapes).  The JAX package is only read.

  JAX_PLATFORMS=cpu python tools/ref_collective_parse.py
"""
import json
import os
import re
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import jax  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

assert jax.device_count() == 2
from repro.configs import get_config, reduce_config  # noqa: E402
from repro.distribution import sharding as shd  # noqa: E402
from repro.launch import steps as steps_lib  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402

# after jax has its two devices: the module sets XLA_FLAGS on import
from repro.launch.dryrun import _COLLECTIVES, collective_bytes  # noqa: E402


def main():
    mesh = make_mesh((1, 2), ("data", "model"))
    cfg = reduce_config(get_config("mistral-7b"))
    B, S = 4, 32
    rules = shd.make_rules(mesh, batch=B)
    pshape = steps_lib.param_specs(cfg)
    psh = jax.tree.map(lambda s: NamedSharding(mesh, s), shd.evenly(
        shd.param_pspecs(pshape, rules), pshape, mesh))
    cache = steps_lib.cache_specs(cfg, B, S)
    csh = jax.tree.map(lambda s: NamedSharding(mesh, s), shd.evenly(
        shd.serving_cache_pspecs(cfg, rules, cache), cache, mesh))
    fn, _ = steps_lib.build_step(cfg, "decode")
    token = jax.ShapeDtypeStruct((B,), jax.numpy.int32)
    jfn = jax.jit(fn, in_shardings=(psh, NamedSharding(mesh, P(rules.dp)),
                                    csh), out_shardings=(None, csh))
    hlo = jfn.lower(pshape, token, cache).compile().as_text()
    lines = [ln.strip() for ln in hlo.splitlines()
             if any(re.search(r"\s" + c + r"(-start)?\(", " " + ln)
                    for c in _COLLECTIVES)]
    print("jax", jax.__version__)
    for ln in lines:
        print("  " + ln[:200])
    print(json.dumps(collective_bytes(hlo)))


if __name__ == "__main__":
    main()
