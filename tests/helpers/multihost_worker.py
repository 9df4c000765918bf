"""Worker for the 2-process jax.distributed localhost test.

Usage: python multihost_worker.py <coordinator> <nprocs> <pid> <outdir>
Each process: init_multihost -> global mesh over all processes' CPU
devices -> a psum'd sharded demux histogram step -> host_file_shard.
Writes <outdir>/result_<pid>.json.
"""
import json
import os
import sys

coordinator, nprocs, pid, outdir = (sys.argv[1], int(sys.argv[2]),
                                    int(sys.argv[3]), sys.argv[4])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402
jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: E402

from nano_orc.dist.multihost import (global_mesh, host_file_shard,  # noqa
                                    init_multihost, is_coordinator)

ppid, pcount = init_multihost(coordinator, nprocs, pid)
assert pcount == nprocs, (ppid, pcount)
devs = jax.devices()
mesh = global_mesh()

# psum-merged histogram across the global mesh (the dist/sharded demux
# collective, minimal form)
import functools
from jax.sharding import PartitionSpec as P
import jax.numpy as jnp

@functools.partial(jax.shard_map, mesh=mesh, in_specs=P("data"),
                   out_specs=P(), check_vma=False)
def hist(x):
    return jax.lax.psum(jnp.sum(x, axis=0, keepdims=True), "data")

n = mesh.shape["data"]
local = np.arange(n * 4, dtype=np.int32).reshape(n, 4)
out = np.asarray(jax.jit(hist)(local))[0]

files = [f"bin_{i:02d}.fastq" for i in range(7)]
mine = host_file_shard(files)

res = {"pid": ppid, "pcount": pcount, "ndev_global": len(devs),
       "ndev_local": len(jax.local_devices()),
       "hist": out.tolist(), "files": mine,
       "is_coord": is_coordinator()}
with open(os.path.join(outdir, f"result_{pid}.json"), "w") as fh:
    json.dump(res, fh)
print("ok", ppid)
