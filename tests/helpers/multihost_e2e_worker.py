"""Worker for the 2-process multi-host END-TO-END test (VERDICT r4
next#7): each process sorts its host_file_shard of barcode bins and
writes per-bin consensus outputs; after a global-mesh barrier the
coordinator merges them into the run-level consensusfile.fasta — the
multi-host analogue of 03_amplicon_sorter.sh's array tasks plus the
run-level consensusfile of amplicon_sorter.py:2089-2098.

Usage: multihost_e2e_worker.py <coordinator> <nprocs> <pid> <indir> <outdir>
"""
import glob
import json
import os
import sys

coordinator, nprocs, pid, indir, outdir = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
    sys.argv[5])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402
jax.config.update("jax_platforms", "cpu")
import functools  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from nano_orc.cluster.engine import AmpliconSorter, SorterConfig  # noqa
from nano_orc.cluster.output import write_barcode_consensus  # noqa: E402
from nano_orc.cluster.scoring import DeviceScorer  # noqa: E402
from nano_orc.dist.multihost import (global_mesh, host_file_shard,  # noqa
                                    init_multihost, is_coordinator)
from nano_orc.io.fastq import read_records  # noqa: E402

ppid, pcount = init_multihost(coordinator, nprocs, pid)
mesh = global_mesh()

bins = sorted(glob.glob(os.path.join(indir, "*.fastq")))
mine = host_file_shard(bins)
done = []
for path in mine:
    barcode = os.path.splitext(os.path.basename(path))[0]
    records = list(read_records(path))
    srt = AmpliconSorter(SorterConfig(min_length=300, seed=7),
                         scorer=DeviceScorer(backend="native"))
    result = srt.sort_records(records)
    write_barcode_consensus(result, os.path.join(outdir, "bins"),
                            barcode, "e2e")
    done.append(barcode)

# global-mesh barrier: every host contributes 1; psum == process count
@functools.partial(jax.shard_map, mesh=mesh, in_specs=P("data"),
                   out_specs=P(), check_vma=False)
def barrier(x):
    return jax.lax.psum(jnp.sum(x, keepdims=True)[None], "data")

n = mesh.shape["data"]
total = int(np.asarray(jax.jit(barrier)(
    np.ones(n, np.int32)))[0, 0])
assert total == n, total

if is_coordinator():
    # run-level merge in sorted bin order (coordinator-only write)
    parts = []
    for path in bins:
        barcode = os.path.splitext(os.path.basename(path))[0]
        p = os.path.join(outdir, "bins",
                         f"{barcode}_consensus_e2e.fasta")
        with open(p) as fh:
            parts.append(fh.read())
    with open(os.path.join(outdir, "consensusfile.fasta"), "w") as fh:
        fh.write("".join(parts))

with open(os.path.join(outdir, f"e2e_result_{pid}.json"), "w") as fh:
    json.dump({"pid": ppid, "bins": done,
               "is_coord": is_coordinator()}, fh)
print("ok", ppid)
