"""Multi-host support (jax.distributed across hosts).

The reference scales with SLURM array jobs over barcode files
(SURVEY.md §2.4); the equivalent here is one program over the
devices of several hosts:

  * every host calls :func:`init_multihost` (coordinator address from the
    launcher), then :func:`global_mesh` builds a ('data', 'pair') mesh
    over all global devices — collectives ride NVLink within a host and
    the network across hosts;
  * input FASTQ files are statically partitioned per host with
    :func:`host_file_shard` (file-level sharding mirrors the reference's
    one-task-one-file model, so no cross-host read shuffling is needed);
  * per-bin counts / cluster edges merge through the same psum /
    all_gather steps as single-host (dist/sharded.py) — under a global
    mesh those collectives are automatically cross-host.

The tests exercise the same code on a virtual CPU mesh; nothing here
branches on host count.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import jax

from .sharded import make_mesh


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> Tuple[int, int]:
    """Initialize jax.distributed from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID;
    without them a single host is assumed). Returns
    (process_id, num_processes). Safe to call on a single host (no-op).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address or num_processes:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    return jax.process_index(), jax.process_count()


def global_mesh(pair_axis: int = 1):
    """('data', 'pair') mesh over all global devices; 'data' spans hosts
    so read batches shard across hosts while adapter banks stay
    replicated per device."""
    devs = jax.devices()
    n = len(devs)
    if n % pair_axis:
        pair_axis = 1
    return make_mesh((n // pair_axis, pair_axis), devices=devs)


def host_file_shard(paths: Sequence[str],
                    process_id: Optional[int] = None,
                    num_processes: Optional[int] = None) -> List[str]:
    """Deterministic per-host partition of input files (sorted,
    round-robin) — the multi-host analogue of the reference's
    SLURM-array task->file mapping (03_amplicon_sorter.sh:119-135)."""
    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num_processes is None else num_processes
    return [p for i, p in enumerate(sorted(paths)) if i % n == pid]


def is_coordinator() -> bool:
    """Host 0 writes run-level outputs (consensusfile, reports); other
    hosts write only their own bins."""
    return jax.process_index() == 0
