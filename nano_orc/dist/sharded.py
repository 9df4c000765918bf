"""Multi-device data parallelism for demux and clustering.

The reference's only parallelism is SLURM array fan-out over barcode files
plus in-node multiprocessing (SURVEY.md §2.4). Here:

* **reads** are the data-parallel axis: a batch [B, L] is sharded over the
  mesh 'data' axis; the adapter/primer bank is replicated per device;
* **per-bin demux histograms** merge with ``psum``;
* the **all-vs-all pair matrix** is split into row stripes of patterns,
  one per device; cluster edges are gathered to host for the union-find
  (host-sequential by design, SURVEY.md §7.4.4).

The cards of one host are joined all to all, so the mesh follows the
algorithm alone. Everything compiles under one jit per step with static
shapes; tested on a virtual 8-device CPU mesh (tests/conftest.py).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..align import myers
from ..align.batched import batched_locate
from ..align.spec import FRONT
from ..demux.fused import best_per_read, dual_round


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices=None) -> Mesh:
    """2-D mesh ('data', 'pair'). Default: all devices on 'data'."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, ("data", "pair"))


# ---------------------------------------------------------------------------
# Demux step: sharded reads x replicated bank -> assignments + psum histogram
# ---------------------------------------------------------------------------

def sharded_demux_step(mesh: Mesh, bank, read_masks, read_lens,
                       flags: int = int(FRONT)):
    """One demux step over the mesh: returns (adapter_idx [B], matches [B],
    qstart [B], qstop [B], bin_histogram [A+1] globally psum-reduced).

    read rows must be divisible by the 'data' axis size.
    """
    A = bank.masks.shape[0]
    masks = jnp.asarray(bank.masks)
    lens = jnp.asarray(bank.lens)
    ktab = jnp.asarray(bank.k_table)
    npre = jnp.asarray(bank.n_prefix)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P("data"), P("data")),
        out_specs=(P("data"), P("data"), P("data"), P("data"), P()),
        check_vma=False)
    def step(m, l, k, np_, rm, rl):
        res = batched_locate(m, l, k, np_, rm, rl, flags)
        idx, best_m, qstart, qstop, _ = best_per_read(res)
        onehot = (idx[:, None] == jnp.arange(A + 1)[None, :] - 1)
        hist = jnp.sum(onehot, axis=0, dtype=jnp.int32)  # slot 0 = unknown
        hist = jax.lax.psum(hist, "data")
        return idx, best_m, qstart, qstop, hist

    return step(masks, lens, ktab, npre, jnp.asarray(read_masks),
                jnp.asarray(read_lens))


# ---------------------------------------------------------------------------
# Dual-round demux step: the full 02-stage decision per read, sharded
# ---------------------------------------------------------------------------

def sharded_dual_demux_step(mesh: Mesh, sp5, sp27rc, read_masks,
                            read_lens):
    """Both cutadapt rounds (SP5 FRONT + SP27-rc BACK, --rc each round,
    on-device trim between rounds) for a read batch sharded over 'data';
    the multi-device form of demux.fused (same ``dual_round`` body).

    Returns per-read vectors (idx1, rc1, qe1, idx2, rc2, qs2, err1,
    err2), each [B] sharded over 'data', plus psum-merged histograms
    hist1 [A5+1] and hist2 [A27+1] (slot 0 = unknown).
    """
    A5 = sp5.masks.shape[0]
    A27 = sp27rc.masks.shape[0]
    b5 = tuple(jnp.asarray(x) for x in
               (sp5.masks, sp5.lens, sp5.k_table, sp5.n_prefix))
    b27 = tuple(jnp.asarray(x) for x in
                (sp27rc.masks, sp27rc.lens, sp27rc.k_table,
                 sp27rc.n_prefix))

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P("data"), P("data")),
        out_specs=(P("data"), P("data"), P("data"), P("data"),
                   P("data"), P("data"), P("data"), P("data"), P(), P()),
        check_vma=False)
    def step(bank5, bank27, rm, rl):
        dec = dual_round(bank5, bank27, rm.astype(jnp.int32), rl)
        idx1, idx2 = dec[0], dec[3]
        h1 = jnp.sum(idx1[:, None] == jnp.arange(A5 + 1)[None, :] - 1,
                     axis=0, dtype=jnp.int32)
        h2 = jnp.sum(idx2[:, None] == jnp.arange(A27 + 1)[None, :] - 1,
                     axis=0, dtype=jnp.int32)
        return dec + (jax.lax.psum(h1, "data"), jax.lax.psum(h2, "data"))

    return step(b5, b27, jnp.asarray(read_masks), jnp.asarray(read_lens))


# ---------------------------------------------------------------------------
# Per-device scoring dispatch (the production multi-device scoring path)
# ---------------------------------------------------------------------------

def device_parallel_pairwise(devices, pat_codes, pat_lens, txt_codes,
                             txt_lens, mode: str = "NW",
                             gate: Optional[np.ndarray] = None
                             ) -> np.ndarray:
    """All patterns vs all texts with pattern rows striped over explicit
    devices; each stripe runs the single-device route (nano_orc.device:
    the Pallas kernel on a GPU, the XLA scan on the CPU — bit-identical)
    committed to its device. Stripes are all dispatched before any
    fetch, so devices compute concurrently; results gather on host,
    where the union-find consumer lives (SURVEY.md §7.4.4).

    gate: optional [P, T] bool — on a GPU only the text tiles holding a
    True entry are computed; un-gated entries of the result are
    unspecified (callers mask). Returns [P, T] int32 distances (numpy).
    """
    from .. import device
    devices = list(devices)
    ndev = len(devices)
    P0 = int(pat_codes.shape[0])
    T0 = int(txt_codes.shape[0])
    on_gpu = device.on_gpu()
    stripe = -(-P0 // ndev)
    lazies = []  # (r0, r1, lazy_dist)
    for k, dev in enumerate(devices):
        r0, r1 = k * stripe, min((k + 1) * stripe, P0)
        if r0 >= r1:
            break
        pc = np.ascontiguousarray(pat_codes[r0:r1])
        pl = np.ascontiguousarray(pat_lens[r0:r1])
        if on_gpu:
            from ..align import myers_gpu
            g = None if gate is None else gate[r0:r1]
            if g is not None and not g.any():
                continue
            d, _ = myers_gpu.distances(pc, pl, txt_codes, txt_lens, mode,
                                       gate=g, device=dev, lazy=True)
        else:
            W = myers.n_words(int(pc.shape[1]))
            put = functools.partial(jax.device_put, device=dev)
            peq = myers.build_peq(put(jnp.asarray(pc)), W,
                                  put(jnp.asarray(pl, dtype=np.int32)))
            d, _ = myers.myers_tile(peq, put(jnp.asarray(pl, np.int32)),
                                    put(jnp.asarray(txt_codes)),
                                    put(jnp.asarray(txt_lens, np.int32)),
                                    mode, W)
        lazies.append((r0, r1, d))
    out = np.zeros((P0, T0), np.int32)
    for r0, r1, d in lazies:   # fetch AFTER all dispatches
        out[r0:r1] = np.asarray(d)[:r1 - r0, :T0]
    return out


# ---------------------------------------------------------------------------
# Pairwise tile step: pattern stripe per 'pair' rank, texts replicated
# ---------------------------------------------------------------------------

def sharded_pairwise_step(mesh: Mesh, pat_codes, pat_lens, txt_codes,
                          txt_lens):
    """All patterns vs all texts, pattern rows sharded over 'pair' (with
    'data' folded in when it is the only axis): returns [Ptot, T] distance
    matrix, all-gathered so every chip (and the host) sees the full edge
    set for the union-find merge."""
    W = myers.n_words(int(pat_codes.shape[1]))

    shard_axes = ("data", "pair")

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(shard_axes), P(shard_axes), P(), P()),
        out_specs=P(), check_vma=False)
    def step(pc, pl, tc, tl):
        peq = myers.build_peq(pc, W, pl)
        d, _ = myers.myers_tile(peq, pl, tc, tl, "NW", W)
        return jax.lax.all_gather(d, shard_axes, axis=0, tiled=True)

    return step(jnp.asarray(pat_codes), jnp.asarray(pat_lens),
                jnp.asarray(txt_codes), jnp.asarray(txt_lens))
