"""Benchmark of the amplicon pipeline's device paths, in one process.

    python bench.py [--sections demux,cluster,sort,longsort,reorient,plate]
                    [--seed N] [--reps N] [--scale F]

Inputs are made from ``--seed``: the adapter/primer banks by
``nano_orc.synth`` and synthetic reads of the reference's shapes. Each
section times its workload over ``--reps`` warm repetitions after one
untimed call that compiles it, and reports the median, min and max.
Progress goes to standard error; standard output gets one JSON object
per section and, last, one summary object. Every line names the device
(JAX platform, device kind and count, and the card's name and power
limit from nvidia-smi). A failed section fails the run. ``--scale``
multiplies every read count (a small value checks the script on the CPU).

Sections:

* ``demux``: the fused dual-round demux (``FusedDemux.assign``) on
  16,384 reads, with its parts: the XLA locate of one round
  (``batched_locate_with_rc``, FRONT and BACK over 12 adapters at
  L = 512), the INFIX scan of stage 01 on 8,192 reads, and the host's
  pack and materialize of one 2,048-read chunk. CPU baseline: the native
  C++ locate on one core, both rounds, forward and reverse complement.
* ``cluster``: all-vs-all NW distances of 1,024 reads of ~480 bp and of
  1,000 reads of ~3.5 kb, on the platform's Myers route against the XLA
  scan (``align/myers.py``); native C++ on one core as the CPU baseline.
* ``sort``: one 1,000-read two-species bin of ~450 bp through the whole
  sorter, with each scorer backend; ``longsort``: the same at ~3.5 kb.
* ``reorient``: stage 01 (``Reorienter.run``) on 8,192 reads.
* ``plate``: ``run_all`` on a seeded 96-bin COI plate (80 reads a bin).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SECTIONS = ("demux", "cluster", "sort", "longsort", "reorient", "plate")


def note(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def device_info() -> dict:
    import jax
    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": None, "power_limit": None}
    if devs[0].platform == "gpu":
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        info["card"], info["power_limit"] = (x.strip()
                                             for x in out.split(","))
    return info


def timed(fn, reps: int) -> dict:
    """One untimed call (compiles), then ``reps`` timed calls; fn
    blocks until its result is on the host."""
    t0 = time.perf_counter()
    fn()
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return {"first_s": first, "median_s": float(np.median(ts)),
            "min_s": min(ts), "max_s": max(ts), "reps": reps}


def cpu_rate(fn, work: float, min_s: float = 2.0) -> float:
    """Work per second of ``fn`` repeated for at least ``min_s``."""
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < min_s:
        fn()
        n += 1
    return n * work / (time.perf_counter() - t0)


def rand_seq(rnd: random.Random, n: int) -> str:
    return "".join(rnd.choice("ACGT") for _ in range(n))


def mutate(rnd: random.Random, s: str, k: int) -> str:
    s = list(s)
    for _ in range(k):
        op, p = rnd.randrange(3), rnd.randrange(len(s))
        if op == 0:
            s[p] = rnd.choice("ACGT")
        elif op == 1 and len(s) > 1:
            del s[p]
        else:
            s.insert(p, rnd.choice("ACGT"))
    return "".join(s)


def two_species_bin(seed: int, length: int, k_species: int, k_read: int,
                    per_species: int = 500):
    """Two species ``k_species`` edits apart, ``per_species`` reads each
    with ``k_read`` edits."""
    from nano_orc.io.fastq import Record
    rnd = random.Random(seed)
    t1 = rand_seq(rnd, length)
    t2 = mutate(rnd, t1, k_species)
    recs = [Record(f"r{k}_{i}", "", mutate(rnd, t, k_read), None)
            for k, t in enumerate((t1, t2)) for i in range(per_species)]
    rnd.shuffle(recs)
    return recs


def family(rng, n: int, L: int, length: int, subs: int):
    """[n, L] codes of one template with ``subs`` substitutions each."""
    base = rng.integers(0, 4, length)
    pat = np.full((n, L), 4, np.uint8)
    lens = np.zeros(n, np.int32)
    for i in range(n):
        s = base.copy()
        s[rng.integers(0, length, subs)] = rng.integers(0, 4, subs)
        ln = length - int(rng.integers(0, 20))
        pat[i, :ln] = s[:ln]
        lens[i] = ln
    return pat, lens


# ---------------------------------------------------------------------------
# Sections
# ---------------------------------------------------------------------------

def section_demux(ctx) -> dict:
    import jax

    from nano_orc import native
    from nano_orc.align.batched import batched_locate, batched_locate_with_rc
    from nano_orc.align.spec import BACK, FRONT, Flag
    from nano_orc.demux.demux import materialize_batch
    from nano_orc.demux.fused import FusedDemux
    from nano_orc.demux.reorient import Reorienter
    from nano_orc.io import encode
    from nano_orc.io.fastq import Record
    sp5, sp27, reps = ctx["sp5"], ctx["sp27"], ctx["reps"]
    rng = np.random.default_rng(ctx["seed"])
    B, CHUNK = ctx["n"](16384), 2048
    seqs = []
    for i in range(B):
        ins = "".join(rng.choice(list("ACGT"), size=380))
        s = sp5.seqs[i % 12] + ins + sp27.seqs[i % 8]
        seqs.append(encode.revcomp(s) if i % 2 else s)
    recs = [Record(f"r{i}", f"r{i}", s, "I" * len(s))
            for i, s in enumerate(seqs)]
    out = {}
    fd = FusedDemux(sp5, sp27)
    note("demux: fused dual-round demux")
    t = timed(lambda: fd.assign(recs, batch_size=CHUNK), reps)
    out["demux"] = dict(t, reads=B, reads_per_s=B / t["median_s"])

    amat, lens = encode.ascii_matrix(seqs, max_len=512)
    masks = encode.read_masks_matrix(amat, lens)
    for bank, flag, name in ((sp5, FRONT, "front"), (sp27, BACK, "back")):
        note(f"demux: locate {name}")
        t = timed(lambda bank=bank, flag=flag: jax.block_until_ready(
            batched_locate_with_rc(bank.masks, bank.lens, bank.k_table,
                                   bank.n_prefix, masks, lens, int(flag))),
            reps)
        out[f"locate_{name}"] = dict(t, reads=B, adapters=len(bank),
                                     read_len=512)
    reo = Reorienter(os.path.join(ctx["banks"], ctx["synth"].PYCHOPPER_FASTA),
                     ctx["synth"].CONFIG)
    ib = reo._bank_for(0.75)[0]
    infix = int(Flag.START_WITHIN_SEQ2 | Flag.STOP_WITHIN_SEQ2)
    BI = B // 2
    note("demux: locate infix")
    t = timed(lambda: jax.block_until_ready(batched_locate(
        ib.masks, ib.lens, ib.k_table, ib.n_prefix, masks[:BI],
        lens[:BI], infix)), reps)
    out["locate_infix"] = dict(t, reads=BI, adapters=len(ib),
                               read_len=512)

    CHUNK = min(CHUNK, B)
    chunk = recs[:CHUNK]

    def pack():
        a, ln = encode.ascii_matrix([r.seq for r in chunk], max_len=512)
        encode.read_masks_matrix(a, ln)
    out["host_pack_chunk"] = dict(timed(pack, reps), reads=CHUNK)
    idx = np.arange(CHUNK, dtype=np.int32) % 12
    z = np.zeros(CHUNK, np.int32)
    a2, l2 = amat[:CHUNK], lens[:CHUNK]
    out["host_materialize_chunk"] = dict(timed(lambda: materialize_batch(
        chunk, sp5.names, sp27.names, idx, z, z + 59, idx % 8, z,
        l2 - 120, amat=a2, lens=l2), reps), reads=CHUNK)

    refs5 = [encode.encode_ref_masks(s) for s in sp5.seqs]
    refs27 = [encode.encode_ref_masks(s) for s in sp27.seqs]
    cpu = seqs[:128] + [encode.revcomp(s) for s in seqs[:128]]
    qm = [encode.encode_read_masks(s) for s in cpu]

    def cpu_demux():
        native.locate_batch(refs5, qm, 0.1, int(FRONT), nthreads=1)
        native.locate_batch(refs27, qm, 0.1, int(BACK), nthreads=1)
    note("demux: CPU baseline")
    out["cpu_demux_reads_per_s_1core"] = cpu_rate(cpu_demux, len(cpu) / 2)
    return out


def section_cluster(ctx) -> dict:
    import jax
    import jax.numpy as jnp

    from nano_orc import device, native
    from nano_orc.align import myers
    rng = np.random.default_rng(ctx["seed"] + 1)
    out = {}
    for name, n, L, length, subs in (
            ("480bp", ctx["n"](1024), 512, 480, 30),
            ("3500bp", ctx["n"](1000), 3584, 3500, 200)):
        pat, lens = family(rng, n, L, length, subs)
        cells = float(lens.astype(np.float64).sum()) ** 2
        if device.on_gpu():
            from nano_orc.align import myers_gpu

            def route():
                d, _ = myers_gpu.distances(pat, lens, pat, lens, "NW",
                                           lazy=True)
                d.block_until_ready()
        else:
            def route():
                native.all_vs_all([pat[i, :lens[i]] for i in range(n)],
                                  band=0.0)
        W = myers.n_words(L)
        peq = myers.build_peq(jnp.asarray(pat), W, jnp.asarray(lens))
        dl, dp = jnp.asarray(lens), jnp.asarray(pat)

        def xla():
            jax.block_until_ready(myers.myers_tile(peq, dl, dp, dl, "NW",
                                                   W)[0])
        # on the CPU, XLA takes many minutes to compile the 112-word scan
        labels = (("route", route), ("xla", xla)) \
            if device.on_gpu() or L < 1024 else (("route", route),)
        for label, fn in labels:
            note(f"cluster: {name} {label}")
            t = timed(fn, ctx["reps"])
            out[f"{name}_{label}"] = dict(t, pairs=n * n,
                                          cells_per_s=cells / t["median_s"])
    fam = [pat[i, :lens[i]] for i in range(min(192, n))]
    cells = float(np.mean([len(c) for c in fam])) ** 2 * len(fam) * (
        len(fam) - 1)
    note("cluster: CPU baseline")
    out["cpu_cells_per_s_1core"] = cpu_rate(
        lambda: native.all_vs_all(fam, band=0.0, nthreads=1), cells)
    out["route"] = "gpu kernel" if device.on_gpu() else "native"
    return out


def _sort(recs, backend):
    from nano_orc.cluster.engine import AmpliconSorter, SorterConfig
    from nano_orc.cluster.scoring import DeviceScorer
    cfg = SorterConfig(min_length=300, seed=7)
    res = AmpliconSorter(cfg, scorer=DeviceScorer(
        tile=cfg.tile, backend=backend)).sort_records(recs)
    return [(s.members, s.consensus) for g in res.species for s in g]


def _sort_section(ctx, recs, backends, label) -> dict:
    out, sigs = {}, {}
    for be in backends:
        note(f"{label}: {be} scorer")
        box = []
        t = timed(lambda: box.append(_sort(recs, be)), ctx["reps"])
        sigs[be] = box[-1]
        out[be] = dict(t, reads=len(recs), species=len(box[-1]))
    ref = sigs[backends[-1]]
    out["identical"] = all(s == ref for s in sigs.values())
    if not out["identical"]:
        raise AssertionError(f"{label}: scorer backends disagree")
    return out


def section_sort(ctx) -> dict:
    from nano_orc import device
    backends = (("gpu",) if device.on_gpu() else ()) + ("xla", "native")
    return _sort_section(ctx, two_species_bin(2, 450, 60, 27, ctx["n"](500)),
                         backends, "sort")


def section_longsort(ctx) -> dict:
    from nano_orc import device
    backends = ("gpu", "xla") if device.on_gpu() else ("native",)
    return _sort_section(
        ctx, two_species_bin(5, 3500, 450, 200, ctx["n"](500)), backends,
        "longsort")


def section_reorient(ctx) -> dict:
    from nano_orc.demux.reorient import ReorientConfig, Reorienter
    from nano_orc.io import encode
    from nano_orc.io.fastq import Record, read_fasta
    synth = ctx["synth"]
    rng = np.random.default_rng(ctx["seed"] + 2)
    m13 = {r.id: r.seq.upper() for r in read_fasta(
        os.path.join(ctx["banks"], synth.PYCHOPPER_FASTA))}

    def fill(s):
        return "".join(c if c != "N" else str(rng.choice(list("ACGT")))
                       for c in s)
    recs = []
    for i in range(ctx["n"](8192)):
        ins = "".join(rng.choice(list("ACGT"), size=380))
        s = fill(m13["SP5"]) + ins + encode.revcomp(fill(m13["SP27"]))
        if i % 3 == 1:
            s = encode.revcomp(s)
        if i % 17 == 0:
            s = ins  # unclassifiable
        recs.append(Record(f"q{i}", f"q{i}", s, "I" * len(s)))
    reo = Reorienter(os.path.join(ctx["banks"], synth.PYCHOPPER_FASTA),
                     synth.CONFIG, ReorientConfig(q=0.75))
    note("reorient")
    box = []
    t = timed(lambda: box.append(reo.run(recs)), ctx["reps"])
    return dict(t, reads=len(recs), reads_per_s=len(recs) / t["median_s"],
                passed=box[-1].stats["pass"])


def section_plate(ctx) -> dict:
    from nano_orc.io.fastq import write_records
    from nano_orc.pipeline.stages import PipelineConfig, run_all
    recs, made = ctx["synth"].coi_plate(ctx["banks"], ctx["seed"],
                                        reads_per_bin=ctx["n"](80),
                                        large_bins=0)
    work = ctx["work"]
    fq = os.path.join(work, "plate.fastq")
    write_records(fq, recs, fmt="fastq")
    cfg = PipelineConfig(adapters_dir=ctx["banks"])
    box = []

    def run():
        out = os.path.join(work, "plate_out")
        shutil.rmtree(out, ignore_errors=True)
        # run_all narrates to stdout, which holds the JSON lines
        with contextlib.redirect_stdout(sys.stderr):
            box.append(run_all(fq, out, "plate", "COI", cfg))
    note(f"plate: run_all on {len(recs)} reads")
    t = timed(run, ctx["reps"])
    rep = box[-1]
    stage_s = {}
    for st in rep["metrics"]["stages"]:
        key = st["stage"].split("/")[0]
        stage_s[key] = stage_s.get(key, 0.0) + st["wall_s"]
    if len(rep["barcodes"]) != len(made):
        raise AssertionError(f"plate: {len(rep['barcodes'])} of "
                             f"{len(made)} bins")
    return dict(t, reads=len(recs), reads_per_s=len(recs) / t["median_s"],
                bins=len(rep["barcodes"]), stage_s_last_rep=stage_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sections", default=",".join(SECTIONS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)
    sections = args.sections.split(",")
    unknown = set(sections) - set(SECTIONS)
    if unknown:
        ap.error(f"unknown sections {sorted(unknown)}")

    from nano_orc import device, synth
    from nano_orc.demux.adapters import AdapterBank
    device.platform()  # a GPU or the CPU, else an error
    dev = device_info()
    work = tempfile.mkdtemp(prefix="bench-")
    try:
        banks = synth.write_banks(os.path.join(work, "adapters"), args.seed)
        ctx = {"seed": args.seed, "reps": args.reps, "banks": banks,
               "n": lambda full: max(4, round(full * args.scale)),
               "synth": synth, "work": work,
               "sp5": AdapterBank.from_fasta(
                   os.path.join(banks, synth.SP5_FASTA), 0.1),
               "sp27": AdapterBank.from_fasta(
                   os.path.join(banks, synth.SP27RC_FASTA), 0.1)}
        t0 = time.perf_counter()
        for name in sections:
            res = globals()[f"section_{name}"](ctx)
            print(json.dumps({"section": name, "device": dev,
                              "result": res}), flush=True)
        print(json.dumps({"sections": sections, "device": dev,
                          "wall_s": time.perf_counter() - t0}))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
