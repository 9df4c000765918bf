"""Smoke run of the amplicon pipeline on an NVIDIA GPU, in one process.

    python chip_smoke.py [--seed N]     one card
    python chip_smoke.py --four         the mesh path on four cards

One card: the ``gpu``-marked parity tests, then a seeded 96-bin COI plate
(80 reads per bin, four bins of 1,000 reads) and a 3.5 kb rRNA input
through ``run-all``, checked against the repository's references: demux
bins against the native C++ locate, the large bins' sort outputs against
the native scorer, stage-05 calls against the float64 host Viterbi.
``--four``: only the plate through ``run-all --mesh`` on four cards,
byte for byte against the one-card run of the same plate.

Stage times and compile time are printed as this run's own lines; they
are not benchmark metrics. The last line of standard output is one JSON
object naming the device. Any failed phase exits non-zero.
"""
from __future__ import annotations

import argparse
import contextlib
import filecmp
import gzip
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def say(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)
    say(f"ok: {what}")


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def compile_seconds():
    """Running total of JAX's compile events (tracing, lowering, backend
    compile) in this process, summed over threads: bins compile
    concurrently, so the total can exceed the wall time."""
    import jax
    total = [0.0]

    def listen(event, duration, **_):
        if "compile" in event:
            total[0] += duration
    jax.monitoring.register_event_duration_secs_listener(listen)
    return total


def run_all(argv):
    """``nano_orc.cli run-all``; returns the run report (the CLI prints
    it as JSON, kept off this script's output)."""
    from nano_orc import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["run-all"] + argv)
    check(rc == 0, f"run-all {' '.join(argv[-6:])} exits 0")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def stage_lines(report, label):
    """Per-stage wall time summed over bins."""
    sums = {}
    for st in report["metrics"]["stages"]:
        key = st["stage"].split("/")[0]
        sums[key] = sums.get(key, 0.0) + st["wall_s"]
    for key, s in sums.items():
        say(f"stage time [{label}] {key}: {s:.3f} s")


def tree_files(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f in ("metrics.json", "run_report.json"):
                continue  # wall times
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = p
    return out


def same_file(a, b):
    """Byte equality; gzip files by content (the header holds a time)."""
    if a.endswith(".gz"):
        with gzip.open(a) as fa, gzip.open(b) as fb:
            return fa.read() == fb.read()
    return filecmp.cmp(a, b, shallow=False)


def same_tree(a, b):
    """Relative paths that differ between two output trees."""
    fa, fb = tree_files(a), tree_files(b)
    diff = sorted(set(fa) ^ set(fb))
    diff += sorted(k for k in set(fa) & set(fb)
                   if not same_file(fa[k], fb[k]))
    return diff


def write_plate(work, seed, banks):
    from nano_orc import synth
    from nano_orc.io.fastq import write_records
    recs, made = synth.coi_plate(banks, seed)
    fq = os.path.join(work, "plate.fastq")
    write_records(fq, recs, fmt="fastq")
    say(f"plate: {len(made)} bins, {len(recs)} reads, "
        f"{sum(1 for n in made.values() if n > min(made.values()))} bins "
        f"of {max(made.values())} reads")
    return fq, made


def native_demux_bins(pass_fastq, banks):
    """Both demux rounds over the reoriented reads with the native C++
    locate in place of the device: {bin: [(desc, seq, qual)]}."""
    import unittest.mock as mock

    import numpy as np

    from nano_orc import native, synth
    from nano_orc.align.batched import LocateResult
    from nano_orc.demux import demux as D
    from nano_orc.demux.adapters import AdapterBank
    from nano_orc.io import encode
    from nano_orc.io.fastq import read_records

    def native_fwd_rc(bank, masks, lens, flags, min_overlap=3):
        refs = [encode.encode_ref_masks(s) for s in bank.seqs]
        out = []
        for m in (masks, encode.revcomp_read_masks(masks, lens)):
            o, v = native.locate_batch(
                refs, [m[i, :lens[i]] for i in range(len(lens))],
                bank.max_error_rate, int(flags), min_overlap)
            z = np.zeros_like(v, dtype=np.int32)
            out.append(LocateResult(v.astype(np.int32), o[:, :, 4],
                                    o[:, :, 5], o[:, :, 0], o[:, :, 1],
                                    o[:, :, 2], o[:, :, 3], z, z))
        return tuple(out)

    sp5 = AdapterBank.from_fasta(os.path.join(banks, synth.SP5_FASTA), 0.1)
    sp27 = AdapterBank.from_fasta(os.path.join(banks, synth.SP27RC_FASTA),
                                  0.1)
    recs = list(read_records(pass_fastq))
    with mock.patch.object(D, "locate_fwd_rc", native_fwd_rc):
        rows = D._decisions_unfused(recs, sp5, sp27, 2048)
    bins = {}
    for sp5_name, _, sp27_name, final, *_ in rows:
        if sp5_name is None or sp27_name is None \
                or sp27_name in D.INVALID_SP27:
            continue
        bins.setdefault(f"{sp27_name}_{sp5_name}", []).append(
            (final.desc, final.seq, final.qual))
    return bins


def device_demux_bins(out, dataset):
    from nano_orc.io.fastq import read_records
    d = os.path.join(out, "demuxed", "SP27")
    bins = {}
    suffix = f"_{dataset}.fastq.gz"
    for f in sorted(os.listdir(d)):
        if not f.endswith(suffix):
            continue
        name = f[:-len(suffix)]
        bins[name] = [(r.desc, r.seq, r.qual)
                      for r in read_records(os.path.join(d, f))]
    return bins


def check_sort_vs_native(out, work, dataset, banks, large):
    """Re-sort the large bins with the native scorer; the sort outputs
    must be byte-identical to the device run's."""
    from nano_orc.cluster.scoring import DeviceScorer
    from nano_orc.pipeline import stages
    cfg = stages.PipelineConfig(adapters_dir=banks)
    nat = os.path.join(work, "native_sort")
    for comb in large:
        binf = os.path.join(out, "demuxed", "SP27",
                            f"{comb}_{dataset}.fastq.gz")
        nt = sum(len(r.seq) for r in stages.read_records(binf))
        check(nt > stages.NATIVE_SMALL_BIN_NT,
              f"{comb}: {nt} nt > {stages.NATIVE_SMALL_BIN_NT}, so the "
              f"device scorer sorted it")
        stages.stage_sort(binf, nat, comb, "amplicons", cfg,
                          scorer=DeviceScorer(backend="native"))
        diff = same_tree(os.path.join(out, "sorted", comb),
                         os.path.join(nat, "sorted", comb))
        check(not diff, f"{comb}: sort outputs byte-identical to the "
                        f"native scorer ({diff[:3]})")


def check_rrna_vs_host_viterbi(out, work, dataset):
    """Stage 05 again with the float64 host Viterbi in place of the
    device scan: identical calls and hit files; device scores within
    1e-3 nats (float32 prefix sums in another summation order)."""
    import unittest.mock as mock

    import numpy as np

    from nano_orc.io.fastq import read_records
    from nano_orc.rrna import hmm, profiles
    from nano_orc.rrna.extract import extract_rrna

    worst = [0.0]

    def host_scan(profile, seqs, lens):
        dev = hmm.viterbi_scan(profile, seqs, lens)
        host = [hmm.viterbi_host(profile, seqs[k, :lens[k]])
                for k in range(len(lens))]
        hs = np.array([h[0] for h in host])
        worst[0] = max(worst[0], float(np.max(np.abs(dev[0] - hs))))
        check(all((int(dev[1][k]), int(dev[2][k])) == host[k][1:]
                  for k in range(len(lens))),
              f"Viterbi end positions and nodes equal the host "
              f"({len(lens)} scans of K={profile.K})")
        return (hs, np.array([h[1] for h in host]),
                np.array([h[2] for h in host]))

    for d in sorted(os.listdir(os.path.join(out, "primerless"))):
        cleaned = os.path.join(out, "primerless", d, f"cleaned_{d}.fasta")
        recs = list(read_records(cleaned))
        host_dir = os.path.join(work, "host_rrna")
        with mock.patch.object(profiles, "viterbi_scan", host_scan):
            hits = extract_rrna(recs, host_dir, d)
        check(all(len(h) >= 1 for h in hits.values()),
              f"{d}: 18S and 28S found")
        for g in ("18S", "28S"):
            a = os.path.join(out, "rRNA_genes", f"{d}_{g}.fa")
            b = os.path.join(host_dir, f"{d}_{g}.fa")
            check(filecmp.cmp(a, b, shallow=False),
                  f"{d}: {g} hits equal the float64 host Viterbi calls")
    check(worst[0] <= 1e-3, f"Viterbi scores within 1e-3 nats of float64 "
                            f"(worst {worst[0]:.2e})")


def one_card(args, work):
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(HERE, "tests")])
    check(rc == 0, "gpu-marked parity tests pass")

    from nano_orc import synth
    from nano_orc.align import myers_gpu
    banks = synth.write_banks(os.path.join(work, "adapters"), args.seed)
    fq, made = write_plate(work, args.seed, banks)
    calls = [0]
    kernel = myers_gpu.myers_pairs

    def counted(*a, **k):
        calls[0] += 1
        return kernel(*a, **k)
    myers_gpu.myers_pairs = counted
    comp = compile_seconds()
    out = os.path.join(work, "coi")
    t0 = time.perf_counter()
    rep = run_all([fq, "-o", out, "-n", "plate", "-a", "COI",
                   "--adapters-dir", banks])
    say(f"run-all COI plate: {time.perf_counter() - t0:.3f} s wall, "
        f"compile events {comp[0]:.3f} s summed over threads, {calls[0]} "
        f"Myers kernel calls")
    stage_lines(rep, "COI plate")
    check(calls[0] > 0, "the Myers kernel ran in the sort stage")
    check(rep["demux"]["bins"] == len(made),
          f"demux found all {len(made)} bins")
    check(device_demux_bins(out, "plate")
          == native_demux_bins(os.path.join(out, "pychopped",
                                            "plate_pass.fastq"), banks),
          "demux bins identical to the native C++ locate")
    large = [b for b, n in made.items() if n > min(made.values())]
    check_sort_vs_native(out, work, "plate", banks, large)

    from nano_orc.io.fastq import write_records
    rfq = os.path.join(work, "rrna.fastq")
    write_records(rfq, synth.rrna_input(banks, args.seed + 1), fmt="fastq")
    rout = os.path.join(work, "rrna")
    c0 = comp[0]
    t0 = time.perf_counter()
    rrep = run_all([rfq, "-o", rout, "-n", "rrna", "-a", "RNA",
                    "--adapters-dir", banks])
    say(f"run-all RNA 2 x 300 reads of 3.5 kb: "
        f"{time.perf_counter() - t0:.3f} s wall, compile events "
        f"{comp[0] - c0:.3f} s summed over threads")
    stage_lines(rrep, "RNA")
    check(rrep["demux"]["bins"] == 2, "RNA demux found both bins")
    check_rrna_vs_host_viterbi(rout, work, "rrna")


def four_cards(args, work):
    import jax

    from nano_orc import synth
    from nano_orc.align import myers_gpu
    from nano_orc.demux import fused
    devs = jax.devices()
    check(len(devs) == 4, f"four devices ({len(devs)})")
    banks = synth.write_banks(os.path.join(work, "adapters"), args.seed)
    fq, made = write_plate(work, args.seed, banks)
    one = os.path.join(work, "one")
    t0 = time.perf_counter()
    run_all([fq, "-o", one, "-n", "plate", "-a", "COI",
             "--adapters-dir", banks])
    say(f"run-all COI plate, one card: {time.perf_counter() - t0:.3f} s")

    seen = {"myers": set(), "demux": set()}
    dist, dispatch = myers_gpu.distances, fused.FusedDemux._dispatch

    def rec_distances(*a, **k):
        out = dist(*a, **k)
        if k.get("device") is not None:
            seen["myers"].update(d.id for d in out[0].devices())
        return out

    def rec_dispatch(self, masks, lens, dev=None):
        out = dispatch(self, masks, lens, dev)
        if dev is not None:
            seen["demux"].update(d.id for d in out.devices())
        return out
    myers_gpu.distances = rec_distances
    fused.FusedDemux._dispatch = rec_dispatch
    mesh = os.path.join(work, "mesh")
    t0 = time.perf_counter()
    rep = run_all([fq, "-o", mesh, "-n", "plate", "-a", "COI",
                   "--adapters-dir", banks, "--mesh"])
    say(f"run-all COI plate, --mesh on four cards: "
        f"{time.perf_counter() - t0:.3f} s")
    stage_lines(rep, "COI plate --mesh")
    ids = {d.id for d in devs}
    check(seen["demux"] == ids, f"demux stripes ran on devices "
                                f"{sorted(seen['demux'])}")
    check(seen["myers"] == ids, f"Myers stripes ran on devices "
                                f"{sorted(seen['myers'])}")
    diff = same_tree(one, mesh)
    check(not diff, f"--mesh outputs byte-identical to one card "
                    f"({diff[:3]})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the mesh path on four cards")
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 2
    say(f"device_kind: {devs[0].device_kind}; devices: {len(devs)}")
    say(gpu_name_and_power())  # name, power limit (one line per card)

    work = tempfile.mkdtemp(prefix=".smoke-", dir=HERE)
    try:
        (four_cards if args.four else one_card)(args, work)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
