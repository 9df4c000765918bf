"""Multi-chip sharded steps on the virtual 8-device CPU mesh.

Validates the dist layer (SURVEY.md §2.4 mapping: data parallelism over
reads, pair-stripe parallelism over the all-vs-all matrix, psum-merged
histograms) against the single-chip paths, which are themselves
oracle-parity-tested.
"""
import os

import jax
import numpy as np
import pytest

from nano_orc.demux.adapters import AdapterBank
from nano_orc.demux.fused import FusedDemux
from nano_orc.dist.sharded import (make_mesh, sharded_demux_step,
                                  sharded_dual_demux_step,
                                  sharded_pairwise_step)
from nano_orc.io import encode


@pytest.fixture(scope="module")
def banks(adapters_dir):
    sp5 = AdapterBank.from_fasta(f"{adapters_dir}/M13_amplicon_indices_forward.fa",
                                 0.1)
    sp27 = AdapterBank.from_fasta(
        f"{adapters_dir}/M13_amplicon_indices_reverse_rc.fa", 0.1)
    return sp5, sp27


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return make_mesh((4, 2))


def _reads(rng, sp5, sp27, B=32, L=256):
    seqs = []
    for i in range(B):
        ins = "".join(rng.choice(list("ACGT"),
                                 size=int(rng.integers(60, 120))))
        s = sp5.seqs[i % 12] + ins + sp27.seqs[i % 8]
        if i % 2:
            s = encode.revcomp(s)
        if i % 7 == 0:
            s = ins  # adapterless -> unknown
        seqs.append(s)
    return encode.pack_batch(seqs, max_len=L, pad_multiple=1,
                             encoder=encode.encode_read_masks, pad_value=0)


def test_sharded_dual_demux_matches_single_chip(banks, mesh, rng):
    sp5, sp27 = banks
    masks, lens = _reads(rng, sp5, sp27)
    (idx1, rc1, qe1, idx2, rc2, qs2, e1, e2, h1,
     h2) = sharded_dual_demux_step(mesh, sp5, sp27, masks, lens)
    want = FusedDemux(sp5, sp27).decide(masks, lens)
    np.testing.assert_array_equal(np.asarray(idx1), want.idx1)
    np.testing.assert_array_equal(np.asarray(rc1), want.rc1)
    np.testing.assert_array_equal(np.asarray(qe1), want.qe1)
    np.testing.assert_array_equal(np.asarray(idx2), want.idx2)
    np.testing.assert_array_equal(np.asarray(rc2), want.rc2)
    np.testing.assert_array_equal(np.asarray(qs2), want.qs2)
    sel1 = np.asarray(idx1) >= 0
    np.testing.assert_array_equal(np.asarray(e1)[sel1], want.err1[sel1])
    sel2 = np.asarray(idx2) >= 0
    np.testing.assert_array_equal(np.asarray(e2)[sel2], want.err2[sel2])
    # psum histograms cover every read exactly once
    assert int(np.asarray(h1).sum()) == masks.shape[0]
    assert int(np.asarray(h2).sum()) == masks.shape[0]
    assert int(np.asarray(h1)[0]) == int((want.idx1 < 0).sum())


def test_sharded_single_round_histogram(banks, mesh, rng):
    sp5, sp27 = banks
    masks, lens = _reads(rng, sp5, sp27)
    idx, m, qs, qe, hist = sharded_demux_step(mesh, sp5, masks, lens)
    assert int(np.asarray(hist).sum()) == masks.shape[0]
    # histogram agrees with the per-read assignments
    idx = np.asarray(idx)
    for a in range(-1, len(sp5)):
        assert int(np.asarray(hist)[a + 1]) == int((idx == a).sum())


def test_sharded_pairwise_matches_myers(banks, mesh, rng):
    from nano_orc.align import myers
    seqs = []
    base = "".join(rng.choice(list("ACGT"), size=200))
    for _ in range(16):
        s = list(base)
        for _ in range(10):
            s[int(rng.integers(0, len(s)))] = str(rng.choice(list("ACGT")))
        seqs.append(encode.encode_codes("".join(s)))
    pat = np.full((16, 256), 4, np.uint8)
    lens = np.zeros(16, np.int32)
    for i, c in enumerate(seqs):
        pat[i, :len(c)] = c
        lens[i] = len(c)
    D = np.asarray(sharded_pairwise_step(mesh, pat, lens, pat, lens))
    want = np.asarray(myers.distances(pat, lens, pat, lens))
    np.testing.assert_array_equal(D, want)


def test_run_all_mesh_byte_identical(adapters_dir, tmp_path, rng):
    """run_all with use_mesh=True on the virtual 8-device mesh produces
    BYTE-IDENTICAL outputs to the single-device run (VERDICT r1 next#3):
    the mesh only re-schedules the same device programs."""
    import filecmp
    from nano_orc.demux.adapters import AdapterBank
    from nano_orc.io.fastq import Record, write_records
    from nano_orc.pipeline.stages import PipelineConfig, run_all
    sp5 = AdapterBank.from_fasta(f"{adapters_dir}/M13_amplicon_indices_forward.fa",
                                 0.1)
    sp27 = AdapterBank.from_fasta(f"{adapters_dir}/M13_amplicon_indices_reverse_rc.fa",
                                  0.1)
    t1 = "".join(rng.choice(list("ACGT"), size=400))
    t2 = "".join(rng.choice(list("ACGT"), size=400))

    def noisy(t, k):
        s = list(t)
        for _ in range(k):
            s[int(rng.integers(0, len(s)))] = str(rng.choice(list("ACGT")))
        return "".join(s)

    from nano_orc.io import encode
    recs = []
    for i in range(40):
        tmpl = t1 if i % 2 else t2
        s = sp5.seqs[i % 3] + noisy(tmpl, 12) + sp27.seqs[i % 2]
        if i % 4 == 0:
            s = encode.revcomp(s)
        recs.append(Record(f"r{i}", f"r{i}", s, "I" * len(s)))
    fq = tmp_path / "in.fastq"
    write_records(str(fq), recs, fmt="fastq")

    rep1 = run_all(str(fq), str(tmp_path / "single"), "ds", "COI",
                   cfg=PipelineConfig(adapters_dir, use_mesh=False))
    rep2 = run_all(str(fq), str(tmp_path / "mesh"), "ds", "COI",
                   cfg=PipelineConfig(adapters_dir, use_mesh=True))
    assert rep1["demux"] == rep2["demux"]
    assert rep1["barcodes"] == rep2["barcodes"]
    # byte-compare every pipeline artifact (metrics/timing files differ)
    skip = {"metrics.json", "run_report.json"}
    import gzip
    for root, _, files in os.walk(tmp_path / "single"):
        for f in files:
            if f in skip:
                continue
            a = os.path.join(root, f)
            b = a.replace(str(tmp_path / "single"), str(tmp_path / "mesh"))
            assert os.path.exists(b), b
            if f.endswith(".gz"):
                assert gzip.open(a).read() == gzip.open(b).read(), a
            elif f == "results.txt":
                # run telemetry: pairs_scored counts DP invocations,
                # which legitimately differ per backend (the device
                # paths score fwd+rc for every gated pair; the native
                # path retries rc selectively)
                fa = [l for l in open(a) if not l.startswith("pairs_")]
                fb = [l for l in open(b) if not l.startswith("pairs_")]
                assert fa == fb, a
            else:
                assert filecmp.cmp(a, b, shallow=False), a


def test_multihost_two_process_localhost(tmp_path):
    """REAL 2-process jax.distributed on localhost (SURVEY §4 multi-host
    strategy; VERDICT r1 missing#6): both processes see the global
    4-device mesh, the psum'd histogram matches the global sum, and
    host_file_shard partitions files disjointly and completely."""
    import json
    import socket
    import subprocess
    import sys

    with socket.socket() as s:  # free port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    worker = os.path.join(os.path.dirname(__file__), "helpers",
                          "multihost_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(worker))))
    env["PYTHONPATH"] = os.pathsep.join(
        [repo_root] + env.get("PYTHONPATH", "").split(os.pathsep))
    procs = [subprocess.Popen(
        [sys.executable, worker, coord, "2", str(pid), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{so}\n{se}"
    r0 = json.load(open(tmp_path / "result_0.json"))
    r1 = json.load(open(tmp_path / "result_1.json"))
    assert r0["pcount"] == r1["pcount"] == 2
    assert r0["ndev_global"] == 4 and r0["ndev_local"] == 2
    assert r0["is_coord"] and not r1["is_coord"]
    # both processes agree on the globally psum'd histogram:
    # sum over ALL 4 shards of arange rows
    n = 4
    expect = np.arange(n * 4).reshape(n, 4).sum(axis=0).tolist()
    assert r0["hist"] == expect and r1["hist"] == expect
    # file shards: disjoint, complete, deterministic
    all_files = sorted(r0["files"] + r1["files"])
    assert all_files == [f"bin_{i:02d}.fastq" for i in range(7)]
    assert not set(r0["files"]) & set(r1["files"])


def test_multihost_two_process_e2e_consensusfile(tmp_path):
    """Multi-host END-TO-END (VERDICT r4 next#7): 2 jax.distributed
    processes sort disjoint host_file_shard bins, the coordinator
    merges the run-level consensusfile.fasta, and the result is
    byte-identical to a single-process run over all bins."""
    import json
    import socket
    import subprocess
    import sys

    from nano_orc.cluster.engine import AmpliconSorter, SorterConfig
    from nano_orc.cluster.output import write_barcode_consensus
    from nano_orc.cluster.scoring import DeviceScorer
    from nano_orc.io.fastq import Record, read_records, write_records

    rng = np.random.default_rng(99)
    indir = tmp_path / "bins_in"
    indir.mkdir()
    for b in range(3):
        t1 = "".join(rng.choice(list("ACGT"), size=360))
        t2 = "".join(rng.choice(list("ACGT"), size=370))
        recs = []
        for i in range(24):
            t = t1 if i < 12 else t2
            s = list(t)
            for p in rng.choice(len(s), 6, replace=False):
                s[int(p)] = "ACGT"[int(rng.integers(4))]
            recs.append(Record(f"b{b}r{i}", f"b{b}r{i}", "".join(s),
                               "I" * len(s)))
        write_records(str(indir / f"SP27_00{b + 1}_SP5_001.fastq"),
                      recs, fmt="fastq")

    # single-process reference: same per-bin seeding, sorted bin order
    ref_dir = tmp_path / "ref"
    for path in sorted(indir.glob("*.fastq")):
        barcode = path.stem
        srt = AmpliconSorter(SorterConfig(min_length=300, seed=7),
                             scorer=DeviceScorer(backend="native"))
        result = srt.sort_records(list(read_records(str(path))))
        write_barcode_consensus(result, str(ref_dir / "bins"), barcode,
                                "e2e")
    ref = "".join(
        open(p).read() for p in sorted(
            (ref_dir / "bins").glob("*_consensus_e2e.fasta")))
    assert ref.count(">") >= 3  # every bin contributes >= 1 group

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    worker = os.path.join(os.path.dirname(__file__), "helpers",
                          "multihost_e2e_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(worker))))
    env["PYTHONPATH"] = os.pathsep.join(
        [repo_root] + env.get("PYTHONPATH", "").split(os.pathsep))
    outdir = tmp_path / "mh"
    outdir.mkdir()
    procs = [subprocess.Popen(
        [sys.executable, worker, coord, "2", str(pid), str(indir),
         str(outdir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{so}\n{se}"
    r0 = json.load(open(outdir / "e2e_result_0.json"))
    r1 = json.load(open(outdir / "e2e_result_1.json"))
    assert r0["is_coord"] and not r1["is_coord"]
    assert not set(r0["bins"]) & set(r1["bins"])
    assert len(r0["bins"]) + len(r1["bins"]) == 3
    merged = open(outdir / "consensusfile.fasta").read()
    assert merged == ref
