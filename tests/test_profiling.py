"""Observability layer: stage timers, throughput counters, device trace.

The reference's observability is echo narration + results.txt audit
trails (SURVEY.md §5); this checks the replacement."""
import json
import os

from nano_orc.utils.profiling import Metrics, device_trace


def test_stage_timer_counters_and_throughput(tmp_path, capsys):
    met = Metrics(run="r1")
    with met.stage("02_demux") as st:
        st.count(n_reads=100)
        st.count(n_reads=28)  # accumulates
    with met.stage("03_sort") as st:
        st.count(n_reads=64, n_cells=1e6)
    d = met.as_dict()
    assert [s["stage"] for s in d["stages"]] == ["02_demux", "03_sort"]
    s0 = d["stages"][0]
    assert s0["n_reads"] == 128
    assert s0["reads_per_s"] > 0          # derived from n_ counters
    assert d["total_wall_s"] >= s0["wall_s"]
    out = capsys.readouterr().out          # narration lines
    assert "[nano_orc] r1/02_demux" in out and "n_reads=128" in out
    p = tmp_path / "metrics.json"
    met.write(str(p))
    assert json.load(open(p))["run"] == "r1"


def test_stage_timer_skips_on_exception():
    met = Metrics(run="r", verbose=False)
    try:
        with met.stage("bad"):
            raise RuntimeError("boom")
    except RuntimeError:
        pass
    assert met.stages == []  # failed stages don't pollute metrics


def test_device_trace_noop_without_dir(monkeypatch):
    monkeypatch.delenv("ORC_TRACE", raising=False)
    with device_trace(None) as d:
        assert d is None


def test_device_trace_writes_profile(tmp_path):
    import jax.numpy as jnp
    with device_trace(str(tmp_path / "tr")) as d:
        assert d is not None
        (jnp.ones((8, 8)) @ jnp.ones((8, 8))).block_until_ready()
    # profiler emits plugins/profile/<ts>/ under the trace dir
    found = []
    for root, _, files in os.walk(tmp_path / "tr"):
        found += [f for f in files if f.endswith((".xplane.pb", ".trace.json.gz", ".json.gz"))]
    assert found, "no profiler artifacts written"


def test_run_all_writes_metrics(adapters_dir, tmp_path, rng):
    """metrics.json lands next to run_report.json with per-stage rows."""
    from nano_orc.demux.adapters import AdapterBank
    from nano_orc.io import encode
    from nano_orc.pipeline.stages import PipelineConfig, run_all
    sp5 = AdapterBank.from_fasta(f"{adapters_dir}/M13_amplicon_indices_forward.fa",
                                 0.1)
    sp27 = AdapterBank.from_fasta(
        f"{adapters_dir}/M13_amplicon_indices_reverse_rc.fa", 0.1)
    # pychopper-style reads: SP5...insert...SP27 with quality lines
    fq = tmp_path / "in.fastq"
    with open(fq, "w") as fh:
        for i in range(24):
            ins = "".join(rng.choice(list("ACGT"), size=320))
            s = sp5.seqs[i % 2] + ins + sp27.seqs[i % 2]
            fh.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
    rep = run_all(str(fq), str(tmp_path / "out"), "ds", "COI",
                  cfg=PipelineConfig(adapters_dir))
    mpath = tmp_path / "out" / "metrics.json"
    assert mpath.exists()
    m = json.load(open(mpath))
    names = [s["stage"] for s in m["stages"]]
    assert names[0] == "00_qc" and "02_demux" in names
    demux = next(s for s in m["stages"] if s["stage"] == "02_demux")
    assert demux["n_reads"] > 0 and "reads_per_s" in demux
    assert rep["metrics"]["total_wall_s"] > 0
