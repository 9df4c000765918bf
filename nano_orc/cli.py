"""nano_orc command line: one CLI with subcommands mirroring the
reference's SLURM stages 00-09 plus run-all (SURVEY.md §7.1 cli/).

    python -m nano_orc.cli qc        <fastq> -o OUT -n NAME
    python -m nano_orc.cli reorient  <fastq> -o OUT -n NAME
    python -m nano_orc.cli demux     <fastq> -o OUT -n DATASET
    python -m nano_orc.cli sort      <bin.fastq> -o OUT -b BARCODE [-p PREFIX]
                                    [--min N] [--max N] [--seed N]
    python -m nano_orc.cli clean     <consensus.fasta> -o OUT -b BARCODE
                                    -a {COI,RNA}
    python -m nano_orc.cli rrna      <contigs.fasta> -o OUT -b BARCODE
                                    [--exemplars-18s F] [--exemplars-28s F]
    python -m nano_orc.cli extract-max  <dir> -o OUT {ribo,coi}
    python -m nano_orc.cli summary   <sorted-dir> -o OUT.tsv
    python -m nano_orc.cli blast-top5 <blast.tsv> -o OUT.tsv
    python -m nano_orc.cli reorganise <csv> --coi F --r18s F --r28s F -o OUT
    python -m nano_orc.cli prep-anchors <aligned.fa> <samples.fa> -g GENE
    python -m nano_orc.cli run-all   <fastq> -o OUT -n DATASET -a {COI,RNA}
                                    --adapters-dir DIR

reorient, demux, clean and run-all read the adapter/primer FASTAs from
--adapters-dir (``python -m nano_orc.synth DIR`` writes a seeded set).
"""
from __future__ import annotations

import argparse
import json
import sys


__version__ = "0.6.0"


def main(argv=None):
    import os
    p = argparse.ArgumentParser(prog="nano_orc", description=__doc__)
    p.add_argument("-v", "--version", action="version",
                   version=f"nano_orc {__version__}")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name, **kw):
        sp = sub.add_parser(name, **kw)
        return sp

    def adapters_arg(sp):
        sp.add_argument("--adapters-dir", required=True,
                        help="directory of the adapter/primer FASTAs "
                             "(the reference's adapters_primers/)")

    sp = add("qc")
    sp.add_argument("input")
    sp.add_argument("-o", "--outdir", required=True)
    sp.add_argument("-n", "--name", required=True)

    sp = add("reorient")
    sp.add_argument("input")
    adapters_arg(sp)
    sp.add_argument("-o", "--outdir", required=True)
    sp.add_argument("-n", "--name", required=True)
    sp.add_argument("-Q", "--qmin", type=float, default=10.0)

    sp = add("demux")
    sp.add_argument("input")
    adapters_arg(sp)
    sp.add_argument("-o", "--outdir", required=True)
    sp.add_argument("-n", "--dataset", required=True)
    sp.add_argument("-e", "--error-rate", type=float, default=0.1)

    sp = add("sort")
    sp.add_argument("input", help="bin fastq/fasta(.gz) OR a folder of "
                                  "them (reference -i accepts both)")
    sp.add_argument("-o", "--outdir", required=True)
    sp.add_argument("-b", "--barcode", default=None,
                    help="output name for single-file input (required "
                         "unless input is a folder)")
    sp.add_argument("-p", "--prefix", default="amplicons")
    sp.add_argument("--min", type=int, default=300)
    sp.add_argument("--max", type=int, default=None)
    sp.add_argument("--maxr", type=int, default=10000)
    sp.add_argument("--seed", type=int, default=42)
    sp.add_argument("--amb", action="store_true",
                    help="IUPAC ambiguity calls in consensus (-amb)")
    # remaining amplicon_sorter threshold flags (amplicon_sorter.py:126-191)
    sp.add_argument("--sg", type=float, default=0.80,
                    help="similar_genes threshold (-sg, %% as fraction)")
    sp.add_argument("--ssg", type=float, default=None,
                    help="similar_species_groups (-ssg; default estimate)")
    sp.add_argument("--ss", type=float, default=0.85,
                    help="similar_species ladder floor (-ss)")
    sp.add_argument("--sc", type=float, default=0.96,
                    help="similar_consensus merge threshold (-sc)")
    sp.add_argument("--ldc", type=float, default=8.0,
                    help="length_diff_consensus %% (-ldc)")
    sp.add_argument("--np", dest="np_", type=int, default=None,
                    help="accepted for reference-CLI compatibility "
                         "(parallelism is device tiling, not processes)")
    sp.add_argument("--sequential", action="store_true",
                    help="take the first maxr reads instead of a random "
                         "sample (inverse of reference -ar)")
    sp.add_argument("--sfq", action="store_true",
                    help="also write per-group .fastq outputs (-sfq)")
    sp.add_argument("--gz", action="store_true",
                    help="gzip group outputs (reference -c)")
    sp.add_argument("--all", dest="compare_all", action="store_true",
                    help="compare ALL selected reads with each other in "
                         "one block (-a/--all)")
    sp.add_argument("--aln", action="store_true",
                    help="write per-group star-alignment fastas (-aln)")
    sp.add_argument("--ho", action="store_true",
                    help="only write the read-length histogram figure "
                         "(-ho/--histogram_only)")
    sp.add_argument("--mac", action="store_true",
                    help="accepted for reference-CLI compatibility "
                         "(macOS multiprocessing workaround; no-op "
                         "here)")

    sp = add("clean")
    sp.add_argument("input")
    adapters_arg(sp)
    sp.add_argument("-o", "--outdir", required=True)
    sp.add_argument("-b", "--barcode", required=True)
    sp.add_argument("-a", "--amplicon", choices=["COI", "RNA"],
                    required=True)
    sp.add_argument("-e", "--error-rate", type=float, default=0.1)
    sp.add_argument("--match-read-wildcards", action="store_true",
                    help="IUPAC codes in contigs match their base set "
                         "(use with -amb consensus)")

    sp = add("rrna")
    sp.add_argument("input")
    sp.add_argument("-o", "--outdir", required=True)
    sp.add_argument("-b", "--barcode", required=True)
    sp.add_argument("--exemplars-18s")
    sp.add_argument("--exemplars-28s")
    sp.add_argument("--hmm", help="HMMER3 .hmm with 18S/28S models")
    sp.add_argument("--cm", help="Infernal .cm (Rfam SSU/LSU models; "
                                 "pybarrnap variant)")

    sp = add("extract-max")
    sp.add_argument("mode", choices=["ribo", "coi"])
    sp.add_argument("indir")
    sp.add_argument("-o", "--outdir", required=True)

    sp = add("summary")
    sp.add_argument("indir")
    sp.add_argument("-o", "--out", required=True)

    sp = add("blast-top5")
    sp.add_argument("input")
    sp.add_argument("-o", "--out", required=True)

    sp = add("reorganise")
    sp.add_argument("csv")
    sp.add_argument("--coi", required=True)
    sp.add_argument("--r18s", required=True)
    sp.add_argument("--r28s", required=True)
    sp.add_argument("-o", "--outdir", required=True)

    sp = add("prep-anchors")
    sp.add_argument("aligned_fasta")
    sp.add_argument("samples_fasta")
    sp.add_argument("-g", "--gene", required=True)
    sp.add_argument("-o", "--outdir")

    sp = add("figures")
    sp.add_argument("-o", "--outdir", required=True)
    sp.add_argument("--blast-csv", default=None,
                    help="manual-BLAST verdict CSV -> success bars + "
                         "readcount means")
    sp.add_argument("--lca-csv", default=None,
                    help="lca_table CSV -> lollipop + bubble figures")
    sp.add_argument("--flow-tsv", default=None,
                    help="stage_read_flow TSV -> read-conservation bands")

    sp = add("run-all")
    sp.add_argument("input")
    adapters_arg(sp)
    sp.add_argument("-o", "--outdir", required=True)
    sp.add_argument("-n", "--dataset", required=True)
    sp.add_argument("-a", "--amplicon", choices=["COI", "RNA"],
                    required=True)
    sp.add_argument("--trace", metavar="DIR", default=None,
                    help="capture a jax.profiler device trace into DIR "
                         "(TensorBoard/XProf format)")
    sp.add_argument("--rrna-hmm", default=None,
                    help="HMMER3 .hmm (e.g. barrnap euk.hmm) for stage 05; "
                         "default = universal junction anchors")
    sp.add_argument("--rrna-cm", default=None,
                    help="Infernal .cm (e.g. Rfam 14.10 SSU/LSU) for "
                         "stage 05 — the pybarrnap variant; scored via "
                         "the CM's embedded p7 filter (rrna/cm.py)")
    sp.add_argument("--exemplars-18s", default=None)
    sp.add_argument("--exemplars-28s", default=None)
    sp.add_argument("--mesh", action="store_true",
                    help="shard demux reads and clustering stripes over "
                         "all visible devices (jax.sharding mesh)")
    sp.add_argument("--bin-workers", type=int, default=4,
                    help="concurrent barcode bins in stages 03-05 "
                         "(overlaps one bin's host consensus with "
                         "another's device scoring; outputs are "
                         "byte-identical). 1 = serial")

    args = p.parse_args(argv)

    if args.cmd == "qc":
        from .pipeline.stages import stage_qc
        stats = stage_qc(args.input, args.outdir, args.name)
        print(json.dumps(stats.__dict__))
    elif args.cmd == "reorient":
        from .pipeline.stages import PipelineConfig, stage_reorient
        cfg = PipelineConfig(adapters_dir=args.adapters_dir,
                             qmin=args.qmin)
        res = stage_reorient(args.input, args.outdir, args.name, cfg)
        print(json.dumps(res.stats))
    elif args.cmd == "demux":
        from .pipeline.stages import PipelineConfig, stage_demux
        cfg = PipelineConfig(adapters_dir=args.adapters_dir,
                             e_rate=args.error_rate)
        rep = stage_demux(args.input, args.outdir, args.dataset, cfg)
        print(json.dumps({"final_bins": rep["final_bins"]}))
    elif args.cmd == "sort":
        from .cluster.engine import SorterConfig
        from .pipeline.stages import PipelineConfig, stage_sort
        if args.ho:
            # reference -ho/--histogram_only (amplicon_sorter.py:
            # 183-184, 627-628): only the read-length histogram figure
            import os as _os

            from .analysis.figures import plot_read_length_histogram
            from .io.fastq import read_records
            from .pipeline.qc import n50 as _n50
            lens = [len(r.seq) for r in read_records(args.input)]
            base = _os.path.basename(args.input)
            for suf in (".gz", ".fastq", ".fasta"):
                if base.endswith(suf):
                    base = base[:-len(suf)]
            fig = plot_read_length_histogram(
                lens, _os.path.join(args.outdir,
                                    f"{base}_total_outputfig.pdf"),
                min_length=args.min, max_length=args.max,
                n50=_n50(lens))
            print(json.dumps({"histogram": fig, "reads": len(lens)}))
            return
        cfg = PipelineConfig(sorter=SorterConfig(
            min_length=args.min, max_length=args.max, max_reads=args.maxr,
            seed=args.seed, ambiguous=args.amb,
            similar_genes=args.sg, similar_species_groups=args.ssg,
            similar_species=args.ss, similar_consensus=args.sc,
            length_diff_consensus=args.ldc,
            random_selection=not args.sequential,
            compare_all=args.compare_all))
        import os as _os
        if not _os.path.isdir(args.input) and not args.barcode:
            raise SystemExit("sort: -b/--barcode is required for a "
                             "single-file input")
        if _os.path.isdir(args.input):
            # reference -i accepts a FOLDER: every fastq/fasta(.gz) in
            # it is sorted in name order, each into its own outputs
            # (amplicon_sorter.py:2134-2188 main loop); barcode =
            # file stem, '-b' becomes a prefix for the summary only
            import glob as _glob
            files = sorted(
                p for pat in ("*.fastq", "*.fastq.gz", "*.fasta",
                              "*.fasta.gz")
                for p in _glob.glob(_os.path.join(args.input, pat)))
            summary = []
            for p in files:
                stem = _os.path.basename(p)
                for suf in (".gz", ".fastq", ".fasta"):
                    if stem.endswith(suf):
                        stem = stem[:-len(suf)]
                result, path = stage_sort(
                    p, args.outdir, stem, args.prefix, cfg,
                    save_fastq=args.sfq, compressed=args.gz,
                    alignment=args.aln)
                summary.append(
                    {"file": p, "skipped": result.skipped,
                     "reads": result.n_reads,
                     "species_groups": sum(len(s)
                                           for s in result.species),
                     "consensus": path})
            print(json.dumps({"folder": args.input, "sorted": summary}))
            return 0
        result, path = stage_sort(args.input, args.outdir, args.barcode,
                                  args.prefix, cfg, save_fastq=args.sfq,
                                  compressed=args.gz,
                                  alignment=args.aln)
        print(json.dumps({"skipped": result.skipped,
                          "reads": result.n_reads,
                          "species_groups": sum(len(s)
                                                for s in result.species),
                          "consensus": path}))
    elif args.cmd == "clean":
        from .pipeline.stages import PipelineConfig, stage_clean
        cfg = PipelineConfig(adapters_dir=args.adapters_dir,
                             clean_e_rate=args.error_rate,
                             match_read_wildcards=args.match_read_wildcards)
        clean, rep = stage_clean(args.input, args.outdir, args.barcode,
                                 args.amplicon, cfg)
        print(json.dumps({"total": rep.total, "trimmed": rep.trimmed,
                          "failsafe_dropped": rep.failsafe_dropped}))
    elif args.cmd == "rrna":
        from .io.fastq import read_fasta, read_records
        from .rrna.extract import extract_rrna
        from .rrna.hmm import parse_hmmer3
        kw = {}
        if args.exemplars_18s:
            kw["exemplars_18s"] = [r.seq for r in
                                   read_fasta(args.exemplars_18s)]
        if args.exemplars_28s:
            kw["exemplars_28s"] = [r.seq for r in
                                   read_fasta(args.exemplars_28s)]
        if args.cm:
            from .rrna.cm import parse_cm, profiles_by_gene
            bygene = profiles_by_gene(parse_cm(args.cm))
            if "18S" in bygene:
                kw["profile_18s"] = bygene["18S"]
            if "28S" in bygene:
                kw["profile_28s"] = bygene["28S"]
        elif args.hmm:
            models = {m.name: m for m in parse_hmmer3(args.hmm)}
            for name, m in models.items():
                if "18" in name:
                    kw["profile_18s"] = m
                if "28" in name:
                    kw["profile_28s"] = m
        hits = extract_rrna(list(read_records(args.input)), args.outdir,
                            args.barcode, **kw)
        print(json.dumps({g: len(h) for g, h in hits.items()}))
    elif args.cmd == "extract-max":
        from .pipeline.extractors import extract_coi_max, extract_ribo_max
        fn = extract_ribo_max if args.mode == "ribo" else extract_coi_max
        out = fn(args.indir, args.outdir)
        print(json.dumps({k: len(v) for k, v in out.items()}))
    elif args.cmd == "summary":
        from .pipeline.summary import summarize_barcode_dir
        rows = summarize_barcode_dir(args.indir, args.out)
        found = sum(1 for r in rows if r["amplicon_found"] == "yes")
        print(json.dumps({"rows": len(rows), "found": found}))
    elif args.cmd == "blast-top5":
        from .pipeline.downstream import blast_top5_filter
        n = blast_top5_filter(args.input, args.out)
        print(json.dumps({"kept": n}))
    elif args.cmd == "reorganise":
        from .pipeline.downstream import reorganise_barcodes
        counts = reorganise_barcodes(
            args.csv, {"COI": args.coi, "18S": args.r18s,
                       "28S": args.r28s}, args.outdir)
        print(json.dumps(counts))
    elif args.cmd == "prep-anchors":
        from .pipeline.downstream import prep_anchor_selection
        clean, meta = prep_anchor_selection(args.aligned_fasta,
                                            args.samples_fasta, args.gene,
                                            args.outdir)
        print(json.dumps({"cleaned": clean, "metadata": meta}))
    elif args.cmd == "figures":
        import csv as _csv
        from .analysis import figures as figs
        from .analysis.reports import success_metrics
        written = []
        if args.blast_csv:
            rows = list(_csv.DictReader(open(args.blast_csv)))
            by_ds = {}
            for r in rows:
                by_ds.setdefault(r.get("plate", "all"), []).append(r)
            written.append(figs.plot_success_metrics(
                {d: success_metrics(rs) for d, rs in by_ds.items()},
                os.path.join(args.outdir, "success_metrics.png")))
            written.append(figs.plot_readcount_means(
                rows, os.path.join(args.outdir, "readcount_means.png")))
        if args.lca_csv:
            rows = list(_csv.DictReader(open(args.lca_csv)))
            written.append(figs.plot_lca_lollipop(
                rows, os.path.join(args.outdir, "lca_lollipop.png")))
            written.append(figs.plot_lca_bubble(
                rows, os.path.join(args.outdir, "lca_bubble.png")))
        if args.flow_tsv:
            rows = list(_csv.DictReader(open(args.flow_tsv),
                                        delimiter="\t"))
            written.append(figs.plot_read_flow(
                rows, os.path.join(args.outdir, "read_flow.png")))
        print(json.dumps({"figures": written}))
    elif args.cmd == "run-all":
        from .pipeline.stages import PipelineConfig, run_all
        cfg = PipelineConfig(adapters_dir=args.adapters_dir,
                             rrna_hmm=args.rrna_hmm,
                             rrna_cm=args.rrna_cm,
                             rrna_exemplars_18s=args.exemplars_18s,
                             rrna_exemplars_28s=args.exemplars_28s,
                             use_mesh=args.mesh,
                             bin_workers=args.bin_workers)
        rep = run_all(args.input, args.outdir, args.dataset, args.amplicon,
                      cfg=cfg, trace_dir=args.trace)
        print(json.dumps(rep, default=str))
    return 0


def _entry():
    try:
        return main()
    except FileNotFoundError as e:
        print(f"nano_orc: error: file not found: {e.filename or e}",
              file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"nano_orc: error: {e}", file=sys.stderr)
        return 2
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(_entry())
