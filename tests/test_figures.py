"""Rendered analysis figures (analysis/figures.py) — each writer
produces a non-trivial image file from the reports/LCA tables."""
import os

import pytest

from nano_orc.analysis import figures
from nano_orc.analysis.reports import stage_read_flow, success_metrics


@pytest.fixture()
def blast_rows():
    return [
        {"max_readcount_group": "1", "hit1_expect": "Y",
         "hit2_expect": "n", "hit1_primer_set": "Moorea",
         "max_readcount": 120},
        {"max_readcount_group": "2", "hit1_expect": "n",
         "hit2_expect": "Y", "hit1_primer_set": "Sauron",
         "max_readcount": 30},
        {"max_readcount_group": "", "hit1_expect": "n",
         "hit2_expect": "n", "hit1_primer_set": "", "max_readcount": ""},
        {"max_readcount_group": "3", "hit1_expect": "n",
         "hit2_expect": "n", "hit1_primer_set": "Moorea",
         "max_readcount": 55},
    ]


def _check(path):
    assert os.path.exists(path)
    assert os.path.getsize(path) > 2000  # a real rendered image


def test_success_metric_stacked_bars(tmp_path, blast_rows):
    per_ds = {"Lakes_1": success_metrics(blast_rows),
              "Gardens_1": success_metrics(blast_rows[:2])}
    p = figures.plot_success_metrics(per_ds,
                                     str(tmp_path / "success.png"))
    _check(p)


def test_read_flow_bands(tmp_path):
    rows = stage_read_flow({
        "raw": {"bc1": 1000, "bc2": 800},
        "pychopped": {"bc1": 900, "bc2": 700},
        "demuxed": {"bc1": 850, "bc2": 650},
        "sorted": {"bc1": 700, "bc2": 500},
    })
    p = figures.plot_read_flow(rows, str(tmp_path / "flow.svg"))
    _check(p)


def test_lca_lollipop_and_bubble(tmp_path):
    lca_rows = [
        {"lca": "Lumbricidae", "lca_rank": "family", "dataset": "L1"},
        {"lca": "Lumbricidae", "lca_rank": "family", "dataset": "L1"},
        {"lca": "Eisenia", "lca_rank": "genus", "dataset": "L1"},
        {"lca": "Annelida", "lca_rank": "phylum", "dataset": "G1"},
        {"lca": "Eisenia fetida", "lca_rank": "species",
         "dataset": "G1"},
    ]
    _check(figures.plot_lca_lollipop(lca_rows,
                                     str(tmp_path / "lolli.png")))
    _check(figures.plot_lca_bubble(lca_rows,
                                   str(tmp_path / "bubble.png")))


def test_readcount_means(tmp_path, blast_rows):
    _check(figures.plot_readcount_means(blast_rows,
                                        str(tmp_path / "rc.png")))
