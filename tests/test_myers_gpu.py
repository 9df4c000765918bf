"""The Myers Pallas kernel (align/myers_gpu.py) and its wrapper.

On the CPU the kernel runs in Pallas interpret mode against the XLA scan
(align/myers.py), and the wrapper's padding, tile list, strip choice and
route are checked directly. Tests marked ``gpu`` run the compiled kernel
at real widths and compare it with the XLA scan and the native oracle.
All DP here is integer, so every comparison is exact.
"""
import numpy as np
import pytest

from nano_orc.align import myers
from nano_orc.align import myers_gpu as K


def _codes(rng, n, L, lo, hi, n_frac=0.2):
    lens = rng.integers(lo, hi + 1, n).astype(np.int32)
    c = np.full((n, L), 4, np.uint8)
    for i, ln in enumerate(lens):
        c[i, :ln] = rng.integers(0, 4, ln)
        if rng.random() < n_frac:
            c[i, rng.integers(0, ln)] = 4  # a literal N
    return c, lens


def _family(rng, n, L, base_len, subs):
    base = rng.integers(0, 4, base_len)
    c = np.full((n, L), 4, np.uint8)
    lens = np.zeros(n, np.int32)
    for i in range(n):
        s = base.copy()
        s[rng.integers(0, base_len, subs)] = rng.integers(0, 4, subs)
        ln = base_len - int(rng.integers(0, 8))
        c[i, :ln] = s[:ln]
        lens[i] = ln
    return c, lens


@pytest.mark.parametrize("s_max,L", [(16, 64), (2, 96)],
                         ids=["one-strip", "three-strips"])
@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_kernel_interpret_matches_xla(monkeypatch, mode, s_max, L):
    """Distances and end positions equal the XLA scan, with the pattern
    in one register strip and split over several (the scratch carry)."""
    monkeypatch.setattr(K, "S_MAX", s_max)
    K.myers_pairs.clear_cache()
    rng = np.random.default_rng(L + len(mode))
    P, pl = _codes(rng, 5, L, 1, L)
    T, tl = _codes(rng, 9, L, 1, L)
    T[:3], tl[:3] = P[:3], pl[:3]
    d, p = K.distances(P, pl, T, tl, mode, interpret=True)
    dr, pr = myers.distances_with_pos(P, pl, T, tl, mode)
    np.testing.assert_array_equal(d, dr)
    np.testing.assert_array_equal(p, pr)
    K.myers_pairs.clear_cache()


def test_kernel_interpret_gate_computes_listed_tiles():
    """With a gate, the text tiles holding a True entry are exact; the
    rest are never written (unspecified)."""
    rng = np.random.default_rng(3)
    P, pl = _codes(rng, 4, 32, 5, 30)
    T, tl = _codes(rng, 2 * K.TJ, 32, 5, 30)
    gate = np.zeros((4, 2 * K.TJ), bool)
    gate[1, 3] = gate[2, K.TJ + 7] = True
    d, _ = K.distances(P, pl, T, tl, "NW", gate=gate, interpret=True)
    dr = myers.distances(P, pl, T, tl, "NW")
    np.testing.assert_array_equal(d[1, :K.TJ], dr[1, :K.TJ])
    np.testing.assert_array_equal(d[2, K.TJ:], dr[2, K.TJ:])


def test_tile_list_pads_with_sentinels():
    tiles = K.tile_list(3, 2 * K.TJ + 1)
    assert tiles.shape == (16, 2)          # 9 pairs -> next power of 2
    assert (tiles[9:] == -1).all()
    assert {tuple(t) for t in tiles[:9]} == {(i, j) for i in range(3)
                                             for j in range(3)}


def test_tile_list_gate_selects_tiles():
    gate = np.zeros((3, 2 * K.TJ), bool)
    gate[0, K.TJ + 1] = gate[2, 0] = True
    tiles = K.tile_list(3, 2 * K.TJ, gate)
    assert [tuple(t) for t in tiles if t[0] >= 0] == [(0, 1), (2, 0)]
    assert len(tiles) == 2


def test_tile_list_empty_gate_is_all_sentinel():
    tiles = K.tile_list(2, 10, np.zeros((2, 10), bool))
    assert tiles.shape == (1, 2) and (tiles == -1).all()


@pytest.mark.parametrize("W,expect", [(1, (1, 1)), (16, (16, 1)),
                                      (29, (16, 2)), (112, (16, 7))])
def test_strip_words_buckets(W, expect):
    """COI (<= 16 words) fits one strip; 3.5 kb rRNA (112) needs 7."""
    assert K.strip_words(W) == expect


def test_bit_planes_encode_codes_and_padding():
    codes = np.array([[0, 1, 2, 3, 4, 2]], np.uint8)
    planes = K.bit_planes(codes, np.array([5]), 1).reshape(1, 1, 3)
    for pos, code in enumerate([0, 1, 2, 3, 4, K.PAD_CODE]):
        got = sum(((int(planes[0, 0, k]) >> pos) & 1) << k
                  for k in range(3))
        assert got == code, pos
    # beyond the pattern: PAD_CODE (101) matches no text base
    assert (int(planes[0, 0, 0]) >> 31) & 1 == 1
    assert (int(planes[0, 0, 1]) >> 31) & 1 == 0


def test_distances_pads_texts_to_whole_tiles_and_words():
    rng = np.random.default_rng(5)
    P, pl = _codes(rng, 2, 40, 10, 40)
    T, tl = _codes(rng, 3, 40, 10, 40)
    d, p = K.distances(P, pl, T, tl, "NW", interpret=True, lazy=True)
    assert d.shape == (2, K.TJ) and p.shape == (2, K.TJ)


def test_scorer_route_on_cpu_is_native():
    from nano_orc.cluster.scoring import DeviceScorer
    assert DeviceScorer().backend == "native"
    assert DeviceScorer(backend="gpu").backend == "gpu"
    with pytest.raises(ValueError):
        DeviceScorer(backend="pallas")


def test_unknown_platform_is_an_error(monkeypatch):
    import jax

    from nano_orc import device
    assert device.platform() == "cpu"
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        device.platform()


def test_scorer_gpu_backend_interpret_matches_native(monkeypatch):
    """The sorter's gated all-vs-all on the kernel (interpret mode)
    yields the same edges as the native backend."""
    import functools

    from nano_orc.cluster.scoring import DeviceScorer
    monkeypatch.setattr(K, "distances",
                        functools.partial(K.distances, interpret=True))
    rng = np.random.default_rng(8)
    c, lens = _family(rng, 12, 64, 60, 6)
    codes = [c[i, :lens[i]] for i in range(12)]
    got = DeviceScorer(backend="gpu").allvsall_effective_sims(codes)
    want = DeviceScorer(backend="native").allvsall_effective_sims(codes)
    for f in ("i", "j", "sim", "reverse"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_gpu_kernel_matches_xla_480bp(gpu, mode):
    """1024 x 1024 reads of ~480 bp (the sorter's comparison block)."""
    rng = np.random.default_rng(1)
    c, lens = _family(rng, 1024, 512, 480, 30)
    n = 1024 if mode == "NW" else 256
    d, p = K.distances(c[:n], lens[:n], c, lens, mode)
    dr, pr = myers.distances_with_pos(c[:n], lens[:n], c, lens, mode)
    np.testing.assert_array_equal(d, dr)
    np.testing.assert_array_equal(p, pr)


@pytest.mark.gpu
def test_gpu_kernel_matches_native_3500bp(gpu):
    """~3.5 kb rRNA amplicons: 112 words, seven register strips."""
    from nano_orc import native
    rng = np.random.default_rng(2)
    c, lens = _family(rng, 96, 3584, 3500, 200)
    d, _ = K.distances(c, lens, c, lens, "NW")
    want = native.all_vs_all([c[i, :lens[i]] for i in range(96)],
                             band=0.0)
    iu = np.triu_indices(96, 1)
    np.testing.assert_array_equal(d[iu], want[iu])


@pytest.mark.gpu
def test_gpu_fused_demux_matches_native(gpu, adapters_dir):
    """The fused dual-round demux on the card == both rounds on the
    native C++ locate."""
    import os

    from nano_orc import native, synth
    from nano_orc.align.batched import LocateResult
    from nano_orc.demux import demux as D
    from nano_orc.demux.adapters import AdapterBank
    from nano_orc.demux.fused import FusedDemux
    from nano_orc.io import encode
    sp5 = AdapterBank.from_fasta(
        os.path.join(adapters_dir, synth.SP5_FASTA), 0.1)
    sp27 = AdapterBank.from_fasta(
        os.path.join(adapters_dir, synth.SP27RC_FASTA), 0.1)
    recs, _ = synth.coi_plate(adapters_dir, 3, reads_per_bin=24,
                              large_bins=0)
    got = [t[1:] for t in FusedDemux(sp5, sp27).assign(recs)]

    def native_fwd_rc(bank, masks, lens, flags, min_overlap=3):
        refs = [encode.encode_ref_masks(s) for s in bank.seqs]
        rcm = encode.revcomp_read_masks(masks, lens)
        out = []
        for m in (masks, rcm):
            o, v = native.locate_batch(
                refs, [m[i, :lens[i]] for i in range(len(lens))],
                bank.max_error_rate, int(flags), min_overlap)
            z = np.zeros_like(v, dtype=np.int32)
            out.append(LocateResult(v.astype(np.int32), o[:, :, 4],
                                    o[:, :, 5], o[:, :, 0], o[:, :, 1],
                                    o[:, :, 2], o[:, :, 3], z, z))
        return tuple(out)

    import unittest.mock as mock
    with mock.patch.object(D, "locate_fwd_rc", native_fwd_rc):
        want = D._decisions_unfused(recs, sp5, sp27, 256)
    assert got == want


@pytest.mark.gpu
def test_gpu_viterbi_matches_host_float64(gpu):
    """The device Viterbi (float32 prefix sums, summed in another order
    than on the host) against the float64 host reference: scores within
    1e-3 nats, identical end positions and end nodes. No matrix products
    run here, so TF32 does not arise."""
    from nano_orc.rrna.hmm import viterbi_host, viterbi_scan
    from nano_orc.rrna.profiles import default_euk_profiles
    rng = np.random.default_rng(4)
    prof = default_euk_profiles()["18S"]
    cons = np.argmax(prof.match_scores, axis=1).astype(np.uint8)
    seqs = np.full((8, 1024), 4, np.uint8)
    lens = np.zeros(8, np.int32)
    for i in range(8):
        s = np.concatenate([rng.integers(0, 4, 300), cons,
                            rng.integers(0, 4, 200 + 40 * i)])
        s[rng.integers(0, len(s), 10)] = rng.integers(0, 4, 10)
        seqs[i, :len(s)] = s
        lens[i] = len(s)
    score, pos, node = viterbi_scan(prof, seqs, lens)
    for i in range(8):
        hs, hp, hn = viterbi_host(prof, seqs[i, :lens[i]])
        assert abs(score[i] - hs) <= 1e-3, i
        assert (int(pos[i]), int(node[i])) == (hp, hn), i
