"""The port's realigner modules against the JAX package's, one by one:
`realign.ssw`, `realign.debruijn_graph`, `realign.window_selector`,
`realign.fast_pass_aligner` and `realign.realigner`.

The same numpy-seeded inputs go through both. The JAX side runs as its
users run it, with its native library loaded, and again with the
library's realigner functions switched off (its Python and numpy path).
Everything is exact: integers, strings, lists and their orders. The two
JAX paths agree on every case here but the ones that pair an N with an
N (`test_n_against_n_parts_the_jax_paths`); there the port follows the
native path.
"""

import dataclasses

import numpy as np
import pytest
import torch

from deepvariant_tpu.io import native
from deepvariant_tpu.realign import config as jconfig
from deepvariant_tpu.realign import debruijn_graph as jdbg
from deepvariant_tpu.realign import fast_pass_aligner as jfpa
from deepvariant_tpu.realign import realigner as jrealigner
from deepvariant_tpu.realign import ssw as jssw
from deepvariant_tpu.realign import window_selector as jws
from deepvariant_tpu_torch.realign import config as tconfig
from deepvariant_tpu_torch.realign import debruijn_graph as tdbg
from deepvariant_tpu_torch.realign import fast_pass_aligner as tfpa
from deepvariant_tpu_torch.realign import realigner as trealigner
from deepvariant_tpu_torch.realign import ssw as tssw
from deepvariant_tpu_torch.realign import window_selector as tws
from torch_port_util import (
    assert_reads_equal,
    make_reads,
    realigner_natives_off,
    region_reads,
    sparse_sample,
    stage1_sample,
    to_package,
    write_stage1_inputs,
)

torch.set_num_threads(2)

JAX, PORT = "deepvariant_tpu", "deepvariant_tpu_torch"
JAX_PATHS = ("native", "python")


@pytest.fixture(params=JAX_PATHS)
def jax_path(request, monkeypatch):
    """Runs a test against both paths of the JAX package."""
    if request.param == "python":
        realigner_natives_off(monkeypatch)
    return request.param


def random_dna(rng, n, alphabet="ACGT"):
    return "".join(alphabet[i] for i in rng.randint(0, len(alphabet), n))


def mutate(rng, seq, subs=2, ins=1, dels=1):
    """`seq` with a few substitutions, insertions and deletions."""
    out = list(seq)
    for _ in range(subs):
        if out:
            out[rng.randint(len(out))] = "ACGT"[rng.randint(4)]
    for _ in range(ins):
        at = rng.randint(len(out) + 1)
        out[at:at] = random_dna(rng, rng.randint(1, 6))
    for _ in range(dels):
        if len(out) > 8:
            at = rng.randint(len(out) - 6)
            del out[at:at + rng.randint(1, 6)]
    return "".join(out)


# -- ssw ----------------------------------------------------------------------

DEFAULT_SCORES = (4, 6, 8, 2)


def ssw_cases():
    rng = np.random.RandomState(11)
    cases = {}
    for i in range(8):
        cases[f"random{i}"] = (random_dna(rng, rng.randint(1, 301)),
                               random_dna(rng, rng.randint(1, 301)),
                               DEFAULT_SCORES)
    for i in range(10):
        ref = random_dna(rng, rng.randint(40, 301))
        lo = rng.randint(0, len(ref) // 2)
        hi = rng.randint(lo + 10, len(ref) + 1)
        cases[f"near{i}"] = (ref, mutate(rng, ref[lo:hi], i % 4, i % 3,
                                         (i + 1) % 3), DEFAULT_SCORES)
    # Co-optimal end points and start points: tandem repeats.
    cases["repeat-ref"] = ("ACGTTGCA" * 12, "ACGTTGCAACGT", DEFAULT_SCORES)
    cases["repeat-both"] = ("AC" * 40, "CA" * 17, DEFAULT_SCORES)
    cases["homopolymer"] = ("G" * 30 + "T" + "G" * 30, "G" * 25,
                            DEFAULT_SCORES)
    cases["two-copies"] = ("TTACGGATCCAGTT" + "CC" + "TTACGGATCCAGTT",
                           "ACGGATCCAG", DEFAULT_SCORES)
    # Leading and trailing soft clips.
    core = random_dna(rng, 60)
    cases["clips"] = (random_dna(rng, 30) + core + random_dna(rng, 30),
                      "GGGGGGG" + core + "TTTTTTTTT", DEFAULT_SCORES)
    cases["lead-clip"] = (core, "CATCATCAT" + core[5:], DEFAULT_SCORES)
    cases["tail-clip"] = (core, core[:50] + "CATCATCAT", DEFAULT_SCORES)
    # A gap costs what two mismatches cost, and what one costs.
    cases["gap-or-mismatch"] = ("AAAACCCCGGGGTTTTACGTACGT",
                                "AAAACCCGGGGTTTTACGTACGT", (2, 3, 4, 2))
    cases["gap-ties-mismatch"] = ("ACGTACGTTTGACCAGTCAGT",
                                  "ACGTACGTTGACCAGTCAGT", (3, 5, 5, 0))
    cases["ins-or-del"] = ("ACGTTGCAAGGCTTACG" * 2,
                           "ACGTTGCAGGCTTTACG" * 2, (4, 6, 8, 2))
    for i, scores in enumerate([(1, 1, 1, 1), (2, 3, 5, 1), (5, 4, 10, 0),
                                (1, 3, 5, 2), (7, 2, 3, 3)]):
        ref = random_dna(rng, 150)
        cases[f"scores{i}"] = (ref, mutate(rng, ref[20:130], 4, 2, 2), scores)
    # Bytes are compared: N equals N, lower case is raised first.
    cases["n-run"] = ("ACGTAC" + "N" * 12 + "GGATCCTA",
                      "GTAC" + "N" * 12 + "GGAT", DEFAULT_SCORES)
    cases["n-in-query"] = (core, core[:20] + "N" + core[21:55],
                           DEFAULT_SCORES)
    cases["lower-case"] = (core.lower(), core[10:40], DEFAULT_SCORES)
    cases["no-match"] = ("AAAAAAAA", "CCCC", DEFAULT_SCORES)
    cases["one-base"] = ("ACGT", "G", DEFAULT_SCORES)
    cases["empty-query"] = ("ACGT", "", DEFAULT_SCORES)
    return cases


SSW_CASES = ssw_cases()


@pytest.mark.parametrize("name", list(SSW_CASES))
def test_ssw_align_matches_jax(name, jax_path):
    ref, query, scores = SSW_CASES[name]
    want_aligner = jssw.SswAligner(*scores)
    got_aligner = tssw.SswAligner(*scores)
    want_aligner.set_reference_sequence(ref)
    got_aligner.set_reference_sequence(ref)
    want = want_aligner.align(query)
    got = got_aligner.align(query)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert [f.name for f in dataclasses.fields(got)] == [
        "sw_score", "ref_begin", "ref_end", "query_begin", "query_end",
        "cigar_string"]
    if name not in ("no-match", "empty-query"):
        assert got.sw_score > 0 and got.cigar_string


def score_cases():
    """(haplotypes, reads): reads cut from mutated haplotypes, some with
    N, haplotypes with and without an N run, lengths that differ."""
    rng = np.random.RandomState(5)
    out = {}
    for i in range(6):
        haps = [random_dna(rng, rng.randint(120, 260)) for _ in range(3)]
        if i % 2:
            at = rng.randint(20, 80)
            haps = [h[:at] + "N" * (10 + 5 * i) + h[at:] for h in haps]
        reads = []
        for r in range(9):
            h = haps[r % 3]
            lo = rng.randint(0, len(h) - 60)
            read = mutate(rng, h[lo:lo + rng.randint(30, 110)],
                          r % 3, r % 2, (r + 1) % 2)
            if r % 4 == 0:
                read = read[:7] + "N" + read[8:]
            reads.append(read)
        reads.append("")
        out[f"window{i}"] = (haps, reads)
    return out


SCORE_CASES = score_cases()


@pytest.mark.parametrize("name", list(SCORE_CASES))
@pytest.mark.parametrize("scores", [DEFAULT_SCORES, (2, 3, 5, 1)],
                         ids=["default", "other-scores"])
def test_local_scores_match_the_native_score_kernel(name, scores):
    """`local_scores` is what the JAX package's fallback takes from
    `native.ssw_score_multi`; `align(known_score=...)` is its
    `ssw_align(known_score=...)`, for every pair, with N in both."""
    haps, reads = SCORE_CASES[name]
    want = native.ssw_score_multi(
        [h.encode() for h in haps], [1] * len(haps),
        [r.encode() for r in reads], *scores)
    got = np.stack([tssw.local_scores(h, reads, *scores) for h in haps])
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64 and (got[:, :-1] > 0).all()
    compared = undefined = 0
    for h, hap in enumerate(haps):
        want_aligner = jssw.SswAligner(*scores)
        got_aligner = tssw.SswAligner(*scores)
        want_aligner.set_reference_sequence(hap)
        got_aligner.set_reference_sequence(hap)
        for r, read in enumerate(reads[:-1]):
            known = int(want[h, r])
            got_alignment = got_aligner.align(read, known_score=known)
            if not got_alignment.cigar_string:
                # Told a score below the aligner's own optimum (an N on
                # both sides), the banded traceback can step out of its
                # band at the first row. The native code then reads
                # outside its direction array and returns whatever lies
                # there; the port returns an empty alignment. Nothing to
                # compare: the native result differs from run to run.
                assert got_aligner.align(read).sw_score > known
                undefined += 1
                continue
            compared += 1
            assert dataclasses.astuple(got_alignment) == dataclasses.astuple(
                want_aligner.align(read, known_score=known))
    assert compared >= 20 and undefined <= 3


def test_n_against_n_parts_the_jax_paths(monkeypatch):
    """Where the JAX package's own two paths differ, and why: its
    score-only kernel never lets an N match, its aligner compares bytes.
    A read over an N run therefore scores lower in the kernel than in
    the aligner, and the aligner, told that score, ends its forward pass
    at the first row that reaches it, not at the maximum. The port does
    what the native path does."""
    hap = "ACGTACGGTC" + "N" * 20 + "GGATCCTAGA"
    read = "GGTC" + "N" * 20 + "GGATCC"
    kernel = int(native.ssw_score_multi(
        [hap.encode()], [1], [read.encode()], *DEFAULT_SCORES)[0, 0])
    assert int(tssw.local_scores(hap, [read])[0]) == kernel == 24
    j, t = jssw.SswAligner(), tssw.SswAligner()
    j.set_reference_sequence(hap)
    t.set_reference_sequence(hap)
    plain = j.align(read)
    assert plain.sw_score == 4 * len(read) > kernel
    assert dataclasses.astuple(t.align(read)) == dataclasses.astuple(plain)
    told = j.align(read, known_score=kernel)
    assert told.sw_score == kernel and told.ref_end < plain.ref_end
    assert dataclasses.astuple(t.align(read, known_score=kernel)) == \
        dataclasses.astuple(told)
    # The JAX package's numpy path ignores the score it is told.
    realigner_natives_off(monkeypatch)
    assert dataclasses.astuple(j.align(read, known_score=kernel)) == \
        dataclasses.astuple(plain)


def test_a_score_no_cell_holds_falls_back_to_the_maximum():
    hap, read = "ACGTACGTTGCAAGGC", "CGTACGTTGC"
    j, t = jssw.SswAligner(), tssw.SswAligner()
    j.set_reference_sequence(hap)
    t.set_reference_sequence(hap)
    for known in (39, 41, 1000):   # the DP holds multiples of 4 and 40 - gaps
        assert dataclasses.astuple(t.align(read, known_score=known)) == \
            dataclasses.astuple(j.align(read, known_score=known))
    assert t.align(read, known_score=1000).sw_score == 40


# -- debruijn graph -----------------------------------------------------------

def reads_over(hap, hap_start, n, length, rng, mapq=60, qual=30):
    """`n` read specs cut from `hap` (which starts at `hap_start`)."""
    specs = []
    for _ in range(n):
        lo = rng.randint(0, max(1, len(hap) - length))
        seq = hap[lo:lo + length]
        specs.append((seq, hap_start + lo, f"{len(seq)}M", mapq, qual))
    return specs


def dbg_cases():
    rng = np.random.RandomState(23)
    cases = {}
    ref = random_dna(rng, 120)
    snp = ref[:60] + ("A" if ref[60] != "A" else "C") + ref[61:]
    ins = ref[:50] + "GATTACA" + ref[50:]
    dele = ref[:70] + ref[78:]
    cases["snp"] = (ref, reads_over(snp, 0, 12, 50, rng)
                    + reads_over(ref, 0, 12, 50, rng), {})
    cases["insertion"] = (ref, reads_over(ins, 0, 16, 60, rng), {})
    cases["deletion"] = (ref, reads_over(dele, 0, 16, 60, rng), {})
    cases["three-haplotypes"] = (
        ref, reads_over(snp, 0, 14, 50, rng) + reads_over(ins, 0, 14, 60, rng)
        + reads_over(dele, 0, 14, 60, rng), {})
    # A 14-mer of the reference repeats: k starts above it.
    rep = ref[:40] + ref[10:24] + ref[40:]
    rep_alt = rep[:80] + ("G" if rep[80] != "G" else "T") + rep[81:]
    cases["k-grows"] = (rep, reads_over(rep_alt, 0, 20, 60, rng), {})
    # Every k up to the window's length minus one repeats.
    cases["reference-cycle-at-every-k"] = (
        "ACGT" * 30, reads_over("ACGT" * 30, 0, 6, 40, rng), {})
    # The reads bring a duplication longer than any k that is tried.
    dup = ref[:90] + ref[30:90] + ref[90:]
    cases["read-cycle-at-every-k"] = (
        ref, reads_over(dup, 0, 30, 110, rng), dict(max_k=40))
    # Three independent SNPs on every combination: 8 paths, cap 4.
    combos = []
    for mask in range(8):
        h = list(ref)
        for bit, at in enumerate((30, 60, 90)):
            if mask >> bit & 1:
                h[at] = "A" if ref[at] != "A" else "C"
        combos += reads_over("".join(h), 0, 10, 120, rng)
    cases["path-cap"] = (ref, combos, dict(max_num_paths=4))
    cases["under-the-cap"] = (ref, combos, dict(max_num_paths=8))
    weak = reads_over(snp, 0, 1, 120, rng) + reads_over(ref, 0, 8, 60, rng)
    cases["weak-edge-pruned"] = (ref, weak, {})
    cases["no-pruning"] = (ref, weak, dict(disable_graph_pruning=True))
    cases["low-mapq"] = (ref, reads_over(snp, 0, 12, 50, rng, mapq=13)
                         + reads_over(ins, 0, 12, 60, rng, mapq=14), {})
    low = []
    for seq, pos, cigar, mapq, _ in reads_over(snp, 0, 14, 70, rng):
        quals = rng.randint(16, 40, len(seq))
        quals[rng.randint(len(seq), size=3)] = 14
        low.append((seq, pos, cigar, mapq, quals.tolist()))
    cases["low-quality-bases"] = (ref, low, {})
    noisy = [(s[:9] + "N" + s[10:], p, c, m, q)
             for s, p, c, m, q in reads_over(ins, 0, 14, 60, rng)]
    cases["n-in-reads"] = (ref, noisy, dict(min_k=12, step_k=3))
    cases["lower-case-reference"] = (ref.lower(),
                                     reads_over(snp, 0, 12, 50, rng), {})
    cases["no-reads"] = (ref, [], {})
    return cases


DBG_CASES = dbg_cases()


@pytest.mark.parametrize("name", list(DBG_CASES))
def test_assemble_haplotypes_matches_jax(name, jax_path):
    ref, specs, overrides = DBG_CASES[name]
    want = jdbg.assemble_haplotypes(
        ref, make_reads(JAX, specs), jconfig.DeBruijnGraphOptions(**overrides))
    got = tdbg.assemble_haplotypes(
        ref, make_reads(PORT, specs),
        tconfig.DeBruijnGraphOptions(**overrides))
    assert got == want
    expected = {"reference-cycle-at-every-k": None,
                "read-cycle-at-every-k": None, "path-cap": [],
                "low-mapq": None, "no-reads": [ref]}
    if name in expected and name != "low-mapq":
        assert got == expected[name]
    if name in ("snp", "insertion", "deletion", "k-grows", "no-pruning"):
        assert len(got) >= 2 and ref.upper() in got
    if name == "three-haplotypes":
        assert len(got) >= 4
    if name == "under-the-cap":
        assert len(got) == 8
    if name == "weak-edge-pruned":
        assert got == [ref]
    if name == "low-mapq":
        # Only the mapq-14 reads count: the insertion, not the SNP.
        assert len(got) == 2


def test_graph_internals_match_jax_python():
    """`build` and the graph it returns: k, vertices and edges in
    insertion order, weights, paths before sorting."""
    ref, specs, _ = DBG_CASES["three-haplotypes"]
    want = jdbg.build(ref, make_reads(JAX, specs))
    got = tdbg.build(ref, make_reads(PORT, specs))
    assert got.k == want.k and got.source == want.source
    assert list(got.succ.items()) == list(want.succ.items())
    assert list(got.pred.items()) == list(want.pred.items())
    assert list(got.edges.items()) == list(want.edges.items())
    assert got.candidate_paths() == want.candidate_paths()
    assert tdbg.build("ACGT" * 30, []) is None


# -- window selector ----------------------------------------------------------

@pytest.fixture(scope="module")
def dense_paths(tmp_path_factory):
    return write_stage1_inputs(stage1_sample(),
                               tmp_path_factory.mktemp("dense"))


@pytest.fixture(scope="module")
def sparse_paths(tmp_path_factory):
    return write_stage1_inputs(sparse_sample(),
                               tmp_path_factory.mktemp("sparse"))


WS_OPTIONS = {
    "default": dict(),
    "linear-model": dict(model_type="allele_count_linear"),
    "realign-all": dict(realign_all=True),
    "strict-insertions": dict(enable_strict_insertion_filter=True),
    "legacy": dict(keep_legacy_behavior=True),
    "legacy-linear": dict(keep_legacy_behavior=True,
                          model_type="allele_count_linear"),
    "thresholds": dict(min_mapq=30, min_base_quality=25,
                       min_allele_support=3, min_windows_distance=30,
                       region_expansion_in_bp=5),
}
# A contig's first and last partition, and one in the middle.
WS_REGIONS = [("chr1", 0, 1000), ("chr1", 1000, 2000), ("chr1", 5000, 6000),
              ("chr2", 2000, 3000)]


@pytest.mark.parametrize("region", WS_REGIONS, ids=lambda r: "%s:%d-%d" % r)
@pytest.mark.parametrize("name", list(WS_OPTIONS))
def test_select_windows_matches_jax(dense_paths, name, region):
    out = []
    for package, ws, config in ((JAX, jws, jconfig), (PORT, tws, tconfig)):
        batch, _, ref, rng = region_reads(package, dense_paths, region)
        options = config.WindowSelectorOptions(**WS_OPTIONS[name])
        length = ref.contig_length(rng.reference_name)
        candidates = None if options.realign_all else \
            ws.candidates_from_reads(options, ref.query, batch, rng, length)
        windows = ws.select_windows(options, ref.query, batch, rng,
                                    contig_length=length)
        out.append((candidates, [dataclasses.astuple(w) for w in windows]))
    assert out[1] == out[0]
    assert out[1][1]
    if name != "realign-all":
        assert all(type(c) is int for c in out[1][0]) and len(out[1][0]) > 10


def test_window_selector_pieces_match_jax(dense_paths):
    """The counter-based scores the strict filter and the linear model
    use, and `candidates_to_windows` on its own."""
    region = ("chr1", 1000, 2000)
    for overrides in (dict(enable_strict_insertion_filter=True), dict()):
        out = []
        for package, ws, config in ((JAX, jws, jconfig), (PORT, tws, tconfig)):
            ac = __import__(f"{package}.make_examples.allele_counter",
                            fromlist=["x"])
            batch, _, ref, rng = region_reads(package, dense_paths, region)
            options = config.WindowSelectorOptions(**overrides)
            counter = ac.AlleleCounter(
                ref.bases(rng), rng, ac.AlleleCounterOptions(
                    min_base_quality=options.min_base_quality,
                    min_mapping_quality=options.min_mapq),
                ref_prev_base=ref.query(type(rng)("chr1", 999, 1000)))
            counter.add_batch(batch)
            out.append((
                ws.variant_reads_counts(counter, options),
                ws.allele_count_linear_scores(counter, options),
                ws._variant_reads_counts_vectorized(
                    batch, np.arange(len(batch)), ref.bases(rng), rng,
                    "N", options)))
        np.testing.assert_array_equal(out[1][0], out[0][0])
        np.testing.assert_array_equal(out[1][1], out[0][1])   # float64, exact
        if overrides:
            assert out[1][2] is None and out[0][2] is None
        else:
            np.testing.assert_array_equal(out[1][2], out[0][2])
    positions = [5, 100, 150, 700, 20, 1200, 1361]
    for distance in (80, 10):
        want = jws.candidates_to_windows(
            jconfig.WindowSelectorOptions(min_windows_distance=distance),
            positions, "chr2")
        got = tws.candidates_to_windows(
            tconfig.WindowSelectorOptions(min_windows_distance=distance),
            positions, "chr2")
        assert [dataclasses.astuple(w) for w in got] == \
            [dataclasses.astuple(w) for w in want]
    with pytest.raises(ValueError, match="unknown window selector model"):
        batch, _, ref, rng = region_reads(PORT, dense_paths, region)
        tws.select_windows(tconfig.WindowSelectorOptions(model_type="x"),
                           ref.query, batch, rng)


# -- fast pass aligner: the free functions ------------------------------------

def test_cigar_helpers_match_jax():
    rng = np.random.RandomState(3)
    for name in ("OP_M", "OP_I", "OP_D", "OP_S", "NOT_ALIGNED"):
        assert getattr(tfpa, name) == getattr(jfpa, name)
    for cigar in ("10=2I3X", "5S20=1D3=2X4S", "7M", "", "3=10D2=1I1="):
        assert tfpa.cigar_string_to_ops(cigar) == \
            jfpa.cigar_string_to_ops(cigar)
        size = sum(n for op, n in jfpa.cigar_string_to_ops(cigar)
                   if op != jfpa.OP_D)
        want = jfpa.HaplotypeReadsAlignment(0, 0, [])
        got = tfpa.HaplotypeReadsAlignment(0, 0, [])
        want.cigar = got.cigar = cigar
        jfpa.set_positions_map(size, want)
        tfpa.set_positions_map(size, got)
        assert got.hap_to_ref_positions_map == want.hap_to_ref_positions_map
    ops = (jfpa.OP_M, jfpa.OP_I, jfpa.OP_D, jfpa.OP_S)
    for _ in range(300):
        cigar = [[int(ops[rng.randint(4)]), int(rng.randint(1, 6))]
                 for _ in range(rng.randint(0, 5))]
        op = [int(ops[rng.randint(4)]), int(rng.randint(1, 6))]
        read_len = int(rng.randint(1, 25))
        want, got = [list(c) for c in cigar], [list(c) for c in cigar]
        jfpa.merge_cigar_op(list(op), read_len, want)
        tfpa.merge_cigar_op(list(op), read_len, got)
        assert got == want
        assert tfpa.aligned_length(got) == jfpa.aligned_length(want)
    for _ in range(100):
        cigar = [[int(ops[rng.randint(4)]), int(rng.randint(1, 9))]
                 for _ in range(rng.randint(1, 6))]
        consumed = sum(n for op, n in cigar if op != jfpa.OP_D)
        at = int(rng.randint(0, consumed + 1))
        try:
            want = jfpa.left_trim_hap_to_ref(cigar, at)
        except AssertionError:
            with pytest.raises(AssertionError):
                tfpa.left_trim_hap_to_ref(cigar, at)
        else:
            assert tfpa.left_trim_hap_to_ref(cigar, at) == want


def random_cigar(rng, total, ops):
    """A CIGAR string whose read-consuming lengths sum to `total`."""
    out, left = [], total
    while left > 0:
        n = int(min(left, rng.randint(1, 12)))
        op = ops[rng.randint(len(ops))]
        if out and out[-1][1] == op:
            op = "="
        out.append((n, op))
        if op != "D":
            left -= n
    if out[-1][1] == "D":
        out.append((1, "="))
        out[0] = (out[0][0], out[0][1])
    return "".join(f"{n}{op}" for n, op in out)


def test_calculate_read_to_ref_alignment_matches_jax(jax_path):
    """Seeded read-to-haplotype and haplotype-to-reference CIGARs with
    insertions against deletions, clips and reads that run off the
    haplotype: the merged CIGAR, [] or the AssertionError."""
    rng = np.random.RandomState(17)
    outcomes = set()
    for _ in range(400):
        hap_len = int(rng.randint(20, 80))
        hap_to_ref = tfpa.cigar_string_to_ops(
            random_cigar(rng, hap_len, "===XID"))
        read_len = int(rng.randint(5, 40))
        read_cigar = random_cigar(rng, read_len, "====XID")
        if rng.rand() < 0.3:
            read_cigar = f"{rng.randint(1, 5)}S" + read_cigar
            read_len = sum(n for op, n in tfpa.cigar_string_to_ops(read_cigar)
                           if op != tfpa.OP_D)
        position = int(rng.randint(0, hap_len))
        seq = "A" * read_len
        try:
            want = jfpa.calculate_read_to_ref_alignment(
                seq, jfpa.ReadAlignment(1, position, read_cigar),
                [list(c) for c in hap_to_ref])
        except AssertionError:
            with pytest.raises(AssertionError):
                tfpa.calculate_read_to_ref_alignment(
                    seq, tfpa.ReadAlignment(1, position, read_cigar),
                    [list(c) for c in hap_to_ref])
            outcomes.add("assert")
            continue
        got = tfpa.calculate_read_to_ref_alignment(
            seq, tfpa.ReadAlignment(1, position, read_cigar),
            [list(c) for c in hap_to_ref])
        assert got == want
        outcomes.add("merged" if want else "empty")
    assert outcomes >= {"merged", "empty"}


# -- fast pass aligner: windows -----------------------------------------------

def window_cases():
    """name -> (reference, haplotypes, read specs, region start, prefix
    length, suffix length, aligner options)."""
    rng = np.random.RandomState(41)
    cases = {}
    prefix, window, suffix = (random_dna(rng, 170), random_dna(rng, 120),
                              random_dna(rng, 170))
    ref = prefix + window + suffix
    snp = window[:60] + ("A" if window[60] != "A" else "C") + window[61:]
    ins = window[:50] + "GATTACAGG" + window[50:]
    dele = window[:70] + window[82:]

    def haps(*alts):
        return sorted(prefix + h + suffix for h in (window,) + alts)

    def reads_from(hap, n, length=100):
        full = prefix + hap + suffix
        return reads_over(full, 5000, n, length, rng)

    def with_errors(specs, every=3):
        out = []
        for i, (seq, pos, cigar, mapq, qual) in enumerate(specs):
            if i % every == 0:
                at = rng.randint(len(seq))
                seq = seq[:at] + "ACGT"[rng.randint(4)] + seq[at + 1:]
            out.append((seq, pos, cigar, mapq, qual))
        return out

    base = (ref, 5000, len(prefix), len(suffix))
    cases["snp"] = base + (haps(snp), with_errors(
        reads_from(snp, 10) + reads_from(window, 10)), {})
    cases["insertion"] = base + (haps(ins), with_errors(
        reads_from(ins, 14) + reads_from(window, 6)), {})
    cases["deletion"] = base + (haps(dele), with_errors(
        reads_from(dele, 14) + reads_from(window, 6)), {})
    cases["three-alts"] = base + (haps(snp, ins, dele), with_errors(
        reads_from(snp, 8) + reads_from(ins, 8) + reads_from(dele, 8)
        + reads_from(window, 8), every=2), {})
    # Reads the fast pass cannot place: four errors each, or an indel of
    # their own against every haplotype.
    hard = []
    for seq, pos, cigar, mapq, qual in reads_from(ins, 8):
        seq = list(seq)
        for at in rng.randint(len(seq), size=4):
            seq[at] = "ACGT"[rng.randint(4)]
        hard.append(("".join(seq), pos, cigar, mapq, qual))
    for seq, pos, cigar, mapq, qual in reads_from(dele, 8):
        hard.append((seq[:40] + "TT" + seq[40:], pos, f"{len(seq) + 2}M",
                     mapq, qual))
    cases["ssw-fallback"] = base + (haps(ins, dele),
                                    hard + reads_from(ins, 6)
                                    + reads_from(dele, 6), {})
    noisy = [(s[:30] + "N" + s[31:], p, c, m, q)
             for s, p, c, m, q in reads_from(ins, 10)] + hard[:6]
    cases["n-in-reads"] = base + (haps(ins), noisy + reads_from(ins, 4), {})
    cases["forced"] = base + (haps(ins), hard + [
        (random_dna(rng, 90), 5100, "90M", 60, 30)],
        dict(force_alignment=True))
    cases["not-forced"] = base + (haps(ins), hard + [
        (random_dna(rng, 90), 5100, "90M", 60, 30)], {})
    # One read longer than every haplotype, one shorter than a k-mer.
    long_read = (ref + random_dna(rng, 40), 5000, f"{len(ref) + 40}M", 60, 30)
    short_read = (ref[200:225], 5200, "25M", 60, 30)
    cases["long-and-short-reads"] = base + (
        haps(snp), [long_read, short_read] + reads_from(snp, 8), {})
    n_window = window[:40] + "N" * 30 + window[70:]
    n_ref = prefix + n_window + suffix
    n_alt = n_window[:20] + "TTT" + n_window[20:]
    n_reads = reads_over(prefix + n_alt + suffix, 5000, 16, 100, rng)
    n_reads = [(s[:50] + "CG" + s[50:], p, f"{len(s) + 2}M", m, q)
               if i % 2 else (s, p, c, m, q)
               for i, (s, p, c, m, q) in enumerate(n_reads)]
    cases["n-run-window"] = (n_ref, 5000, len(prefix), len(suffix),
                             sorted([n_ref, prefix + n_alt + suffix]),
                             n_reads, {})
    cases["other-scores"] = base + (haps(ins, dele), hard + reads_from(
        dele, 6), dict(match=2, mismatch=3, gap_open=5, gap_extend=1,
                       kmer_size=16, max_num_of_mismatches=1,
                       realignment_similarity_threshold=0.3))
    cases["no-haplotypes"] = base + ([], reads_from(window, 3), {})
    cases["no-haplotypes-forced"] = base + ([], reads_from(window, 3),
                                            dict(force_alignment=True))
    cases["no-reads"] = base + (haps(snp), [], {})
    return cases


WINDOW_CASES = window_cases()


def run_window(package, fpa, config, case, normalize=False):
    ref, start, prefix_len, suffix_len, haplotypes, specs, overrides = case
    reads = make_reads(package, specs)
    aligner = fpa.FastPassAligner(config.AlignerOptions(**overrides))
    aligner.normalize_reads = normalize
    aligner.set_reference(ref)
    aligner.set_ref_start("chr1", start)
    aligner.set_ref_prefix_len(prefix_len)
    aligner.set_ref_suffix_len(suffix_len)
    aligner.set_haplotypes(haplotypes)
    return reads, aligner.realign_reads(reads), aligner


@pytest.mark.parametrize("name", list(WINDOW_CASES))
def test_fast_pass_realign_reads_matches_jax(name):
    """The realigned reads field by field, the same object where the JAX
    package returns its input, and what the aligner leaves in its
    options. Against the JAX package as it runs, natives loaded."""
    case = WINDOW_CASES[name]
    want_in, want, want_aligner = run_window(JAX, jfpa, jconfig, case)
    got_in, got, got_aligner = run_window(PORT, tfpa, tconfig, case)
    assert_reads_equal(got, want)
    assert [g is i for g, i in zip(got, got_in)] == \
        [w is i for w, i in zip(want, want_in)]
    assert repr(got_aligner.options) == repr(want_aligner.options)
    moved = sum(g is not i for g, i in zip(got, got_in))
    if name in ("insertion", "deletion", "three-alts", "ssw-fallback",
                "n-in-reads", "forced", "n-run-window", "other-scores"):
        assert moved > 0
        assert any(len(g.cigar) > 1 for g in got)
    if name == "forced":
        assert got[-1].aligned_sequence == "" or got[-1] is not got_in[-1]
    if name == "no-haplotypes-forced":
        assert all(g.aligned_sequence == "" for g in got)


@pytest.mark.parametrize("name", ["insertion", "three-alts", "ssw-fallback",
                                  "forced", "other-scores"])
def test_fast_pass_matches_the_jax_python_path_without_n(name, monkeypatch):
    """Without an N on both sides of a pair the JAX package's Python
    path gives the same reads as its native path, and as the port."""
    realigner_natives_off(monkeypatch)
    case = WINDOW_CASES[name]
    _, want, _ = run_window(JAX, jfpa, jconfig, case)
    _, got, _ = run_window(PORT, tfpa, tconfig, case)
    assert_reads_equal(got, want)


def test_n_run_window_parts_the_jax_paths(monkeypatch):
    """Reads over the N run fall back to SSW against haplotypes that hold
    the run: the JAX package's two paths then place some of them
    differently (see test_n_against_n_parts_the_jax_paths), and the port
    equals the native one."""
    case = WINDOW_CASES["n-run-window"]
    _, native_reads, _ = run_window(JAX, jfpa, jconfig, case)
    _, got, _ = run_window(PORT, tfpa, tconfig, case)
    assert_reads_equal(got, native_reads)
    realigner_natives_off(monkeypatch)
    _, python_reads, _ = run_window(JAX, jfpa, jconfig, case)
    differing = [i for i, (a, b) in enumerate(zip(native_reads, python_reads))
                 if dataclasses.asdict(a) != dataclasses.asdict(b)]
    assert differing, "the JAX package's two paths now agree on N runs"


def test_normalize_reads_keeps_unnormalized_alignments():
    case = WINDOW_CASES["ssw-fallback"]
    _, want, _ = run_window(JAX, jfpa, jconfig, case, normalize=True)
    _, got, _ = run_window(PORT, tfpa, tconfig, case, normalize=True)
    assert_reads_equal(got, want)


def test_fast_pass_pieces_match_jax():
    want_a, got_a = jfpa.FastPassAligner(), tfpa.FastPassAligner()
    for options in (want_a.options, got_a.options):
        options.read_size = 100
    assert got_a._ssw_score_threshold() == want_a._ssw_score_threshold()
    for s1, s2, cap in (("ACGTNACGT", "ACGTAACGA", 3), ("AAAA", "CCCC", 2),
                        ("ACGT", "ACGT", 1), ("ANNA", "NCCN", 1)):
        assert got_a._fast_align_strings(s1, s2, cap) == \
            want_a._fast_align_strings(s1, s2, cap)
    for aligner in (want_a, got_a):
        aligner._reads = ["ACGTACGTAC" * 5, "ACGT", "TTGCA" * 9]
        aligner.options.kmer_size = 8
        aligner._build_index()
    assert list(got_a._kmer_index.items()) == list(want_a._kmer_index.items())
    for aligner in (want_a, got_a):
        aligner.reference = "ACGTTGCAAC"
    for cigar, offset, seq in (([[1, 4], [2, 2], [1, 2]], 0, "ACGTGTTG"),
                               ([[1, 4], [2, 1], [1, 3]], 0, "ACGTTTGC"),
                               ([[1, 4], [3, 2], [1, 2]], 0, "ACGTCA"),
                               ([[1, 2], [3, 9], [1, 2]], 0, "ACGT"),
                               ([[5, 2], [1, 4]], -1, "GGACGT")):
        assert got_a._is_alignment_normalized(cigar, offset, seq) == \
            want_a._is_alignment_normalized(cigar, offset, seq)


# -- realigner ----------------------------------------------------------------

def test_assign_and_split_reads_match_jax(dense_paths):
    specs = [("A" * 60, 100, "20M30N20M5N20M", 60, 30),
             ("C" * 50, 200, "50M", 60, 30),
             ("G" * 40, 300, "10M100N30M", 60, 30),
             ("T" * 45, 400, "5S20M50N10M2I5M3S", 60, 30),
             ("A" * 30, 500, "15N30M", 60, 30)]
    want = jrealigner.split_reads(make_reads(JAX, specs))
    got = trealigner.split_reads(make_reads(PORT, specs))
    assert_reads_equal(got, want)
    assert [r.fragment_name for r in got] == [
        "r0_p0", "r0_p1", "r0_p2", "r1", "r2_p1", "r3_p0", "r3_p1", "r4_p1"]
    unsplit = make_reads(PORT, specs[1:2])
    assert trealigner.split_reads(unsplit)[0] is unsplit[0]

    out = []
    for package, module in ((JAX, jrealigner), (PORT, trealigner)):
        types = __import__(f"{package}.core.types", fromlist=["x"])
        _, reads, _, _ = region_reads(package, dense_paths,
                                      ("chr1", 1000, 2000))
        regions = [module.AssemblyRegion(module.CandidateHaplotypes(
            types.Range("chr1", s, e), ["A"])) for s, e in
            ((1000, 1200), (1150, 1400), (1900, 2100))]
        unassigned = module.assign_reads_to_assembled_regions(regions, reads)
        out.append((
            [r.fragment_name for r in unassigned],
            [[r.fragment_name for r in ar.reads] for ar in regions],
            [dataclasses.astuple(ar.read_span) for ar in regions],
            [ar.haplotypes for ar in regions]))
    assert out[1] == out[0]
    assert out[1][0] and all(out[1][1])


REALIGNER_OPTIONS = {
    "default": dict(),
    "split-skip-reads": dict(split_skip_reads=True),
    "linear-windows": dict(ws_config=dict(model_type="allele_count_linear")),
    "small-k-no-pruning": dict(dbg_config=dict(
        min_k=12, max_k=40, step_k=2, disable_graph_pruning=True)),
    "tolerant-aligner": dict(aln_config=dict(
        max_num_of_mismatches=4, realignment_similarity_threshold=0.3)),
}


def realigner_options(config, overrides):
    kw = dict(overrides)
    for key, cls in (("ws_config", config.WindowSelectorOptions),
                     ("dbg_config", config.DeBruijnGraphOptions),
                     ("aln_config", config.AlignerOptions)):
        if key in kw:
            kw[key] = cls(**kw[key])
    return config.RealignerOptions(**kw)


@pytest.mark.parametrize("region", [("chr1", 1000, 2000), ("chr2", 0, 1000)],
                         ids=lambda r: "%s:%d-%d" % r)
@pytest.mark.parametrize("name", list(REALIGNER_OPTIONS))
def test_realigner_matches_jax(sparse_paths, name, region):
    """`Realigner.realign_reads` on reads decoded from the BAM: the
    candidate haplotypes, the reads in the returned order, which of them
    are the input objects, and the options after the run (the aligner
    writes read_size into the shared aln_config)."""
    out = []
    for package, module, config in ((JAX, jrealigner, jconfig),
                                    (PORT, trealigner, tconfig)):
        batch, reads, ref, rng = region_reads(package, sparse_paths, region)
        options = realigner_options(config, REALIGNER_OPTIONS[name])
        realigner = module.Realigner(options, ref)
        haplotypes, realigned = realigner.realign_reads(reads, rng,
                                                        batch=batch)
        ids = {id(r) for r in reads}
        out.append((haplotypes, realigned, [id(r) in ids for r in realigned],
                    repr(options).replace(package + ".", "")))
    (want_haps, want, want_same, want_repr), (haps, got, same, got_repr) = out
    assert [(dataclasses.astuple(h.span), h.haplotypes) for h in haps] == \
        [(dataclasses.astuple(h.span), h.haplotypes) for h in want_haps]
    assert_reads_equal(got, want)
    assert same == want_same and got_repr == want_repr
    assert haps and not all(same), "no window assembled or no read moved"
    # Without the columnar batch the selector rebuilds it: same result.
    batch, reads, ref, rng = region_reads(PORT, sparse_paths, region)
    _, again = trealigner.Realigner(
        realigner_options(tconfig, REALIGNER_OPTIONS[name]),
        ref).realign_reads(reads, rng)
    assert_reads_equal(again, got)


def test_realigner_edge_cases(sparse_paths):
    _, reads, ref, rng = region_reads(PORT, sparse_paths, ("chr1", 0, 1000))
    realigner = trealigner.Realigner(None, ref)
    assert realigner.realign_reads([], rng) == ([], [])
    assert isinstance(realigner.config, tconfig.RealignerOptions)
    # A window wider than max_window_size or off the contig is skipped.
    Range = type(rng)
    assert realigner.call_debruijn_graph(
        [Range("chr1", 0, 1200), Range("chr1", 3900, 4100)], reads) == []
    region = trealigner.AssemblyRegion(trealigner.CandidateHaplotypes(
        Range("chr1", 100, 200), ["A"]))
    assert region.read_span is None
    assert realigner.call_fast_pass_aligner(region) == []
    assert to_package(tconfig.RealignerOptions(), JAX) == \
        jconfig.RealignerOptions()
