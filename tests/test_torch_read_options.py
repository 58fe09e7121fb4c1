"""The read-side options of the short-read path in the PyTorch port
against the JAX package: original qualities (OQ), Ultima's flow tags
(tp/t0) and the three homopolymer-quality channels they feed, and read
normalization (`make_examples/normalize.py`).

All of it is host code in both packages (Python and numpy), so
everything here is exact: the same qualities, tags, CIGARs and starts,
pixels, examples, candidates and plans, and the make_examples CLI's
files byte for byte. The seeded sample is `stage1_sample` with the tags
and right-shifted homopolymer indels of `synthetic.add_read_options`;
each test also checks that its option changed something on it.
"""

import json

import numpy as np
import pytest
import torch

from deepvariant_tpu.core import types as jt
from deepvariant_tpu.io import bam as jbam
from deepvariant_tpu.make_examples import core as jcore
from deepvariant_tpu.make_examples import normalize as jnorm
from deepvariant_tpu.make_examples import pileup as jpileup
from deepvariant_tpu.scripts import make_examples as jcli
from deepvariant_tpu_torch.core import types as tt
from deepvariant_tpu_torch.core.sharded_files import glob_sharded_inputs
from deepvariant_tpu_torch.io import bam as tbam
from deepvariant_tpu_torch.io import examples as example_codec
from deepvariant_tpu_torch.io.fasta import FastaReader
from deepvariant_tpu_torch.io.tfrecord import TFRecordReader
from deepvariant_tpu_torch.make_examples import core as tcore
from deepvariant_tpu_torch.make_examples import normalize as tnorm
from deepvariant_tpu_torch.make_examples import pileup as tpileup
from deepvariant_tpu_torch.scripts import make_examples as tcli
from torch_port_util import (
    assert_batches_equal,
    assert_planned_equal,
    build_region,
    preset_options,
    reference_window,
    run_cli_outputs,
    synthetic_region,
    tagged_short_sample,
    wgs_options,
    write_stage1_inputs,
)

torch.set_num_threads(2)

JAX, PORT = "deepvariant_tpu", "deepvariant_tpu_torch"
CORES = {JAX: jcore, PORT: tcore}
REGIONS = [("chr1", 0, 3000), ("chr1", 3000, 6000), ("chr2", 0, 3000)]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return write_stage1_inputs(tagged_short_sample(),
                               tmp_path_factory.mktemp("tagged"))


def both_batches(paths, region):
    """(JAX batch, port batch) over `region`, each from its own reader,
    and the two readers (left open)."""
    out = []
    for bam, types in ((jbam, jt), (tbam, tt)):
        reader = bam.BamReader(paths["reads"])
        out.append((reader, reader.query(types.Range(*region))))
    return out


# -- the aux readers -----------------------------------------------------------

@pytest.mark.parametrize("region", REGIONS)
def test_original_quality_scores_match_jax(paths, region):
    """OQ replaces QUAL only where its length is the read's: reads with
    an OQ one base short or long keep their QUAL."""
    (jr, jb), (tr, tb) = both_batches(paths, region)
    before = tb.qual.copy()
    assert tr.apply_original_quality_scores(tb) == \
        jr.apply_original_quality_scores(jb) > 20
    assert_batches_equal(tb, jb)
    assert (tb.qual != before).sum() > 1000
    so = tb.seq_offsets
    wrong = 0
    for i, blob in enumerate(tb.aux):
        oq = tbam.parse_aux(blob).get("OQ")
        if oq is not None and len(oq) != so[i + 1] - so[i]:
            wrong += 1
            np.testing.assert_array_equal(tb.qual[so[i]:so[i + 1]],
                                          before[so[i]:so[i + 1]])
    assert wrong >= 1


@pytest.mark.parametrize("region", REGIONS)
def test_ultima_tags_match_jax(paths, region):
    (jr, jb), (tr, tb) = both_batches(paths, region)
    assert tr.parse_ultima_tags(tb) == jr.parse_ultima_tags(jb) > 20
    for got, want in ((tb.tp, jb.tp), (tb.t0, jb.t0)):
        assert len(got) == len(want) == len(tb)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
    assert sum(t is not None for t in tb.t0) > 20


# t0 is phred + 33, clipped to [0, 255]: a byte below '!' decodes to 0,
# a byte above ASCII to '?' (30) after the reader's 'replace'.
T0_BLOBS = {
    "plain": b"t0Z" + bytes([33, 40, 93, 126]) + b"\x00",
    "below-bang": b"t0Z" + bytes([32, 1, 33]) + b"\x00",
    "not-ascii": b"t0Z" + bytes([200, 60]) + b"\x00",
    "tp-and-t0": b"tpBc" + (3).to_bytes(4, "little") + bytes([255, 0, 1])
                 + b"t0Z" + bytes([50, 51, 52]) + b"\x00",
    "tp-only": b"tpBc" + (2).to_bytes(4, "little") + bytes([1, 254]),
}


@pytest.mark.parametrize("name", list(T0_BLOBS))
def test_flow_tag_blobs_match_jax(paths, name):
    (jr, jb), (tr, tb) = both_batches(paths, ("chr2", 0, 400))
    for batch in (jb, tb):
        batch.aux = [T0_BLOBS[name]] * len(batch)
    assert tr.parse_ultima_tags(tb) == jr.parse_ultima_tags(jb)
    for got, want in ((tb.tp[0], jb.tp[0]), (tb.t0[0], jb.t0[0])):
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
    if name == "below-bang":
        assert tb.t0[0].tolist() == [0, 0, 0]


# -- normalization ---------------------------------------------------------------

_M, _I, _D, _S = 1, 2, 3, 5


def _arr(text):
    return np.frombuffer(text.encode(), np.uint8)


# The cases of tests/test_normalize.py (allelecounter.cc NormalizeCigar
# scenarios) and a few more: (read, offset, cigar, reference).
NORMALIZE_CASES = {
    "no-indel": ("ACGT", 0, [(_M, 4)], "ACGTACGT"),
    "deletion-to-start": ("AAAC", 0, [(_M, 3), (_D, 1), (_M, 1)], "AAAAC"),
    "insertion-left": ("CATTTTG", 0, [(_M, 5), (_I, 1), (_M, 1)], "CATTTG"),
    "deletion-insertion-merge": ("GGGCCCCCGGG", 0,
                                 [(_M, 3), (_D, 3), (_I, 5), (_M, 3)],
                                 "GGGTTTGGG"),
    "soft-clip": ("NNCATTTTG", 0, [(_S, 2), (_M, 5), (_I, 1), (_M, 1)],
                  "CATTTG"),
    "dinucleotide-deletion": ("GCACACT", 1, [(_M, 5), (_D, 2), (_M, 2)],
                              "TGCACACACT"),
    "heading-insertion": ("AAAG", 0, [(_M, 1), (_I, 1), (_M, 2)], "AAG"),
    "two-indels": ("CTTTGAAAAC", 0,
                   [(_M, 4), (_I, 1), (_M, 3), (_D, 1), (_M, 2)],
                   "CTTGAAAAAC"),
    "past-the-reference": ("CAAAA", 2, [(_M, 3), (_I, 1), (_M, 1)], "TTCAAA"),
}


@pytest.mark.parametrize("name", list(NORMALIZE_CASES))
def test_normalize_cigar_hand_cases_match_jax(name):
    read, offset, cigar, ref = NORMALIZE_CASES[name]
    got = tnorm.normalize_cigar(_arr(read), offset, cigar, _arr(ref))
    assert got == jnorm.normalize_cigar(_arr(read), offset, cigar, _arr(ref))
    if name in ("deletion-to-start", "insertion-left", "soft-clip"):
        assert got[2]


def random_indel_read(rng):
    """A reference of short homopolymers and repeats, and a read of it
    with one to three indels at random offsets (often in a run)."""
    units = [rng.choice(list("ACGT")) * int(rng.randint(1, 6))
             for _ in range(30)]
    ref = "".join(units)
    start = int(rng.randint(0, 10))
    read, cigar, pos = [], [], start
    for _ in range(int(rng.randint(1, 4))):
        n = int(rng.randint(3, 12))
        read.append(ref[pos:pos + n])
        cigar.append((_M, n))
        pos += n
        k = int(rng.randint(1, 3))
        if rng.rand() < 0.5:
            pos += k
            cigar.append((_D, k))
        else:
            read.append(ref[pos - 1] * k)
            cigar.append((_I, k))
    read.append(ref[pos:pos + 6])
    cigar.append((_M, len(ref[pos:pos + 6])))
    return "".join(read), start, cigar, ref


@pytest.mark.parametrize("seed", range(8))
def test_normalize_cigar_seeded_cases_match_jax(seed):
    rng = np.random.RandomState(seed)
    modified = 0
    for _ in range(40):
        read, start, cigar, ref = random_indel_read(rng)
        got = tnorm.normalize_cigar(_arr(read), start, cigar, _arr(ref))
        assert got == jnorm.normalize_cigar(_arr(read), start, cigar,
                                            _arr(ref)), (read, cigar, ref)
        modified += got[2]
    assert modified >= 5


@pytest.mark.parametrize("region", REGIONS)
def test_normalize_batch_cigars_on_the_sample_match_jax(paths, region):
    """The sample's right-shifted homopolymer indels move left, the other
    reads stay; the same CIGARs, starts and count in both packages."""
    (jr, jb), (tr, tb) = both_batches(paths, region)
    fasta = FastaReader(paths["ref"])
    ref = fasta.bases(tt.Range(*region))
    before = tb.cigar_ops.copy(), tb.cigar_lens.copy(), tb.pos.copy()
    n = tnorm.normalize_batch_cigars(tb, ref, region[1])
    assert n == jnorm.normalize_batch_cigars(jb, ref.copy(), region[1])
    assert_batches_equal(tb, jb)
    assert n >= 3
    assert len(tb.cigar_lens) != len(before[1]) or \
        (tb.cigar_lens != before[1]).any() or (tb.pos != before[2]).any()


# -- the homopolymer-quality channels -----------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_hmer_indel_qualities_match_jax(seed):
    rng = np.random.RandomState(seed)
    for _ in range(30):
        n = int(rng.randint(0, 60))
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.randint(0, 2, n)]
        qual = rng.randint(10, 60, n).astype(np.uint8)
        tp = rng.randint(-1, 2, n + int(rng.randint(0, 2))).astype(np.int8) \
            if rng.rand() < 0.9 else None
        for is_deletion in (False, True):
            np.testing.assert_array_equal(
                tpileup._hmer_indel_qualities(seq, qual, tp, is_deletion),
                jpileup._hmer_indel_qualities(seq, qual, tp, is_deletion))


def test_hmer_error_sum_past_one_is_held_at_zero():
    """Two bases of quality 2 in one run with the same tp sign sum to an
    error probability of 1.26, a phred of -1: the port paints 0 there,
    the JAX package's uint8 store raises (ROADMAP.md Queue 3); the other
    runs are equal."""
    seq = _arr("AACGGG")
    qual = np.array([2, 2, 30, 30, 20, 20], np.uint8)
    tp = np.array([1, 1, 0, -1, 1, 1], np.int8)
    got = tpileup._hmer_indel_qualities(seq, qual, tp, False)
    assert got[:2].tolist() == [0, 0]
    with pytest.raises(OverflowError):
        jpileup._hmer_indel_qualities(seq, qual, tp, False)
    # The same runs with a summed error below 1 at the first one.
    qual[:2] = 30
    np.testing.assert_array_equal(got[2:], jpileup._hmer_indel_qualities(
        seq, qual, tp, False)[2:])


def flow_region(seed, n_reads=80):
    """`synthetic_region` in both packages with the same tp/t0 arrays on
    most reads (some tp of the wrong length, some t0 short)."""
    reference, reads, candidates = synthetic_region(seed, n_reads)
    out = [reference]
    rng = np.random.RandomState(seed + 7)
    built = [build_region(p, reads, candidates) for p in (JAX, PORT)]
    lengths = np.diff(built[0][0].seq_offsets)
    tps, t0s = [], []
    for n in lengths.tolist():
        tps.append(None if rng.rand() < 0.1 else rng.randint(
            -1, 2, n - (rng.rand() < 0.1)).astype(np.int8))
        t0s.append(None if rng.rand() < 0.1 else rng.randint(
            0, 120, n - 2 * (rng.rand() < 0.1)).astype(np.uint8))
    for batch, _, _ in built:
        # Qualities of 10 and up: a run's summed error stays below 1.
        batch.qual = np.maximum(batch.qual, 10).astype(np.uint8)
        batch.tp = [None if t is None else t.copy() for t in tps]
        batch.t0 = [None if t is None else t.copy() for t in t0s]
    out.extend(built)
    return out


@pytest.mark.parametrize("channels", [(28,), (29,), (30,), (1, 28, 29, 30),
                                      (30, 6, 28)])
def test_homopolymer_channels_paint_as_jax(channels):
    reference, (jb, jcalls, jcombos), (tb, tcalls, tcombos) = \
        flow_region(len(channels))
    images = []
    for module, batch, calls, combos in ((jpileup, jb, jcalls, jcombos),
                                         (tpileup, tb, tcalls, tcombos)):
        options = module.PileupOptions(channels=channels, width=99,
                                       height=60)
        encoder = module.PileupEncoder(options)
        out = []
        for call, combo in zip(calls, combos):
            window = reference_window(reference, options, call.variant)
            indices = module.reads_overlapping_variant(
                batch, call.variant, options.read_overlap_buffer_bp)
            out.append(encoder.build_pileup(call, window, batch, indices,
                                            combo))
        images.append(np.stack(out))
    np.testing.assert_array_equal(images[1], images[0])
    # The channels read the tags: rows differ from the flat colors.
    band = images[1][:, 5:]
    assert len(np.unique(band)) > 3


# -- the runner and the CLI --------------------------------------------------------

HMER = (28, 29, 30)
RUNNER_CASES = {
    "normalize": dict(normalize_reads=True),
    "original-qualities": dict(use_original_quality_scores=True),
    "both": dict(normalize_reads=True, use_original_quality_scores=True),
    "homopolymer-channels": dict(channels=(1, 2, 3, 4, 5, 6, 19) + HMER),
    "homopolymer-channels-normalized": dict(
        channels=(1, 2, 3, 28, 30), normalize_reads=True),
    "realigner-normalize-oq": dict(realigner_enabled=True,
                                   normalize_reads=True,
                                   use_original_quality_scores=True),
}


def run_runner(package, paths, tmp, case, on, plans=None):
    """The WGS runner over two regions with the case's options, or with
    `on` False the WGS channels and only the case's realigner switch
    (off unless the case says); returns the examples (b"" with a plan
    sink) and candidates TFRecords' bytes."""
    overrides = dict(RUNNER_CASES[case])
    channels = overrides.pop("channels", None)
    if not on:
        overrides = {"realigner_enabled":
                     overrides.get("realigner_enabled", False)}
        channels = None
    tag = f"{package}-{case}-{on}"
    options = wgs_options(
        package, paths, regions=["chr1:1,001-3,000", "chr2:1-1,500"],
        examples_filename=str(tmp / f"{tag}.ex.tfrecord") if plans is None
        else "",
        candidates_filename=str(tmp / f"{tag}.cand.tfrecord"))
    for key, value in overrides.items():
        setattr(options, key, value)
    if channels:
        options.pileup_options.channels = channels
    if plans is None:
        CORES[package].make_examples_runner(options)
        return tuple((tmp / f"{tag}.{k}.tfrecord").read_bytes()
                     for k in ("ex", "cand"))
    CORES[package].make_examples_runner(options, plan_sink=plans.append)
    return (b"", (tmp / f"{tag}.cand.tfrecord").read_bytes())


@pytest.mark.parametrize("case", list(RUNNER_CASES))
def test_runner_examples_and_candidates_match_jax(case, paths, tmp_path):
    got = run_runner(PORT, paths, tmp_path, case, True)
    assert got == run_runner(JAX, paths, tmp_path, case, True)
    assert len(got[0]) > 10000
    assert got != run_runner(PORT, paths, tmp_path, case, False)
    channels = RUNNER_CASES[case].get("channels", ())
    if channels:
        # The homopolymer planes read the reads' tp/t0: more than the
        # flat colors in the read rows.
        images = [example_codec.parse_example(buf).image for buf in
                  TFRecordReader(str(tmp_path /
                                     f"{PORT}-{case}-True.ex.tfrecord"))]
        for ch in HMER:
            if ch in channels:
                plane = np.stack(images)[:, 5:, :, channels.index(ch)]
                assert len(np.unique(plane)) > 3, ch


@pytest.mark.parametrize("case", ["normalize", "original-qualities", "both"])
def test_runner_plans_match_jax(case, paths, tmp_path):
    """The device-encode plans (the plan form paints them on the card)
    see the normalized reads and the original qualities as the host
    painter does."""
    got, want, off = [], [], []
    cand = run_runner(PORT, paths, tmp_path, case, True, plans=got)
    assert cand == run_runner(JAX, paths, tmp_path, case, True, plans=want)
    assert_planned_equal(got, want)
    run_runner(PORT, paths, tmp_path, case, False, plans=off)
    assert len(got) == len(off) > 10
    assert any(not np.array_equal(g.plan[k], o.plan[k])
               for g, o in zip(got, off) for k in g.plan
               if g.plan[k].shape == o.plan[k].shape)


HMER_LIST = ("BASE_CHANNELS,homopolymer_insertion_quality,"
             "homopolymer_deletion_quality,"
             "inter_homopolymer_insertion_quality")
CLI_CASES = {
    "normalize-oq": (["--model_preset", "WGS", "--normalize_reads",
                      "--use_original_quality_scores",
                      "--regions", "chr1:1-2,500"], 1, "calling"),
    "homopolymer-channels": (["--model_preset", "WGS", "--no-realign_reads",
                              "--channel_list", HMER_LIST,
                              "--regions", "chr1:1-2,000 chr2"], 2,
                             "calling"),
    "candidate-sweep-mode": (["--model_preset", "WGS", "--no-realign_reads",
                              "--regions", "chr2"], 1, "candidate_sweep"),
}


@pytest.mark.parametrize("name", list(CLI_CASES))
def test_cli_outputs_match_jax(name, paths, tmp_path):
    """The make_examples CLI's files equal the JAX CLI's byte for byte.
    `--mode candidate_sweep` runs the calling runner in both CLIs (the
    positions file is `candidate_sweep_runner`'s, held in
    test_torch_merge_phased_reads.py)."""
    flags, shards, mode = CLI_CASES[name]
    got = run_cli_outputs(tcli, paths, str(tmp_path / "port"), flags,
                          shards, mode)
    want = run_cli_outputs(jcli, paths, str(tmp_path / "jax"), flags,
                           shards, mode)
    assert got == want
    assert len(got["examples"]) == shards and \
        sum(len(b) for b in got["examples"]) > 10000
    if name == "homopolymer-channels":
        first = glob_sharded_inputs(
            str(tmp_path / "port" / "examples.tfrecord@2"))[0]
        with open(first + ".example_info.json") as f:
            assert json.load(f)["shape"] == [100, 221, 9]


@pytest.fixture(scope="module")
def long_paths(tmp_path_factory):
    from deepvariant_tpu_torch.testing import synthetic

    sample = synthetic.synthetic_longread_sample(
        5, (("chr1", 6000), ("chr2", 3000)), depth=12, mean_read_length=2000)
    return write_stage1_inputs(sample, tmp_path_factory.mktemp("long"))


@pytest.mark.parametrize("partition_size", [1500, 3000])
def test_pacbio_normalization_plans_match_jax(long_paths, tmp_path,
                                              partition_size):
    """The PACBIO preset (direct phasing, diff_channels) with
    `normalize_reads`: the long reads' homopolymer indel errors move
    left, and the plans, phases and candidates equal the JAX runner's."""
    runs = []
    for package in (JAX, PORT, PORT):
        normalize = len(runs) < 2
        plans = []
        tag = f"{package}-{normalize}"
        options = preset_options(
            package, long_paths, "PACBIO", partition_size=partition_size,
            normalize_reads=normalize, output_phase_info=True,
            candidates_filename=str(tmp_path / f"{tag}.cand"),
            output_local_read_phasing_filename=str(tmp_path / f"{tag}.tsv"))
        CORES[package].make_examples_runner(options, plan_sink=plans.append)
        runs.append((plans, (tmp_path / f"{tag}.cand").read_bytes(),
                     (tmp_path / f"{tag}.tsv").read_bytes()))
    (want, *want_files), (got, *got_files), (plain, *_) = runs
    assert_planned_equal(got, want)
    assert got_files == want_files and len(got) > 10
    assert any(not np.array_equal(g.plan[k], p.plan[k])
               for g, p in zip(got, plain) for k in g.plan
               if g.plan[k].shape == p.plan[k].shape) or \
        len(got) != len(plain)
