"""Methylation in the PyTorch port against the JAX package: MM/ML
decoding (`io/methylation.py`, `BamReader.parse_methylation`), the
base_methylation and base_6ma channels, methylation calling (MF/MD on
the candidates and the '.'-alt methylated reference sites), and
methylation-aware phasing (`phasing/methylation_aware_phasing.py`: the
Wilcoxon rank-sum test, the informative sites, the vote, and MI).

All of it is host code in both packages, so everything is exact (the
p-values too: the same float operations in the same order): decodes,
pixels, examples, candidates TFRecords, plans, the make_examples CLI's
files, and the VCF that `run_deepvariant --device cpu` writes against
the JAX postprocess CLI on its CVOs. The seeded sample is
`torch_port_util.methylated_long_sample` (SNPs C>T at CpGs, 5mC with
haplotype-specific levels at a share of the CpGs, some 6mA); each test
also checks that the option did something there.
"""

import gzip
import os

import numpy as np
import pytest
import torch

from deepvariant_tpu.core import types as jt
from deepvariant_tpu.io import bam as jbam
from deepvariant_tpu.io import methylation as jmeth
from deepvariant_tpu.make_examples import core as jcore
from deepvariant_tpu.make_examples import pileup as jpileup
from deepvariant_tpu.phasing import methylation_aware_phasing as jmap
from deepvariant_tpu.scripts import make_examples as jcli
from deepvariant_tpu.scripts import postprocess_variants as jpp_cli
from deepvariant_tpu_torch.calling.call_variants import read_cvos
from deepvariant_tpu_torch.core import types as tt
from deepvariant_tpu_torch.io import bam as tbam
from deepvariant_tpu_torch.io import methylation as tmeth
from deepvariant_tpu_torch.io.tfrecord import TFRecordReader
from deepvariant_tpu_torch.make_examples import core as tcore
from deepvariant_tpu_torch.make_examples import pileup as tpileup
from deepvariant_tpu_torch.models import inception_v3 as iv3
from deepvariant_tpu_torch.models.checkpoint import save_variables
from deepvariant_tpu_torch.phasing import methylation_aware_phasing as tmap
from deepvariant_tpu_torch.scripts import make_examples as tcli
from deepvariant_tpu_torch.scripts import run_deepvariant as rd
from torch_port_util import (
    assert_planned_equal,
    build_region,
    methylated_long_sample,
    preset_options,
    random_flax_variables,
    reference_window,
    run_cli_outputs,
    synthetic_region,
    write_stage1_inputs,
)

torch.set_num_threads(2)

JAX, PORT = "deepvariant_tpu", "deepvariant_tpu_torch"
CORES = {JAX: jcore, PORT: tcore}
TYPES = {JAX: jt, PORT: tt}
REGIONS = [("chr1", 0, 3000), ("chr1", 3000, 6000), ("chr2", 0, 3000)]
METH_CHANNELS = (23, 24)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return write_stage1_inputs(methylated_long_sample(),
                               tmp_path_factory.mktemp("meth"))


def both_batches(paths, region):
    out = []
    for bam, types in ((jbam, jt), (tbam, tt)):
        reader = bam.BamReader(paths["reads"], bam.ReadRequirements(
            min_mapping_quality=1))
        out.append((reader, reader.query(types.Range(*region))))
    return out


def assert_optional_arrays_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


# -- MM/ML decoding ---------------------------------------------------------------

ML = np.array([10, 20, 30, 40, 50, 60, 70, 80, 90, 100], np.uint8)
# name -> (aligned sequence, MM, ML or None, reverse strand)
DECODE_CASES = {
    "forward": ("ACGTCGACCG", "C+m,0,1;", ML, False),
    "reverse": ("ACGTCGACCG", "C+m,0,1;", ML, True),
    "skip-question": ("CCCCGCCG", "C+m?,1,0,2;", ML, False),
    "skip-dot": ("CCCCGCCG", "C+m.,2;", ML, True),
    "two-items": ("CACAGTACG", "C+m,1;A+a,0,1;", ML, False),
    "two-codes": ("CCGCCG", "C+hm,0,2;", ML, False),
    "numeric-code": ("CCGCCG", "C+27,1;", ML, False),
    "no-ml": ("ACGCG", "C+m,0,0;", None, False),
    "past-the-read": ("ACGCG", "C+m,0,5,1;", ML, False),
    "ml-short": ("CCCCCC", "C+m,0,0,0;", ML[:2], False),
    "lower-case": ("acgcgt", "C+m,1;", ML, False),
    "no-semicolon": ("ACGCG", "C+m,0", ML, True),
    "minus-strand-code": ("GCGCGG", "G-m,0,1;", ML, False),
    "n-base": ("ANCNG", "N+m,1,0;", ML, False),
    "empty": ("ACGT", "", ML, False),
}


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_decode_base_modifications_hand_cases_match_jax(name):
    seq, mm, ml, reverse = DECODE_CASES[name]
    got = tmeth.decode_base_modifications(seq, mm, ml, reverse)
    want = jmeth.decode_base_modifications(seq, mm, ml, reverse)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    if name in ("forward", "reverse"):
        assert got["C+m"].any()
        # Reverse reads walk the G's from the 3' end.
        assert (got["C+m"].nonzero()[0].tolist() == [1, 7]) == (not reverse)


def random_tags(rng, n):
    seq = "".join("ACGT"[i] for i in rng.randint(0, 4, n))
    items = []
    count = 0
    for base, code in (("C", "m"), ("A", "a"), ("C", "h")):
        if rng.rand() < 0.3:
            continue
        k = int(rng.randint(0, 6))
        deltas = rng.randint(0, 4, k).tolist()
        count += k
        skip = ("", "?", ".")[rng.randint(3)]
        items.append(f"{base}+{code}{skip}" + "".join(
            f",{d}" for d in deltas) + ";")
    ml = rng.randint(0, 256, max(0, count + int(rng.randint(-2, 2)))).astype(
        np.uint8) if rng.rand() < 0.9 else None
    aux = {("MM", "Mm")[rng.randint(2)]: "".join(items)}
    if ml is not None:
        aux[("ML", "Ml")[rng.randint(2)]] = ml
    return seq, aux


@pytest.mark.parametrize("seed", range(6))
def test_seeded_tags_decode_as_jax(seed):
    rng = np.random.RandomState(seed)
    seen = 0
    for _ in range(50):
        seq, aux = random_tags(rng, int(rng.randint(1, 80)))
        reverse = bool(rng.randint(2))
        for code in ("m", "a", "h"):
            got = tmeth.base_modification_values(seq, aux, reverse, code)
            want = jmeth.base_modification_values(seq, aux, reverse, code)
            assert (got is None) == (want is None)
            if got is not None:
                np.testing.assert_array_equal(got, want)
                seen += bool(got.any())
        got = tmeth.methylation_values(seq, aux, reverse)
        want = jmeth.methylation_values(seq, aux, reverse)
        assert (got is None) == (want is None)
    assert seen > 10


@pytest.mark.parametrize("region", REGIONS)
def test_parse_methylation_matches_jax(paths, region):
    """Both spellings (MM/ML and Mm/Ml), both strands, 5mC and 6mA."""
    (jr, jb), (tr, tb) = both_batches(paths, region)
    n = tr.parse_methylation(tb)
    assert n == jr.parse_methylation(jb) >= 5
    assert_optional_arrays_equal(tb.meth, jb.meth)
    assert_optional_arrays_equal(tb.meth6ma, jb.meth6ma)
    assert sum(m is not None and m.any() for m in tb.meth6ma) >= 3
    spellings = {b"Mm" in blob for blob in tb.aux if b"C+m" in blob}
    assert spellings == {False, True} or region[0] == "chr2"
    reverse = tb.is_reverse()
    assert {bool(reverse[i]) for i, m in enumerate(tb.meth)
            if m is not None} == {False, True}


# -- the two methylation channels --------------------------------------------------

def methylated_region(seed, n_reads=80):
    """`synthetic_region` in both packages with the same 5mC and 6mA
    arrays on most reads."""
    reference, reads, candidates = synthetic_region(seed, n_reads)
    built = [build_region(p, reads, candidates) for p in (JAX, PORT)]
    rng = np.random.RandomState(seed + 3)
    lengths = np.diff(built[0][0].seq_offsets).tolist()
    meth, m6a = [], []
    for n in lengths:
        meth.append(None if rng.rand() < 0.1 else (
            rng.randint(0, 256, n) * (rng.rand(n) < 0.3)).astype(np.uint8))
        m6a.append(None if rng.rand() < 0.3 else (
            rng.randint(0, 256, n) * (rng.rand(n) < 0.1)).astype(np.uint8))
    for batch, _, _ in built:
        batch.meth = [None if m is None else m.copy() for m in meth]
        batch.meth6ma = [None if m is None else m.copy() for m in m6a]
    return [reference] + built


@pytest.mark.parametrize("channels", [(23,), (24,), (1, 23, 24, 2),
                                      (24, 7, 23)])
def test_methylation_channels_paint_as_jax(channels):
    reference, (jb, jcalls, jcombos), (tb, tcalls, tcombos) = \
        methylated_region(len(channels))
    images = []
    for module, batch, calls, combos in ((jpileup, jb, jcalls, jcombos),
                                         (tpileup, tb, tcalls, tcombos)):
        options = module.PileupOptions(channels=channels, width=77,
                                       height=50)
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
    ci = next(i for i, ch in enumerate(channels) if ch in METH_CHANNELS)
    assert len(np.unique(images[1][:, 5:, :, ci])) > 10
    assert not images[1][:, :5, :, ci].any()


# -- methylation-aware phasing ------------------------------------------------

def random_sites(rng, module, n_reads=40, n_sites=30):
    """Seeded sites: per-read levels, haplotype-specific at most sites."""
    truth = rng.randint(1, 3, n_reads)
    sites = []
    for k in range(n_sites):
        levels = {}
        kind = rng.rand()
        for r in rng.choice(n_reads, int(rng.randint(4, 20)),
                            replace=False).tolist():
            if kind < 0.6:
                base = 0.9 if truth[r] == 1 else 0.1
            else:
                base = rng.rand()
            levels[r] = float(np.clip(base + rng.normal(0, 0.05), 0, 1))
        sites.append(module.MethylatedRefSite(100 + 3 * k, levels))
    phases = [int(t) if rng.rand() < 0.6 else 0 for t in truth]
    return phases, sites


@pytest.mark.parametrize("seed", range(5))
def test_wilcoxon_rank_sum_matches_jax(seed):
    rng = np.random.RandomState(seed)
    for _ in range(40):
        a = rng.randint(0, 5, int(rng.randint(0, 12))) / 4.0
        b = rng.rand(int(rng.randint(0, 12)))
        assert tmap.wilcoxon_rank_sum_test(a.tolist(), b.tolist()) == \
            jmap.wilcoxon_rank_sum_test(a.tolist(), b.tolist())
    assert tmap.wilcoxon_rank_sum_test([], [0.1]) == -1.0


@pytest.mark.parametrize("seed", range(5))
def test_sites_vote_and_phasing_match_jax(seed):
    runs = []
    for module in (jmap, tmap):
        rng = np.random.RandomState(seed)
        phases, sites = random_sites(rng, module)
        hap1 = frozenset(i for i, p in enumerate(phases) if p == 1)
        hap2 = frozenset(i for i, p in enumerate(phases) if p == 2)
        informative = module.identify_informative_sites(hap1, hap2, sites)
        votes = [module.haplotype_vote(i, informative, hap1, hap2)
                 for i in range(len(phases))]
        _, fresh = random_sites(np.random.RandomState(seed), module)
        done, p_values = module.perform_methylation_aware_phasing(
            len(phases), phases, fresh)
        runs.append(([s.position for s in informative],
                     [s.p_value for s in sites], votes, done, p_values,
                     phases))
    assert runs[0] == runs[1]
    informative, _, votes, done, _, phases = runs[1]
    assert len(informative) >= 3 and any(votes)
    assert sum(p == 0 for p in done) < sum(p == 0 for p in phases)


def test_constants_match_jax():
    for name in ("P_THRESHOLD", "MIN_READS_PER_HAP", "MIN_TOTAL_READS",
                 "MIN_MEAN_DIFF", "MAX_WITHIN_HAP_STDDEV", "MIN_VOTES",
                 "DEFAULT_MAX_ITER", "DEFAULT_METHYLATION_THRESHOLD"):
        assert getattr(tmap, name) == getattr(jmap, name)
    assert tcore.RegionProcessor._METHYLATION_EXCLUDED_CONTIGS == \
        jcore.RegionProcessor._METHYLATION_EXCLUDED_CONTIGS


@pytest.mark.parametrize("threshold", [0.5, 0.8])
def test_extract_methylated_ref_sites_matches_jax(paths, threshold):
    (jr, jb), (tr, tb) = both_batches(paths, ("chr1", 0, 6000))
    jr.parse_methylation(jb)
    tr.parse_methylation(tb)
    got = tmap.extract_methylated_ref_sites(tb, 500, 5500, threshold)
    want = jmap.extract_methylated_ref_sites(jb, 500, 5500, threshold)
    assert [(s.position, list(s.levels.items())) for s in got] == \
        [(s.position, list(s.levels.items())) for s in want]
    assert len(got) > 50


# -- MF/MD and the '.'-alt sites, in a RegionProcessor --------------------------

def processors(paths, **overrides):
    out = []
    for package in (JAX, PORT):
        options = preset_options(package, paths, "PACBIO", **overrides)
        out.append((package, CORES[package].RegionProcessor(options)))
    return out


@pytest.mark.parametrize("region", REGIONS)
def test_methylation_stats_and_ref_sites_match_jax(paths, region):
    results = []
    for package, processor in processors(paths,
                                         enable_methylation_calling=True):
        rng = TYPES[package].Range(*region)
        batch = processor.region_reads(rng)
        candidates, _, _ = processor.candidates_in_region(rng, batch, False)
        processor._add_methylation_stats(batch, candidates)
        sites = processor._methylated_ref_site_candidates(batch, rng,
                                                          candidates)
        results.append(([c.variant.encode() for c in candidates],
                        [(c.variant.encode(), c.ref_support)
                         for c in sites]))
    assert results[0] == results[1]
    variants = [tt.Variant.decode(v) for v in results[1][0]]
    assert any(any(f > 0 for f in v.calls[0].info.get("MF", []))
               for v in variants)
    assert len(results[1][1]) > 20
    site = tt.Variant.decode(results[1][1][0][0])
    assert site.alternate_bases == ["."] and \
        site.calls[0].genotype == [-1, -1]


def test_ref_sites_skip_excluded_contigs(paths):
    for package, processor in processors(paths,
                                         enable_methylation_calling=True):
        types = TYPES[package]
        batch = processor.region_reads(types.Range("chr1", 0, 6000))
        assert processor._methylated_ref_site_candidates(
            batch, types.Range("chrX", 0, 6000), []) == []


# -- the runner --------------------------------------------------------------------

RUNNER_CASES = {
    "calling": dict(enable_methylation_calling=True),
    "aware-phasing": dict(enable_methylation_aware_phasing=True),
    "both": dict(enable_methylation_calling=True,
                 enable_methylation_aware_phasing=True),
    "parse-aux": dict(parse_sam_aux_fields=True,
                      aux_fields_to_keep=["HP", "MM", "ML"],
                      enable_methylation_calling=True),
    "channels": dict(channels=METH_CHANNELS),
    "channels-and-both": dict(channels=METH_CHANNELS,
                              enable_methylation_calling=True,
                              enable_methylation_aware_phasing=True),
    "excluded-contig": dict(enable_methylation_aware_phasing=True,
                            exclude_contigs_for_methylation_phasing=[
                                "chr1"]),
}


def run_runner(package, paths, tmp, case, plan_mode):
    """The PACBIO runner with the case's options, phase info and the
    read-phase TSV (a case not in RUNNER_CASES runs without methylation);
    returns (examples bytes or plans, candidates bytes, read-phase TSV
    bytes)."""
    overrides = dict(RUNNER_CASES.get(case, {}))
    channels = overrides.pop("channels", ())
    tag = f"{package}-{case}-{plan_mode}"
    options = preset_options(
        package, paths, "PACBIO", output_phase_info=True,
        partition_size=3000,
        examples_filename="" if plan_mode else str(tmp / f"{tag}.ex"),
        candidates_filename=str(tmp / f"{tag}.cand"),
        output_local_read_phasing_filename=str(tmp / f"{tag}.tsv"),
        **overrides)
    options.pileup_options.channels += channels
    plans = []
    CORES[package].make_examples_runner(
        options, plan_sink=plans.append if plan_mode else None)
    first = plans if plan_mode else (tmp / f"{tag}.ex").read_bytes()
    return (first, (tmp / f"{tag}.cand").read_bytes(),
            (tmp / f"{tag}.tsv").read_bytes())


def candidates(blob_path):
    return [tt.Variant.decode(b) for b in TFRecordReader(str(blob_path))]


@pytest.mark.parametrize("case", list(RUNNER_CASES))
def test_runner_matches_jax(case, paths, tmp_path):
    """Examples (or plans, where the channels are the plan form's),
    candidates TFRecords with the '.'-alt sites, and the read phases."""
    plan_mode = "channels" not in RUNNER_CASES[case]
    got = run_runner(PORT, paths, tmp_path, case, plan_mode)
    want = run_runner(JAX, paths, tmp_path, case, plan_mode)
    if plan_mode:
        assert_planned_equal(got[0], want[0])
        assert len(got[0]) > 10
    else:
        assert got[0] == want[0] and len(got[0]) > 100000
    assert got[1:] == want[1:]
    tag = f"{PORT}-{case}-{plan_mode}"
    variants = candidates(tmp_path / f"{tag}.cand")
    ref_sites = [v for v in variants if v.alternate_bases == ["."]]
    opts = RUNNER_CASES[case]
    calling = opts.get("enable_methylation_calling")
    aware = opts.get("enable_methylation_aware_phasing")
    assert bool(ref_sites) == bool(calling or aware)
    if calling:
        assert any(any(f > 0 for f in v.calls[0].info.get("MF", []))
                   for v in variants if v.alternate_bases != ["."])
    mi = [v for v in variants if "MI" in v.calls[0].info]
    assert bool(mi) == bool(aware and case != "excluded-contig") or \
        (case == "excluded-contig" and all(v.reference_name == "chr2"
                                           for v in mi))
    if aware and case != "excluded-contig":
        # Methylation-aware phasing moved reads that direct phasing left
        # unphased.
        plain = run_runner(PORT, paths, tmp_path, "none", True)
        assert got[2] != plain[2]
        before = dict(line.split(b"\t")[:2]
                      for line in plain[2].splitlines()[1:])
        after = dict(line.split(b"\t")[:2]
                     for line in got[2].splitlines()[1:])
        assert any(before[k] == b"0" and after[k] != b"0" for k in after)


def test_cli_outputs_match_jax(paths, tmp_path):
    """The make_examples CLI with the methylation flags and channels, two
    shards with their read-phase TSVs: every file byte for byte."""
    flags = ["--model_preset", "PACBIO", "--partition_size", "3000",
             "--channel_list", "BASE_CHANNELS,haplotype,"
             "supplementary_alignment,base_methylation,base_6ma",
             "--enable_methylation_calling",
             "--enable_methylation_aware_phasing", "--output_phase_info"]
    outputs = []
    for cli, tag in ((jcli, "jax"), (tcli, "port")):
        tsv = str(tmp_path / f"{tag}-phase@2.tsv")
        outputs.append(run_cli_outputs(
            cli, paths, str(tmp_path / tag),
            flags + ["--output_local_read_phasing", tsv], shards=2))
    assert outputs[0] == outputs[1]
    for task in range(2):
        # The port writes one TSV per shard (the JAX CLI one file for
        # both, ROADMAP.md Queue 3).
        assert os.path.getsize(
            tmp_path / f"port-phase-0000{task}-of-00002.tsv") > 100
    assert b"MI" in b"".join(outputs[1]["candidates"])


# -- run_deepvariant, to a VCF ------------------------------------------------

CHANNEL_LIST = ("BASE_CHANNELS,haplotype,supplementary_alignment,"
                "base_methylation,base_6ma")


@pytest.fixture(scope="module")
def run_dv(paths, tmp_path_factory):
    """`run_deepvariant --device cpu` staged (2 shards, the read-phase
    TSVs), PACBIO with the methylation channels, calling and phasing;
    then merge_phased_reads and the postprocess CLI with the switches."""
    from deepvariant_tpu_torch.make_examples.presets import (
        apply_pileup_preset,
    )

    directory = tmp_path_factory.mktemp("run_dv_meth")
    channels = 12
    model = iv3.InceptionV3(channels)
    model.load_state_dict(iv3.from_flax_variables(
        random_flax_variables(channels, seed=5)))
    checkpoint = str(directory / "ckpt")
    pileup = apply_pileup_preset(tpileup.PileupOptions(), "PACBIO")
    save_variables(os.path.join(checkpoint, "model.msgpack"), model,
                   {"shape": [100, 147, channels],
                    "channels": list(pileup.channels) + [23, 24]})
    out = str(directory / "staged")

    def argv(name, *more):
        return ["--model_type", "PACBIO", "--ref", paths["ref"],
                "--reads", paths["reads"],
                "--output_vcf", str(directory / f"{name}.vcf.gz"),
                "--checkpoint", checkpoint, "--device", "cpu",
                "--batch_size", "16", "--channel_list", CHANNEL_LIST,
                "--enable_methylation_calling",
                "--enable_methylation_aware_phasing",
                "--intermediate_results_dir", str(directory / name),
                *more]

    assert rd.main(argv("staged", "--num_shards", "2",
                        "--make_examples_extra_args",
                        f"output_local_read_phasing={out}/phase@2.tsv,"
                        "output_phase_info=true")) == 0
    return dict(directory=directory, argv=argv,
                cvos=str(directory / "staged" /
                         "call_variants_output.tfrecord.gz"),
                vcf=str(directory / "staged.vcf.gz"), phases=out)


def vcf_lines(path):
    with gzip.open(path, "rt") as f:
        return [line for line in f if not line.startswith("##")]


def test_run_deepvariant_vcf_is_the_jax_postprocess_s(paths, run_dv,
                                                      tmp_path):
    """The staged VCF equals the JAX postprocess CLI on its CVOs byte for
    byte, and it carries MF, MD, MT and MI."""
    vcf = str(tmp_path / "jax.vcf.gz")
    assert jpp_cli.main(["--ref", paths["ref"], "--infile", run_dv["cvos"],
                         "--outfile", vcf, "--sample_name", "default"]) == 0
    for suffix in ("", ".tbi"):
        with open(run_dv["vcf"] + suffix, "rb") as a, \
                open(vcf + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    body = "".join(vcf_lines(run_dv["vcf"]))
    for key in ("MF", "MD", "MT", "MI"):
        assert f":{key}" in body or f"{key}:" in body, key
    assert len(list(read_cvos(run_dv["cvos"]))) > 10


def test_switches_reach_postprocess_as_in_jax(paths, run_dv, tmp_path):
    """merge_phased_reads on the two shards' TSVs, then each package's
    postprocess CLI with the switches TSV: the same VCF bytes."""
    from deepvariant_tpu_torch.phasing import merge_phased_reads as tmpr
    from deepvariant_tpu_torch.scripts import postprocess_variants as tpp_cli

    switches = str(tmp_path / "switches.tsv")
    assert tmpr.main(["--input_path", f"{run_dv['phases']}/phase@2.tsv",
                      "--output_path", str(tmp_path / "merged.tsv"),
                      "--switches_output_path", switches]) == 0
    assert os.path.getsize(switches) > 0
    written = []
    for cli, tag in ((jpp_cli, "jax"), (tpp_cli, "port")):
        vcf = str(tmp_path / f"{tag}.vcf")
        assert cli.main(["--ref", paths["ref"], "--infile", run_dv["cvos"],
                         "--outfile", vcf, "--sample_name", "default",
                         "--phased_reads_switches_output_path",
                         switches]) == 0
        written.append(open(vcf).read())
    assert written[0] == written[1] and "MI" in written[1]


def test_stream_vcf_carries_the_staged_methylation_fields(run_dv, capsys):
    """`--stream` (auto picks the host encoder for the methylation
    channels): the MF, MD, MT and MI of every record equal the staged
    VCF's (MF/MD/MI ride on the variant's call through the workers)."""
    assert rd.main(run_dv["argv"]("stream", "--stream",
                                  "--num_shards", "2")) == 0
    assert "encoder=host" in capsys.readouterr().out

    def fields(path):
        out = {}
        for line in vcf_lines(path)[1:]:
            cols = line.rstrip("\n").split("\t")
            keys, values = cols[8].split(":"), cols[9].split(":")
            out[(cols[0], cols[1], cols[3], cols[4])] = {
                k: v for k, v in zip(keys, values)
                if k in ("MF", "MD", "MT", "MI")}
        return out

    staged = fields(run_dv["vcf"])
    streamed = fields(str(run_dv["directory"] / "stream.vcf.gz"))
    assert streamed == staged
    assert sum("MI" in f for f in staged.values()) >= 1
    assert sum("MT" in f for f in staged.values()) >= 3


def test_device_encode_stream_carries_mf_md_mi(paths):
    """The device-encode stream (plans through the worker queue, painted
    and classified in the parent, here on the CPU): every CVO's variant
    equals the variant of the in-process runner's plan at its locus,
    MF, MD and MI included."""
    from deepvariant_tpu_torch.parallel import stream_pipeline as sp

    options = preset_options(PORT, paths, "PACBIO", partition_size=3000,
                             enable_methylation_calling=True,
                             enable_methylation_aware_phasing=True)
    plans = []
    tcore.make_examples_runner(options, plan_sink=plans.append)
    model = iv3.InceptionV3(10)
    model.load_state_dict(iv3.from_flax_variables(
        random_flax_variables(10, seed=6)))
    cvos, stats, _ = sp.stream_examples_to_cvos(
        options, 1, model=model, batch_size=16, device_encode=True,
        device="cpu", dtype=torch.float32)
    want = {(p.variant.start, tuple(p.alt_indices)): p.variant.encode()
            for p in plans}
    got = {(c.variant.start, tuple(c.alt_allele_indices)):
           c.variant.encode() for c in cvos}
    assert got == want and len(got) > 10
    infos = [c.variant.calls[0].info for c in cvos]
    assert any("MI" in i for i in infos)
    assert any(any(f > 0 for f in i.get("MF", [])) for i in infos)
