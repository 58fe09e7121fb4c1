"""The PyTorch port's VCF and tabix code against the JAX package.

Both are host code in both packages, so everything is exact: header and
record lines and whole files (plain and BGZF) byte-identical, `.tbi` and
`.csi` index bytes identical, `VcfReader` round trips and region
queries equal, and `TabixReader` queries equal. Inputs: the candidate
variants the JAX runner calls on the seeded short-read and long-read
samples (AD, DP, VAF; the long-read ones with phase info), and hand
cases: multi-allelic records, missing and haploid genotypes, phased
calls with PS, methylation fields with MI, somatic fields, gVCF-style
END records, and float formatting edges.
"""

import math
import os

import numpy as np
import pytest
import torch

from deepvariant_tpu.core import types as jt
from deepvariant_tpu.io import tabix as jtabix
from deepvariant_tpu.io import vcf as jvcf
from deepvariant_tpu.io.tfrecord import TFRecordReader
from deepvariant_tpu.make_examples import core as jcore
from deepvariant_tpu_torch.core import types as tt
from deepvariant_tpu_torch.io import tabix as ttabix
from deepvariant_tpu_torch.io import vcf as tvcf
from deepvariant_tpu_torch.testing import synthetic
from torch_port_util import (
    preset_options,
    stage1_sample,
    wgs_options,
    write_stage1_inputs,
)

torch.set_num_threads(2)

JAX, PORT = "deepvariant_tpu", "deepvariant_tpu_torch"
TYPES = {JAX: jt, PORT: tt}
VCF = {JAX: jvcf, PORT: tvcf}
TABIX = {JAX: jtabix, PORT: ttabix}


def both(variants):
    """(JAX Variants, port Variants) of the same records: the port's are
    decoded from the JAX ones' wire bytes."""
    return variants, [tt.Variant.decode(v.encode()) for v in variants]


@pytest.fixture(scope="module")
def candidate_variants(tmp_path_factory):
    """The JAX runner's candidates on the short-read sample (WGS,
    realigner off) and on the long-read sample (PACBIO with its defaults
    and phase info), as JAX Variants in file order."""
    tmp = tmp_path_factory.mktemp("cands")
    out = []
    short = write_stage1_inputs(stage1_sample(), tmp / "short")
    sample = synthetic.synthetic_longread_sample(
        5, (("chr1", 6000), ("chr2", 3000)), depth=12, mean_read_length=2000)
    long_paths = write_stage1_inputs(sample, tmp / "long")
    for tag, options in (
            ("short", wgs_options(JAX, short)),
            ("long", preset_options(JAX, long_paths, "PACBIO",
                                    output_phase_info=True,
                                    partition_size=3000))):
        options.candidates_filename = str(tmp / f"{tag}.tfrecord")
        jcore.make_examples_runner(options, plan_sink=lambda plan: None)
        with TFRecordReader(options.candidates_filename) as reader:
            out.extend(jt.Variant.decode(buf) for buf in reader)
    assert len(out) > 100
    return out


def call(types, **fields):
    return types.VariantCall(**fields)


def hand_variants(types):
    """Hand-built records of one package, covering every FORMAT key and
    the formatting edges."""
    V = types.Variant
    return [
        # Multi-allelic with GL, PL truncation and a VAF per alt.
        V(reference_name="chr1", start=99, end=100, reference_bases="A",
          alternate_bases=["C", "AT", "G"], quality=37.04999,
          filter=["PASS"],
          calls=[call(types, call_set_name="s", genotype=[1, 2],
                      genotype_likelihood=[-5.1, -0.11, -3.3, -2.0,
                                           -0.0001, -9.9, -4.0, -1.5,
                                           -7.25, -12.0],
                      info={"GQ": [23], "DP": [40], "AD": [10, 14, 9, 7],
                            "VAF": [0.35, 0.225, 0.175]})]),
        # Missing genotype, NoCall, no quality.
        V(reference_name="chr1", start=200, end=203, reference_bases="ACG",
          alternate_bases=["A"], quality=0.0, filter=["NoCall"],
          calls=[call(types, genotype=[-1, -1],
                      genotype_likelihood=[0.0, 0.0],
                      info={"GQ": [0], "DP": [0], "AD": [0, 0],
                            "VAF": [0.0]})]),
        # Haploid call, one allele.
        V(reference_name="chrX", start=5000, end=5001, reference_bases="T",
          alternate_bases=["G"], quality=12.5, filter=["LowQual"],
          calls=[call(types, genotype=[1],
                      genotype_likelihood=[-2.5, -0.05, -1.0],
                      info={"GQ": [9], "DP": [3], "AD": [1, 2],
                            "VAF": [2 / 3]})]),
        # Phased het with PS, methylation fields and MI.
        V(reference_name="chr2", start=10, end=11, reference_bases="C",
          alternate_bases=["T"], quality=99.99, filter=["PASS"],
          names=["rs1", "rs2"],
          info={"CANDIDATES": ["T|TA"]},
          calls=[call(types, genotype=[0, 1], is_phased=True,
                      genotype_likelihood=[-9.0, 0.0, -6.0],
                      info={"GQ": [60], "DP": [30], "AD": [15, 15],
                            "VAF": [0.5], "PS": [11], "MF": [0.1, 0.9],
                            "MD": [2, 13], "MT": ["0/1"],
                            "MI": [1.2345678e-07]})]),
        # Somatic fields and MIN_DP / MED_DP.
        V(reference_name="chr2", start=40, end=41, reference_bases="G",
          alternate_bases=["A", "C"], quality=3.0,
          filter=["GERMLINE", "PON"],
          calls=[call(types, genotype=[0, 0],
                      info={"GQ": [3], "DP": [8], "MIN_DP": [5],
                            "MED_DP": [7], "AD": [6, 1, 1],
                            "VAF": [0.125, 0.125], "NDP": [12],
                            "NAD": [11, 1, 0], "NAF": [0.0833333, 0.0]})]),
        # gVCF-style reference blocks: <*> with END, and an END in INFO.
        V(reference_name="chr2", start=100, end=150, reference_bases="A",
          alternate_bases=["<*>"], quality=0.0,
          calls=[call(types, genotype=[0, 0],
                      genotype_likelihood=[0.0, -2.0, -4.0],
                      info={"GQ": [20], "MIN_DP": [9]})]),
        V(reference_name="chr2", start=150, end=17000, reference_bases="C",
          alternate_bases=["<*>"], info={"END": [17000]},
          calls=[call(types, genotype=[0, 0], info={"GQ": [1]})]),
        # No calls, no ALT, flag INFO.
        V(reference_name="chr2", start=20000, end=20001,
          reference_bases="T", info={"DB": [True], "AF": [0.5, 1e-5]}),
    ]


HEADERS = {
    "plain": dict(sample_names=["s1"]),
    "no-sample": dict(sample_names=[]),
    "two-samples": dict(sample_names=["tumor", "normal"]),
    "somatic": dict(sample_names=["t"], include_somatic_fields=True,
                    extra_filter_lines=[("GERMLINE", "Non somatic variants"),
                                        ("PON", "Filtered by PON")]),
}

CONTIGS = [("chr1", 248956422), ("chr2", 242193529), ("chrX", 156040895)]


def header(package, name):
    types = TYPES[package]
    contigs = [types.ContigInfo(name=n, n_bases=b, pos_in_fasta=i)
               for i, (n, b) in enumerate(CONTIGS)]
    kwargs = dict(HEADERS[name])
    names = kwargs.pop("sample_names")
    return VCF[package].deepvariant_header(contigs, names, **kwargs)


@pytest.mark.parametrize("name", list(HEADERS))
def test_header_lines_match_jax(name):
    assert header(PORT, name).lines() == header(JAX, name).lines()
    for const in ("DEEP_VARIANT_VERSION", "PASS_FILTER", "REF_FILTER",
                  "QUAL_FILTER", "NO_CALL_FILTER", "GERMLINE_FILTER",
                  "PON_FILTER", "UNCALLED_GENOTYPE", "SOMATIC_FORMAT_LINES",
                  "_FORMAT_ORDER", "_FORMAT_LINES", "_FILTER_LINES",
                  "_INFO_LINES"):
        assert getattr(tvcf, const) == getattr(jvcf, const)


@pytest.mark.parametrize("index", range(8))
def test_hand_record_lines_match_jax(index):
    want = jvcf.format_variant_line(hand_variants(jt)[index])
    got = tvcf.format_variant_line(hand_variants(tt)[index])
    assert got == want


def test_candidate_record_lines_match_jax(candidate_variants):
    want, got = both(candidate_variants)
    assert [tvcf.format_variant_line(v) for v in got] == \
        [jvcf.format_variant_line(v) for v in want]
    assert any("PS_CONTIG" in line for line in
               (jvcf.format_variant_line(v) for v in want))


FLOATS = [0.0, -0.0, 1.0, 0.5, 1e-4, 9.99999e-5, 1e-5, 1.5e-7, 0.1, 1 / 3,
          2 / 3, 1.23456789, 123456.7891234, 1e14, 1e15, 1e16, 12.0000004,
          -2.5, -1e-6, float("nan"), 0.0833333, 99.9999996, 7.0000005]


@pytest.mark.parametrize("value", FLOATS)
def test_float_and_qual_formatting_match_jax(value):
    assert tvcf.format_float(value) == jvcf.format_float(value)
    if not math.isnan(value):
        assert tvcf._format_qual(value) == jvcf._format_qual(value)
        assert tvcf._format_qual(value * 7.7) == \
            jvcf._format_qual(value * 7.7)
    assert tvcf.format_float(None) == jvcf.format_float(None) == "."


def write_vcf(package, path, variants, name="plain"):
    with VCF[package].VcfWriter(path, header(package, name)) as writer:
        for v in variants:
            writer.write(v)
    with open(path, "rb") as f:
        return f.read()


def sorted_records(variants):
    order = {n: i for i, (n, _) in enumerate(CONTIGS)}
    return sorted(variants, key=lambda v: (order[v.reference_name], v.start))


@pytest.mark.parametrize("suffix", [".vcf", ".vcf.gz"])
@pytest.mark.parametrize("name", ["plain", "somatic"])
def test_vcf_files_match_jax(candidate_variants, tmp_path, suffix, name):
    want_vars, got_vars = both(sorted_records(
        candidate_variants + hand_variants(jt)))
    want = write_vcf(JAX, str(tmp_path / f"j{suffix}"), want_vars, name)
    got = write_vcf(PORT, str(tmp_path / f"t{suffix}"), got_vars, name)
    assert got == want
    if suffix == ".vcf.gz":
        assert got[:4] == b"\x1f\x8b\x08\x04"   # BGZF


def spread_variants(types, seed):
    """Records over three contigs at positions that cross 16 kb linear
    windows and the bins of every level (up to 2**29 for the CSI
    cases), with long deletions and END blocks spanning windows."""
    rng = np.random.RandomState(seed)
    out = []
    for name, limit in (("chr1", 3_000_000), ("chr2", 40_000),
                        ("chrX", 140_000_000)):
        pos = 0
        for _ in range(int(rng.randint(30, 80))):
            pos += int(rng.choice([1, 5, 300, 16_000, 70_000, 600_000]))
            if pos >= limit:
                break
            ref_len = int(rng.choice([1, 1, 1, 3, 40, 20_000]))
            v = types.Variant(
                reference_name=name, start=pos, end=pos + ref_len,
                reference_bases="A" * ref_len, alternate_bases=["C"],
                quality=float(rng.randint(0, 500)) / 10,
                filter=["PASS"],
                calls=[types.VariantCall(
                    genotype=[0, 1], info={"GQ": [int(rng.randint(99))],
                                           "DP": [10], "AD": [5, 5]})])
            if rng.rand() < 0.1:
                v.alternate_bases = ["<*>"]
                v.end = pos + int(rng.randint(1, 40_000))
                v.info = {"END": [v.end]}
            out.append(v)
    return out


@pytest.mark.parametrize("use_csi", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_index_bytes_match_jax(tmp_path, seed, use_csi):
    paths = {}
    for package in (JAX, PORT):
        path = str(tmp_path / f"{package}.vcf.gz")
        write_vcf(package, path, spread_variants(TYPES[package], seed))
        paths[package] = TABIX[package].build_index(path, use_csi=use_csi)
    suffix = ".csi" if use_csi else ".tbi"
    assert paths[PORT].endswith(suffix)
    with open(paths[JAX], "rb") as f:
        want = f.read()
    with open(paths[PORT], "rb") as f:
        assert f.read() == want


def test_candidate_index_bytes_and_queries_match_jax(candidate_variants,
                                                     tmp_path):
    want_vars, got_vars = both(sorted_records(
        candidate_variants + hand_variants(jt)))
    jpath, tpath = str(tmp_path / "j.vcf.gz"), str(tmp_path / "t.vcf.gz")
    write_vcf(JAX, jpath, want_vars)
    write_vcf(PORT, tpath, got_vars)
    for use_csi in (False, True):
        ji = jtabix.build_index(jpath, use_csi=use_csi)
        ti = ttabix.build_index(tpath, use_csi=use_csi)
        with open(ji, "rb") as a, open(ti, "rb") as b:
            assert a.read() == b.read()
    queries = [("chr1", 0, 10), ("chr1", 1000, 2000), ("chr1", 95, 105),
               ("chr2", 0, 3000), ("chr2", 120, 160), ("chr2", 16_000, 16_500),
               ("chrX", 4000, 6000), ("chr3", 0, 100), ("chr2", 20_000, 20_001)]
    reader = ttabix.TabixReader(tpath)
    jreader = jtabix.TabixReader(jpath, ji)   # the .csi written last
    assert reader.names == jreader.names
    hits = 0
    for q in queries:
        got = list(reader.query(*q))
        assert got == list(jreader.query(*q)) == \
            list(jtabix.TabixReader(jpath).query(*q))
        hits += len(got)
    assert hits > 20


@pytest.mark.parametrize("suffix", [".vcf", ".vcf.gz"])
def test_reader_round_trip_and_queries_match_jax(candidate_variants,
                                                 tmp_path, suffix):
    want_vars, got_vars = both(sorted_records(
        candidate_variants + hand_variants(jt)))
    jpath, tpath = str(tmp_path / f"j{suffix}"), str(tmp_path / f"t{suffix}")
    write_vcf(JAX, jpath, want_vars, "two-samples")
    write_vcf(PORT, tpath, got_vars, "two-samples")
    jr, tr = jvcf.VcfReader(jpath), tvcf.VcfReader(tpath)
    assert tr.header_lines == jr.header_lines
    assert tr.sample_names == jr.sample_names == ["tumor", "normal"]
    assert [(c.name, c.n_bases, c.pos_in_fasta) for c in tr.contigs] == \
        [(c.name, c.n_bases, c.pos_in_fasta) for c in jr.contigs]
    got, want = list(tr), list(jr)
    assert len(got) == len(want) == len(want_vars)
    assert [v.encode() for v in got] == [v.encode() for v in want]
    # Written again, the parsed records give the same lines.
    assert [tvcf.format_variant_line(v) for v in got] == \
        [jvcf.format_variant_line(v) for v in want]
    for q in [("chr1", 0, 500), ("chr1", 99, 100), ("chr2", 0, 200),
              ("chr2", 140, 151), ("chrX", 0, 10_000), ("chr9", 0, 9)]:
        got_q = [v.encode() for v in tr.query(tt.Range(*q))]
        assert got_q == [v.encode() for v in jr.query(jt.Range(*q))]
    tr.close()


def test_unsorted_reader_queries_match_jax(tmp_path):
    """A contig whose records are out of order takes the linear scan."""
    lines = ["##fileformat=VCFv4.2", "##contig=<ID=c1,length=1000>",
             "##contig=<ID=c2>",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tx",
             "c1\t500\t.\tA\tC\t5\tPASS\t.\tGT:PS\t0|1:PATMAT",
             "c1\t100\t.\tAC\tA\t.\t.\tEND=140\tGT:GL\t./.:-1,-0.5,.",
             "c2\t7\tid\tG\t.\t1e-3\tq10;s50\tAF=0.5,1e-05;DB\tGT:AD\t1/1:0,3"]
    path = str(tmp_path / "u.vcf")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    jr, tr = jvcf.VcfReader(path), tvcf.VcfReader(path)
    assert [v.encode() for v in tr] == [v.encode() for v in jr]
    assert [(c.name, c.n_bases) for c in tr.contigs] == \
        [(c.name, c.n_bases) for c in jr.contigs]
    for q in [("c1", 0, 1000), ("c1", 120, 130), ("c2", 6, 7), ("c2", 0, 6)]:
        assert [v.encode() for v in tr.query(tt.Range(*q))] == \
            [v.encode() for v in jr.query(jt.Range(*q))]
    assert os.path.getsize(path) > 0
