"""gVCF records of the PyTorch port against the JAX package: the
reference-confidence model, `make_gvcfs`, the runner's gVCF TFRecord,
the gVCF merge of `postprocess_variants` and its CLI, and the stream's
gVCF records.

All of it is host code in both packages (Python and numpy), so every
comparison here is exact: the GQ and the float64 bits of every
likelihood, the records' wire bytes, the TFRecord, VCF, gVCF and `.tbi`
bytes. The inputs are the seeded synthetic samples of
`deepvariant_tpu_torch/testing/synthetic.py` written by the JAX
package's writers, CVOs made from the JAX runner's plans with seeded
probabilities, and for the stream random InceptionV3 weights on the CPU
in float32.
"""

import gzip
import os
import random

import numpy as np
import pytest
import torch

from deepvariant_tpu.core import types as jt
from deepvariant_tpu.core.genomics_math import round_gls
from deepvariant_tpu.io import tabix as jtabix
from deepvariant_tpu.io.fasta import FastaReader as JaxFastaReader
from deepvariant_tpu.io.tfrecord import TFRecordReader, TFRecordWriter
from deepvariant_tpu.io.vcf import format_variant_line as jax_line
from deepvariant_tpu.make_examples import core as jcore
from deepvariant_tpu.make_examples import variant_caller as jvc
from deepvariant_tpu.parallel import stream_pipeline as jsp
from deepvariant_tpu.postprocess import pipeline as jpipe
from deepvariant_tpu.scripts import postprocess_variants as jcli
from deepvariant_tpu_torch.core import types as tt
from deepvariant_tpu_torch.io import tabix as ttabix
from deepvariant_tpu_torch.io.fasta import FastaReader as PortFastaReader
from deepvariant_tpu_torch.io.vcf import format_variant_line as port_line
from deepvariant_tpu_torch.make_examples import core as tcore
from deepvariant_tpu_torch.make_examples import variant_caller as tvc
from deepvariant_tpu_torch.models import inception_v3 as iv3
from deepvariant_tpu_torch.parallel import stream_pipeline as sp
from deepvariant_tpu_torch.postprocess import pipeline as tpipe
from deepvariant_tpu_torch.scripts import postprocess_variants as tcli
from deepvariant_tpu_torch.testing import synthetic
from torch_port_util import (
    STAGE1_REGIONS,
    merge_by_contig,
    preset_options,
    random_flax_variables,
    region_counters,
    stage1_sample,
    wgs_options,
    write_stage1_inputs,
)

torch.set_num_threads(2)

JAX, PORT = "deepvariant_tpu", "deepvariant_tpu_torch"
CORE = {JAX: jcore, PORT: tcore}
PIPE = {JAX: jpipe, PORT: tpipe}
TYPES = {JAX: jt, PORT: tt}
FASTA = {JAX: JaxFastaReader, PORT: PortFastaReader}


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return write_stage1_inputs(stage1_sample(),
                               tmp_path_factory.mktemp("gvcf_in"))


@pytest.fixture(scope="module")
def long_paths(tmp_path_factory):
    sample = synthetic.synthetic_longread_sample(
        5, (("chr1", 6000), ("chr2", 3000)), depth=12, mean_read_length=2000)
    return write_stage1_inputs(sample, tmp_path_factory.mktemp("gvcf_long"))


# -- the reference-confidence model ---------------------------------------------

RC_OPTIONS = {
    "defaults": dict(),
    "p_error-max_gq": dict(p_error=0.01, max_gq=99),
}
# Counts past the cache of 100: rescaled, n_ref rounded up.
LARGE_COUNTS = [(0, 101), (1, 101), (1, 1000), (500, 1000), (999, 1000),
                (1000, 1000), (3, 7000), (6999, 7000)]


@pytest.mark.parametrize("haploid", [False, True],
                         ids=["diploid", "haploid"])
@pytest.mark.parametrize("name", list(RC_OPTIONS))
def test_reference_confidence_matches_jax(name, haploid):
    want = jvc.ReferenceConfidence(jvc.VariantCallerOptions(
        **RC_OPTIONS[name]))
    got = tvc.ReferenceConfidence(tvc.VariantCallerOptions(
        **RC_OPTIONS[name]))
    counts = [(n_ref, n_total) for n_total in range(131)
              for n_ref in range(n_total + 1)] + LARGE_COUNTS
    for n_ref, n_total in counts:
        gq, probs = got(n_ref, n_total, haploid)
        want_gq, want_probs = want(n_ref, n_total, haploid)
        assert type(gq) is int and gq == want_gq, (n_ref, n_total)
        assert np.asarray(probs).dtype == np.float64
        assert np.asarray(probs).tobytes() == \
            np.asarray(want_probs).tobytes(), (n_ref, n_total)
    # The cache's vectorised rows are the scalar formula, bit for bit.
    for n_total in range(101):
        for n_ref in range(n_total + 1):
            gq, probs = got._calc(n_ref, n_total, haploid)
            cached_gq, cached = got._cache[haploid][n_total][n_ref]
            assert gq == cached_gq
            assert np.asarray(probs).tobytes() == \
                np.asarray(cached).tobytes()


def test_quantize_and_rescale_match_jax():
    for raw_gq in range(-3, 120):
        for binsize in (1, 2, 3, 5, 10, 50):
            assert tvc._quantize_gq(raw_gq, binsize) == \
                jvc._quantize_gq(raw_gq, binsize)
    for n_total in (0, 1, 99, 100, 101, 257, 1000, 12345):
        for n_ref in sorted({0, 1, n_total // 3, n_total - 1, n_total}):
            for cap in (1, 50, 100):
                assert tvc.rescale_read_counts_if_necessary(
                    n_ref, n_total, cap) == \
                    jvc.rescale_read_counts_if_necessary(n_ref, n_total, cap)


# -- make_gvcfs on the seeded sample's allele counters --------------------------

MAKE_GVCFS = {
    "gq5": (dict(), dict()),
    "gq5-med-dp": (dict(), dict(include_med_dp=True)),
    "gq1": (dict(gq_resolution=1), dict()),
    "gq1-med-dp": (dict(gq_resolution=1), dict(include_med_dp=True)),
    "haploid": (dict(haploid_contigs=("chr2",)), dict()),
    "haploid-par": (dict(haploid_contigs=("chr1", "chr2")),
                    dict(include_med_dp=True)),
    "padded": (dict(gq_resolution=3),
               dict(left_padding=37, right_padding=110)),
    "sample-name": (dict(sample_name="NA12878", p_error=0.01), dict()),
}


@pytest.fixture(scope="module")
def counters(paths):
    return [region_counters(paths, region, track_ref_reads=i % 2 == 0)
            for i, region in enumerate(STAGE1_REGIONS)]


@pytest.mark.parametrize("name", list(MAKE_GVCFS))
def test_make_gvcfs_matches_jax(counters, paths, tmp_path, name):
    options, kwargs = MAKE_GVCFS[name]
    if name == "haploid-par":
        bed = tmp_path / "par.bed"
        bed.write_text("chr1\t900\t2100\n")
        options = dict(options, par_regions_bed=str(bed))
    want_caller = jvc.VerySensitiveCaller(jvc.VariantCallerOptions(**options))
    got_caller = tvc.VerySensitiveCaller(tvc.VariantCallerOptions(**options))
    n = iupac = 0
    for want_counter, got_counter in counters:
        want = [v.encode() for v in want_caller.make_gvcfs(want_counter,
                                                            **kwargs)]
        got = [v.encode() for v in got_caller.make_gvcfs(got_counter,
                                                         **kwargs)]
        assert got == want
        n += len(got)
        iupac += int((got_counter.ref == ord("N")).sum())
    assert n > 50 and iupac > 0


def test_make_gvcfs_iupac_and_invalid_bases_match_jax(paths):
    """IUPAC codes other than N are skipped; a base that is no IUPAC code
    raises in both packages."""
    want_counter, got_counter = region_counters(paths, ("chr1", 1000, 2000))
    for counter in (want_counter, got_counter):
        counter.ref = counter.ref.copy()
        counter.ref[[5, 6, 40, 41, 42, 300, 999]] = np.frombuffer(
            b"RYSKMBV", np.uint8)
    kwargs = dict(include_med_dp=True)
    want = list(jvc.VerySensitiveCaller().make_gvcfs(want_counter, **kwargs))
    got = list(tvc.VerySensitiveCaller().make_gvcfs(got_counter, **kwargs))
    assert [v.encode() for v in got] == [v.encode() for v in want]
    covered = {p for v in got for p in range(v.start, v.end)}
    assert 1005 not in covered and 1041 not in covered and 1004 in covered
    for counter in (want_counter, got_counter):
        counter.ref[7] = ord("X")
    errors = []
    for caller, counter in ((jvc.VerySensitiveCaller(), want_counter),
                            (tvc.VerySensitiveCaller(), got_counter)):
        with pytest.raises(ValueError) as info:
            list(caller.make_gvcfs(counter))
        errors.append(str(info.value))
    assert errors[0] == errors[1] and "chr1:1007" in errors[1]


# -- the runner's gVCF TFRecord --------------------------------------------------

RUNNER_CASES = {
    "wgs": dict(),
    "wgs-med-dp-gq1": dict(include_med_dp=True),
    "wgs-two-shards": dict(num_shards=2, task_id=1),
    "pacbio": dict(),
}


def runner_options(package, paths, long_paths, name, gvcf):
    if name == "pacbio":
        options = preset_options(package, long_paths, "PACBIO",
                                 gvcf_filename=gvcf, partition_size=1500)
        assert options.phase_reads and \
            options.phase_reads_region_padding_pct > 0
        return options
    options = wgs_options(package, paths, gvcf_filename=gvcf,
                          **RUNNER_CASES[name])
    if name == "wgs-med-dp-gq1":
        options.variant_caller_options.gq_resolution = 1
    return options


@pytest.mark.parametrize("name", list(RUNNER_CASES))
def test_runner_gvcf_tfrecord_matches_jax(paths, long_paths, tmp_path, name):
    out = {}
    for package in (JAX, PORT):
        # Uncompressed: a gzip header holds the file's name and time.
        gvcf = str(tmp_path / f"{package}.gvcf.tfrecord")
        plans = []
        counts = CORE[package].make_examples_runner(
            runner_options(package, paths, long_paths, name, gvcf),
            plan_sink=plans.append)
        with open(gvcf, "rb") as f:
            out[package] = (counts, f.read(), len(plans),
                            list(TFRecordReader(gvcf)))
    assert out[PORT][:3] == out[JAX][:3]
    counts, _, n_plans, records = out[PORT]
    assert counts["gvcfs"] == len(records) > 100 and n_plans > 5
    # The blocks tile the processed regions without overlap, the N run
    # excepted: a gap there.
    variants = [tt.Variant.decode(r) for r in records]
    by_contig = {}
    for v in variants:
        by_contig.setdefault(v.reference_name, []).append(v)
    for blocks in by_contig.values():
        for a, b in zip(blocks, blocks[1:]):
            assert a.end <= b.start


def test_runner_gvcf_sink_matches_the_tfrecord(paths, tmp_path):
    """The fused stream's sink gets the records the TFRecord holds, in
    the same order, without a gVCF file."""
    gvcf = str(tmp_path / "g.tfrecord")
    tcore.make_examples_runner(wgs_options(PORT, paths, gvcf_filename=gvcf),
                               plan_sink=lambda plan: None)
    seen = []
    counts = tcore.make_examples_runner(wgs_options(PORT, paths),
                                        plan_sink=lambda plan: None,
                                        gvcf_sink=seen.append)
    assert [v.encode() for v in seen] == list(TFRecordReader(gvcf))
    assert counts["gvcfs"] == len(seen) > 100


# -- stage 3: the gVCF merge -------------------------------------------------------

def seeded_cvos(plans, seed):
    """JAX CVOs of the runner's plans with seeded probabilities (peaked
    Dirichlet draws, so that every genotype class occurs), rounded as
    call_variants rounds them."""
    rng = np.random.RandomState(seed)
    return [jt.CallVariantsOutput(
        variant=p.variant, alt_allele_indices=list(p.alt_indices),
        genotype_probabilities=round_gls(
            [float(x) for x in rng.dirichlet([0.4] * 3)]))
        for p in plans]


@pytest.fixture(scope="module")
def stage3(paths, long_paths, tmp_path_factory):
    """CVO files and gVCF TFRecords of the JAX runner: the WGS sample,
    and the long-read sample with the PACBIO defaults and phase info."""
    tmp = tmp_path_factory.mktemp("gvcf_pp")
    files = {"tmp": str(tmp)}
    for name, options in (
            ("short", wgs_options(JAX, paths, include_med_dp=True)),
            ("long", preset_options(JAX, long_paths, "PACBIO",
                                    output_phase_info=True,
                                    partition_size=1500))):
        options.gvcf_filename = str(tmp / f"{name}.gvcf.tfrecord@2.gz")
        plans = []
        for task in (0, 1):
            options.task_id, options.num_shards = task, 2
            jcore.make_examples_runner(options, plan_sink=plans.append)
        files[name] = str(tmp / f"{name}.cvo.tfrecord.gz")
        with TFRecordWriter(files[name]) as writer:
            for cvo in seeded_cvos(plans, 3 if name == "short" else 4):
                writer.write(cvo.encode())
        files[name + "_gvcf"] = options.gvcf_filename
    files["short_ref"], files["long_ref"] = paths["ref"], long_paths["ref"]
    return files


def spans(text):
    """(contig, start, end, is reference block) of gVCF record lines; a
    record's end is its END where it has one."""
    out = []
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        f = line.split("\t")
        start = int(f[1]) - 1
        end = start + len(f[3])
        for item in f[7].split(";"):
            if item.startswith("END="):
                end = int(item[4:])
        out.append((f[0], start, end, f[4] == "<*>"))
    return out


def assert_tiles(text, ref, regions=None):
    """The gVCF's records cover every A, C, G or T base of each contig
    (of `regions`, (contig, start, end), where given) once, in order,
    contig after contig; only variant records overlap."""
    fasta = PortFastaReader(ref)
    records = spans(text)
    names = [c.name for c in fasta.contigs]
    assert [r[0] for r in records] == sorted(
        (r[0] for r in records), key=names.index)
    for contig in fasta.contigs:
        own = [r for r in records if r[0] == contig.name]
        assert [r[1] for r in own] == sorted(r[1] for r in own)
        bases = fasta.bases(tt.Range(contig.name, 0, contig.n_bases))
        covered = np.zeros(contig.n_bases, np.int32)
        blocks = np.zeros(contig.n_bases, np.int32)
        for _, start, end, block in own:
            covered[start:end] += 1
            blocks[start:end] += block
        dna = np.isin(bases, np.frombuffer(b"ACGT", np.uint8))
        if regions is not None:
            inside = np.zeros(contig.n_bases, bool)
            for name, start, end in regions:
                if name == contig.name:
                    inside[start:end] = True
            dna &= inside
        np.testing.assert_array_equal(covered > 0, dna)
        assert not (blocks[covered > 1] > 0).any()


def ref_lookup(package, ref):
    reader = FASTA[package](ref)
    if package == PORT:
        return tpipe.fasta_ref_lookup(reader)

    def lookup(contig, pos):
        return reader.query(TYPES[package].Range(contig, pos, pos + 1))

    return lookup


PP_CASES = {
    "defaults": dict(),
    "only-pass": dict(only_keep_pass=True),
    "qual-filter": dict(qual_filter=10.0, cnn_homref_call_min_gq=25.0),
    "haploid-par": dict(haploid_contigs={"chr2"}),
    "ungrouped-min": dict(multiallelic_mode="min"),
}


# Plain text at every option set; BGZF (and the gVCF's .tbi) at two.
PP_RUNS = [(name, source, ".vcf") for name in PP_CASES
           for source in ("short", "long")] + [
    (name, source, ".vcf.gz") for name in ("defaults", "only-pass")
    for source in ("short", "long")]


@pytest.mark.parametrize("name,source,suffix", PP_RUNS)
def test_postprocess_gvcf_matches_jax(stage3, monkeypatch, name, source,
                                      suffix):
    merge_by_contig(monkeypatch)
    out = {}
    for package in (JAX, PORT):
        stem = os.path.join(stage3["tmp"], f"{name}-{source}-{package}")
        ref = stage3[f"{source}_ref"]
        stats = PIPE[package].postprocess_variants(
            stage3[source], stem + suffix,
            FASTA[package](ref).contigs,
            nonvariant_site_path=stage3[f"{source}_gvcf"],
            output_gvcf=stem + ".g" + suffix,
            ref_lookup=ref_lookup(package, ref), **PP_CASES[name])
        with open(stem + suffix, "rb") as a, \
                open(stem + ".g" + suffix, "rb") as b:
            out[package] = (stats, a.read(), b.read())
    assert out[PORT] == out[JAX]
    stats, vcf, gvcf = out[PORT]
    assert stats["gvcf_records"] > stats["vcf_records"] > 5
    text = gzip.decompress(gvcf) if suffix == ".vcf.gz" else gvcf
    assert b"<*>" in text and b"MIN_DP" in text
    vcf_text = gzip.decompress(vcf) if suffix == ".vcf.gz" else vcf
    assert b"<*>" not in vcf_text
    assert_tiles(text.decode(), stage3[f"{source}_ref"])
    if suffix == ".vcf.gz":
        for package, tabix in ((JAX, jtabix), (PORT, ttabix)):
            stem = os.path.join(stage3["tmp"], f"{name}-{source}-{package}")
            tabix.build_index(stem + ".g" + suffix)
        with open(stem.replace(PORT, JAX) + ".g.vcf.gz.tbi", "rb") as a, \
                open(stem + ".g.vcf.gz.tbi", "rb") as b:
            assert a.read() == b.read()


def test_in_memory_nonvariants_sort_as_the_file_does(stage3):
    """`nonvariant_site_path` as a list of Variants in any order (what the
    stream hands over) gives the file's bytes: `_read_nonvariants` sorts
    both by (contig index, start, end)."""
    contigs = PortFastaReader(stage3["short_ref"]).contigs
    from deepvariant_tpu_torch.core.sharded_files import glob_sharded_inputs
    from deepvariant_tpu_torch.io.tfrecord import (
        TFRecordReader as PortReader,
    )

    records = [tt.Variant.decode(buf)
               for p in glob_sharded_inputs(stage3["short_gvcf"])
               for buf in PortReader(p)]
    random.Random(5).shuffle(records)
    want = [v.encode() for v in jpipe._read_nonvariants(
        stage3["short_gvcf"],
        JaxFastaReader(stage3["short_ref"]).contigs)]
    assert [v.encode() for v in tpipe._read_nonvariants(
        stage3["short_gvcf"], contigs)] == want
    assert [v.encode() for v in tpipe._read_nonvariants(
        records, contigs)] == want
    outs = []
    for source in (stage3["short_gvcf"], records):
        stem = os.path.join(stage3["tmp"], f"memory-{len(outs)}")
        tpipe.postprocess_variants(
            stage3["short"], stem + ".vcf", contigs,
            nonvariant_site_path=source, output_gvcf=stem + ".g.vcf",
            ref_lookup=ref_lookup(PORT, stage3["short_ref"]))
        with open(stem + ".g.vcf", "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1]


def test_merge_writes_each_event_before_the_next(stage3, monkeypatch):
    """The merge yields a variant for the VCF and then mutates the same
    object for the gVCF (zero-scaled GLs, `<*>`, GL -99): each event must
    be formatted before the generator resumes. Formatted at once, the
    port's events equal the JAX package's; formatted after the merge has
    run to its end, the VCF events would carry the gVCF's alleles."""
    def events(package, line):
        pipe = PIPE[package]
        contigs = FASTA[package](stage3["short_ref"]).contigs
        variants = list(pipe.cvos_to_variants(
            pipe.read_cvos_sorted([stage3["short"]], contigs), "s"))
        nonvariants = pipe._read_nonvariants(stage3["short_gvcf"], contigs)
        merged = pipe.merge_variants_and_nonvariants(
            variants, nonvariants,
            *([contigs] if package == PORT else []),
            ref_lookup=ref_lookup(package, stage3["short_ref"]))
        return [(kind, line(v)) for kind, v in merged]

    merge_by_contig(monkeypatch)
    want = events(JAX, jax_line)
    got = events(PORT, port_line)
    assert got == want
    vcf_lines = [line for kind, line in got if kind == "vcf"]
    assert len(vcf_lines) > 5
    assert not any("<*>" in line for line in vcf_lines)
    late = list(tpipe.merge_variants_and_nonvariants(
        [tt.Variant(reference_name="chr1", start=10, end=11,
                    reference_bases="A", alternate_bases=["C"],
                    calls=[tt.VariantCall(genotype=[0, 1],
                                          genotype_likelihood=[-1.0, -0.5,
                                                               -2.0])])],
        [], PortFastaReader(stage3["short_ref"]).contigs))
    assert [kind for kind, _ in late] == ["vcf", "gvcf"]
    assert late[0][1] is late[1][1]
    assert late[0][1].alternate_bases == ["C", "<*>"]


def test_postprocess_cli_gvcf_matches_jax(stage3, tmp_path, monkeypatch):
    merge_by_contig(monkeypatch)
    outs = {}
    for package, cli in ((JAX, jcli), (PORT, tcli)):
        stem = str(tmp_path / package)
        assert cli.main([
            "--ref", stage3["long_ref"], "--infile", stage3["long"],
            "--outfile", stem + ".vcf.gz",
            "--nonvariant_site_tfrecord_path", stage3["long_gvcf"],
            "--gvcf_outfile", stem + ".g.vcf.gz"]) == 0
        outs[package] = [open(stem + suffix, "rb").read() for suffix in (
            ".vcf.gz", ".vcf.gz.tbi", ".g.vcf.gz", ".g.vcf.gz.tbi")]
    assert outs[PORT] == outs[JAX]
    # The .tbi of the gVCF answers a region query with the blocks that
    # overlap it, END included.
    path = str(tmp_path / f"{PORT}.g.vcf.gz")
    lines = [line for line in gzip.decompress(outs[PORT][2]).decode()
             .splitlines() if not line.startswith("#")]

    def span(line):
        f = line.split("\t")
        start = int(f[1]) - 1
        end = start + len(f[3])
        for item in f[7].split(";"):
            if item.startswith("END="):
                end = int(item[4:])
        return f[0], start, end

    lo, hi = 2500, 2600
    want = [line for line in lines
            if span(line)[0] == "chr1" and span(line)[1] < hi
            and span(line)[2] > lo]
    assert list(ttabix.TabixReader(path).query("chr1", lo, hi)) == want
    assert want
    for package, cli in ((JAX, jcli), (PORT, tcli)):
        with pytest.raises(SystemExit, match="without --cpus"):
            cli.main(["--ref", stage3["long_ref"], "--infile", stage3["long"],
                      "--outfile", str(tmp_path / "x.vcf"), "--cpus", "2",
                      "--nonvariant_site_tfrecord_path", stage3["long_gvcf"],
                      "--gvcf_outfile", str(tmp_path / "x.g.vcf")])


# -- the stream ---------------------------------------------------------------------

def test_stream_gvcf_matches_staged_and_jax(paths, tmp_path, monkeypatch):
    """`run_streaming_pipeline(output_gvcf=...)` with two spawned workers:
    its gVCF records are the runner's, its gVCF equals the staged route's
    (the runner's gVCF TFRecord and the stream's CVOs through the
    postprocess CLI) and the JAX package's stage 3 on the JAX runner's
    gVCF TFRecord and the same CVOs, byte for byte."""
    # chr1:428 holds a block that a variant truncates.
    regions = ["chr1:300-2,500", "chr2:200-1,100"]
    model = iv3.InceptionV3(7)
    model.load_state_dict(iv3.from_flax_variables(
        random_flax_variables(7, seed=4)))
    seen = []
    plain = sp.stream_examples_to_cvos

    def recording(*args, **kwargs):
        result = plain(*args, **kwargs)
        seen.append(([tt.CallVariantsOutput.decode(c.encode())
                      for c in result[0]], list(result[2])))
        return result

    truncated = []
    plain_template = tpipe._record_from_template

    def counting_template(template, start, end, lookup):
        if start != template.start:
            truncated.append((template.reference_name, start))
        return plain_template(template, start, end, lookup)

    sp.stream_examples_to_cvos = recording
    tpipe._record_from_template = counting_template
    try:
        got = sp.run_streaming_pipeline(
            wgs_options(PORT, paths, regions=regions),
            str(tmp_path / "stream.vcf.gz"), paths["ref"], model=model,
            num_workers=2, batch_size=8, device_encode=True,
            output_gvcf=str(tmp_path / "stream.g.vcf.gz"), device="cpu",
            dtype=torch.float32)
    finally:
        sp.stream_examples_to_cvos = plain
        tpipe._record_from_template = plain_template
    (cvos, records), = seen
    assert truncated
    assert got["stream_gvcf_records"] == len(records) > 100
    assert got["postprocess"]["gvcf_records"] > len(cvos) > 8

    # Stage 1: the workers' records are the runners' (JAX and port).
    jax_gvcf = str(tmp_path / "jax.gvcf.tfrecord")
    port_gvcf = str(tmp_path / "port.gvcf.tfrecord")
    for package, gvcf in ((JAX, jax_gvcf), (PORT, port_gvcf)):
        CORE[package].make_examples_runner(
            wgs_options(package, paths, regions=regions, gvcf_filename=gvcf),
            plan_sink=lambda plan: None)
    assert sorted(v.encode() for v in records) == \
        sorted(TFRecordReader(jax_gvcf)) == sorted(TFRecordReader(port_gvcf))

    # Stage 3: the staged route of each package on the same CVOs.
    merge_by_contig(monkeypatch)
    cvo_path = str(tmp_path / "cvo.tfrecord.gz")
    with TFRecordWriter(cvo_path) as writer:
        for cvo in cvos:
            writer.write(cvo.encode())
    for package, cli, gvcf in ((JAX, jcli, jax_gvcf),
                               (PORT, tcli, port_gvcf)):
        assert cli.main([
            "--ref", paths["ref"], "--infile", cvo_path,
            "--outfile", str(tmp_path / f"{package}.vcf.gz"),
            "--sample_name", "default",
            "--nonvariant_site_tfrecord_path", gvcf,
            "--gvcf_outfile", str(tmp_path / f"{package}.g.vcf.gz")]) == 0
    for suffix in (".vcf.gz", ".g.vcf.gz"):
        stream = gzip.decompress((tmp_path / f"stream{suffix}").read_bytes())
        for package in (JAX, PORT):
            assert gzip.decompress(
                (tmp_path / f"{package}{suffix}").read_bytes()) == stream
    assert_tiles(stream.decode(), paths["ref"],
                 [("chr1", 299, 2500), ("chr2", 199, 1100)])


def test_jax_stream_lookup_raises_on_a_truncated_block(stage3, tmp_path):
    """The JAX package's stream route hands `FastaReader.bases` (which
    takes a Range) to the merge as its lookup of one base, so it raises
    at the first block a variant truncates (ROADMAP.md Queue 3); the
    port's stream passes the CLI's lookup of one base instead. This
    sample has such blocks."""
    ref = JaxFastaReader(stage3["short_ref"])
    with pytest.raises(TypeError):
        jpipe.postprocess_variants(
            stage3["short"], str(tmp_path / "j.vcf"), ref.contigs,
            nonvariant_site_path=stage3["short_gvcf"],
            output_gvcf=str(tmp_path / "j.g.vcf"), ref_lookup=ref.bases)
    import inspect

    assert "ref_lookup=ref_reader.bases" in inspect.getsource(
        jsp.run_streaming_pipeline)


def test_jax_merge_interleaves_contigs(stage3, tmp_path):
    """Pinned: on two contigs the JAX package's merge writes chr2's
    variant records before chr1's last blocks and chr2's blocks whole
    under them (ROADMAP.md Queue 3); the port's gVCF tiles."""
    texts = {}
    for package in (JAX, PORT):
        stem = str(tmp_path / package)
        PIPE[package].postprocess_variants(
            stage3["short"], stem + ".vcf",
            FASTA[package](stage3["short_ref"]).contigs,
            nonvariant_site_path=stage3["short_gvcf"],
            output_gvcf=stem + ".g.vcf",
            ref_lookup=ref_lookup(package, stage3["short_ref"]))
        texts[package] = open(stem + ".g.vcf").read()
    contigs = [r[0] for r in spans(texts[JAX])]
    first_chr2 = contigs.index("chr2")
    assert "chr1" in contigs[first_chr2:]
    with pytest.raises(AssertionError):
        assert_tiles(texts[JAX], stage3["short_ref"])
    assert_tiles(texts[PORT], stage3["short_ref"])
    # Both hold the same records, the JAX package's with chr2's blocks
    # unsplit where chr2's variants sit.
    assert sorted(r for r in spans(texts[PORT]) if not r[3]) == \
        sorted(r for r in spans(texts[JAX]) if not r[3])


def test_stream_gvcf_constants_match_jax():
    assert sp._GVCF_KIND == jsp._GVCF_KIND
    assert sp._GVCF_FLUSH_EVERY == jsp._GVCF_FLUSH_EVERY
    assert tpipe.GVCF_ALT_ALLELE == jpipe.GVCF_ALT_ALLELE
    assert tpipe._GVCF_ALT_ALLELE_GL == jpipe._GVCF_ALT_ALLELE_GL
