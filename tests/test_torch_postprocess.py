"""Stage 3 of the PyTorch port (postprocess/, scripts/postprocess_variants)
against the JAX package.

Stage 3 is host code in both packages (Python and numpy, the
multiallelic MLP included), so everything here is exact: both packages
postprocess the same CVO file and the VCFs, plain and BGZF, and their
`.tbi` are byte-identical for every option set. The CVO files: one from
the JAX package's `call_variants` on examples its runner painted from
the seeded sample (random InceptionV3 weights), and, so that every
genotype class, multi-allelic group and phase set occurs, the JAX
runner's plans of the seeded short-read and long-read samples (the
latter with the PACBIO preset's defaults and phase info) given seeded
probabilities, written with the JAX package's TFRecord writer; plus
hand-built multi-allelic and overlapping CVO groups. The module
functions (genotype, haplotypes, merge, the multiallelic model) are
held on the same groups one by one.
"""

import copy
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepvariant_tpu.calling import call_variants as jcall
from deepvariant_tpu.core import ranges as jranges
from deepvariant_tpu.core import types as jt
from deepvariant_tpu.core.genomics_math import round_gls
from deepvariant_tpu.io import tabix as jtabix
from deepvariant_tpu.io import vcf as jvcf
from deepvariant_tpu.io.tfrecord import TFRecordWriter
from deepvariant_tpu.make_examples import core as jcore
from deepvariant_tpu.models import inception_v3 as jax_iv3
from deepvariant_tpu.postprocess import genotype as jgt
from deepvariant_tpu.postprocess import haplotypes as jhap
from deepvariant_tpu.postprocess import merge as jmerge
from deepvariant_tpu.postprocess import multiallelic_model as jmm
from deepvariant_tpu.postprocess import pipeline as jpipe
from deepvariant_tpu.scripts import postprocess_variants as jcli
from deepvariant_tpu_torch.core import ranges as tranges
from deepvariant_tpu_torch.core import types as tt
from deepvariant_tpu_torch.postprocess import genotype as tgt
from deepvariant_tpu_torch.postprocess import haplotypes as thap
from deepvariant_tpu_torch.postprocess import merge as tmerge
from deepvariant_tpu_torch.postprocess import multiallelic_model as tmm
from deepvariant_tpu_torch.postprocess import pipeline as tpipe
from deepvariant_tpu_torch.scripts import postprocess_variants as tcli
from deepvariant_tpu_torch.testing import synthetic
from torch_port_util import (
    preset_options,
    random_flax_variables,
    stage1_sample,
    wgs_options,
    write_stage1_inputs,
)

torch.set_num_threads(2)

JAX, PORT = "deepvariant_tpu", "deepvariant_tpu_torch"
PIPE = {JAX: jpipe, PORT: tpipe}
RANGES = {JAX: jranges, PORT: tranges}
TYPES = {JAX: jt, PORT: tt}


def seeded_cvos(plans, seed):
    """JAX CVOs of the runner's plans with seeded probabilities: peaked
    Dirichlet draws, so that every genotype class occurs, leaning to het
    where the candidate's alleles got both phases (so phase sets occur),
    rounded as call_variants rounds them."""
    rng = np.random.RandomState(seed)
    out = []
    for p in plans:
        phased = {1, 2} <= set(p.variant.info.get("ALT_PS", []))
        probs = rng.dirichlet([0.3, 2.0, 0.3] if phased else [0.4] * 3)
        out.append(jt.CallVariantsOutput(
            variant=p.variant, alt_allele_indices=list(p.alt_indices),
            genotype_probabilities=round_gls([float(x) for x in probs])))
    return out


def write_cvos(path, cvos):
    with TFRecordWriter(path) as writer:
        for cvo in cvos:
            writer.write(cvo.encode())
    return path


def hand_cvos():
    """Multi-allelic and overlapping CVO groups (JAX objects): a three-
    alt site (six CVOs), two-alt sites (three CVOs each, for the MLP and
    the allele pruning), overlapping deletions whose genotypes conflict,
    a site whose alts all fall under the qual filter, and a lone SNP."""
    rng = np.random.RandomState(11)

    def cvo(start, ref, alts, indices, probs=None, ad=None):
        if probs is None:
            probs = rng.dirichlet([0.5, 0.5, 0.5])
        ad = ad or [int(x) for x in rng.randint(0, 12, len(alts) + 1)]
        return jt.CallVariantsOutput(
            variant=jt.Variant(
                reference_name="chr1", start=start, end=start + len(ref),
                reference_bases=ref, alternate_bases=list(alts),
                calls=[jt.VariantCall(
                    call_set_name="hand", genotype=[-1, -1],
                    info={"AD": ad, "DP": [sum(ad)],
                          "VAF": [a / max(1, sum(ad)) for a in ad[1:]]})]),
            alt_allele_indices=list(indices),
            genotype_probabilities=round_gls([float(x) for x in probs]))

    out = []
    alts3 = ["C", "AT", "G"]
    ad3 = [3, 9, 7, 1]
    for idx in ([0], [1], [2], [0, 1], [0, 2], [1, 2]):
        out.append(cvo(100, "A", alts3, idx, ad=ad3))
    for start in (300, 400, 500, 600):
        ad2 = [int(x) for x in rng.randint(0, 15, 3)]
        for idx in ([0], [1], [0, 1]):
            out.append(cvo(start, "GT", ["G", "GTT"], idx, ad=ad2))
    # Every alt under the qual filter: the best one is kept.
    for idx, probs in (([0], [0.9, 0.05, 0.05]), ([1], [0.8, 0.1, 0.1]),
                       ([0, 1], [0.7, 0.2, 0.1])):
        out.append(cvo(700, "T", ["A", "C"], idx, probs=probs,
                       ad=[10, 1, 1]))
    # Overlapping deletions, each called hom-alt: incompatible.
    out.append(cvo(800, "ACGTA", ["A"], [0], probs=[0.01, 0.09, 0.9],
                   ad=[2, 9]))
    out.append(cvo(801, "CG", ["C"], [0], probs=[0.05, 0.15, 0.8],
                   ad=[3, 7]))
    out.append(cvo(802, "G", ["T"], [0], probs=[0.02, 0.48, 0.5],
                   ad=[5, 5]))
    out.append(cvo(900, "C", ["T"], [0], probs=[0.2, 0.7, 0.1]))
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    short = write_stage1_inputs(stage1_sample(), tmp / "short")
    sample = synthetic.synthetic_longread_sample(
        5, (("chr1", 6000), ("chr2", 3000)), depth=12, mean_read_length=2000)
    long_paths = write_stage1_inputs(sample, tmp / "long")
    files = {"ref": short["ref"], "long_ref": long_paths["ref"]}

    plans = []
    jcore.make_examples_runner(wgs_options(JAX, short),
                               plan_sink=plans.append)
    files["short"] = write_cvos(str(tmp / "short.tfrecord"),
                                seeded_cvos(plans, 1))
    plans = []
    jcore.make_examples_runner(
        preset_options(JAX, long_paths, "PACBIO", output_phase_info=True,
                       partition_size=1500),
        plan_sink=plans.append)
    files["long"] = write_cvos(str(tmp / "long.tfrecord.gz"),
                               seeded_cvos(plans, 2))
    files["hand"] = write_cvos(str(tmp / "hand.tfrecord"), hand_cvos())
    # Only one-alt sites: what group_variants=False can take.
    files["biallelic"] = write_cvos(
        str(tmp / "biallelic.tfrecord"),
        [c for c in seeded_cvos(plans, 3)
         if len(c.variant.alternate_bases) == 1])

    # The JAX package's call_variants on examples its runner painted.
    examples = str(tmp / "examples.tfrecord.gz")
    jcore.make_examples_runner(wgs_options(
        JAX, short, examples_filename=examples,
        regions=["chr1:1,000-2,200", "chr2:100-900"]))
    files["cnn"] = str(tmp / "cnn.tfrecord.gz")
    stats = jcall.call_variants(
        examples, files["cnn"], random_flax_variables(7, seed=4),
        batch_size=8, model=jax_iv3.InceptionV3(dtype=jnp.float32))
    assert stats["num_examples"] > 20
    files["tmp"] = str(tmp)
    return files


def contigs(package, ref):
    fasta = __import__(f"{package}.io.fasta", fromlist=["FastaReader"])
    return fasta.FastaReader(ref).contigs


def option_set(name, package, data):
    """Keyword arguments of postprocess_variants for one option set."""
    ranges = RANGES[package]
    types = TYPES[package]
    sets = {
        "defaults": {},
        "qual-filter": dict(qual_filter=20.0, multi_allelic_qual_filter=15.0,
                            cnn_homref_call_min_gq=30.0),
        "min-mode": dict(multiallelic_mode="min"),
        "multiallelic-model": dict(use_multiallelic_model=True),
        "haploid-par": dict(haploid_contigs={"chr2", "chr1"},
                            par_regions=ranges.RangeSet(
                                [types.Range("chr1", 1000, 2500)])),
        "only-pass": dict(only_keep_pass=True),
        "ungrouped": dict(group_variants=False),
        "regions": dict(regions=ranges.RangeSet.from_regions(
            ["chr1:1-2,000", "chr2:500-2,600"])),
        "somatic": dict(process_somatic=True),
        "somatic-pon": dict(process_somatic=True,
                            pon_vcf_path=data["pon"]),
        "debug-alt": dict(debug_output_all_candidates="ALT",
                          multi_allelic_qual_filter=20.0),
        "debug-info": dict(debug_output_all_candidates="INFO",
                           multi_allelic_qual_filter=20.0),
        "debug-info-model": dict(debug_output_all_candidates="INFO",
                                 use_multiallelic_model=True),
        "switches": dict(phased_reads_switches_path=data["switches"]),
        "sample-name": dict(sample_name="NA12878"),
    }
    return sets[name]


@pytest.fixture(scope="module")
def aux_files(data):
    """A Panel of Normals VCF (every other hom-alt PASS record of the
    JAX package's VCF of the short CVOs) and a phase-switches TSV for
    the long CVOs' regions (SWITCH, NOT_ENOUGH_OVERLAP, MATCH)."""
    tmp = data["tmp"]
    vcf = os.path.join(tmp, "for_pon.vcf")
    jpipe.postprocess_variants(data["short"], vcf,
                               contigs(JAX, data["ref"]))
    records = [v for v in jvcf.VcfReader(vcf)
               if v.filter == ["PASS"] and v.calls[0].genotype == [1, 1]]
    assert len(records) > 4
    pon = os.path.join(tmp, "pon.vcf.gz")
    with jvcf.VcfWriter(pon, jvcf.deepvariant_header(
            contigs(JAX, data["ref"]), ["normal"])) as w:
        for v in records[::2]:
            w.write(v)
    switches = os.path.join(tmp, "switches.tsv")
    with open(switches, "w") as f:
        for region, status in ((2, 1), (3, 2), (4, 1), (5, 0), (7, 1),
                               (8, 2)):
            f.write(f"0\t{region}\t{status}\n")
        f.write("\n")
    data["pon"] = pon
    data["switches"] = switches
    return data


CVO_SETS = {
    "short": ("short", "ref"),
    "long": ("long", "long_ref"),
    "hand": ("hand", "ref"),
    "cnn": ("cnn", "ref"),
    "biallelic": ("biallelic", "long_ref"),
}
OPTION_SETS = ["defaults", "qual-filter", "min-mode", "multiallelic-model",
               "haploid-par", "only-pass", "regions", "somatic",
               "somatic-pon", "debug-alt", "debug-info", "debug-info-model",
               "switches", "sample-name"]
# group_variants=False takes one CVO per site, so only one-alt sites
# (both packages' sanity check refuses a lone two-alt CVO).
CASES = [(c, o) for c in CVO_SETS if c != "biallelic" for o in OPTION_SETS] \
    + [("biallelic", o) for o in ("defaults", "ungrouped", "switches")]


def run_both(data, cvos, ref, suffix, options, tag):
    """Both packages' postprocess_variants on the same CVO file; returns
    (JAX bytes, port bytes, JAX stats, port stats, port path)."""
    out = {}
    for package in (JAX, PORT):
        path = os.path.join(data["tmp"], f"{tag}-{package}{suffix}")
        stats = PIPE[package].postprocess_variants(
            data[cvos], path, contigs(package, data[ref]),
            **option_set(options, package, data))
        with open(path, "rb") as f:
            out[package] = (f.read(), stats, path)
    return out[JAX][0], out[PORT][0], out[JAX][1], out[PORT][1], \
        out[PORT][2]


@pytest.mark.parametrize("cvos,options", CASES)
def test_vcf_bytes_match_jax(aux_files, cvos, options):
    data = aux_files
    source, ref = CVO_SETS[cvos]
    want, got, want_stats, got_stats, _ = run_both(
        data, source, ref, ".vcf", options, f"{cvos}-{options}")
    assert got == want
    assert got_stats == want_stats
    assert got.count(b"\n#CHROM") == 1


@pytest.mark.parametrize("cvos", list(CVO_SETS))
def test_bgzf_vcf_and_index_bytes_match_jax(aux_files, cvos):
    data = aux_files
    source, ref = CVO_SETS[cvos]
    want, got, _, stats, path = run_both(data, source, ref, ".vcf.gz",
                                         "defaults", f"gz-{cvos}")
    assert got == want and got[:4] == b"\x1f\x8b\x08\x04"
    assert stats["vcf_records"] > 5
    from deepvariant_tpu_torch.io import tabix as ttabix

    jpath = path.replace(PORT, JAX)
    for use_csi in (False, True):
        ti = ttabix.build_index(path, use_csi=use_csi)
        ji = jtabix.build_index(jpath, use_csi=use_csi)
        with open(ti, "rb") as a, open(ji, "rb") as b:
            assert a.read() == b.read()


def test_special_outputs_occur(aux_files):
    """The option sets reach what they are for: PS fields from phase
    sets (switched by the TSV), PON and GERMLINE filters, CANDIDATES
    info, the MLP's genotypes, haploid calls."""
    data = aux_files

    def text(cvos, ref, options):
        return run_both(data, cvos, ref, ".vcf", options,
                        f"occur-{cvos}-{options}")[1].decode()

    plain = text("long", "long_ref", "defaults")
    switched = text("long", "long_ref", "switches")
    assert ":PS\t" in plain and plain != switched
    assert "\tPON\t" in text("short", "ref", "somatic-pon")
    assert "\tGERMLINE\t" in text("short", "ref", "somatic")
    assert "CANDIDATES=" in text("hand", "ref", "debug-info")
    assert text("hand", "ref", "multiallelic-model") != \
        text("hand", "ref", "defaults")
    assert text("hand", "ref", "min-mode") != text("hand", "ref", "defaults")
    assert text("short", "ref", "haploid-par") != \
        text("short", "ref", "defaults")


def test_in_memory_cvos_equal_the_file(aux_files):
    """postprocess_variants on CVO objects (the stream's route) writes
    the bytes it writes from their file; JAX's in-memory route too."""
    data = aux_files
    from deepvariant_tpu_torch.calling.call_variants import read_cvos

    for source, ref in (("long", "long_ref"), ("short", "ref")):
        cvos = list(read_cvos(data[source]))
        np.random.RandomState(3).shuffle(cvos)
        a = os.path.join(data["tmp"], f"mem-{source}.vcf.gz")
        b = os.path.join(data["tmp"], f"file-{source}.vcf.gz")
        tpipe.postprocess_variants(cvos, a, contigs(PORT, data[ref]))
        tpipe.postprocess_variants(data[source], b, contigs(PORT, data[ref]))
        jmem = os.path.join(data["tmp"], f"jmem-{source}.vcf.gz")
        jpipe.postprocess_variants(list(jcall.read_cvos(data[source])), jmem,
                                   contigs(JAX, data[ref]))
        with open(a, "rb") as fa, open(b, "rb") as fb, open(jmem, "rb") as fj:
            assert fa.read() == fb.read() == fj.read()


def test_several_cvo_files_and_sharded_specs(aux_files, tmp_path):
    """A sharded spec and a list of files give the one file's VCF."""
    data = aux_files
    cvos = list(jcall.read_cvos(data["short"]))
    shards = [str(tmp_path / f"s-{k:05d}-of-00003.tfrecord")
              for k in range(3)]
    for k, path in enumerate(shards):
        write_cvos(path, cvos[k::3])
    outs = []
    for package, source in ((JAX, data["short"]),
                            (PORT, str(tmp_path / "s@3.tfrecord")),
                            (PORT, shards), (JAX, shards)):
        path = str(tmp_path / f"{len(outs)}.vcf")
        PIPE[package].postprocess_variants(source, path,
                                           contigs(package, data["ref"]))
        with open(path, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1] == outs[2] == outs[3]
    assert len(cvos) > 50


@pytest.mark.parametrize("cvos", ["short", "long"])
def test_parallel_postprocess_matches_jax(aux_files, cvos, tmp_path):
    """postprocess_variants_parallel with two processes (spawned in the
    port, forked in the JAX package) writes the JAX bytes. Without phase
    sets they are the single-process VCF's; with them a partition
    boundary starts a new phase set, in both packages."""
    data = aux_files
    source, ref = CVO_SETS[cvos]
    out = {}
    for package in (JAX, PORT):
        path = str(tmp_path / f"{package}.vcf")
        stats = PIPE[package].postprocess_variants_parallel(
            data[source], path, contigs(package, data[ref]),
            num_partitions=3, processes=2, qual_filter=2.0)
        with open(path, "rb") as f:
            out[package] = (f.read(), stats)
    assert out[PORT] == out[JAX]
    single = str(tmp_path / "single.vcf")
    tpipe.postprocess_variants(data[source], single,
                               contigs(PORT, data[ref]), qual_filter=2.0)
    with open(single, "rb") as f:
        assert (f.read() == out[PORT][0]) == (cvos == "short")
    assert not [n for n in os.listdir(tmp_path) if n.startswith("dv_post")]


CLI_ARGS = {
    "plain": [],
    "filters": ["--qual_filter", "15", "--multiallelic_mode", "min",
                "--only_keep_pass", "--sample_name", "HG002"],
    "haploid": ["--haploid_contigs", "chr1, chr2", "--use_csi"],
    "model-regions": ["--use_multiallelic_model", "--regions",
                      "chr1:1-4,000 chr2:1-3,000"],
    "debug-info": ["--debug_output_all_candidates", "INFO"],
    "ungrouped": ["--no-group_variants"],
    "somatic": ["--process_somatic"],
}


@pytest.mark.parametrize("suffix", [".vcf", ".vcf.gz"])
@pytest.mark.parametrize("name", list(CLI_ARGS))
def test_cli_matches_jax(aux_files, tmp_path, capsys, name, suffix):
    data = aux_files
    outs = {}
    for package, cli in ((JAX, jcli), (PORT, tcli)):
        path = str(tmp_path / f"{package}{suffix}")
        inputs = ["--infile", data["short"], "--small_model_cvo_records",
                  data["hand"]]
        if name == "ungrouped":
            inputs = ["--infile", data["biallelic"]]
        argv = ["--ref", data["ref"]] + inputs + ["--outfile", path] + \
            CLI_ARGS[name]
        assert cli.main(argv) == 0
        files = [path] + [path + s for s in (".tbi", ".csi")
                          if os.path.exists(path + s)]
        outs[package] = [open(p, "rb").read() for p in files]
        outs[package].append([os.path.basename(p)[len(package):]
                              for p in files])
    assert outs[PORT] == outs[JAX]
    assert len(outs[PORT]) == (3 if suffix == ".vcf.gz" else 2)
    printed = capsys.readouterr().out.splitlines()
    assert printed[-1] == printed[-2] and "VCF records" in printed[-1]


def test_cli_parallel_and_sample_name_match_jax(aux_files, tmp_path, capsys):
    data = aux_files
    outs = []
    for cli in (jcli, tcli):
        path = str(tmp_path / f"{len(outs)}.vcf")
        assert cli.main(["--ref", data["long_ref"], "--infile",
                         data["long"], "--outfile", path, "--cpus", "2",
                         "--num_partitions", "3"]) == 0
        outs.append(open(path, "rb").read())
    assert outs[0] == outs[1]
    # The sample column is the CVOs' call_set_name, the BAM's @RG SM.
    name = tcli._sample_name_from_cvos(data["long"])
    assert name == jcli._sample_name_from_cvos(data["long"])
    assert f"\tFORMAT\t{name}\n".encode() in outs[1]
    assert tcli._sample_name_from_cvos(data["cnn"]) == \
        jcli._sample_name_from_cvos(data["cnn"])
    assert tcli._sample_name_from_cvos(str(tmp_path / "none")) is None


def test_unported_options_raise(aux_files, tmp_path):
    data = aux_files
    # --vcf_stats_report is ported: the stats JSON and HTML beside the
    # VCF, the JAX CLI's bytes. The page's title names the VCF, so the
    # two packages write to the same path in turn.
    reports = {}
    directory = tmp_path / "stats"
    for package, cli in ((JAX, jcli), (PORT, tcli)):
        directory.mkdir()
        assert cli.main(["--ref", data["ref"], "--infile", data["short"],
                         "--outfile", str(directory / "x.vcf.gz"),
                         "--vcf_stats_report"]) == 0
        reports[package] = {name: (directory / name).read_bytes()
                            for name in sorted(os.listdir(directory))}
        shutil.rmtree(directory)
    assert reports[PORT] == reports[JAX]
    assert sorted(reports[PORT]) == [
        "x.stats.json", "x.vcf.gz", "x.vcf.gz.tbi", "x.visual_report.html"]
    # The gVCF merge is ported (tests/test_torch_gvcf.py): as in the JAX
    # package, one of its two inputs without the other writes the VCF
    # alone, the same bytes.
    for extra in (["--gvcf_outfile", str(tmp_path / "g.vcf")],
                  ["--nonvariant_site_tfrecord_path", str(tmp_path / "n")]):
        outs = []
        for package, cli in ((JAX, jcli), (PORT, tcli)):
            path = str(tmp_path / f"{package}.vcf")
            assert cli.main(["--ref", data["ref"], "--infile", data["short"],
                             "--outfile", path] + extra) == 0
            outs.append(open(path, "rb").read())
        assert outs[0] == outs[1] and not os.path.exists(tmp_path / "g.vcf")
    for kwargs in (dict(nonvariant_site_path=str(tmp_path / "n")),
                   dict(output_gvcf=str(tmp_path / "g.vcf"))):
        outs = []
        for package in (JAX, PORT):
            path = str(tmp_path / f"{package}-y.vcf")
            stats = PIPE[package].postprocess_variants(
                data["short"], path, contigs(package, data["ref"]), **kwargs)
            outs.append((stats, open(path, "rb").read()))
        assert outs[0] == outs[1] and outs[1][0]["gvcf_records"] == 0
    assert list(tpipe.merge_variants_and_nonvariants([], [], [])) == []
    assert list(tpipe._read_nonvariants([], [])) == []
    for package in (JAX, PORT):
        with pytest.raises(ValueError, match="multiallelic model"):
            PIPE[package].postprocess_variants(
                data["short"], str(tmp_path / "z.vcf"),
                contigs(package, data["ref"]), use_multiallelic_model=True,
                debug_output_all_candidates="ALT")
        with pytest.raises(ValueError, match="somatic"):
            PIPE[package].postprocess_variants(
                data["short"], str(tmp_path / "z.vcf"),
                contigs(package, data["ref"]), pon_vcf_path=data["pon"])
    assert callable(tpipe.transform_to_gvcf)


# -- the modules one by one ----------------------------------------------------

def groups(data, source):
    """The CVO groups of a file, sorted and grouped as the pipeline does,
    in both packages' objects."""
    jc = jpipe.read_cvos_sorted([data[source]], contigs(JAX, data["ref"]))
    tc = [tt.CallVariantsOutput.decode(c.encode()) for c in jc]
    return ([jpipe._sort_group(g) for g in jpipe.group_cvos(jc)],
            [tpipe._sort_group(g) for g in tpipe.group_cvos(tc)])


@pytest.mark.parametrize("source", ["hand", "short"])
def test_merge_and_genotype_match_jax_group_by_group(aux_files, source):
    jgroups, tgroups = groups(aux_files, source)
    assert len(jgroups) == len(tgroups) > 5
    model = {JAX: jmm.load_multiallelic_model(),
             PORT: tmm.load_multiallelic_model()}
    for jg, tg in zip(jgroups, tgroups):
        assert [c.encode() for c in tg] == [c.encode() for c in jg]
        assert tmerge.is_valid_call_variants_outputs(tg) == \
            jmerge.is_valid_call_variants_outputs(jg)
        for qual in (None, 1.0, 20.0):
            assert tmerge.get_alt_alleles_to_remove(tg, qual) == \
                jmerge.get_alt_alleles_to_remove(jg, qual)
        for kwargs in (dict(), dict(multiallelic_mode="min"),
                       dict(qual_filter=20.0,
                            debug_output_all_candidates="ALT"),
                       dict(haploid_contigs={"chr1"}),
                       dict(multiallelic_model=True)):
            jk, tk = dict(kwargs), dict(kwargs)
            if "multiallelic_model" in kwargs:
                jk["multiallelic_model"] = model[JAX]
                tk["multiallelic_model"] = model[PORT]
            jv, jp = jmerge.merge_predictions(copy.deepcopy(jg), **jk)
            tv, tp = tmerge.merge_predictions(copy.deepcopy(tg), **tk)
            assert tv.encode() == jv.encode() and tp == jp
            for min_gq in (0.0, 20.0):
                a = jgt.add_call_to_variant(copy.deepcopy(jv), list(jp), 5.0,
                                            "s", min_gq)
                b = tgt.add_call_to_variant(copy.deepcopy(tv), list(tp), 5.0,
                                            "s", min_gq)
                assert b.encode() == a.encode()
                assert tgt.genotype_type(b) == jgt.genotype_type(a)


def test_genotype_helpers_match_jax():
    rng = np.random.RandomState(5)
    for _ in range(300):
        n_alts = int(rng.randint(1, 4))
        k = (n_alts + 1) * (n_alts + 2) // 2
        probs = [float(x) for x in rng.dirichlet([0.3] * k)]
        assert tgt.most_likely_genotype(probs, n_alleles=n_alts + 1) == \
            jgt.most_likely_genotype(probs, n_alleles=n_alts + 1)
        idx = int(rng.randint(k))
        assert tgt.compute_quals(probs, idx) == jgt.compute_quals(probs, idx)
        if rng.rand() < 0.3:
            probs[int(rng.randint(k))] = tgt._FILTERED_ALT_PROB
        assert tgt.normalize_predictions(probs) == \
            jgt.normalize_predictions(probs)
        alleles = ["".join(rng.choice(list("ACGT"), rng.randint(1, 5)))
                   for _ in range(n_alts + 1)]
        assert tgt.simplify_alleles(*alleles) == jgt.simplify_alleles(*alleles)
        mf = [float(x) for x in rng.rand(int(rng.randint(0, 4)))]
        assert tgt.determine_methylation_type(mf) == \
            jgt.determine_methylation_type(mf)
    assert list(tgt.genotype_order(4)) == list(jgt.genotype_order(4))
    assert tgt.PHASED_GENOTYPE == jgt.PHASED_GENOTYPE
    assert tgt.VARIANT_PHASE_SET == jgt.VARIANT_PHASE_SET
    assert tgt._ALT_ALLELE_INDEXED_FORMAT_FIELDS == \
        jgt._ALT_ALLELE_INDEXED_FORMAT_FIELDS
    assert tmerge.expected_alt_allele_indices(3) == \
        jmerge.expected_alt_allele_indices(3)


def test_haplotype_resolution_matches_jax(aux_files):
    """maybe_resolve_conflicting_variants on the called variants of the
    hand groups (its overlapping deletions conflict) and the short
    sample, at two qual filters."""
    data = aux_files
    for source in ("hand", "short"):
        ref = contigs(JAX, data["ref"])
        jc = jpipe.read_cvos_sorted([data[source]], ref)
        tc = [tt.CallVariantsOutput.decode(c.encode()) for c in jc]
        jv = list(jpipe.cvos_to_variants(jc, "s"))
        tv = list(tpipe.cvos_to_variants(tc, "s"))
        assert [v.encode() for v in tv] == [v.encode() for v in jv]
        for qual in (1.0, 10.0):
            want = list(jhap.maybe_resolve_conflicting_variants(
                copy.deepcopy(jv), qual_filter=qual))
            got = list(thap.maybe_resolve_conflicting_variants(
                copy.deepcopy(tv), qual_filter=qual))
            assert [v.encode() for v in got] == [v.encode() for v in want]
        assert [len(g) for g in thap.group_overlapping_variants(tv)] == \
            [len(g) for g in jhap.group_overlapping_variants(jv)]
        if source == "hand":
            # The overlapping deletions' calls conflict: resolution runs.
            hand = [v for v in tv if 800 <= v.start < 900]
            counts = [sum(g > 0 for g in v.calls[0].genotype) for v in hand]
            assert not thap.VariantCompatibilityCalculator(hand) \
                .all_variants_compatible(counts)


def test_multiallelic_model_is_the_jax_model():
    """The port reads its own copy of the weights; the numpy forward on
    the same inputs gives the same bits."""
    assert tmm._WEIGHTS_PATH != jmm._WEIGHTS_PATH
    assert tmm._WEIGHTS_PATH.startswith(os.path.dirname(tmm.__file__))
    with open(tmm._WEIGHTS_PATH, "rb") as a, open(jmm._WEIGHTS_PATH,
                                                  "rb") as b:
        assert a.read() == b.read()
    x = np.random.RandomState(0).dirichlet([0.5] * 3, (64, 3)).reshape(64, 9)
    got = tmm.load_multiallelic_model()(x)
    want = jmm.load_multiallelic_model()(x)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.shape == (64, 6)
    assert np.allclose(got.sum(-1), 1, atol=1e-6)


def test_phase_switches_and_stitching_match_jax(aux_files):
    data = aux_files
    assert tpipe.load_phase_switches(data["switches"]) == \
        jpipe.load_phase_switches(data["switches"])
    bad = os.path.join(data["tmp"], "bad_switches.tsv")
    with open(bad, "w") as f:
        f.write("0\t1\n")
    for module in (jpipe, tpipe):
        with pytest.raises(ValueError, match="switches file"):
            module.load_phase_switches(bad)
    for name in ("PS_STITCH_MATCH", "PS_STITCH_SWITCH",
                 "PS_STITCH_NOT_ENOUGH_OVERLAP", "_FIRST_VARIANT_IN_BLOCK"):
        assert getattr(tpipe, name) == getattr(jpipe, name)
