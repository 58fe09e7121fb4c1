"""The read simulators of the PyTorch port (training/simulate.py,
simulate_family.py, simulate_longread.py) against the JAX package's.

Both packages fit their error models to the same seeded templates
(`torch_sim_util.write_templates`) and draw every corpus from one
`np.random.default_rng(seed)`, so each corpus is held byte for byte:
the BAMs, their .bai, the truth VCFs and the BED, and the values the
drivers return (counts, variants, VAFs). Then the simulators' own
contract is checked on the port: with errors off every read's CIGAR
reconstructs the reference away from variants, trio children are
Mendelian with their de novo alleles absent from the parents, and
tumour reads track the drawn VAFs (the JAX simulator tests' bodies, run
on the port's corpora of the seeded templates, whose contig is named
as theirs is).
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_simulate
import test_simulate_family
from deepvariant_tpu_torch.core.types import Range
from deepvariant_tpu_torch.io.bam import BamReader
from deepvariant_tpu_torch.io.fasta import FastaReader
from deepvariant_tpu_torch.training import simulate as tsim
from deepvariant_tpu_torch.training import simulate_family as tfam
from torch_multisample_util import port_twin, run_twin_case, twin_cases
from torch_sim_util import (
    CONTIG,
    JAX,
    PORT,
    config,
    file_bytes,
    module,
    plain,
    simulate,
    write_templates,
)

torch.set_num_threads(2)

_OP_M, _OP_I, _OP_D, _OP_S = 1, 2, 3, 5

# (kind, config fields): several seeds and windows, the error process
# and the allele-sampling bias off, the long-read fit with an explicit
# template FASTA, and the trio's de novo and recombination paths and
# the somatic VAF draws at raised rates.
CORPORA = {
    "short-seed1": ("short", dict(seed=1, windows=[(5000, 15000)])),
    "short-seed2-two-windows": ("short", dict(
        seed=2, windows=[(1000, 5000), (20000, 26000)])),
    "short-seed3-clean": ("short", dict(
        seed=3, windows=[(8000, 14000)], error_rate_scale=0.0,
        allele_sampling_bias=False)),
    "short-seed4-dense": ("short", dict(
        seed=4, windows=[(2000, 8000)], coverage=12.0, snv_rate=1 / 100,
        indel_rate=1 / 400, indel_repeat_fraction=0.2)),
    "trio-seed2": ("trio", dict(seed=2, windows=[(5000, 13000)])),
    "trio-seed5-denovo-recombination": ("trio", dict(
        seed=5, windows=[(3000, 11000)], de_novo_snv_rate=1 / 1500,
        de_novo_indel_rate=1 / 3000, recombination_rate=2e-4,
        coverage_child=20.0, coverage_parent=15.0)),
    "somatic-seed2": ("somatic", dict(seed=2, windows=[(5000, 13000)])),
    "somatic-seed6-low-vaf": ("somatic", dict(
        seed=6, windows=[(3000, 11000)], somatic_snv_rate=1 / 400,
        somatic_indel_rate=1 / 1500, vaf_min=0.03, vaf_max=0.3)),
    "long-seed3": ("long", dict(seed=3, windows=[(2000, 12000)])),
    "long-seed7-clean": ("long", dict(
        seed=7, windows=[(1000, 9000)], error_rate_scale=0.0)),
    "long-seed8-template-ref": ("long", dict(
        seed=8, windows=[(4000, 14000)], coverage=10.0,
        depth_jitter=(1.0, 1.0))),
}


@pytest.fixture(scope="module")
def templates(tmp_path_factory):
    return write_templates(tmp_path_factory.mktemp("templates"))


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_corpus_equals_jax(name, templates, tmp_path, monkeypatch):
    kind, fields = CORPORA[name]
    if name.endswith("template-ref"):
        fields = dict(fields, template_ref_path=templates["long_ref"])
    crossings = {}
    if kind == "trio":
        for package in (JAX, PORT):
            mod = module(package, "training.simulate_family")
            plain_transmit = mod._transmit

            def transmit(*args, _plain=plain_transmit, _package=package):
                out = _plain(*args)
                crossings[_package] = crossings.get(_package, 0) + int(
                    len(set(out.tolist())) > 1)
                return out

            monkeypatch.setattr(mod, "_transmit", transmit)
    results, files = {}, {}
    for package in (JAX, PORT):
        outdir = tmp_path / package
        results[package] = plain(
            simulate(package, kind, templates, outdir, **fields),
            str(outdir))
        files[package] = file_bytes(outdir)
    assert files[PORT] == files[JAX]
    assert results[PORT] == results[JAX]
    assert any(name.endswith(".bai") for name in files[PORT])
    out = results[PORT]
    if kind == "trio":
        assert crossings[PORT] == crossings[JAX]
        if "denovo" in name:
            assert out["n_denovo"] > 0 and crossings[PORT] > 0
    if kind == "somatic":
        cfg = config(PORT, kind, templates, **fields)
        vafs = list(out["vaf_by_pos"].values())
        assert vafs and cfg.vaf_min <= min(vafs) <= max(vafs) <= cfg.vaf_max
    assert out.get("n_variants", out.get("n_child_variants",
                                         out.get("n_germline"))) > 0


def test_quality_model_fit_equals_jax(templates):
    fits = [module(p, "training.simulate").QualityModel.from_bam(
        templates["reads"], module(p, "core.types").Range(
            CONTIG, 0, 40_000)) for p in (JAX, PORT)]
    jax_fit, port_fit = (vars(f) for f in fits)
    assert sorted(port_fit) == sorted(jax_fit)
    for key, want in jax_fit.items():
        np.testing.assert_array_equal(port_fit[key], want, err_msg=key)
    assert port_fit["r1"].shape[1] == port_fit["read_length"] > 0


@pytest.mark.parametrize("with_ref", [False, True])
def test_longread_model_fit_equals_jax(templates, with_ref):
    fits = []
    for package in (JAX, PORT):
        mod = module(package, "training.simulate_longread")
        fits.append(vars(mod.LongReadModel.from_bam(
            templates["long_reads"], module(package, "core.types").Range(
                CONTIG, 0, 16_000),
            ref_path=templates["long_ref"] if with_ref else "")))
    jax_fit, port_fit = fits
    assert sorted(port_fit) == sorted(jax_fit)
    for key, want in jax_fit.items():
        if isinstance(want, list):
            assert len(port_fit[key]) == len(want), key
            for a, b in zip(port_fit[key], want):
                np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            np.testing.assert_array_equal(port_fit[key], want, err_msg=key)
    assert port_fit["ins_event_rate"] > 0 and port_fit["del_event_rate"] > 0
    # Without the template's FASTA the homopolymer share is not fitted.
    assert (port_fit["hp_fraction"] != 0.6) == with_ref


@pytest.mark.parametrize("kind", ["short", "trio", "somatic", "long"])
def test_no_template_raises(kind, templates, tmp_path):
    """The port has no default template: every driver names the missing
    `template_bam` before it writes anything."""
    with pytest.raises(ValueError, match="template_bam"):
        simulate(PORT, kind, dict(templates, reads="", long_reads=""),
                 tmp_path / "out", windows=[(1000, 2000)])
    assert not (tmp_path / "out").exists()
    assert tsim.SimConfig("ref.fa", CONTIG, []).template_bam == ""
    assert tfam.TrioSimConfig("ref.fa", CONTIG, []).template_bam == ""
    assert tfam.SomaticSimConfig("ref.fa", CONTIG, []).template_bam == ""


# -- the JAX simulator tests on the port ---------------------------------------

SIMULATE_TWIN = port_twin(test_simulate)
FAMILY_TWIN = port_twin(test_simulate_family)
# The fixture-free cases, and those of the clean corpus (errors off).
SIMULATE_CASES = twin_cases(SIMULATE_TWIN, ("clean_corpus",))
FAMILY_CASES = twin_cases(FAMILY_TWIN, ("trio", "somatic"))
CLEAN_WINDOW = (10_000, 18_000)


def test_jax_cases_are_collected():
    names = [c[2] for c in SIMULATE_CASES + FAMILY_CASES]
    assert len(SIMULATE_CASES) >= 14 and len(FAMILY_CASES) == 7
    assert {"test_clean_reads_reconstruct_reference",
            "test_clean_reads_carry_variant_alleles",
            "test_truth_vcf_round_trips", "test_mendelian_consistency",
            "test_somatic_absent_from_normal_reads"} <= set(names)


@pytest.fixture(scope="module")
def clean_corpus(templates, tmp_path_factory):
    """The JAX test's error-free corpus, on the port's template."""
    SIMULATE_TWIN.REF_FASTA = templates["ref"]
    SIMULATE_TWIN.WINDOW = CLEAN_WINDOW
    cfg = config(PORT, "short", templates, windows=[CLEAN_WINDOW], seed=3,
                 coverage=12.0, error_rate_scale=0.0, hotspot_rate=0.0,
                 slip_site_fraction=0.0, allele_sampling_bias=False)
    return cfg, tsim.simulate_corpus(
        cfg, str(tmp_path_factory.mktemp("clean")))


@pytest.mark.parametrize("case", SIMULATE_CASES,
                         ids=[c[0] for c in SIMULATE_CASES])
def test_jax_simulate_case_on_the_port(case, request):
    _id, cls_name, name, params = case
    fixtures = {}
    if name.startswith("test_clean") or name == "test_truth_vcf_round_trips":
        fixtures["clean_corpus"] = request.getfixturevalue("clean_corpus")
    run_twin_case(SIMULATE_TWIN, cls_name, name, params, **fixtures)


@pytest.fixture(scope="module")
def family(templates, tmp_path_factory):
    """The JAX tests' trio and tumour/normal fixtures on the port's
    template: 36 kb, the same seeds, coverages and de novo rate."""
    windows = [(2000, 38_000)]
    trio_cfg = config(PORT, "trio", templates, windows=windows, seed=7,
                      coverage_child=20.0, coverage_parent=20.0,
                      de_novo_snv_rate=1.0 / 6_000.0)
    somatic_cfg = config(PORT, "somatic", templates, windows=windows,
                         seed=11, coverage_tumor=40.0, coverage_normal=20.0)
    return {
        "trio": (trio_cfg, tfam.simulate_trio_corpus(
            trio_cfg, str(tmp_path_factory.mktemp("trio")))),
        "somatic": (somatic_cfg, tfam.simulate_somatic_corpus(
            somatic_cfg, str(tmp_path_factory.mktemp("somatic")))),
    }


@pytest.mark.parametrize("case", FAMILY_CASES,
                         ids=[c[0] for c in FAMILY_CASES])
def test_jax_family_case_on_the_port(case, family):
    _id, cls_name, name, params = case
    run_twin_case(FAMILY_TWIN, cls_name, name, params, **family)


def test_clean_long_reads_reconstruct_reference(templates, tmp_path):
    """The long-read simulator with its error process off: every aligned
    base away from a variant equals the reference base its CIGAR maps it
    to, and every read's CIGAR spans its sequence."""
    from deepvariant_tpu_torch.training import simulate_longread as tlong

    window = (2000, 14_000)
    cfg = config(PORT, "long", templates, windows=[window], seed=5,
                 coverage=8.0, error_rate_scale=0.0, hotspot_rate=0.0,
                 ref_contamination=0.0)
    out = tlong.simulate_corpus_longread(cfg, str(tmp_path))
    ref = FastaReader(templates["long_ref"]).query(
        Range(CONTIG, 0, 16_000)).upper()
    variant_positions = set()
    for v in out["variants"]:
        variant_positions.update(range(v.pos, v.pos + len(v.ref)))
    reads = BamReader(out["bam"]).query(Range(CONTIG, *window)).to_reads()
    assert len(reads) == out["n_reads"] > 10
    checked = 0
    for rd in reads:
        qpos, rpos = 0, rd.position
        for op, n in rd.cigar:
            if op == _OP_M:
                for k in range(n):
                    if rpos + k not in variant_positions:
                        assert rd.aligned_sequence[qpos + k] == \
                            ref[rpos + k], rd.fragment_name
                        checked += 1
                qpos += n
                rpos += n
            elif op in (_OP_I, _OP_S):
                qpos += n
            elif op == _OP_D:
                rpos += n
        assert qpos == len(rd.aligned_sequence)
    assert checked > 50_000
    assert all(dataclasses.is_dataclass(v) for v in out["variants"])
