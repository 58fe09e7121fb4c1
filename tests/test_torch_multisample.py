"""The port's multi-sample make_examples
(deepvariant_tpu_torch/make_examples/multisample.py) against the JAX
package's `make_multisample_examples_runner`.

Host code, held byte for byte: the stacked examples, example_info.json,
candidates and gVCF TFRecords (written uncompressed) of the same
options and samples through both packages, on the seeded family,
tumour/normal pair and pangenome panel of
`deepvariant_tpu_torch/testing/synthetic.py` (3 kb, the files written by
the JAX package's writers, `torch_multisample_util`). Cases: the trio at
run_deeptrio's 40/60/40 rows (0.67 pooled rescue, its channels)
and at the CLI's 100/100/100, each parent's stack, a downsampled trio;
the pair with a normal and the tumour alone, with
--filter_low_vaf_candidates, with --phase_reads with and without
--assign_phase_from_normal; the pangenome panel from a BAM and from a
GBZ, with each blanking mode, without the window-spanning filter and
under a chrom prefix; training mode with a truth VCF; the realigner on,
with the JAX package's native library loaded and switched off. The
realigner is off elsewhere (the port's is Python and numpy).
`RegionProcessor.should_filter_low_vaf` and `assign_phase_from_normal`
are held on their own, and tests/test_multisample.py's and
tests/test_assign_phase_from_normal.py's cases that need no reference
data run once more on the port (those files are read, not edited).
"""

import os
import struct

import numpy as np
import pytest
import torch

import test_assign_phase_from_normal
import test_multisample
from deepvariant_tpu.core.types import Variant as JVariant
from deepvariant_tpu.make_examples import core as jcore
from deepvariant_tpu.make_examples.variant_caller import (
    DeepVariantCall as JCall,
)
from deepvariant_tpu.phasing.direct_phasing import PhasedVariant as JPV
from deepvariant_tpu_torch.io.examples import parse_example
from deepvariant_tpu_torch.make_examples import core as tcore
from deepvariant_tpu_torch.phasing.direct_phasing import PhasedVariant as TPV
from deepvariant_tpu_torch.testing import synthetic
from torch_multisample_util import (
    JAX,
    PORT,
    WGS_CHANNELS,
    port_twin,
    run_multisample,
    run_twin_case,
    trio_specs,
    twin_cases,
    write_family,
    write_pangenome,
    write_tumor_normal,
)
from torch_port_util import (
    package_module,
    realigner_natives_off,
    region_reads,
    to_package,
)

torch.set_num_threads(2)

TWINS = {m.__name__: port_twin(m)
         for m in (test_multisample, test_assign_phase_from_normal)}
CASES = [(name, case) for name, twin in sorted(TWINS.items())
         for case in twin_cases(twin)]


def test_jax_cases_are_collected():
    ids = [f"{m}::{c[0]}" for m, c in CASES]
    assert len(ids) == len(set(ids)) >= 9


@pytest.mark.parametrize("module,case", CASES,
                         ids=[f"{m}::{c[0]}" for m, c in CASES])
def test_jax_case_on_the_port(module, case):
    """The JAX test's case as written, on the port's modules."""
    _id, cls_name, name, params = case
    run_twin_case(TWINS[module], cls_name, name, params)


# -- inputs -------------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("multisample")
    family, fam = write_family(d / "family")
    pair, _ = write_tumor_normal(d / "pair")
    pan, _ = write_pangenome(d / "pangenome")
    family.update(synthetic.write_truth_inputs(
        fam["child"], str(d / "family"), seed=5))
    return dict(family=family, pair=pair, pangenome=pan, dir=str(d))


# The phasing cases paint the haplotype channel (7), where the phases
# show, and track the reference reads, which direct phasing needs.
PHASED_CHANNELS = WGS_CHANNELS[:6] + (7,) + WGS_CHANNELS[6:]


def _trio(p, heights=(40, 60, 40), **options):
    f = p["family"]
    return (dict(dict(reads_filename=f["child"], ref_filename=f["ref"],
                      mode="calling", sample_name="child",
                      realigner_enabled=False,
                      variant_caller={"min_fraction_multiplier": 0.67},
                      pileup={"channels": WGS_CHANNELS}), **options),
            trio_specs(f, heights), 1)


def _somatic(p, **options):
    s = p["pair"]
    return (dict(dict(reads_filename=s["tumor"], ref_filename=s["ref"],
                      mode="calling", sample_name="tumor",
                      realigner_enabled=False,
                      variant_caller={
                          "min_fraction_multiplier": float("inf")},
                      pileup={"channels": WGS_CHANNELS}), **options),
            [dict(role="normal", reads_filename=s["normal"],
                  sample_name="normal"),
             dict(role="tumor", reads_filename=s["tumor"],
                  sample_name="tumor")], 1)


def _pangenome(p, panel="panel_bam", prefix="", **spec):
    g = p["pangenome"]
    pan = dict(role="pangenome", reads_filename=g[panel],
               sample_name="pangenome", pileup_height=100,
               keep_only_window_spanning_reads=True,
               channels_to_blank=(7, 9, 10, 2, 3), chrom_prefix=prefix)
    pan.update(spec)
    return (dict(reads_filename=g["reads"], ref_filename=g["ref"],
                 mode="calling", sample_name="reads",
                 realigner_enabled=False,
                 variant_caller={"min_fraction_multiplier": float("inf")},
                 pileup={"channels": WGS_CHANNELS}),
            [pan, dict(role="reads", reads_filename=g["reads"],
                       sample_name="reads")], 1)


def _gbz_panel(p):
    """The GBZ panel decoded to a BAM by the port (its bytes equal the
    JAX decode's, tests/test_torch_gbz.py)."""
    from deepvariant_tpu_torch.io.gbz import extract_panel_bam

    g = p["pangenome"]
    out = os.path.join(p["dir"], "pangenome", "gbz.panel.bam")
    if not os.path.exists(out):
        extract_panel_bam(g["panel_gbz"], g["ref"], out)
    return dict(p, pangenome=dict(g, panel_gbz_bam=out))


def _tumor_only(p, **options):
    opts, specs, _ = _somatic(p, **options)
    return opts, specs[1:], 0


def _parent2(p):
    opts, _, _ = _trio(p)
    f = p["family"]
    return (dict(opts, reads_filename=f["parent2"], sample_name="parent2"),
            trio_specs(f, order=("parent2", "child", "parent1")), 0)


def _training(p):
    opts, specs, i = _trio(p)
    f = p["family"]
    return (dict(opts, mode="training",
                 truth_variants_filename=f["truth"],
                 confident_regions_filename=f["confident"]), specs, i)


RUNS = {
    "trio-40-60-40": lambda p: _trio(p),
    "trio-100-100-100": lambda p: (
        dict(reads_filename=p["family"]["child"],
             ref_filename=p["family"]["ref"], mode="calling",
             sample_name="child", realigner_enabled=False),
        trio_specs(p["family"], (100, 100, 100)), 1),
    "trio-parent2-stack": _parent2,
    "trio-downsampled": lambda p: _trio(p, max_reads_per_partition=40),
    "trio-phase-reads": lambda p: _trio(
        p, phase_reads=True, track_ref_reads=True,
        pileup={"channels": PHASED_CHANNELS}),
    "trio-training": _training,
    "somatic": lambda p: _somatic(p),
    "somatic-tumor-only": lambda p: _tumor_only(p),
    "somatic-track-ref-reads": lambda p: _somatic(p, track_ref_reads=True),
    "somatic-filter-low-vaf": lambda p: _somatic(
        p, track_ref_reads=True, filter_low_vaf_candidates=True,
        low_vaf_threshold=0.3, low_vaf_max_base_quality=35),
    # Without the reference reads every candidate's VAF is 1: nothing is
    # filtered (ROADMAP.md Queue 3).
    "somatic-filter-low-vaf-untracked": lambda p: _somatic(
        p, filter_low_vaf_candidates=True, low_vaf_threshold=0.3,
        low_vaf_max_base_quality=35),
    "somatic-phase-reads": lambda p: _somatic(
        p, phase_reads=True, track_ref_reads=True,
        pileup={"channels": PHASED_CHANNELS}),
    "somatic-assign-phase-from-normal": lambda p: _somatic(
        p, phase_reads=True, assign_phase_from_normal=True,
        track_ref_reads=True, pileup={"channels": PHASED_CHANNELS}),
    "pangenome-bam": lambda p: _pangenome(p),
    "pangenome-gbz": lambda p: _pangenome(_gbz_panel(p), "panel_gbz_bam"),
    "pangenome-blank-snp": lambda p: _pangenome(
        p, variant_types_to_blank=("SNP",)),
    "pangenome-blank-indel": lambda p: _pangenome(
        p, variant_types_to_blank=("INDEL",)),
    "pangenome-no-blanking": lambda p: _pangenome(p, channels_to_blank=()),
    "pangenome-all-window-reads": lambda p: _pangenome(
        p, keep_only_window_spanning_reads=False),
    "pangenome-chrom-prefix": lambda p: _pangenome(
        p, "panel_nochr", prefix="chr"),
}


# The port's outputs of each case of RUNS, kept for
# test_outputs_differ_where_they_should.
PORT_OUTPUTS = {}


def _port_run(inputs, out_dir, case):
    if case not in PORT_OUTPUTS:
        options, samples, main = RUNS[case](inputs)
        PORT_OUTPUTS[case] = run_multisample(PORT, out_dir, options,
                                             samples, main)
    return PORT_OUTPUTS[case]


def _compare(inputs, tmp_path, case):
    if isinstance(case, str):
        options, samples, main = RUNS[case](inputs)
        got, got_counts = _port_run(inputs, tmp_path / "port", case)
    else:
        options, samples, main = case
        got, got_counts = run_multisample(PORT, tmp_path / "port", options,
                                          samples, main)
    want, want_counts = run_multisample(JAX, tmp_path / "jax", options,
                                        samples, main)
    assert got_counts == want_counts
    for name in want:
        assert got[name] == want[name], name
    return want_counts


@pytest.mark.parametrize("case", sorted(RUNS))
def test_outputs_equal_jax(inputs, tmp_path, case):
    counts = _compare(inputs, tmp_path, case)
    assert counts["candidates"] > 0
    assert counts["examples"] > 0


def _records(blob):
    """The records of an uncompressed TFRecord file's bytes."""
    out, pos = [], 0
    while pos < len(blob):
        n = struct.unpack_from("<Q", blob, pos)[0]
        out.append(blob[pos + 12:pos + 12 + n])
        pos += 16 + n
    return out


def test_outputs_differ_where_they_should(inputs, tmp_path):
    """The cases above are not vacuous: blanking, the window filter, the
    prefix and the filters change the bytes."""
    def examples(case):
        return _port_run(inputs, tmp_path / case, case)[0]["examples"]
    base = examples("pangenome-bam")
    for case in ("pangenome-no-blanking", "pangenome-all-window-reads",
                 "pangenome-blank-snp", "pangenome-blank-indel"):
        assert examples(case) != base, case
    assert examples("pangenome-chrom-prefix") == base
    counts = {case: _port_run(inputs, tmp_path, case)[1]["examples"]
              for case in ("somatic-filter-low-vaf",
                           "somatic-track-ref-reads")}
    assert counts["somatic-filter-low-vaf"] < counts["somatic-track-ref-reads"]
    assert examples("somatic-filter-low-vaf-untracked") == \
        examples("somatic")
    assert examples("somatic-assign-phase-from-normal") != \
        examples("somatic-phase-reads")
    # The phases reach the haplotype plane.
    for case in ("trio-phase-reads", "somatic-phase-reads"):
        assert any(parse_example(r).image[..., 6].any()
                   for r in _records(examples(case))), case


@pytest.mark.parametrize("natives", ["on", "off"])
def test_realigned_trio_equals_jax(inputs, tmp_path, monkeypatch, natives):
    """The realigner on every sample (multisample.py:248-251), over
    300 bases; the JAX package with its native library loaded and
    switched off."""
    if natives == "off":
        realigner_natives_off(monkeypatch)
    options, samples, main = _trio(inputs, regions=["chr1:100-400"])
    options["realigner_enabled"] = True
    counts = _compare(inputs, tmp_path, (options, samples, main))
    assert counts["examples"] > 0
    # Some read moved: the examples differ from the realigner-off ones.
    on = run_multisample(PORT, tmp_path / "port", options, samples, main)
    off = run_multisample(PORT, tmp_path / "off",
                          dict(options, realigner_enabled=False), samples,
                          main)
    assert on[0]["examples"] != off[0]["examples"]


# -- the two RegionProcessor methods -----------------------------------------

def _region_candidates(package, paths, reads, region):
    """(candidates, batch) of one package's caller over `region`."""
    batch, _, ref, rng = region_reads(package, dict(paths, reads=reads),
                                      region)
    core = package_module(package, "make_examples.core")
    proc = core.RegionProcessor.__new__(core.RegionProcessor)
    proc.options = core.MakeExamplesOptions(ref_filename=paths["ref"])
    proc.ref_reader = ref
    counter = proc._allele_counter(rng)
    counter.add_batch(batch)
    vc = package_module(package, "make_examples.variant_caller")
    return vc.VerySensitiveCaller(
        proc.options.variant_caller_options).calls_in_region(counter), batch


@pytest.mark.parametrize("threshold,bq,mapq", [
    (0.05, 30, 30), (0.3, 30, 30), (0.3, 20, 20), (0.5, 41, 61),
    (1.0, 0, 0)])
def test_should_filter_low_vaf_equals_jax(inputs, threshold, bq, mapq):
    pair = inputs["pair"]
    region = ("chr1", 0, 3000)
    got, want = [], []
    for package, out in ((JAX, want), (PORT, got)):
        cands, batch = _region_candidates(package, pair, pair["tumor"],
                                          region)
        core = package_module(package, "make_examples.core")
        proc = core.RegionProcessor.__new__(core.RegionProcessor)
        proc.options = core.MakeExamplesOptions(
            filter_low_vaf_candidates=True, low_vaf_threshold=threshold,
            low_vaf_max_base_quality=bq, low_vaf_max_mapping_quality=mapq)
        out.extend(proc.should_filter_low_vaf(c, batch) for c in cands)
    assert got == want
    assert len(got) > 20


def test_should_filter_low_vaf_is_off_by_default(inputs):
    pair = inputs["pair"]
    cands, batch = _region_candidates(PORT, pair, pair["tumor"],
                                      ("chr1", 0, 1500))
    proc = tcore.RegionProcessor.__new__(tcore.RegionProcessor)
    proc.options = tcore.MakeExamplesOptions()
    assert not any(proc.should_filter_low_vaf(c, batch) for c in cands)


@pytest.mark.parametrize("seed", range(4))
def test_assign_phase_from_normal_equals_jax(inputs, seed):
    """The tumour's candidates against normal phased variants drawn at a
    share of their positions, with seeded phase alleles (REF, an alt or
    another base)."""
    pair = inputs["pair"]
    cands, batch = _region_candidates(JAX, pair, pair["tumor"],
                                      ("chr1", 0, 3000))
    rng = np.random.RandomState(seed)
    phased = []
    for c in cands:
        if rng.rand() < 0.7:
            choices = ["REF"] + list(c.allele_support) + ["T"]
            a, b = rng.choice(len(choices), 2, replace=False)
            phased.append((c.variant.start, choices[a], choices[b]))
    n = len(batch)
    want = jcore.RegionProcessor.assign_phase_from_normal(
        None, cands, n,
        [JPV(position=p, phase_1_bases=a, phase_2_bases=b,
             is_first_in_block=False) for p, a, b in phased])
    got = tcore.RegionProcessor.assign_phase_from_normal(
        None, to_package(cands, PORT), n,
        [TPV(position=p, phase_1_bases=a, phase_2_bases=b,
             is_first_in_block=False) for p, a, b in phased])
    assert got == want


@pytest.mark.parametrize("seed", range(4))
def test_assign_phase_from_normal_on_seeded_tables_equals_jax(seed):
    """Seeded support tables over 12 sites and 30 reads, so that reads
    collect the votes a phase needs."""
    rng = np.random.RandomState(seed)
    n_reads, alleles = 30, ["REF", "A", "C", "T"]
    cands, phased = [], []
    for site in range(12):
        owner = rng.randint(0, 4, n_reads)
        cands.append(JCall(
            variant=JVariant(
                reference_name="chr1", start=10 * site, end=10 * site + 1,
                reference_bases="G", alternate_bases=["A", "C", "T"]),
            allele_support={a: list(np.flatnonzero(owner == k).tolist())
                            for k, a in enumerate(alleles) if k},
            ref_support=np.flatnonzero(owner == 0).tolist()))
        if rng.rand() < 0.8:
            a, b = rng.choice(4, 2, replace=False)
            phased.append((10 * site, alleles[a], alleles[b]))
    want = jcore.RegionProcessor.assign_phase_from_normal(
        None, cands, n_reads,
        [JPV(position=p, phase_1_bases=a, phase_2_bases=b,
             is_first_in_block=False) for p, a, b in phased])
    got = tcore.RegionProcessor.assign_phase_from_normal(
        None, to_package(cands, PORT), n_reads,
        [TPV(position=p, phase_1_bases=a, phase_2_bases=b,
             is_first_in_block=False) for p, a, b in phased])
    assert got == want
    assert set(got) - {0}


# -- the TFRecord CRC of the stacked records ----------------------------------

@pytest.mark.parametrize("length", [0, 7, 4095, 4096, 4103, 65536, 70001,
                                    309_442, 1_048_583])
def test_crc32c_equals_jax(length):
    """The port's CRC-32C (lanes folded with the zero-byte operator from
    4 KB on) against the JAX package's, from 0 and from a running CRC."""
    from deepvariant_tpu.io import tfrecord as jtf
    from deepvariant_tpu_torch.io import tfrecord as ttf

    data = np.random.RandomState(length).randint(
        0, 256, length).astype(np.uint8).tobytes()
    for crc in (0, 0x9E3779B9):
        assert ttf.crc32c(data, crc) == jtf.crc32c(data, crc)
    assert ttf.masked_crc(data) == jtf.masked_crc(data)
