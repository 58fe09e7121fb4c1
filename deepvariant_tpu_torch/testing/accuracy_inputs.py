"""Seeded stand-ins for the inputs of the accuracy drivers.

The drivers (`scripts/accuracy_*.py`, `scripts/resume_somatic_eval.py`)
read the reference's test data at fixed paths (`TESTDATA` and the
like): FASTAs, template BAMs that the simulators fit their error models
to, real read sets with their truth VCFs and BEDs, and windows on chr20
megabases long. `write_inputs` writes seeded stand-ins of all of them into one
directory, with the port's own writers and simulators, and
`driver_constants` returns, driver by driver, the module constants that
point the driver at them, with windows of a few kb, so that each
driver runs from simulation to F1 in a minute or so. The constant names
are the JAX package's as well, so the same values point either
package's driver at the same files.

One reference serves every driver: the FASTA of a seeded long-read
sample (`synthetic.synthetic_longread_sample`), contig "chr20", whose
reads are the long-read template. The short-read template is a seeded
30x `synthetic.synthetic_sample` on a reference of its own: the
short-read quality model reads only its qualities, read lengths and
fragment sizes. The real read sets are stood in for by simulated
corpora with a known truth: two short-read runs of one window (30x and
12x, as the two real runs), a long-read run and a family.

Only the windows are cut: each driver's stages, flags and checkpoint
names are unchanged.
"""

from __future__ import annotations

import contextlib
import importlib
import os
from typing import Dict

CONTIG = "chr20"
REF_LENGTH = 32_000            # the run of N is at 24,000-24,400
SHORT_TEMPLATE_LENGTH = 12_000
SEED = 20261018

# The stand-ins for the real read sets: name -> (simulator, fields).
CORPORA = {
    # The two short-read runs of the WGS eval slice (accuracy_sim's
    # EVAL_SOURCES, accuracy_chr20's TRAIN_SOURCES).
    "wgs_a": ("short", dict(seed=SEED + 1, windows=[(6_000, 10_000)],
                            coverage=30.0)),
    "wgs_b": ("short", dict(seed=SEED + 2, windows=[(6_000, 10_000)],
                            coverage=12.0)),
    # accuracy_ont's real ONT run.
    "ont": ("long", dict(seed=SEED + 3, windows=[(17_000, 23_000)])),
    # accuracy_deeptrio's trio.
    "trio": ("trio", dict(seed=SEED + 4, windows=[(25_000, 31_000)],
                          coverage_child=20.0, coverage_parent=20.0)),
}

TRAIN_WINDOWS = [(1_000, 2_500)]
TUNE_WINDOWS = [(2_500, 3_000)]
EVAL_WINDOWS = [(3_500, 4_600)]
LONG_TRAIN_WINDOWS = [(10_000, 13_000)]
LONG_TUNE_WINDOWS = [(13_000, 14_500)]
LONG_EVAL_WINDOWS = [(14_500, 17_000)]


def _writers():
    from deepvariant_tpu_torch.core import types
    from deepvariant_tpu_torch.io import bam, bam_writer

    return types, bam, bam_writer


def write_inputs(directory: str) -> Dict[str, object]:
    """The templates and the simulated stand-ins, written under
    `directory`. Returns {"ref", "short_template", "long_template",
    and one simulator result per CORPORA name}."""
    from deepvariant_tpu_torch.testing import synthetic
    from deepvariant_tpu_torch.training import simulate as sim
    from deepvariant_tpu_torch.training import simulate_family as family
    from deepvariant_tpu_torch.training import simulate_longread as longread

    long = synthetic.write_inputs(
        synthetic.synthetic_longread_sample(SEED, ((CONTIG, REF_LENGTH),)),
        os.path.join(directory, "long-template"), *_writers())
    short = synthetic.write_inputs(
        synthetic.synthetic_sample(SEED + 100,
                                   ((CONTIG, SHORT_TEMPLATE_LENGTH),),
                                   depth=30),
        os.path.join(directory, "short-template"), *_writers())
    out: Dict[str, object] = {
        "ref": long["ref"],
        "short_template": short["reads"],
        "long_template": long["reads"],
    }
    short_fields = dict(template_bam=short["reads"],
                        template_region=(CONTIG, 0, SHORT_TEMPLATE_LENGTH))
    simulators = {
        "short": (sim.SimConfig, sim.simulate_corpus, short_fields),
        "long": (longread.LongReadSimConfig,
                 longread.simulate_corpus_longread,
                 dict(template_bam=long["reads"],
                      template_region=(CONTIG, 0, REF_LENGTH),
                      template_ref_path=long["ref"])),
        "trio": (family.TrioSimConfig, family.simulate_trio_corpus,
                 short_fields),
    }
    for name, (kind, fields) in CORPORA.items():
        config_cls, driver, template = simulators[kind]
        out[name] = driver(
            config_cls(ref_path=long["ref"], contig=CONTIG, **template,
                       **fields),
            os.path.join(directory, name))
    return out


def _region(lo: int, hi: int) -> str:
    return f"{CONTIG}:{lo:,}-{hi:,}"


def driver_constants(inputs: Dict[str, object]) -> Dict[str, dict]:
    """{driver module name: {constant: value}} pointing every driver at
    `inputs` (`write_inputs`'s result)."""
    ref = inputs["ref"]
    short = dict(template_bam=inputs["short_template"],
                 template_region=(CONTIG, 0, SHORT_TEMPLATE_LENGTH))
    long_template = dict(template_bam=inputs["long_template"],
                         template_region=(CONTIG, 0, REF_LENGTH),
                         template_ref=ref)
    wgs_a, wgs_b = inputs["wgs_a"], inputs["wgs_b"]
    eval_sources = tuple(
        dict(label=label, reads=c["bam"], ref=ref, truth=c["truth_vcf"],
             confident_bed=c["confident_bed"], contig=CONTIG, sample=sample)
        for label, c, sample in (("na12878_s1", wgs_a, "NA12878"),
                                 ("hg001_sorted", wgs_b, "HG001")))
    windows = dict(TRAIN_WINDOWS=list(TRAIN_WINDOWS),
                   TUNE_WINDOWS=list(TUNE_WINDOWS),
                   EVAL_WINDOWS=list(EVAL_WINDOWS))
    family_windows = dict(windows, GRCH38_10M=ref, CONTIG=CONTIG)
    ont, trio = inputs["ont"], inputs["trio"]
    lo, hi = LONG_EVAL_WINDOWS[0]
    return {
        "accuracy_sim": dict(
            REF=ref, GRCH38=ref,
            SIM_BUILDS={"hg19": {"ref": ref,
                                 "train": [(CONTIG, list(TRAIN_WINDOWS))],
                                 "tune": [(CONTIG, list(TUNE_WINDOWS))]},
                        "grch38": {"ref": ref,
                                   "train": [(CONTIG, list(TRAIN_WINDOWS))],
                                   "tune": [(CONTIG, list(TUNE_WINDOWS))]}},
            EVAL_SOURCES=eval_sources,
            EVAL_SPAN=(6_000, 7_200),
            POWERED_EVAL_WINDOWS=list(EVAL_WINDOWS),
            TEMPLATES={"na12878": dict(short),
                       "hg001": dict(short, coverage=12.0),
                       "indelrich": dict(short, indel_rate=1.0 / 550.0)},
            DEFAULT_TEMPLATE=dict(short)),
        "accuracy_trio": family_windows,
        "accuracy_somatic": family_windows,
        "resume_somatic_eval": dict(GRCH38_10M=ref, CONTIG=CONTIG,
                                    EVAL_WINDOWS=list(EVAL_WINDOWS)),
        "accuracy_hybrid": dict(
            windows, GRCH38_10M=ref, CONTIG=CONTIG,
            ILLUMINA_TEMPLATE=short["template_bam"],
            ILLUMINA_TEMPLATE_REGION=short["template_region"],
            ILLUMINA_TEMPLATE_REF=ref,
            PACBIO_TEMPLATE=inputs["long_template"],
            PACBIO_TEMPLATE_REGION=(CONTIG, 0, REF_LENGTH)),
        "accuracy_longread": dict(
            GRCH38_10M=ref,
            _TRAIN_WINDOWS=list(LONG_TRAIN_WINDOWS),
            _TUNE_WINDOWS=list(LONG_TUNE_WINDOWS),
            FAMILIES={
                "pacbio": dict(
                    preset="PACBIO", train_config="pacbio", coverage=0.0,
                    **long_template,
                    eval=dict(simulated=True, ref=ref,
                              windows=list(LONG_EVAL_WINDOWS),
                              region=_region(lo, hi), span=(lo, hi),
                              seed=90210, sample="SIM")),
                "ont": dict(
                    preset="ONT_R104", train_config="ont", coverage=0.0,
                    **long_template,
                    eval=dict(reads=ont["bam"], ref=ref,
                              region=_region(17_000, 20_000),
                              span=(17_000, 20_000),
                              truth=ont["truth_vcf"],
                              confident_bed=ont["confident_bed"],
                              sample="HG002")),
            }),
        "accuracy_chr20": dict(
            READS=wgs_a["bam"], REF=ref, TRUTH_VCF=wgs_a["truth_vcf"],
            CONFIDENT_BED=wgs_a["confident_bed"],
            TRAIN_SOURCES=tuple(
                dict(label=s["label"], reads=s["reads"], ref=ref,
                     truth=s["truth"], contig=CONTIG)
                for s in eval_sources),
            TRAIN_REGION=_region(6_000, 8_000),
            EVAL_REGION=_region(8_000, 9_000),
            SECOND_FOLD=(_region(7_000, 9_000), _region(6_000, 7_000)),
            TUNE_BP=500,
            FULL_REGION_BED_SPAN=(CONTIG, 6_000, 9_000)),
        "accuracy_ont": dict(
            READS=ont["bam"], REF=ref, TRUTH_VCF=ont["truth_vcf"],
            CONFIDENT_BED=ont["confident_bed"],
            WINDOW=(CONTIG, 17_000, 20_000), TUNE_BP=500),
        "accuracy_deeptrio": dict(
            READS_CHILD=trio["bam_child"],
            READS_PARENT1=trio["bam_parent1"],
            READS_PARENT2=trio["bam_parent2"], REF=ref,
            TRUTH_VCF=trio["truth_child"],
            WINDOW=(CONTIG, 25_000, 28_000), TUNE_BP=300),
    }


@contextlib.contextmanager
def patched(constants: Dict[str, dict]):
    """Set the port's driver constants to `constants` inside the block,
    and restore them after it."""
    saved = []
    try:
        for name, values in constants.items():
            mod = importlib.import_module(f"deepvariant_tpu_torch.scripts.{name}")
            for key, value in values.items():
                saved.append((mod, key, getattr(mod, key)))
                setattr(mod, key, value)
        yield
    finally:
        for mod, key, value in reversed(saved):
            setattr(mod, key, value)
