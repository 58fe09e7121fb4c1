"""Shared inputs of the simulator and tools port tests
(test_torch_simulate.py, test_torch_tools.py, test_torch_vis.py): the
seeded templates that both packages' simulators fit their error models
to, the four simulators of both packages side by side, a seeded call
set scored against a simulated truth, and JAX test cases run on the
port.

The templates are `deepvariant_tpu_torch/testing/synthetic.py` samples
written with the port's writers. Their one contig is named "chr20", as
the JAX simulator tests' contig is, so that those tests' bodies run on
the port's corpora unchanged."""

import dataclasses
import os

import numpy as np

from deepvariant_tpu_torch.testing import synthetic
from torch_multisample_util import JAX, PORT, module  # noqa: F401

CONTIG = "chr20"
TEMPLATE_LENGTH = 40_000
LONG_TEMPLATE_LENGTH = 16_000

# kind: (module, config class, driver)
SIMULATORS = {
    "short": ("training.simulate", "SimConfig", "simulate_corpus"),
    "trio": ("training.simulate_family", "TrioSimConfig",
             "simulate_trio_corpus"),
    "somatic": ("training.simulate_family", "SomaticSimConfig",
                "simulate_somatic_corpus"),
    "long": ("training.simulate_longread", "LongReadSimConfig",
             "simulate_corpus_longread"),
}


def write_templates(directory) -> dict:
    """A 30x short-read sample over 40 kb and a long-read sample over
    16 kb, each a FASTA and an indexed BAM."""
    from deepvariant_tpu_torch.core import types
    from deepvariant_tpu_torch.io import bam, bam_writer

    directory = str(directory)
    short = synthetic.write_inputs(
        synthetic.synthetic_sample(3, ((CONTIG, TEMPLATE_LENGTH),),
                                   depth=30),
        os.path.join(directory, "short"), types, bam, bam_writer)
    long = synthetic.write_inputs(
        synthetic.synthetic_longread_sample(
            4, ((CONTIG, LONG_TEMPLATE_LENGTH),)),
        os.path.join(directory, "long"), types, bam, bam_writer)
    return {"ref": short["ref"], "reads": short["reads"],
            "long_ref": long["ref"], "long_reads": long["reads"]}


def template_kwargs(templates: dict, kind: str) -> dict:
    """The config fields that name the template and the reference."""
    if kind == "long":
        return dict(ref_path=templates["long_ref"], contig=CONTIG,
                    template_bam=templates["long_reads"],
                    template_region=(CONTIG, 0, LONG_TEMPLATE_LENGTH))
    return dict(ref_path=templates["ref"], contig=CONTIG,
                template_bam=templates["reads"],
                template_region=(CONTIG, 0, TEMPLATE_LENGTH))


def config(package: str, kind: str, templates: dict, **fields):
    mod, cls, _ = SIMULATORS[kind]
    return getattr(module(package, mod), cls)(
        **template_kwargs(templates, kind), **fields)


def simulate(package: str, kind: str, templates: dict, outdir,
             **fields) -> dict:
    """One package's corpus of `kind` in `outdir`."""
    mod, _, driver = SIMULATORS[kind]
    cfg = config(package, kind, templates, **fields)
    return getattr(module(package, mod), driver)(cfg, str(outdir))


def file_bytes(directory) -> dict:
    directory = str(directory)
    return {name: open(os.path.join(directory, name), "rb").read()
            for name in sorted(os.listdir(directory))}


def plain(value, root: str = ""):
    """A simulator's result as plain values: dataclasses and other
    objects as dicts of their fields, paths under `root` relative to it,
    numpy values as Python ones."""
    if dataclasses.is_dataclass(value):
        return {"class": type(value).__name__,
                **plain(dataclasses.asdict(value), root)}
    if isinstance(value, np.ndarray):
        return value.tolist()
    if hasattr(value, "__dict__") and not isinstance(value, type):
        return {"class": type(value).__name__, **plain(vars(value), root)}
    if isinstance(value, dict):
        return {k: plain(v, root) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(plain(v, root) for v in value)
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, str) and root and value.startswith(root):
        return os.path.relpath(value, root)
    return value


def write_calls(truth, directory, seed: int = 0) -> dict:
    """A call set against the simulated `truth` (SimVariants), written
    with the port's VCF writer: most truth records called as they are,
    every ninth missed, others with the wrong genotype or allele, seeded
    false positives between them, RefCall and multi-allelic records,
    GQ, DP and VAF on every call; and CVOs for half of the missed
    sites, some called hom-ref and some variant. Returns the paths of
    `calls.vcf.gz` (with its .tbi) and `cvos.tfrecord`."""
    from deepvariant_tpu_torch.core import types
    from deepvariant_tpu_torch.io import tabix, tfrecord, vcf

    rng = np.random.RandomState(seed)
    directory = str(directory)
    os.makedirs(directory, exist_ok=True)
    records, cvos = [], []

    def record(start, ref, alts, gt, filt="PASS"):
        return types.Variant(
            reference_name=CONTIG, start=start, end=start + len(ref),
            reference_bases=ref, alternate_bases=list(alts),
            quality=float(np.round(rng.uniform(3, 60), 1)), filter=[filt],
            calls=[types.VariantCall(
                call_set_name="SIM", genotype=list(gt),
                info={"GQ": [int(rng.randint(1, 60))],
                      "DP": [int(rng.randint(10, 45))],
                      "VAF": [float(np.round(rng.uniform(0.1, 1), 3))]})])

    truth = sorted(truth, key=lambda v: v.pos)
    for i, v in enumerate(truth):
        gt = sorted(v.genotype)
        if i % 9 == 0:
            if i % 18 == 0:
                probs = [0.9, 0.06, 0.04] if i % 36 else [0.45, 0.5, 0.05]
                cvos.append(types.CallVariantsOutput(
                    variant=types.Variant(
                        reference_name=CONTIG, start=v.pos,
                        end=v.pos + len(v.ref), reference_bases=v.ref,
                        alternate_bases=[v.alt]),
                    alt_allele_indices=[0], genotype_probabilities=probs))
            continue
        if i % 9 == 1:
            gt = [1, 1] if gt == [0, 1] else [0, 1]
        alt = v.alt
        if i % 9 == 2 and len(v.ref) == len(v.alt) == 1:
            alt = next(b for b in "ACGT" if b not in (v.ref, v.alt))
        if i % 9 == 3 and len(v.ref) == len(v.alt) == 1:
            other = next(b for b in "ACGT" if b not in (v.ref, v.alt))
            records.append(record(v.pos, v.ref, [v.alt, other], [1, 2]))
            continue
        if i % 9 == 4:
            records.append(record(v.pos, v.ref, [alt], [0, 0], "RefCall"))
            continue
        records.append(record(v.pos, v.ref, [alt], gt))
        after = truth[i + 1].pos if i + 1 < len(truth) else v.pos + 40
        gap = after - (v.pos + len(v.ref))
        if i % 4 == 0 and gap > 6:
            pos = v.pos + len(v.ref) + 3
            records.append(record(pos, "A", ["C"] if i % 8 else ["AT"],
                                  [0, 1]))
    contigs = [types.ContigInfo(CONTIG, TEMPLATE_LENGTH, 0)]
    path = os.path.join(directory, "calls.vcf.gz")
    writer = vcf.VcfWriter(path, vcf.VcfHeader(contigs, ["SIM"]))
    for r in sorted(records, key=lambda r: r.start):
        writer.write(r)
    writer.close()
    tabix.build_index(path)
    cvo_path = os.path.join(directory, "cvos.tfrecord")
    with tfrecord.TFRecordWriter(cvo_path) as w:
        for c in cvos:
            w.write(c.encode())
    return {"calls": path, "cvos": cvo_path}


def overlapping_truth(truth, path: str) -> int:
    """A phased truth VCF whose het deletions each cover a SNP of the
    other haplotype, written as a `*` allele on the deleted one (the
    form preprocess_truth consolidates). Returns the groups written."""
    from deepvariant_tpu_torch.core import types
    from deepvariant_tpu_torch.io import vcf

    records, groups = [], 0
    for v in sorted(truth, key=lambda v: v.pos):
        records.append(types.Variant(
            reference_name=CONTIG, start=v.pos, end=v.pos + len(v.ref),
            reference_bases=v.ref, alternate_bases=[v.alt],
            calls=[types.VariantCall(call_set_name="SIM",
                                     genotype=list(v.genotype),
                                     is_phased=True)]))
        if len(v.ref) >= 3 and len(v.alt) == 1 and 1 in v.genotype \
                and 0 in v.genotype:
            base = v.ref[1]
            alt = next(b for b in "ACGT" if b != base)
            gt = [2 if a == 1 else 1 for a in v.genotype]
            records.append(types.Variant(
                reference_name=CONTIG, start=v.pos + 1, end=v.pos + 2,
                reference_bases=base, alternate_bases=[alt, "*"],
                calls=[types.VariantCall(call_set_name="SIM", genotype=gt,
                                         is_phased=True)]))
            groups += 1
    contigs = [types.ContigInfo(CONTIG, TEMPLATE_LENGTH, 0)]
    with open(path, "w") as f:
        for line in vcf.VcfHeader(contigs, ["SIM"]).lines():
            f.write(line + "\n")
        for r in records:
            f.write(vcf.format_variant_line(r) + "\n")
    return groups


def label_corpus(corpus: dict, ref: str, directory, region: str,
                 num_shards: int = 2) -> dict:
    """The port's make_examples in training mode (WGS preset, realigner
    off) over `region` of a simulated corpus, in `num_shards` shards of
    uncompressed labeled examples, the first shard with its runtime TSV.
    Returns the examples spec and the TSV's path."""
    from deepvariant_tpu_torch.core.sharded_files import sharded_filename
    from deepvariant_tpu_torch.make_examples import core, presets

    directory = str(directory)
    os.makedirs(directory, exist_ok=True)
    base = os.path.join(directory, "labeled")
    runtime = os.path.join(directory, "runtime.tsv")
    for task in range(num_shards):
        options = presets.apply_model_preset(core.MakeExamplesOptions(
            reads_filename=corpus["bam"], ref_filename=ref,
            examples_filename=sharded_filename(base, task, num_shards,
                                               ".tfrecord"),
            mode="training", regions=[region], realigner_enabled=False,
            truth_variants_filename=corpus["truth_vcf"],
            confident_regions_filename=corpus["confident_bed"],
            task_id=task, num_shards=num_shards), "WGS")
        core.make_examples_runner(
            options, runtime_by_region_path=runtime if task == 0 else None)
    return {"examples": f"{base}@{num_shards}.tfrecord", "runtime": runtime}
