"""The port's labelers (deepvariant_tpu_torch.labeler) against the JAX
package's.

The case tables of tests/test_variant_labeler_port.py and
tests/test_haplotype_labeler.py run twice: as those files stand, against
the JAX package, and with their source read once more with every
`deepvariant_tpu.` import pointing at the port, so that the same
candidates, truths, references and expectations go through the port's
labelers. Those files are read and not edited. Then the tables, and
seeded scenarios of candidates and truths around a random reference,
go through both packages side by side: labels, confidence, genotypes
and metrics must be equal.
"""

import dataclasses
import inspect
import itertools
import os
import types

import numpy as np
import pytest
import torch

import test_haplotype_labeler
import test_variant_labeler_port
from deepvariant_tpu.labeler import combined_labeler as jcl
from deepvariant_tpu.labeler import haplotype_labeler as jhl
from deepvariant_tpu.labeler import soft_labeler as jsl
from deepvariant_tpu.labeler import variant_labeler as jvl
from deepvariant_tpu_torch.labeler import combined_labeler as tcl
from deepvariant_tpu_torch.labeler import haplotype_labeler as thl
from deepvariant_tpu_torch.labeler import soft_labeler as tsl
from deepvariant_tpu_torch.labeler import variant_labeler as tvl
from torch_port_util import to_package

torch.set_num_threads(2)
JAX, PORT = "deepvariant_tpu", "deepvariant_tpu_torch"
TEST_FILES = (test_haplotype_labeler, test_variant_labeler_port)


def port_twin(module):
    """`module`'s source executed once more with its imports of the JAX
    package pointing at the port."""
    path = module.__file__
    with open(path) as f:
        source = f.read().replace("deepvariant_tpu.", "deepvariant_tpu_torch.")
    twin = types.ModuleType(module.__name__ + "_on_the_port")
    twin.__file__ = path
    exec(compile(source, path, "exec"), twin.__dict__)
    return twin


TWINS = {m.__name__: port_twin(m) for m in TEST_FILES}


def _cases(module):
    """(id, class name, method name, params) of every test method of the
    module that needs no fixture: each parametrized case on its own."""
    out = []
    for cls_name, cls in sorted(vars(module).items()):
        if not (cls_name.startswith("Test") and inspect.isclass(cls)):
            continue
        for name, fn in sorted(vars(cls).items()):
            if not name.startswith("test_"):
                continue
            marks = getattr(fn, "pytestmark", [])
            if any(m.name == "integration" for m in marks):
                continue
            grids = [m for m in marks if m.name == "parametrize"]
            args = [a for a in inspect.signature(fn).parameters
                    if a != "self"]
            if not grids:
                if not args:
                    out.append((f"{cls_name}.{name}", cls_name, name, {}))
                continue
            axes = []
            for m in grids:
                names = [n.strip() for n in m.args[0].split(",")] \
                    if isinstance(m.args[0], str) else list(m.args[0])
                axes.append([dict(zip(names, v if len(names) > 1 else (v,)))
                             for v in m.args[1]])
            for k, combo in enumerate(itertools.product(*axes)):
                params = {}
                for part in combo:
                    params.update(part)
                if set(params) == set(args):
                    out.append((f"{cls_name}.{name}[{k}]", cls_name, name,
                                params))
    return out


CASES = [(module.__name__, case) for module in TEST_FILES
         for case in _cases(TWINS[module.__name__])]


def _run(module, cls_name, name, params):
    cls = getattr(module, cls_name)
    obj = cls()
    if hasattr(obj, "setup_method"):
        obj.setup_method()
    getattr(obj, name)(**params)


def test_case_tables_are_collected():
    """Every module-level table the two files parametrize with is here."""
    ids = [case[0] for _, case in CASES]
    assert len(ids) == len(set(ids)) > 100
    n_table = len(test_variant_labeler_port.GENOTYPE_TABLE)
    assert sum(i.startswith("TestGenotypeFromMatchedTruth.test_table[")
               for i in ids) == n_table


@pytest.mark.parametrize("module,case", CASES,
                         ids=[f"{m}::{c[0]}" for m, c in CASES])
def test_case_on_the_port(module, case):
    """The case as written, on the port's labelers."""
    _id, cls_name, name, params = case
    _run(TWINS[module], cls_name, name, params)


# -- side by side -------------------------------------------------------------

def _label_fields(label):
    return (label.is_confident, to_package(label.variant, PORT),
            tuple(label.genotype) if label.genotype is not None else None)


@pytest.mark.parametrize("row", range(
    len(test_variant_labeler_port.GENOTYPE_TABLE)))
def test_genotype_table_side_by_side(row):
    (variant_alleles, alt_alleles, truth_alleles, truth_gt, _gt,
     _label) = test_variant_labeler_port.GENOTYPE_TABLE[row]
    twin = TWINS[test_variant_labeler_port.__name__]
    outs = []
    for mod, vl in ((test_variant_labeler_port, jvl), (twin, tvl)):
        variant = mod.mkvar(start=10, alleles=variant_alleles)
        truth = mod.mkvar(start=10, alleles=truth_alleles, gt=truth_gt)
        gt = vl._genotype_from_matched_truth(variant, truth)
        label = vl.VariantLabel(is_confident=True, variant=variant,
                                genotype=gt)
        indices = [variant_alleles.index(a) - 1 for a in alt_alleles]
        outs.append((gt, label.label_for_alt_alleles(indices)))
    assert outs[0] == outs[1]


def _scenario(seed):
    """A random reference of 60 bases (a period-2 repeat in its middle,
    so that indels have several representations), truths with
    genotypes, and candidates that are the truths, shifted or trimmed
    forms of them, or false ones; as plain tuples."""
    rng = np.random.RandomState(seed)
    ref = "".join("ACGT"[i] for i in rng.randint(0, 4, 60))
    ref = ref[:25] + "CA" * 5 + ref[35:]
    start = 1000

    def site(pos):
        kind = rng.randint(3)
        base = ref[pos]
        if kind == 0:
            return (pos, base, ["ACGT"[("ACGT".index(base) + 1 +
                                        rng.randint(3)) % 4]])
        if kind == 1:
            n = int(rng.randint(1, 4))
            return (pos, ref[pos:pos + 1 + n], [base])
        return (pos, base, [base + "".join(
            "ACGT"[i] for i in rng.randint(0, 4, rng.randint(1, 4)))])

    # Five bases or more apart: no two sites overlap.
    positions = sorted(rng.choice(np.arange(3, 52, 5), 5, replace=False))
    truths = [site(p) + ([[0, 1], [1, 1], [1, 0]][rng.randint(3)],)
              for p in positions[:3]]
    candidates = []
    for p, r, alts, _gt in truths:
        form = rng.randint(3)
        if form == 0:
            candidates.append((p, r, alts))
        elif form == 1:  # one more reference base on both alleles
            tail = ref[p + len(r)]
            candidates.append((p, r + tail, [a + tail for a in alts]))
    candidates += [site(p) for p in positions[3:]]
    candidates.sort()
    return ref, start, truths, candidates


def _build(mod, ref, start, truths, candidates):
    """The scenario as one test module's Variants, truth reader, and
    reference."""
    truth_vs = [mod.variant(start + p, r, alts, gt=gt)
                for p, r, alts, gt in truths]
    cand_vs = [mod.variant(start + p, r, alts) for p, r, alts in candidates]
    fake_ref = mod.FakeRef(ref, start)
    return truth_vs, cand_vs, fake_ref


LABELERS = {
    "haplotype": (jhl.HaplotypeLabeler, thl.HaplotypeLabeler),
    "soft": (jsl.SoftLabeler, tsl.SoftLabeler),
    "combined": (jcl.CombinedLabeler, tcl.CombinedLabeler),
    "positional": (jvl.PositionalVariantLabeler,
                   tvl.PositionalVariantLabeler),
}


@pytest.mark.parametrize("labeler", list(LABELERS))
@pytest.mark.parametrize("seed", range(12))
def test_seeded_scenarios_side_by_side(seed, labeler):
    ref, start, truths, candidates = _scenario(seed)
    outs = []
    for mod, cls in zip(
            (test_haplotype_labeler, TWINS[test_haplotype_labeler.__name__]),
            LABELERS[labeler]):
        truth_vs, cand_vs, fake_ref = _build(mod, ref, start, truths,
                                             candidates)
        confident = mod.RangeSet([mod.Range(mod.CHROM, start + 2,
                                            start + 50)])
        if labeler == "positional":
            obj = cls(mod.FakeTruth(truth_vs), confident)
        else:
            obj = cls(mod.FakeTruth(truth_vs), fake_ref, confident)
        labels = list(obj.label_variants(
            cand_vs, mod.Range(mod.CHROM, start, start + 60)))
        metrics = getattr(obj, "metrics", None)
        outs.append(([_label_fields(lab) for lab in labels],
                     metrics.as_dict() if metrics is not None else None,
                     [lab.label_for_alt_alleles([0]) for lab in labels]))
    assert outs[0] == outs[1]
    assert outs[0][0]


def test_labeling_metrics_fields_and_sum():
    """LabelingMetrics: the same fields in the same order, and the
    haplotype labeler's metrics add up across calls alike."""
    assert [f.name for f in dataclasses.fields(thl.LabelingMetrics)] == \
        [f.name for f in dataclasses.fields(jhl.LabelingMetrics)]
    ref, start, truths, candidates = _scenario(99)
    outs = []
    for mod, cls in ((test_haplotype_labeler, jhl.HaplotypeLabeler),
                     (TWINS[test_haplotype_labeler.__name__],
                      thl.HaplotypeLabeler)):
        truth_vs, cand_vs, fake_ref = _build(mod, ref, start, truths,
                                             candidates)
        labeler = mod.make_labeler(truth_vs, ref_bases=ref, ref_start=start)
        for _ in range(3):
            list(labeler.label_variants(cand_vs, mod.Range(
                mod.CHROM, start, start + 60)))
        outs.append(labeler.metrics.as_dict())
    assert outs[0] == outs[1]
    assert outs[0]["n_candidate_variant_sites"] > 0


def test_make_labeler_dispatch_matches_jax(tmp_path):
    """make_labeler builds the same class for every labeler_algorithm,
    with and without confident regions."""
    from deepvariant_tpu_torch.make_examples.core import MakeExamplesOptions
    from deepvariant_tpu_torch.testing import synthetic
    from torch_port_util import write_stage1_inputs

    from deepvariant_tpu.io.fasta import FastaReader as JFasta
    from deepvariant_tpu_torch.io.fasta import FastaReader

    sample = synthetic.synthetic_sample(1, (("chr1", 1500),))
    paths = write_stage1_inputs(sample, tmp_path)
    paths.update(synthetic.write_truth_inputs(sample, str(tmp_path)))
    for algorithm in ("haplotype_labeler", "positional_labeler",
                      "customized_classes_labeler", "soft_labeler",
                      "combined_labeler"):
        for confident in (paths["confident"], ""):
            options = MakeExamplesOptions(
                truth_variants_filename=paths["truth"],
                confident_regions_filename=confident,
                labeler_algorithm=algorithm)
            ours = tvl.make_labeler(options, FastaReader(paths["ref"]))
            theirs = jvl.make_labeler(to_package(options, JAX),
                                      JFasta(paths["ref"]))
            assert type(ours).__name__ == type(theirs).__name__
    with pytest.raises(ValueError, match="unknown labeler_algorithm"):
        tvl.make_labeler(MakeExamplesOptions(
            truth_variants_filename=paths["truth"],
            labeler_algorithm="bogus"), FastaReader(paths["ref"]))
    assert os.path.exists(paths["truth"] + ".tbi")
