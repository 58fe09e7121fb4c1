"""make_examples in training mode: the port against the JAX package.

A seeded sample, its BAM and CRAM, a truth VCF of its planted variants
(some left out, some added that no read carries, one filtered) and a
BED of confident regions that leaves a stretch out
(`synthetic.write_truth_inputs`). The runner and the CLI label the
candidates with each `labeler_algorithm`, with and without confident
regions and with `--downsample_classes`; the examples (labels included),
the labeled plans and `.labeling_metrics.json` equal the JAX package's
byte for byte, and a CRAM gives what the BAM gives. Then the two
command lines over labeled examples, `labeled_examples_to_vcf` and
`compare_labelers`, against the JAX ones.
"""

import json
import os

import pytest
import torch

from deepvariant_tpu.labeler import compare_labelers as jcompare
from deepvariant_tpu.labeler import labeled_examples_to_vcf as jtovcf
from deepvariant_tpu.make_examples import core as jcore
from deepvariant_tpu.scripts import make_examples as jcli
from deepvariant_tpu_torch.io import examples as example_codec
from deepvariant_tpu_torch.io.tfrecord import read_tfrecords
from deepvariant_tpu_torch.labeler import compare_labelers as tcompare
from deepvariant_tpu_torch.labeler import labeled_examples_to_vcf as ttovcf
from deepvariant_tpu_torch.make_examples import core as tcore
from deepvariant_tpu_torch.scripts import make_examples as tcli
from torch_port_util import (
    assert_planned_equal,
    stage1_sample,
    to_package,
    training_inputs,
    wgs_options,
)

torch.set_num_threads(2)
JAX, PORT = "deepvariant_tpu", "deepvariant_tpu_torch"
CORES = {JAX: jcore, PORT: tcore}
ALGORITHMS = ("haplotype_labeler", "positional_labeler",
              "customized_classes_labeler", "soft_labeler",
              "combined_labeler")
REGIONS = ["chr1:1-2,000", "chr2:1-1,000"]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    sample = stage1_sample(11, (("chr1", 2000), ("chr2", 1000)))
    return training_inputs(sample, tmp_path_factory.mktemp("training"))


def run_training(package, paths, tmp, tag, reads=None, plans=None,
                 **overrides):
    """The WGS runner (realigner off) in training mode; returns (examples
    bytes, labeling metrics text or None)."""
    examples = str(tmp / f"{package}-{tag}.tfrecord")
    options = wgs_options(
        package, dict(paths, reads=reads or paths["reads"]), regions=REGIONS,
        mode="training", truth_variants_filename=paths["truth"],
        confident_regions_filename=paths["confident"],
        examples_filename=examples if plans is None else "")
    for key, value in overrides.items():
        setattr(options, key, value)
    if plans is None:
        CORES[package].make_examples_runner(options)
    else:
        CORES[package].make_examples_runner(options, plan_sink=plans.append)
        return None, None
    metrics = examples + ".labeling_metrics.json"
    return (open(examples, "rb").read(),
            open(metrics).read() if os.path.exists(metrics) else None)


def labels_of(blob_path):
    return [example_codec.parse_example(buf).label
            for buf in read_tfrecords(blob_path)]


@pytest.mark.parametrize("confident", ["confident", "no-confident-regions"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_runner_examples_and_metrics_match_jax(paths, tmp_path, algorithm,
                                               confident):
    overrides = dict(labeler_algorithm=algorithm)
    if confident != "confident":
        overrides["confident_regions_filename"] = ""
    got = run_training(PORT, paths, tmp_path, "t", **overrides)
    want = run_training(JAX, paths, tmp_path, "t", **overrides)
    assert got == want
    assert len(got[0]) > 10000
    labels = labels_of(str(tmp_path / f"{PORT}-t.tfrecord"))
    assert None not in labels and len(set(labels)) > 1
    haplotype = algorithm in ("haplotype_labeler", "soft_labeler",
                              "combined_labeler")
    assert (got[1] is not None) == (haplotype and confident == "confident")
    if got[1] is not None:
        metrics = json.loads(got[1])
        for key in ("n_true_positive_sites", "n_false_positive_sites",
                    "n_false_negative_sites"):
            assert metrics[key] > 0, key


def test_confident_regions_drop_examples(paths, tmp_path):
    """Candidates outside the confident regions make no example."""
    inside = run_training(PORT, paths, tmp_path, "in",
                          labeler_algorithm="positional_labeler")[0]
    everywhere = run_training(PORT, paths, tmp_path, "all",
                              labeler_algorithm="positional_labeler",
                              confident_regions_filename="")[0]
    n_in = len(labels_of(str(tmp_path / f"{PORT}-in.tfrecord")))
    n_all = len(labels_of(str(tmp_path / f"{PORT}-all.tfrecord")))
    assert 0 < n_in < n_all
    assert inside != everywhere


@pytest.mark.parametrize("classes", [[1.0, 0.5, 0.5], [0.2, 1.0, 1.0]])
def test_downsample_classes_match_jax(paths, tmp_path, classes):
    got = run_training(PORT, paths, tmp_path, "ds",
                       downsample_classes=classes)
    assert got == run_training(JAX, paths, tmp_path, "ds",
                               downsample_classes=classes)
    n = len(labels_of(str(tmp_path / f"{PORT}-ds.tfrecord")))
    run_training(PORT, paths, tmp_path, "all")
    assert 0 < n < len(labels_of(str(tmp_path / f"{PORT}-all.tfrecord")))


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_labeled_plans_match_jax(paths, tmp_path, algorithm):
    """The plans of training mode carry the label of their example; the
    port's equal the JAX package's, label and all."""
    got, want = [], []
    run_training(PORT, paths, tmp_path, "p", plans=got,
                 labeler_algorithm=algorithm)
    run_training(JAX, paths, tmp_path, "p", plans=want,
                 labeler_algorithm=algorithm)
    assert len(got) > 20
    assert_planned_equal(got, [to_package(p, PORT) for p in want])
    run_training(PORT, paths, tmp_path, "e", labeler_algorithm=algorithm)
    assert [p.label for p in got] == labels_of(
        str(tmp_path / f"{PORT}-e.tfrecord"))


def test_cram_trains_as_bam(paths, tmp_path):
    """A CRAM of the reads makes the BAM's labeled examples, metrics and
    plans."""
    got = run_training(PORT, paths, tmp_path, "cram", reads=paths["cram"])
    assert got == run_training(PORT, paths, tmp_path, "bam")
    plans, bam_plans = [], []
    run_training(PORT, paths, tmp_path, "cp", reads=paths["cram"],
                 plans=plans)
    run_training(PORT, paths, tmp_path, "bp", plans=bam_plans)
    assert_planned_equal(plans, bam_plans)


def run_cli(cli, paths, out, reads, flags=()):
    """The make_examples CLI in training mode over two shards, the
    examples uncompressed; returns each shard's examples and metrics."""
    os.makedirs(out, exist_ok=True)
    spec = os.path.join(out, "ex.tfrecord@2")
    for task in range(2):
        assert cli.main([
            "--mode", "training", "--ref", paths["ref"], "--reads", reads,
            "--examples", spec, "--truth_variants", paths["truth"],
            "--confident_regions", paths["confident"], "--task", str(task),
            "--num_shards", "2", "--no-realign_reads"] + list(flags)) == 0
    got = []
    for task in range(2):
        path = os.path.join(out, f"ex.tfrecord-{task:05d}-of-00002")
        with open(path, "rb") as f, \
                open(path + ".labeling_metrics.json") as g:
            got.append((f.read(), g.read()))
    return got


@pytest.mark.parametrize("reads", ["bam", "cram"])
def test_cli_training_matches_jax(paths, tmp_path, reads):
    path = paths["reads"] if reads == "bam" else paths["cram"]
    # The JAX package takes no sample name from a CRAM's @RG line.
    flags = ["--sample_name", "synthetic", "--downsample_classes",
             "1.0,0.8,0.8"]
    got = run_cli(tcli, paths, str(tmp_path / "port"), path, flags)
    assert got == run_cli(jcli, paths, str(tmp_path / "jax"), path, flags)
    assert all(len(ex) > 1000 for ex, _ in got)
    if reads == "cram":
        assert run_cli(tcli, paths, str(tmp_path / "port-default"),
                       path) == run_cli(tcli, paths, str(tmp_path / "bam"),
                                        paths["reads"])


def test_cli_training_needs_truth(paths, tmp_path, capsys):
    """The option checks refuse training mode without truth alike."""
    results = []
    for cli in (jcli, tcli):
        with pytest.raises(SystemExit) as raised:
            cli.main(["--mode", "training", "--ref", paths["ref"],
                      "--reads", paths["reads"],
                      "--examples", str(tmp_path / "e.tfrecord")])
        results.append((str(raised.value.code), capsys.readouterr().err))
    assert results[0] == results[1]
    assert "truth" in results[1][0] + results[1][1]


@pytest.fixture(scope="module")
def labeled(paths, tmp_path_factory):
    """Labeled examples of the haplotype and the positional labeler."""
    d = tmp_path_factory.mktemp("labeled")
    out = {}
    for algorithm in ("haplotype_labeler", "positional_labeler"):
        run_training(PORT, paths, d, algorithm, labeler_algorithm=algorithm)
        out[algorithm] = str(d / f"{PORT}-{algorithm}.tfrecord")
    return out


@pytest.mark.parametrize("suffix", [".vcf", ".vcf.gz"])
def test_labeled_examples_to_vcf_matches_jax(paths, labeled, tmp_path,
                                             suffix):
    outs = []
    for name, cli in ((JAX, jtovcf), (PORT, ttovcf)):
        path = str(tmp_path / f"{name}{suffix}")
        assert cli.main(["--examples", labeled["haplotype_labeler"],
                         "--ref", paths["ref"], "--output_vcf", path]) == 0
        files = [path] + ([path + ".tbi"] if suffix.endswith("gz") else [])
        outs.append([open(p, "rb").read() for p in files])
    assert outs[0] == outs[1]
    if suffix == ".vcf":
        body = [line for line in outs[1][0].decode().splitlines()
                if not line.startswith("#")]
        assert len(body) > 20
        assert {line.split("\t")[-1].split(":")[0] for line in body} >= \
            {"0/1", "1/1"}


def test_compare_labelers_matches_jax(labeled, tmp_path):
    outs = []
    for name, cli in ((JAX, jcompare), (PORT, tcompare)):
        path = str(tmp_path / f"{name}.txt")
        assert cli.main([
            "--labeled_examples_a", labeled["haplotype_labeler"],
            "--labeled_examples_b", labeled["positional_labeler"],
            "--output", path]) == 0
        outs.append(open(path).read())
    assert outs[0] == outs[1]
