"""run_oracle_inference of the port against the JAX package's, on the CPU.

A seeded sample with `synthetic.write_truth_inputs`' truth VCF and
confident BED. Both run training-mode make_examples in 2 shards
and then labeled_examples_to_vcf: the oracle VCF, its index and the
examples are byte-identical, and every confident truth record that has
a biallelic candidate carries its truth genotype. The extra-args parser
and `--dry_run` are held to the JAX command's.
"""

import gzip
import os

import pytest
import torch

from deepvariant_tpu.scripts import run_oracle_inference as joracle
from deepvariant_tpu_torch.io.vcf import VcfReader
from deepvariant_tpu_torch.scripts import run_oracle_inference as toracle
from torch_port_util import stage1_sample, training_inputs

torch.set_num_threads(2)
COMMANDS = {"jax": joracle, "port": toracle}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    directory = tmp_path_factory.mktemp("oracle")
    paths = training_inputs(stage1_sample(9, (("chr1", 2500),
                                              ("chr2", 1500))), directory)
    return dict(paths, directory=str(directory))


def argv(inputs, name, *more):
    d = os.path.join(inputs["directory"], name)
    return ["--model_type", "WGS", "--ref", inputs["ref"],
            "--reads", inputs["reads"],
            "--output_vcf", os.path.join(d, "oracle.vcf.gz"),
            "--truth_variants", inputs["truth"],
            "--confident_regions", inputs["confident"],
            "--intermediate_results_dir", os.path.join(d, "inter"),
            "--logging_dir", os.path.join(d, "logs"), *more]


@pytest.fixture(scope="module")
def oracles(inputs):
    """Both packages' commands, 2 shards, the positional labeler and a sample name,
    with one make_examples flag through the extra args."""
    out = {}
    for name, command in COMMANDS.items():
        assert command.main(argv(
            inputs, name, "--num_shards", "2",
            "--labeler_algorithm", "positional_labeler",
            "--sample_name", "oracle_sample",
            "--make_examples_extra_args",
            "realign_reads=false,min_base_quality=12")) == 0
        out[name] = os.path.join(inputs["directory"], name)
    return out


def test_oracle_vcf_equals_the_jax_command_s(oracles):
    for suffix in ("oracle.vcf.gz", "oracle.vcf.gz.tbi"):
        with open(os.path.join(oracles["port"], suffix), "rb") as a, \
                open(os.path.join(oracles["jax"], suffix), "rb") as b:
            assert a.read() == b.read(), suffix
    for shard in range(2):
        name = f"make_examples.tfrecord-0000{shard}-of-00002.gz"
        with gzip.open(os.path.join(oracles["port"], "inter", name)) as a, \
                gzip.open(os.path.join(oracles["jax"], "inter", name)) as b:
            assert a.read() == b.read(), name
    assert os.path.exists(os.path.join(oracles["port"], "logs",
                                       "make_examples.log"))


def test_oracle_calls_carry_the_truth_genotypes(inputs, oracles):
    """The labels are the truth: a confident truth record that has a
    candidate at its site is called with its alleles, but where the
    candidate is multiallelic (the record kept is one alt set's)."""
    confident = []
    with open(inputs["confident"]) as f:
        for line in f:
            name, start, end = line.split()[:3]
            confident.append((name, int(start), int(end)))

    def inside(v):
        return any(n == v.reference_name and s <= v.start < e
                   for n, s, e in confident)

    def alleles(v):
        bases = [v.reference_bases] + list(v.alternate_bases)
        return sorted(bases[i] for i in v.calls[0].genotype)

    truth = {}
    with VcfReader(inputs["truth"]) as reader:
        for v in reader:
            if inside(v) and "RefCall" not in (v.filter or []):
                truth[(v.reference_name, v.start)] = alleles(v)
    matched = called = overlap = 0
    with VcfReader(os.path.join(oracles["port"], "oracle.vcf.gz")) as r:
        for v in r:
            called += 1
            assert v.calls[0].call_set_name == "oracle_sample"
            want = truth.get((v.reference_name, v.start))
            if want is None:
                continue
            overlap += 1
            if alleles(v) == want:
                matched += 1
            else:
                # labeled_examples_to_vcf keeps one example per locus: at
                # a multiallelic site its label may cover one alt only.
                assert len(v.alternate_bases) > 1, v
    assert called > 10 and matched >= 0.8 * overlap > 5


@pytest.mark.parametrize("extra", [
    None, "",
    "phase_reads=true,realign_reads=false,min_base_quality=7",
    "regions='chr20:1-5,chr20:9-12'",
    "--sample_name=\"x y\",keep_duplicates=TRUE"])
def test_extra_args_parse_as_the_jax_command_s(extra):
    assert toracle.extra_args_to_argv(extra) == \
        joracle.extra_args_to_argv(extra)
    if extra:
        assert toracle.split_extra_args(extra) == \
            joracle.split_extra_args(extra)


@pytest.mark.parametrize("model_type", ["WGS", "PACBIO", "MASSEQ"])
def test_dry_run_prints_the_jax_commands(inputs, capsys, model_type):
    """`--dry_run` prints the stage commands (the JAX command's, word for
    word), runs nothing and writes no VCF."""
    texts = []
    for name, command in COMMANDS.items():
        assert command.main(argv(
            inputs, f"dry-{name}", "--dry_run", "--num_shards", "3",
            "--regions", "chr1:1-100") + ["--model_type", model_type]) == 0
        text = capsys.readouterr().out.replace(f"dry-{name}", "dry")
        texts.append(text)
        assert not os.path.exists(os.path.join(
            inputs["directory"], f"dry-{name}", "oracle.vcf.gz"))
    assert texts[0] == texts[1]
    assert "--mode training" in texts[1]
    assert "--max_reads_per_partition 1500" in texts[1]
    assert f"--partition_size {25000 if model_type == 'PACBIO' else 1000}" \
        in texts[1]
    assert toracle.build_parser()._actions.__len__() == \
        joracle.build_parser()._actions.__len__()
