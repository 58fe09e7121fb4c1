"""The port's make_examples CLI (`scripts/make_examples.py`) against the
JAX package's, on the same seeded BAMs and FASTAs.

Both CLIs run in this process with the same flags; every output they
write is compared byte for byte: the examples TFRecord of every shard,
its example_info.json, the candidates TFRecord and the gVCF TFRecord
(written uncompressed: a `.gz` TFRecord carries its file name and time
in the gzip header). The JAX package runs with its native library
loaded. Refused flags and unknown channels must end both CLIs with the
same exit code and message. Tolerance: none.
"""

import filecmp
import os

import pytest
import torch

from deepvariant_tpu.make_examples import core as jcore
from deepvariant_tpu.scripts import make_examples as jcli
from deepvariant_tpu_torch.make_examples import core as tcore
from deepvariant_tpu_torch.scripts import make_examples as tcli
from deepvariant_tpu_torch.testing import synthetic
from torch_port_util import sparse_sample, write_stage1_inputs

torch.set_num_threads(2)

JAX, PORT = "deepvariant_tpu", "deepvariant_tpu_torch"
CLI = {JAX: jcli, PORT: tcli}
CORE = {JAX: jcore, PORT: tcore}


@pytest.fixture(scope="module")
def short_paths(tmp_path_factory):
    directory = tmp_path_factory.mktemp("short")
    sample = sparse_sample()
    paths = write_stage1_inputs(sample, directory)
    paths.update(synthetic.write_vcf_inputs(sample, str(directory),
                                            population=True))
    return paths


@pytest.fixture(scope="module")
def long_paths(tmp_path_factory):
    sample = synthetic.synthetic_longread_sample(
        5, (("chr1", 6000), ("chr2", 3000)), depth=12, mean_read_length=2000)
    return write_stage1_inputs(sample, tmp_path_factory.mktemp("long"))


# The channels outside the plan painter's that need no aux tag.
HOST_ONLY = ("read_mapping_percent,avg_base_quality,identity,"
             "gap_compressed_identity,gc_content,is_homopolymer,"
             "homopolymer_weighted,blank,mean_coverage,"
             "read_supports_variant_fuzzy,allele_sample_probability")
# The long-read flags of the PACBIO preset, spelled out: the preset sets
# alt_aligned_pileup itself (diff_channels), after the flags.
PACBIO_FLAGS = ["--no-realign_reads", "--phase_reads", "--sort_by_haplotypes",
                "--track_ref_reads", "--add_hp_channel",
                "--pileup_image_width", "147", "--partition_size", "25000",
                "--min_mapping_quality", "1",
                "--vsc_min_fraction_indels", "0.12"]

# name -> (sample, flags, shards)
CASES = {
    "wgs-defaults": ("short", ["--model_preset", "WGS", "--regions",
                               "chr1:1-2,500 chr2:1,001-2,000"], 1),
    "pacbio-defaults": ("long", ["--model_preset", "PACBIO", "--regions",
                                 "chr1:2,001-4,000"], 1),
    "pacbio-base_channels": ("long", PACBIO_FLAGS + [
        "--alt_aligned_pileup", "base_channels",
        "--regions", "chr1:2,001-4,000"], 1),
    "pacbio-rows": ("long", PACBIO_FLAGS + [
        "--alt_aligned_pileup", "rows", "--regions", "chr1:2,001-4,000"], 1),
    "channel-list": ("short", [
        "--model_preset", "WGS", "--no-realign_reads",
        "--channel_list", f"BASE_CHANNELS,insert_size,{HOST_ONLY}",
        "--mean_coverage_per_sample", "21.5,9", "--sort_by_haplotypes",
        "--regions", "chr1:1-2,500"], 1),
    "legacy-channels-hp": ("short", [
        "--no-realign_reads", "--channels", "gc_content,identity",
        "--add_hp_channel", "--add_supporting_other_alt_color",
        "--regions", "chr2"], 1),
    "allele-frequency": ("short", [
        "--model_preset", "WGS", "--use_allele_frequency",
        "--population_vcfs", "{population}", "--regions",
        "chr1:1,001-3,000"], 1),
    "two-shards": ("short", ["--model_preset", "WGS", "--regions",
                             "chr1:1-3,000 chr2"], 2),
}


def run_cli(package, paths, out_dir, flags, shards):
    """Run one package's CLI over every shard; returns the output paths
    (examples spec, candidates spec, gVCF spec)."""
    out = os.path.join(out_dir, package)
    os.makedirs(out, exist_ok=True)
    spec = f"@{shards}" if shards > 1 else ""
    files = [os.path.join(out, f"{name}.tfrecord{spec}")
             for name in ("examples", "candidates", "gvcf")]
    flags = [f.format(**paths) for f in flags]
    for task in range(shards):
        argv = ["--mode", "calling", "--ref", paths["ref"],
                "--reads", paths["reads"], "--examples", files[0],
                "--candidates", files[1], "--gvcf", files[2],
                "--task", str(task)] + flags
        if shards > 1:
            argv += ["--num_shards", str(shards)]
        assert CLI[package].main(argv) == 0
    return files


def shard_files(spec):
    from deepvariant_tpu_torch.core.sharded_files import glob_sharded_inputs

    return glob_sharded_inputs(spec)


@pytest.mark.parametrize("name", list(CASES))
def test_cli_outputs_are_byte_identical_to_jax(name, short_paths, long_paths,
                                               tmp_path):
    sample, flags, shards = CASES[name]
    paths = short_paths if sample == "short" else long_paths
    want = run_cli(JAX, paths, str(tmp_path), flags, shards)
    got = run_cli(PORT, paths, str(tmp_path), flags, shards)
    n_examples = 0
    for g_spec, w_spec in zip(got, want):
        g_files, w_files = shard_files(g_spec), shard_files(w_spec)
        assert len(g_files) == len(w_files) == shards
        for g, w in zip(g_files, w_files):
            assert os.path.getsize(w) > 0, w
            assert filecmp.cmp(g, w, shallow=False), (name, g)
    for g, w in zip(shard_files(got[0]), shard_files(want[0])):
        n_examples += sum(1 for _ in _records(g))
        with open(g + ".example_info.json") as a, \
                open(w + ".example_info.json") as b:
            assert a.read() == b.read()
    assert n_examples >= 4


def _records(path):
    from deepvariant_tpu_torch.io.tfrecord import TFRecordReader

    with TFRecordReader(path) as reader:
        yield from reader


def test_alt_modes_follow_the_preset_as_in_jax(long_paths, tmp_path):
    """`--model_preset PACBIO` sets alt_aligned_pileup after the flags in
    both CLIs, so `--alt_aligned_pileup rows` ends as diff_channels."""
    for package in (JAX, PORT):
        args = CLI[package].build_parser().parse_args([
            "--mode", "calling", "--ref", long_paths["ref"],
            "--reads", long_paths["reads"], "--examples", "e.tfrecord",
            "--model_preset", "PACBIO", "--alt_aligned_pileup", "rows"])
        options = CLI[package].resolved_options_from_args(args)
        assert options.pileup_options.alt_aligned_pileup == "diff_channels"


def test_single_row_runs_as_in_jax(long_paths, tmp_path):
    """`single_row` is not among the CLIs' choices (both exit 2 the same
    way, `test_refusals_match_jax`); the runner takes it from the
    options, and both runners write the same bytes."""
    written = []
    for package in (JAX, PORT):
        args = CLI[package].build_parser().parse_args([
            "--mode", "calling", "--ref", long_paths["ref"],
            "--reads", long_paths["reads"],
            "--examples", str(tmp_path / f"{package}.tfrecord"),
            "--regions", "chr1:2,001-4,000"] + PACBIO_FLAGS)
        options = CLI[package].resolved_options_from_args(args)
        options.pileup_options.alt_aligned_pileup = "single_row"
        counts = CORE[package].make_examples_runner(options)
        assert counts["examples"] >= 4
        written.append(options.examples_filename)
    assert filecmp.cmp(*written, shallow=False)
    with open(written[0] + ".example_info.json") as a, \
            open(written[1] + ".example_info.json") as b:
        assert a.read() == b.read()


REFUSALS = {
    "stream-examples": ["--stream_examples"],
    "shm-prefix": ["--shm_prefix", "/dev/shm/x"],
    "unknown-channel": ["--channel_list", "read_base,no_such_channel"],
    "unknown-legacy-channel": ["--channels", "gc_content,nope"],
    "allele-frequency-without-vcfs": ["--use_allele_frequency"],
    "invalid-options": ["--gvcf_gq_binsize", "0"],
    "importer-without-proposed": ["--variant_caller",
                                  "vcf_candidate_importer"],
    "single-row": ["--alt_aligned_pileup", "single_row"],
    "missing-flag": None,
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_match_jax(name, short_paths, capsys):
    """The same exit code and message from both CLIs: SystemExit with a
    message (exit 1) for refused flags and unknown channels, argparse's
    exit 2 for a value outside a flag's choices or a missing flag."""
    results = []
    for package in (JAX, PORT):
        base = ["--mode", "calling", "--ref", short_paths["ref"],
                "--reads", short_paths["reads"]]
        if REFUSALS[name] is None:
            argv = base
        else:
            argv = base + ["--examples", "e.tfrecord"] + REFUSALS[name]
        with pytest.raises(SystemExit) as raised:
            CLI[package].main(argv)
        code = raised.value.code
        err = capsys.readouterr().err
        results.append((str(code).replace(JAX + ".", PORT + "."), err))
    assert results[0] == results[1]
    code, err = results[1]
    if name in ("single-row", "missing-flag"):
        assert code == "2" and "error:" in err
    else:
        assert len(code) > 10 and not err


@pytest.mark.parametrize("flag", [["--denovo_regions", "chr1:1-10"]])
def test_unported_options_raise_naming_roadmap(flag, short_paths, tmp_path):
    argv = ["--mode", "calling", "--ref", short_paths["ref"],
            "--reads", short_paths["reads"],
            "--examples", str(tmp_path / "e.tfrecord")] + flag
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md Queue 1"):
        tcli.main(argv)


def test_parsers_match_jax():
    """Every flag, with its default and choices, in the same order."""
    def flags(parser):
        return [(a.dest, a.default, a.choices, a.required, a.nargs)
                for a in parser._actions]

    assert flags(tcli.build_parser()) == flags(jcli.build_parser())


def test_example_shape_helpers_match_jax(short_paths, tmp_path):
    """`shape_from_examples_path` on what the CLI wrote (an `@N` spec, a
    glob, a plain path), on an empty file and on a missing one, and
    `example_image_shape` on an example without the field."""
    from deepvariant_tpu.io import examples as jex
    from deepvariant_tpu_torch.io import examples as tex
    from deepvariant_tpu_torch.io.tfrecord import TFRecordWriter

    files = run_cli(PORT, short_paths, str(tmp_path),
                    ["--no-realign_reads", "--regions", "chr2"], 2)
    empty = str(tmp_path / "empty.tfrecord")
    TFRecordWriter(empty).close()
    for spec in (files[0], files[0].replace("@2", "-*-of-00002"),
                 shard_files(files[0])[1], empty):
        assert tex.shape_from_examples_path(spec) == \
            jex.shape_from_examples_path(spec)
    assert tex.shape_from_examples_path(files[0]) == [100, 221, 7]
    assert tex.shape_from_examples_path(empty) is None
    for module in (jex, tex):
        with pytest.raises(FileNotFoundError, match="no examples matched"):
            module.shape_from_examples_path(str(tmp_path / "none-*.tfrecord"))
        with pytest.raises(ValueError, match="image/shape"):
            module.example_image_shape({"locus": [b"chr1:1-1"]})
