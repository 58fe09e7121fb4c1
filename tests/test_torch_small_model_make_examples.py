"""The small model inside make_examples and the pipeline: the port
against the JAX package, on the CPU.

One seeded sample (`stage1_sample`, its truth VCF and BED). Held, all
byte for byte (host code in both packages):
  * the runner with the gate (the untrained seeded numpy init, a bundle
    that accepts single alleles and not pairs, and a bundle the port
    trained on this sample's training rows): the small-model CVO
    TFRecord, the candidates, the remaining plans, or the host-painted
    examples, and the counts;
  * training mode with `--write_small_model_examples`: the training-row
    TFRecord, and the labeled examples beside it;
  * the two command lines with the small-model flags;
  * `run_deepvariant --call_small_model_examples --device cpu`, staged
    and `--stream`: stage 1's examples and small-model CVOs are the JAX
    make_examples CLI's, the VCF is the JAX postprocess CLI's over the
    port's CNN CVOs and the small-model CVOs, and the streamed VCF is the
    staged one. The checkpoint's head has zero weights and a bias, so
    the CNN's probabilities do not depend on the batch and the two
    routes agree exactly;
  * the refusals: the small-model options the JAX package reads
    nowhere, at other values than their defaults, and training rows
    with --phase_reads, which raise IndexError in the JAX package
    (pinned).
"""

import gzip
import os

import numpy as np
import pytest
import torch

from deepvariant_tpu.make_examples import core as jcore
from deepvariant_tpu.scripts import make_examples as jme_cli
from deepvariant_tpu.scripts import postprocess_variants as jpp_cli
from deepvariant_tpu_torch.core.sharded_files import glob_sharded_inputs
from deepvariant_tpu_torch.io import flax_msgpack
from deepvariant_tpu_torch.io.tfrecord import TFRecordReader
from deepvariant_tpu_torch.make_examples import core as tcore
from deepvariant_tpu_torch.make_examples.pileup import WGS_CHANNELS
from deepvariant_tpu_torch.models import inception_v3 as iv3
from deepvariant_tpu_torch.models.checkpoint import save_variables
from deepvariant_tpu_torch.scripts import make_examples as tme_cli
from deepvariant_tpu_torch.scripts import run_deepvariant as rd
from deepvariant_tpu_torch.small_model import train as ttrain
from torch_port_util import (
    assert_planned_equal,
    gate_variables,
    random_flax_variables,
    stage1_sample,
    training_inputs,
    wgs_options,
)

torch.set_num_threads(2)
JAX, PORT = "deepvariant_tpu", "deepvariant_tpu_torch"
CORES = {JAX: jcore, PORT: tcore}
CLIS = {JAX: jme_cli, PORT: tme_cli}
REGIONS = ["chr1:1-3,000", "chr2:1-1,500"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The sample's files, a bundle of `gate_variables` with an identity
    normalization (19 features: no context VAFs), and one the port
    trains (the `test` config, on the CPU) on the training rows the JAX
    runner writes for this sample with the command line's default
    context window, 51 (70 features)."""
    directory = tmp_path_factory.mktemp("sm_me")
    paths = training_inputs(stage1_sample(5, (("chr1", 3000),
                                              ("chr2", 1500))), directory)
    pairs = str(directory / "pairs")
    os.makedirs(pairs)
    with open(os.path.join(pairs, "small_model.msgpack"), "wb") as f:
        f.write(flax_msgpack.pack({"params": gate_variables(19),
                                   "mean": np.zeros(19, np.float32),
                                   "scale": np.ones(19, np.float32)}))
    rows = str(directory / "rows.tfrecord")
    options = wgs_options(
        JAX, paths, regions=REGIONS, mode="training",
        truth_variants_filename=paths["truth"],
        confident_regions_filename=paths["confident"],
        write_small_model_examples=True, small_model_examples_filename=rows,
        small_model_vaf_context_window_size=51)
    assert jcore.make_examples_runner(options)["small_model_examples"] > 50
    trained = str(directory / "trained")
    ttrain.train_small_model(rows, trained, ttrain.get_config("test"),
                             device="cpu")
    return dict(paths, pairs=pairs, trained=trained,
                directory=str(directory))


def run(package, inputs, tmp_path, tag, plans=None, **overrides):
    """One runner call; returns (counts, {output: bytes})."""
    files = {name: str(tmp_path / f"{package}.{tag}.{name}.tfrecord")
             for name in ("candidates", "small_model_cvos", "examples",
                          "small_model_examples")}
    options = wgs_options(
        package, inputs, regions=REGIONS,
        candidates_filename=files["candidates"],
        small_model_cvo_filename=files["small_model_cvos"],
        examples_filename="" if plans is not None else files["examples"])
    for key, value in overrides.items():
        assert hasattr(options, key), key
        setattr(options, key, value)
    if options.write_small_model_examples:
        options.small_model_examples_filename = files["small_model_examples"]
    if plans is not None:
        counts = CORES[package].make_examples_runner(
            options, plan_sink=plans.append)
    else:
        counts = CORES[package].make_examples_runner(options)
    out = {}
    for name, path in files.items():
        if os.path.exists(path):
            with open(path, "rb") as f:
                out[name] = f.read()
    return counts, out


GATES = {
    "untrained": dict(),
    "untrained-window-51": dict(small_model_vaf_context_window_size=51,
                                small_model_snp_gq_threshold=10,
                                small_model_indel_gq_threshold=10),
    "pairs": dict(trained_small_model_path="pairs"),
    "trained": dict(trained_small_model_path="trained",
                    small_model_vaf_context_window_size=51,
                    small_model_snp_gq_threshold=35,
                    small_model_indel_gq_threshold=35),
}


@pytest.mark.parametrize("route", ["plans", "examples"])
@pytest.mark.parametrize("gate", list(GATES))
def test_gated_runner_matches_jax(inputs, tmp_path, gate, route):
    overrides = dict(GATES[gate], call_small_model_examples=True)
    if overrides.get("trained_small_model_path"):
        overrides["trained_small_model_path"] = inputs[
            overrides["trained_small_model_path"]]
    results = []
    for package in (JAX, PORT):
        plans = [] if route == "plans" else None
        counts, files = run(package, inputs, tmp_path, gate, plans,
                            **overrides)
        results.append((counts, files, plans))
    (want_counts, want, want_plans), (counts, got, plans) = results
    assert counts == want_counts
    assert got == want
    n_cvos = counts["small_model_cvos"]
    if route == "plans":
        assert_planned_equal(plans, want_plans)
    # The gate accepts some rows and not all.
    assert 0 < n_cvos and counts["examples"] > 0, counts
    _, ungated = run(PORT, inputs, tmp_path, "ungated", None)
    n_rows = len(list(TFRecordReader(str(
        tmp_path / f"{PORT}.ungated.examples.tfrecord"))))
    assert counts["examples"] < n_rows


def test_partially_accepted_multiallelics_keep_their_pairs(inputs,
                                                           tmp_path):
    """With the `pairs` bundle every single-allele row is accepted: the
    plans left are the multiallelic candidates' pairs, one each."""
    plans = []
    counts, _ = run(PORT, inputs, tmp_path, "pairs", plans,
                    call_small_model_examples=True,
                    trained_small_model_path=inputs["pairs"])
    assert plans and all(len(p.alt_indices) == 2 for p in plans)
    assert counts["small_model_cvos"] >= 2 * len(plans)


@pytest.mark.parametrize("window", [0, 51])
@pytest.mark.parametrize("also_gate", [False, True])
def test_training_rows_match_jax(inputs, tmp_path, window, also_gate):
    overrides = dict(
        mode="training", truth_variants_filename=inputs["truth"],
        confident_regions_filename=inputs["confident"],
        write_small_model_examples=True,
        small_model_vaf_context_window_size=window,
        call_small_model_examples=also_gate)
    want_counts, want = run(JAX, inputs, tmp_path, "train", **overrides)
    counts, got = run(PORT, inputs, tmp_path, "train", **overrides)
    assert counts == want_counts and got == want
    assert counts["small_model_examples"] > 50
    x, y = ttrain.read_training_examples(
        str(tmp_path / f"{PORT}.train.small_model_examples.tfrecord"))
    assert x.shape[1] == 19 + (51 if window else 0)
    assert set(y.tolist()) <= {0, 1, 2} and len(set(y.tolist())) > 1


def test_training_rows_with_phase_reads_are_refused(inputs, tmp_path):
    """The JAX runner raises IndexError (its training rows encode the
    haplotype copies without the reads' phases); the port refuses the
    combination before it starts, naming the Queue 3 entry."""
    overrides = dict(
        mode="training", truth_variants_filename=inputs["truth"],
        confident_regions_filename=inputs["confident"],
        write_small_model_examples=True, phase_reads=True)
    with pytest.raises(IndexError):
        run(JAX, inputs, tmp_path, "phased", **overrides)
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP\.md Queue 3.*phase_reads"):
        run(PORT, inputs, tmp_path, "phased", **overrides)
    # The gate itself takes phased reads (the haplotype copies of its
    # rows): the same CVOs as the JAX gate.
    gated = dict(call_small_model_examples=True, phase_reads=True)
    assert run(PORT, inputs, tmp_path, "pg", **gated) == \
        run(JAX, inputs, tmp_path, "pg", **gated)


UNREAD = {
    "call-multiallelics": ("small_model_call_multiallelics", False),
    "emit-all-candidates": ("small_model_emit_all_candidates", True),
    "inference-batch-size": ("small_model_inference_batch_size", 64),
}


@pytest.mark.parametrize("name", list(UNREAD))
def test_unread_small_model_options_are_refused(inputs, tmp_path, name):
    """The JAX package accepts these and its gate never reads them: the
    JAX runner's outputs do not change. The port runs their defaults
    and refuses any other value by name."""
    key, value = UNREAD[name]
    gate = dict(call_small_model_examples=True)
    default = run(JAX, inputs, tmp_path, "default", **gate)
    assert run(JAX, inputs, tmp_path, name, **gate, **{key: value}) == \
        default
    with pytest.raises(NotImplementedError,
                       match=rf"{key}.*ROADMAP\.md Queue 3"):
        run(PORT, inputs, tmp_path, name, **gate, **{key: value})
    assert tcore.UNREAD_SMALL_MODEL_OPTIONS[key] == \
        getattr(jcore.MakeExamplesOptions(), key)


def cli_files(package, inputs, out_dir, flags):
    os.makedirs(out_dir, exist_ok=True)
    files = {name: os.path.join(out_dir, f"{name}.tfrecord@2")
             for name in ("examples", "small_model_cvos")}
    for task in range(2):
        assert CLIS[package].main([
            "--mode", "calling", "--ref", inputs["ref"],
            "--reads", inputs["reads"], "--examples", files["examples"],
            "--small_model_cvo_records", files["small_model_cvos"],
            "--num_shards", "2", "--task", str(task), "--no-realign_reads",
            "--regions", " ".join(REGIONS)] + flags) == 0
    out = {}
    for name, spec in files.items():
        for path in glob_sharded_inputs(spec):
            with open(path, "rb") as f:
                out.setdefault(name, []).append(f.read())
    return out


@pytest.mark.parametrize("flags", [
    ["--call_small_model_examples", "--small_model_snp_gq_threshold", "10",
     "--small_model_indel_gq_threshold", "10"],
    ["--call_small_model_examples", "--small_model_snp_gq_threshold", "28",
     "--small_model_vaf_context_window_size", "0"],
    ["--call_small_model_examples", "--trained_small_model_path", "pairs",
     "--small_model_vaf_context_window_size", "0"],
], ids=["default", "thresholds", "bundle"])
def test_cli_matches_jax(inputs, tmp_path, flags):
    flags = [inputs["pairs"] if f == "pairs" else f for f in flags]
    want = cli_files(JAX, inputs, str(tmp_path / "jax"), flags)
    got = cli_files(PORT, inputs, str(tmp_path / "port"), flags)
    assert got == want
    assert sum(len(list(TFRecordReader(p))) for p in glob_sharded_inputs(
        str(tmp_path / "port" / "small_model_cvos.tfrecord@2"))) > 0


# -- run_deepvariant ----------------------------------------------------------

@pytest.fixture(scope="module")
def pipeline(inputs):
    """The port's run_deepvariant, staged and --stream, with the gate on
    the `trained` bundle and a constant-output CNN."""
    variables = random_flax_variables(7, seed=6)
    head = variables["params"]["classification"]
    head["kernel"] = np.zeros_like(head["kernel"])
    head["bias"] = np.array([0.2, 1.5, 0.4], np.float32)
    model = iv3.InceptionV3(7)
    model.load_state_dict(iv3.from_flax_variables(variables))
    checkpoint = os.path.join(inputs["directory"], "ckpt")
    save_variables(os.path.join(checkpoint, "model.msgpack"), model,
                   {"shape": [100, 221, 7], "channels": WGS_CHANNELS})
    out = {}
    for name, more in (("staged", []), ("stream", ["--stream"])):
        directory = os.path.join(inputs["directory"], name)
        vcf = os.path.join(inputs["directory"], f"{name}.vcf")
        assert rd.main([
            "--ref", inputs["ref"], "--reads", inputs["reads"],
            "--output_vcf", vcf, "--checkpoint", checkpoint,
            "--device", "cpu", "--batch_size", "8", "--num_shards", "2",
            "--regions", " ".join(REGIONS),
            "--intermediate_results_dir", directory,
            "--call_small_model_examples",
            "--trained_small_model_path", inputs["trained"],
            "--make_examples_extra_args",
            "small_model_snp_gq_threshold=35,"
            "small_model_indel_gq_threshold=35", *more]) == 0
        out[name] = dict(vcf=vcf, dir=directory)
    return out


def test_pipeline_stage1_is_the_jax_cli_s(inputs, pipeline, tmp_path):
    staged = pipeline["staged"]["dir"]
    examples = str(tmp_path / "ex.tfrecord@2.gz")
    cvos = str(tmp_path / "sm.tfrecord@2.gz")
    for task in range(2):
        assert jme_cli.main([
            "--mode", "calling", "--ref", inputs["ref"],
            "--reads", inputs["reads"], "--examples", examples,
            "--num_shards", "2", "--sample_name", "default",
            "--model_preset", "WGS", "--regions", " ".join(REGIONS),
            "--call_small_model_examples",
            "--small_model_cvo_records", cvos,
            "--trained_small_model_path", inputs["trained"],
            "--small_model_snp_gq_threshold", "35",
            "--small_model_indel_gq_threshold", "35",
            "--task", str(task)]) == 0
    n = 0
    for name, want_spec in (("make_examples", examples),
                            ("small_model_cvos", cvos)):
        got = glob_sharded_inputs(os.path.join(staged,
                                               f"{name}.tfrecord@2.gz"))
        want = glob_sharded_inputs(want_spec)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            with gzip.open(g) as a, gzip.open(w) as b:
                assert a.read() == b.read()
            n += len(list(TFRecordReader(g)))
    assert n > 20


def test_pipeline_vcf_is_the_jax_postprocess_s(inputs, pipeline, tmp_path):
    """Staged: the JAX postprocess CLI over the port's two CVO files
    writes the port's VCF. Streamed: the same VCF, byte for byte."""
    staged = pipeline["staged"]["dir"]
    vcf = str(tmp_path / "jax.vcf")
    assert jpp_cli.main([
        "--ref", inputs["ref"],
        "--infile", os.path.join(staged, "call_variants_output.tfrecord.gz"),
        "--small_model_cvo_records",
        os.path.join(staged, "small_model_cvos.tfrecord@2.gz"),
        "--outfile", vcf, "--sample_name", "default"]) == 0
    with open(vcf) as a, open(pipeline["staged"]["vcf"]) as b:
        want, got = a.read(), b.read()
    assert got == want
    with open(pipeline["stream"]["vcf"]) as f:
        assert f.read() == got
    records = [line for line in got.splitlines() if not line.startswith("#")]
    assert len(records) > 10
