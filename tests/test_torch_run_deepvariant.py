"""The slice as a whole: the port's one-step command,
`scripts/run_deepvariant.py --device cpu`, from a seeded BAM and FASTA
to a VCF and a gVCF, staged and `--stream` (both encoders), held against
the JAX package at the stage boundaries. (The JAX run_deepvariant builds
its CNN in bfloat16, which runs only on a TPU, so its stages are called
one by one with a float32 CNN.)

The sample is the sparse one (a variant every 400-500 bases), a fifth of
`chip_smoke.py` phase 8's, with the WGS preset's defaults (realigner
on). The checkpoint is the port's `save_variables` of
`random_flax_variables`. Held:
  (a) stage 1's examples and gVCF records are the JAX make_examples
      CLI's, shard by shard (decompressed: a `.gz` TFRecord carries its
      file name and time in the gzip header);
  (b) stage 2's CVOs equal the JAX `call_variants` (float32) on those
      examples: variants exact, probabilities to 1e-5 (the conv sums'
      order; `tests/test_torch_call_variants.py`);
  (c) the VCF and the gVCF are byte-identical to the JAX postprocess CLI
      on the port's CVOs and gVCF records (its gVCF merge run contig by
      contig, `torch_port_util.merge_by_contig`);
  (d) the `--stream` VCFs (plans painted, and images painted on the
      workers) equal the staged VCF record for record wherever the
      CVOs' rounded probabilities agree; the records where the CNN's
      1e-5 moved one are counted (none at this size), as
      `tests/test_torch_streaming_vcf.py` does;
and the host-encode stream against the JAX `run_streaming_pipeline(
device_encode=False)` with a float32 JAX `Predictor`, the same way.
"""

import gzip
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepvariant_tpu.calling import call_variants as jcv
from deepvariant_tpu.core import types as jt
from deepvariant_tpu.models import inception_v3 as jax_iv3
from deepvariant_tpu.parallel import stream_pipeline as jsp
from deepvariant_tpu.scripts import call_variants as jcv_cli
from deepvariant_tpu.scripts import make_examples as jme_cli
from deepvariant_tpu.scripts import postprocess_variants as jpp_cli
from deepvariant_tpu.scripts import run_deepvariant as jrd
from deepvariant_tpu_torch.calling.call_variants import read_cvos
from deepvariant_tpu_torch.core.sharded_files import glob_sharded_inputs
from deepvariant_tpu_torch.io.tfrecord import TFRecordReader
from deepvariant_tpu_torch.make_examples.pileup import WGS_CHANNELS
from deepvariant_tpu_torch.models import inception_v3 as iv3
from deepvariant_tpu_torch.models.checkpoint import save_variables
from deepvariant_tpu_torch.parallel import stream_pipeline as sp
from deepvariant_tpu_torch.scripts import make_examples as tme_cli
from deepvariant_tpu_torch.scripts import run_deepvariant as rd
from torch_port_util import (
    merge_by_contig,
    random_flax_variables,
    sparse_sample,
    write_stage1_inputs,
)

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

BATCH = 8
SHARDS = 2


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    directory = tmp_path_factory.mktemp("run_dv")
    paths = write_stage1_inputs(
        sparse_sample(8, (("chr1", 5200), ("chr2", 2800))), directory)
    variables = random_flax_variables(7, seed=4)
    model = iv3.InceptionV3(7)
    model.load_state_dict(iv3.from_flax_variables(variables))
    checkpoint = str(directory / "ckpt")
    save_variables(os.path.join(checkpoint, "model.msgpack"), model,
                   {"shape": [100, 221, 7], "channels": WGS_CHANNELS})
    return dict(paths, checkpoint=checkpoint, directory=str(directory))


def argv(inputs, name, *more):
    return ["--ref", inputs["ref"], "--reads", inputs["reads"],
            "--output_vcf", os.path.join(inputs["directory"], f"{name}.vcf.gz"),
            "--output_gvcf",
            os.path.join(inputs["directory"], f"{name}.g.vcf.gz"),
            "--checkpoint", inputs["checkpoint"], "--device", "cpu",
            "--batch_size", str(BATCH), "--num_shards", str(SHARDS),
            "--intermediate_results_dir",
            os.path.join(inputs["directory"], name), *more]


@pytest.fixture(scope="module")
def staged(inputs):
    """The port's staged run: 2 spawned make_examples shards, the
    call_variants CLI on the CPU, the postprocess CLI with the gVCF."""
    assert rd.main(argv(inputs, "staged")) == 0
    out = os.path.join(inputs["directory"], "staged")
    return dict(
        examples=os.path.join(out, f"make_examples.tfrecord@{SHARDS}.gz"),
        gvcf=os.path.join(out, f"gvcf.tfrecord@{SHARDS}.gz"),
        cvos=os.path.join(out, "call_variants_output.tfrecord.gz"),
        vcf=os.path.join(inputs["directory"], "staged.vcf.gz"),
        gvcf_out=os.path.join(inputs["directory"], "staged.g.vcf.gz"))


def gunzip(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def test_stage1_examples_are_the_jax_cli_s(inputs, staged, tmp_path):
    """(a) The argv that run_deepvariant gives its shards, to the JAX
    make_examples CLI: the same examples and gVCF records, shard by
    shard."""
    examples = str(tmp_path / f"ex.tfrecord@{SHARDS}.gz")
    gvcf = str(tmp_path / f"gvcf.tfrecord@{SHARDS}.gz")
    for task in range(SHARDS):
        assert jme_cli.main([
            "--mode", "calling", "--ref", inputs["ref"],
            "--reads", inputs["reads"], "--examples", examples,
            "--num_shards", str(SHARDS), "--sample_name", "default",
            "--model_preset", "WGS", "--gvcf", gvcf,
            "--task", str(task)]) == 0
    n = 0
    for got_spec, want_spec in ((staged["examples"], examples),
                                (staged["gvcf"], gvcf)):
        got, want = glob_sharded_inputs(got_spec), glob_sharded_inputs(
            want_spec)
        assert len(got) == len(want) == SHARDS
        for g, w in zip(got, want):
            assert gunzip(g) == gunzip(w)
            n += len(list(TFRecordReader(g)))
    with open(glob_sharded_inputs(staged["examples"])[0]
              + ".example_info.json") as a, \
            open(glob_sharded_inputs(examples)[0]
                 + ".example_info.json") as b:
        assert a.read() == b.read()
    assert n > 200


def locus(cvo):
    return (cvo.variant.reference_name, cvo.variant.start, cvo.variant.end,
            tuple(cvo.alt_allele_indices))


def test_cvos_equal_jax_call_variants(inputs, staged, tmp_path):
    """(b) The JAX package's call_variants, float32, on the port's
    examples, with the port's checkpoint read by the JAX loader."""
    _, variables = jcv_cli.load_variables_for_shape(inputs["checkpoint"],
                                                    (100, 221, 7))
    out = str(tmp_path / "jax.cvo.tfrecord")
    stats = jcv.call_variants(staged["examples"], out, variables,
                              batch_size=BATCH,
                              model=jax_iv3.InceptionV3(dtype=jnp.float32))
    want = {locus(c): c for c in (jt.CallVariantsOutput.decode(b)
                                  for b in TFRecordReader(out))}
    got = list(read_cvos(staged["cvos"]))
    assert stats["num_examples"] == len(got) == len(want) >= 20
    for c in got:
        w = want[locus(c)]
        assert c.variant.encode() == w.variant.encode()
        np.testing.assert_allclose(c.genotype_probabilities,
                                   w.genotype_probabilities, atol=1e-5,
                                   rtol=0)
        assert int(np.argmax(c.genotype_probabilities)) == \
            int(np.argmax(w.genotype_probabilities))


def test_vcf_and_gvcf_are_the_jax_postprocess_s(inputs, staged, tmp_path,
                                                monkeypatch):
    """(c) The JAX postprocess CLI on the port's CVOs and gVCF records:
    the same VCF and gVCF bytes, and the same .tbi."""
    merge_by_contig(monkeypatch)
    vcf, gvcf = str(tmp_path / "jax.vcf.gz"), str(tmp_path / "jax.g.vcf.gz")
    assert jpp_cli.main([
        "--ref", inputs["ref"], "--infile", staged["cvos"],
        "--outfile", vcf, "--sample_name", "default",
        "--nonvariant_site_tfrecord_path", staged["gvcf"],
        "--gvcf_outfile", gvcf]) == 0
    for got, want in ((staged["vcf"], vcf), (staged["gvcf_out"], gvcf)):
        for suffix in ("", ".tbi"):
            with open(got + suffix, "rb") as a, open(want + suffix, "rb") as b:
                assert a.read() == b.read(), got + suffix
    assert len(gunzip(staged["gvcf_out"]).splitlines()) > 500


def capture_cvos(monkeypatch, module):
    """The CVOs that `module.run_streaming_pipeline` hands to stage 3, as
    copies (stage 3 writes the calls into them)."""
    seen = []
    plain = module.stream_examples_to_cvos

    def recording(*args, **kwargs):
        result = plain(*args, **kwargs)
        seen.append([type(c).decode(c.encode()) for c in result[0]])
        return result

    monkeypatch.setattr(module, "stream_examples_to_cvos", recording)
    return seen


def records(path):
    lines = gunzip(path).decode().splitlines() if path.endswith(".gz") \
        else open(path).read().splitlines()
    return ([line for line in lines if line.startswith("#")],
            [line for line in lines if not line.startswith("#")])


def assert_same_records(vcf, other_vcf, cvos, other_cvos):
    """The two VCFs have one header and, record by record, the same
    lines except where a CVO of the record's site has other rounded
    probabilities; returns the number of such records."""
    by_locus = {locus(c): c for c in other_cvos}
    assert sorted(by_locus) == sorted(locus(c) for c in cvos)
    moved = {locus(c)[:2] for c in cvos
             if c.genotype_probabilities !=
             by_locus[locus(c)].genotype_probabilities}
    head, lines = records(vcf)
    other_head, other_lines = records(other_vcf)
    assert head == other_head and len(lines) == len(other_lines) > 5
    bites = 0
    for line, other in zip(lines, other_lines):
        if line != other:
            fields = line.split("\t")
            assert (fields[0], int(fields[1]) - 1) in moved, (line, other)
            bites += 1
    return bites


@pytest.mark.parametrize("encoder", ["device", "host"])
def test_stream_vcfs_equal_the_staged_vcf(encoder, inputs, staged,
                                          monkeypatch, capsys):
    """(d) `--stream` with each encoder against the staged run."""
    seen = capture_cvos(monkeypatch, sp)
    assert rd.main(argv(inputs, f"stream-{encoder}", "--stream",
                        "--stream_encoder", encoder)) == 0
    assert f"encoder={encoder}" in capsys.readouterr().out
    (cvos,) = seen
    staged_cvos = list(read_cvos(staged["cvos"]))
    for c in cvos:
        assert abs(sum(c.genotype_probabilities) - 1) < 1e-9
    vcf = os.path.join(inputs["directory"], f"stream-{encoder}.vcf.gz")
    bites = assert_same_records(vcf, staged["vcf"], cvos, staged_cvos)
    assert bites == 0, f"the CNN's 1e-5 bites at {bites} records"
    # The gVCF too: the same records as the staged route's.
    assert records(vcf.replace(".vcf.gz", ".g.vcf.gz")) == \
        records(staged["gvcf_out"])


def test_host_stream_matches_the_jax_host_stream(inputs, tmp_path,
                                                 monkeypatch):
    """The host-encode stream of both packages: workers paint tf.Examples,
    the parent's Predictor (float32 on both sides) classifies them."""
    def options(cli):
        return cli.resolved_options_from_args(cli.build_parser().parse_args([
            "--mode", "calling", "--ref", inputs["ref"],
            "--reads", inputs["reads"], "--examples", "unused",
            "--model_preset", "WGS", "--regions", "chr1 chr2:1-1,500"]))

    port_seen = capture_cvos(monkeypatch, sp)
    jax_seen = capture_cvos(monkeypatch, jsp)
    model = iv3.InceptionV3(7)
    variables = random_flax_variables(7, seed=4)
    model.load_state_dict(iv3.from_flax_variables(variables))
    out = str(tmp_path / "port.vcf")
    got = sp.run_streaming_pipeline(
        options(tme_cli), out, inputs["ref"], model=model, num_workers=2, batch_size=BATCH,
        device="cpu", dtype=torch.float32)
    jout = str(tmp_path / "jax.vcf")
    want = jsp.run_streaming_pipeline(
        options(jme_cli), jout, inputs["ref"], num_workers=2,
        batch_size=BATCH,
        predictor_factory=lambda shape: jcv.Predictor(
            variables, batch_size=BATCH,
            model=jax_iv3.InceptionV3(dtype=jnp.float32)))
    assert got["stream_device_encode"] is want["stream_device_encode"] \
        is False
    assert got["stream_examples"] == want["stream_examples"] >= 10
    (port_cvos,), (jax_cvos,) = port_seen, jax_seen
    for c in port_cvos:
        w = {locus(j): j for j in jax_cvos}[locus(c)]
        assert c.variant.encode() == w.variant.encode()
        np.testing.assert_allclose(c.genotype_probabilities,
                                   w.genotype_probabilities, atol=1e-5,
                                   rtol=0)
    bites = assert_same_records(out, jout, port_cvos, jax_cvos)
    assert bites == 0, f"the CNN's 1e-5 bites at {bites} records"


REFUSALS = {
    "no-checkpoint": ["--stream"],
    "device-encoder-for-host-channels": [
        "--stream", "--stream_encoder", "device",
        "--channel_list", "BASE_CHANNELS,gc_content",
        "--allow_uninitialized_model"],
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_stream_refusals_match_jax(name, inputs, tmp_path):
    """The same SystemExit message as the JAX command, before any worker
    starts."""
    messages = []
    for main, device in ((jrd.main, []), (rd.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as raised:
            main(["--ref", inputs["ref"], "--reads", inputs["reads"],
                  "--output_vcf", str(tmp_path / "x.vcf"),
                  *REFUSALS[name], *device])
        messages.append(str(raised.value.code))
    assert messages[0] == messages[1] and len(messages[0]) > 20


def test_a_missing_card_raises_before_stage_1(inputs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        rd.main(["--ref", inputs["ref"], "--reads", inputs["reads"],
                 "--output_vcf", str(tmp_path / "x.vcf"),
                 "--allow_uninitialized_model"])
    assert not os.path.exists(tmp_path / "intermediate_results_dir")


def test_a_failing_shard_fails_the_run(inputs, tmp_path):
    """An option the port lacks, in a spawned shard: the run raises with
    the shard's NotImplementedError, naming its ROADMAP item."""
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md Queue 1"):
        rd.main(["--ref", inputs["ref"], "--reads", inputs["reads"],
                 "--output_vcf", str(tmp_path / "x.vcf"), "--device", "cpu",
                 "--allow_uninitialized_model", "--num_shards", "2",
                 "--make_examples_extra_args", "denovo_regions=chr1:1-10"])


def test_parser_is_the_jax_one_plus_device():
    def flags(parser):
        return [(a.dest, a.default, a.choices, a.required)
                for a in parser._actions]

    got, want = flags(rd.build_parser()), flags(jrd.build_parser())
    assert got[:-2] == want and got[-2:] == [
        ("make_examples_extra_args", None, None, False),
        ("device", "cuda", None, False)]
