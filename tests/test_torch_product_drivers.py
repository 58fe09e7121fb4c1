"""The port's multi-sample command lines against the JAX package's:
`scripts/multisample_make_examples.py` (trio, somatic, pangenome) and the
one-step product scripts `run_deeptrio.py`, `run_deepsomatic.py` and
`run_pangenome_aware_deepvariant.py`.

Held: the CLI's examples, candidates and gVCF TFRecords (uncompressed)
and a GBZ panel's BAM byte for byte; each script with `--device cpu` and
one checkpoint that the port writes and both packages read (the port's
`save_variables` of `random_flax_variables`, as
tests/test_torch_run_deepvariant.py does; no example_info.json beside
it, so one checkpoint serves 100, 140 and 200 rows) against the JAX
script: the stage-1 examples record for record and the VCF text equal.
The JAX scripts build their CNN in bfloat16, which runs only on a TPU;
here their `create_model` makes the float32 model, as the port's CPU
path runs, and one jitted forward per shape serves every call (the
patches live in this file; the JAX package is read, not edited). The
flags the JAX scripts accept and read nowhere are refused by the port,
each beside a pin of the JAX behaviour: the JAX script's stage-1
examples and its stage-2 and stage-3 command lines are the same with the
flag as without it. A missing card raises before stage 1.
"""

import gzip
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from deepvariant_tpu.calling import call_variants as jcv
from deepvariant_tpu.models import inception_v3 as jax_iv3
from deepvariant_tpu.scripts import call_variants as jcv_cli
from deepvariant_tpu.scripts import multisample_make_examples as jms_cli
from deepvariant_tpu.scripts import run_deepsomatic as jsom
from deepvariant_tpu.scripts import run_deeptrio as jtrio
from deepvariant_tpu.scripts import run_pangenome_aware_deepvariant as jpan
from deepvariant_tpu_torch.io.tfrecord import TFRecordReader
from deepvariant_tpu_torch.models import inception_v3 as iv3
from deepvariant_tpu_torch.models.checkpoint import save_variables
from deepvariant_tpu_torch.scripts import multisample_make_examples as tms_cli
from deepvariant_tpu_torch.scripts import run_deepsomatic as tsom
from deepvariant_tpu_torch.scripts import run_deeptrio as ttrio
from deepvariant_tpu_torch.scripts import run_pangenome_aware_deepvariant \
    as tpan
from deepvariant_tpu_torch.testing import synthetic
from torch_multisample_util import (
    read_bytes,
    write_family,
    write_pangenome,
    write_tumor_normal,
)
from torch_port_util import random_flax_variables

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

BATCH = 8
# The scripts run the realigner (the port's is Python): a short region.
REGIONS = "chr1:100-500"
UNREAD = r"Queue 3 \(unread product-driver options\)"


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("scripts")
    family, _ = write_family(d / "family")
    pair, data = write_tumor_normal(d / "pair")
    pangenome, _ = write_pangenome(d / "pangenome")
    pon = synthetic.write_vcf_inputs(data["normal"], str(d / "pair"),
                                     population=True)["population"]
    model = iv3.InceptionV3(7)
    model.load_state_dict(iv3.from_flax_variables(
        random_flax_variables(7, seed=4)))
    checkpoint = str(d / "ckpt" / "model.msgpack")
    save_variables(checkpoint, model)
    return dict(family=family, pair=dict(pair, pon=pon),
                pangenome=pangenome, checkpoint=checkpoint, dir=str(d))


# -- the multisample_make_examples CLI ---------------------------------------

def _cli_argv(inputs, case, out):
    f, s, g = inputs["family"], inputs["pair"], inputs["pangenome"]
    files = ["--examples", os.path.join(out, "ex.tfrecord"),
             "--candidates", os.path.join(out, "cand.tfrecord"),
             "--gvcf", os.path.join(out, "gvcf.tfrecord")]
    trio = ["trio", "--ref", f["ref"], "--reads_child", f["child"],
            "--reads_parent1", f["parent1"], "--reads_parent2",
            f["parent2"]] + files
    somatic = ["somatic", "--ref", s["ref"], "--reads_tumor", s["tumor"]] \
        + files
    pangenome = ["pangenome", "--ref", g["ref"], "--reads", g["reads"]] \
        + files
    return {
        "trio": trio + ["--no-realign_reads"],
        "trio-realigned": trio + ["--regions", "chr1:100-400"],
        "trio-shard-1-of-2": trio + ["--no-realign_reads", "--num_shards",
                                     "2", "--task", "1"],
        "somatic": somatic + ["--reads_normal", s["normal"],
                              "--no-realign_reads"],
        "somatic-tumor-only": somatic + ["--no-realign_reads"],
        "pangenome-bam": pangenome + ["--pangenome", g["panel_bam"],
                                      "--no-realign_reads"],
        "pangenome-gbz-regions": pangenome + [
            "--pangenome", g["panel_gbz"], "--no-realign_reads",
            "--regions", "chr1:500-2500"],
        "pangenome-blank-snp-all-haplotypes": pangenome + [
            "--pangenome", g["panel_bam"], "--no-realign_reads",
            "--variant_types_to_blank", "SNP",
            "--no-keep_only_window_spanning_haplotypes"],
        "pangenome-chrom-prefix": pangenome + [
            "--pangenome", g["panel_nochr"], "--no-realign_reads",
            "--ref_chrom_prefix", "chr"],
    }[case]


CLI_CASES = ("trio", "trio-realigned", "trio-shard-1-of-2", "somatic",
             "somatic-tumor-only", "pangenome-bam", "pangenome-gbz-regions",
             "pangenome-blank-snp-all-haplotypes", "pangenome-chrom-prefix")


@pytest.mark.parametrize("case", CLI_CASES)
def test_cli_outputs_equal_jax(inputs, tmp_path, case):
    outs = []
    for cli, tag in ((jms_cli, "jax"), (tms_cli, "port")):
        out = str(tmp_path / tag)
        os.makedirs(out)
        assert cli.main(_cli_argv(inputs, case, out)) == 0
        names = sorted(os.listdir(out))
        outs.append((names, {n: read_bytes(os.path.join(out, n))
                             for n in names}))
    assert outs[0][0] == outs[1][0]
    assert outs[0][1] == outs[1][1]
    assert len(list(TFRecordReader(str(tmp_path / "port" / "ex.tfrecord")))
               ) > 0
    if case == "pangenome-gbz-regions":
        assert "ex.panel.bam" in outs[1][0] and "ex.panel.bam.bai" in \
            outs[1][0]


def test_cli_parser_is_the_jax_one():
    def flags(parser):
        subs = parser._subparsers._group_actions[0].choices
        return {name: [(a.dest, a.default, a.choices, a.required)
                       for a in sub._actions]
                for name, sub in subs.items()}

    assert flags(tms_cli.build_parser()) == flags(jms_cli.build_parser())


# -- the scripts, end to end -------------------------------------------------

# For the JAX scripts' call_variants: one float32 model per channel
# count, its variables (the template the checkpoint is read into; their
# shapes do not depend on the image's height or width) made by a jitted
# init, and one jitted forward per model, which compiles once per shape.
_JAX_MODELS = {}
_JAX_FORWARDS = {}


def _float32_create_model(num_channels, height=100, width=221, **_):
    if num_channels not in _JAX_MODELS:
        model = jax_iv3.InceptionV3(dtype=jnp.float32)
        variables = jax.jit(lambda x: model.init(
            jax.random.PRNGKey(0), x, train=False))(
            jnp.zeros((1, height, width, num_channels), jnp.float32))
        _JAX_MODELS[num_channels] = (model, variables)
    return _JAX_MODELS[num_channels]


_PLAIN_PREDICTOR_INIT = jcv.Predictor.__init__


def _shared_forward_init(self, *args, **kwargs):
    _PLAIN_PREDICTOR_INIT(self, *args, **kwargs)
    self._forward = _JAX_FORWARDS.setdefault(id(self.model), self._forward)


def _script_argv(inputs, script, out, device=True):
    f, s, g = inputs["family"], inputs["pair"], inputs["pangenome"]
    ckpt = inputs["checkpoint"]
    argv = {
        "deeptrio": [
            "--ref", f["ref"], "--reads_child", f["child"],
            "--reads_parent1", f["parent1"], "--reads_parent2", f["parent2"],
            "--output_vcf_child", os.path.join(out, "child.vcf.gz"),
            "--output_vcf_parent1", os.path.join(out, "parent1.vcf.gz"),
            "--output_vcf_parent2", os.path.join(out, "parent2.vcf.gz"),
            "--checkpoint_child", ckpt, "--checkpoint_parent", ckpt],
        "deepsomatic": [
            "--ref", s["ref"], "--reads_tumor", s["tumor"],
            "--reads_normal", s["normal"], "--pon_filtering", s["pon"],
            "--output_vcf", os.path.join(out, "somatic.vcf.gz"),
            "--checkpoint", ckpt],
        "deepsomatic-tumor-only": [
            "--ref", s["ref"], "--reads_tumor", s["tumor"],
            "--output_vcf", os.path.join(out, "somatic.vcf.gz"),
            "--checkpoint", ckpt],
        "pangenome-gbz": [
            "--ref", g["ref"], "--reads", g["reads"],
            "--pangenome", g["panel_gbz"],
            "--output_vcf", os.path.join(out, "pangenome.vcf.gz"),
            "--checkpoint", ckpt],
    }[script]
    argv += ["--batch_size", str(BATCH), "--regions", REGIONS,
             "--intermediate_results_dir", os.path.join(out, "work")]
    return argv + (["--device", "cpu"] if device else [])


SCRIPTS = {"deeptrio": (jtrio, ttrio), "deepsomatic": (jsom, tsom),
           "deepsomatic-tumor-only": (jsom, tsom),
           "pangenome-gbz": (jpan, tpan)}


@pytest.fixture(scope="module")
def script_runs(inputs):
    """Each script once per package: {script: {"jax"|"port": out dir}}."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcv_cli, "create_model", _float32_create_model)
        mp.setattr(jcv.Predictor, "__init__", _shared_forward_init)
        for script, (jax_script, port_script) in SCRIPTS.items():
            runs[script] = {}
            for tag, module, device in (("jax", jax_script, False),
                                        ("port", port_script, True)):
                out = os.path.join(inputs["dir"], script, tag)
                os.makedirs(out)
                assert module.main(_script_argv(inputs, script, out,
                                                device)) == 0
                runs[script][tag] = out
    return runs


def _gunzip(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def _vcfs(out):
    return sorted(n for n in os.listdir(out) if n.endswith(".vcf.gz"))


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_script_vcfs_equal_jax(script_runs, script):
    runs = script_runs[script]
    names = _vcfs(runs["port"])
    assert names == _vcfs(runs["jax"])
    assert len(names) == (3 if script == "deeptrio" else 1)
    for name in names:
        got = _gunzip(os.path.join(runs["port"], name)).decode()
        want = _gunzip(os.path.join(runs["jax"], name)).decode()
        assert got == want, name
        assert sum(not line.startswith("#") for line in got.splitlines()
                   ) > 2
    if script == "deepsomatic":
        assert "PON" in got


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_script_examples_equal_jax(script_runs, script):
    """Stage 1 of each target: the same records and example_info.json;
    the stacked heights are the script's (140 rows for every DeepTrio
    target, 200 for the pairs, 100 for the tumour alone)."""
    import json

    runs = script_runs[script]
    work = {tag: os.path.join(runs[tag], "work") for tag in runs}
    names = sorted(n for n in os.listdir(work["port"])
                   if n.startswith("make_examples_") and n.endswith(".gz"))
    assert names == sorted(n for n in os.listdir(work["jax"])
                           if n.startswith("make_examples_")
                           and n.endswith(".gz"))
    heights = {"deeptrio": 140, "deepsomatic": 200,
               "deepsomatic-tumor-only": 100, "pangenome-gbz": 200}
    for name in names:
        got = list(TFRecordReader(os.path.join(work["port"], name)))
        assert got == list(TFRecordReader(os.path.join(work["jax"], name)))
        assert len(got) > 0
        with open(os.path.join(work["port"], name + ".example_info.json")
                  ) as a, open(os.path.join(
                      work["jax"], name + ".example_info.json")) as b:
            info = json.load(a)
            assert info == json.load(b)
        assert info["shape"] == [heights[script], 221, 7]


# -- the flags the JAX scripts accept and read nowhere ----------------------

REFUSED = [
    ("deeptrio", ["--num_shards", "2"]),
    ("deepsomatic", ["--num_shards", "3"]),
    ("deepsomatic", ["--model_type", "WGS_TUMOR_ONLY"]),
    ("deepsomatic", ["--filter_low_vaf_candidates"]),
    ("deepsomatic-tumor-only", ["--filter_low_vaf_candidates"]),
    ("pangenome-gbz", ["--num_shards", "2"]),
    ("pangenome-gbz", ["--model_type", "WES"]),
]


def _jax_stage1_and_commands(module, argv, monkeypatch, out):
    """The JAX script's stage-1 examples (records of every examples file)
    and the argv it gives call_variants and postprocess_variants, which
    are stubbed."""
    calls = []
    monkeypatch.setattr(jcv_cli, "main",
                        lambda a: calls.append(("cv", list(a))) or 0)
    from deepvariant_tpu.scripts import postprocess_variants as jpp_cli

    monkeypatch.setattr(jpp_cli, "main",
                        lambda a: calls.append(("pp", list(a))) or 0)
    assert module.main(argv) == 0
    work = os.path.join(out, "work")
    examples = {n: list(TFRecordReader(os.path.join(work, n)))
                for n in sorted(os.listdir(work)) if n.endswith(".gz")}
    return examples, calls


@pytest.mark.parametrize("script,flag", REFUSED,
                         ids=[f"{d}{''.join(f)}" for d, f in REFUSED])
def test_unread_flags_are_refused(inputs, tmp_path, monkeypatch, script,
                                  flag):
    jax_script, port_script = SCRIPTS[script]
    plain = _script_argv(inputs, script, str(tmp_path / "plain"), False)
    flagged = _script_argv(inputs, script, str(tmp_path / "flagged"), False)
    ex_plain, calls_plain = _jax_stage1_and_commands(
        jax_script, plain, monkeypatch, str(tmp_path / "plain"))
    ex_flag, calls_flag = _jax_stage1_and_commands(
        jax_script, flagged + flag, monkeypatch, str(tmp_path / "flagged"))
    assert ex_flag == ex_plain and sum(map(len, ex_plain.values())) > 0
    assert [(k, [a.replace("flagged", "plain") for a in argv])
            for k, argv in calls_flag] == calls_plain
    with pytest.raises(NotImplementedError, match=UNREAD):
        port_script.main(_script_argv(inputs, script,
                                      str(tmp_path / "port")) + flag)
    assert not os.path.exists(tmp_path / "port")


def test_pangenome_trim_never_reaches_the_builders(inputs, tmp_path):
    """The pangenome script sets trim_reads_for_pileup=True; both
    packages' multi-sample builders are made without it, so the
    examples are those of trim_reads_for_pileup=False."""
    from torch_multisample_util import JAX, PORT, run_multisample

    g = inputs["pangenome"]
    samples = [dict(role="pangenome", reads_filename=g["panel_bam"],
                    keep_only_window_spanning_reads=True,
                    channels_to_blank=(7, 9, 10, 2, 3)),
               dict(role="reads", reads_filename=g["reads"])]
    outs = {}
    for package in (JAX, PORT):
        for trim in (False, True):
            outs[package, trim] = run_multisample(
                package, tmp_path / f"{package}{trim}",
                dict(reads_filename=g["reads"], ref_filename=g["ref"],
                     realigner_enabled=False, trim_reads_for_pileup=trim,
                     regions=[REGIONS]), samples, 1)[0]
    assert outs[JAX, True] == outs[JAX, False] == outs[PORT, True] == \
        outs[PORT, False]


# -- the card and the parsers -------------------------------------------------

@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_a_missing_card_raises_before_stage_1(inputs, tmp_path, monkeypatch,
                                              script):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        SCRIPTS[script][1].main(_script_argv(inputs, script, str(tmp_path),
                                             device=False))
    assert not os.path.exists(tmp_path / "work")


@pytest.mark.parametrize("script", sorted(set(SCRIPTS) - {
    "deepsomatic-tumor-only"}))
def test_parser_is_the_jax_one_plus_device(script):
    def flags(parser):
        return [(a.dest, a.default, a.choices, a.required)
                for a in parser._actions]

    jax_script, port_script = SCRIPTS[script]
    got = flags(port_script.build_parser())
    assert got[:-1] == flags(jax_script.build_parser())
    assert got[-1] == ("device", "cuda", None, False)
