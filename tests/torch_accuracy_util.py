"""Shared pieces of the accuracy-driver port tests
(tests/test_torch_accuracy_*.py): both packages' drivers pointed at the
same seeded stand-ins (`deepvariant_tpu_torch.testing.accuracy_inputs`),
the tiny twin model patched into both packages' `create_model` at every
site the drivers reach, a driver run in either package, and the stage by
stage comparison of two work directories.

The JAX drivers rely on the JAX simulators' default template, a BAM
of the reference's test data; `patch_both` points those defaults (the config
classes, wrapped with `functools.partial`) at the seeded short-read
template, which the port's drivers name explicitly
(`accuracy_sim.DEFAULT_TEMPLATE`). Constants the port adds to a driver
(accuracy_chr20's SECOND_FOLD and TUNE_BP, the JAX script's literals)
stay at their defaults, which equal the JAX literals.

Tolerances (`assert_workdirs_equal`): simulated corpora (BAM, index,
truth VCF, BED), labeled and calling TFRecords, example_info, labeling
metrics, dataset configs, corpus counts and the oracle's VCF are equal
byte for byte or record by record; CVO probabilities within 1e-5
(float32 twins in both packages); the model's VCFs are compared through
the F1 JSON and the fn audit, which must be equal. Trained states:
`step` equal, and every other leaf's L2 distance within 1e-2 of the
L2 norm of its training update (the trained value less the initial one:
the twin's weights and statistics, zero for the optimizer's state),
plus 1e-6 per element. tests/test_torch_train_loop.py holds each leaf
to 1e-5 relative, on 17x23 images; the drivers' 100x147 to 300x221
pileups sum thousands of products into each gradient, and over their
1-5 steps a fold the two packages' float32 sums part by up to 1.6e-4
of a leaf (measured), up to 2.2e-3 of the leaf's update (the momentum
trace of the stem's kernel); an update computed otherwise (a step
missed, another rate or loss) moves the distance to a tenth of the
update or more."""

import contextlib
import functools
import importlib
import io
import json
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepvariant_tpu_torch.core.types import CallVariantsOutput
from deepvariant_tpu_torch.io import flax_msgpack, tfrecord
from deepvariant_tpu_torch.models import inception_v3 as iv3
from deepvariant_tpu_torch.testing import accuracy_inputs
from torch_train_util import JaxTwin, TorchTwin, flat

JAX, PORT = "deepvariant_tpu", "deepvariant_tpu_torch"
TWIN_SEED = 2
STATE_UPDATE_RTOL, STATE_ATOL = 1e-2, 1e-6
PROB_ATOL = 1e-5
# The drivers' flags of every CPU run: two make_examples workers, one
# epoch at batch 8 (the JAX loop shards batches over 8 CPU devices).
COMMON = ["--num_workers", "2", "--batch_size", "8", "--num_epochs", "1",
          "--device", "cpu"]


def script(package: str, name: str):
    return importlib.import_module(f"{package}.scripts.{name}")


@functools.lru_cache(maxsize=None)
def twin_variables(channels: int, seed: int = TWIN_SEED):
    """JaxTwin's {params, batch_stats} for `channels` input channels,
    with non-trivial running statistics, as numpy float32."""
    variables = JaxTwin().init(jax.random.PRNGKey(seed),
                               jnp.zeros((1, 17, 23, channels)), train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.RandomState(seed)
    stats = variables["batch_stats"]["stem"]["bn"]
    n = stats["mean"].shape[0]
    stats["mean"] = (rng.standard_normal(n) * 0.1).astype(np.float32)
    stats["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return variables


def patch_twins(monkeypatch):
    """create_model in both packages' trainers and checkpoint loaders
    builds the float32 twin with seed-2 weights for the examples'
    channels."""

    def jax_create(c, height=100, width=221, dtype=None, rng=None,
                   bn_momentum=0.9997):
        return (JaxTwin(dtype=jnp.float32, bn_momentum=bn_momentum),
                jax.tree_util.tree_map(jnp.asarray, twin_variables(c)))

    def port_create(c, height=100, width=221, dtype=torch.float32,
                    generator=None, bn_momentum=0.9997, device="cuda"):
        variables = twin_variables(c)
        model = TorchTwin(c, bn_momentum=bn_momentum)
        model.load_state_dict({**iv3.tree_from_flax(variables["params"]),
                               **iv3.tree_from_flax(
                                   variables["batch_stats"])})
        return iv3.prepare_for_inference(model, device, dtype)

    for name in ("training.train", "training.train_resident",
                 "scripts.call_variants"):
        monkeypatch.setattr(importlib.import_module(f"{JAX}.{name}"),
                            "create_model", jax_create)
    for name in ("training.train", "models.checkpoint"):
        monkeypatch.setattr(importlib.import_module(f"{PORT}.{name}"),
                            "create_model", port_create)


def patch_both(monkeypatch, inputs):
    """Both packages' driver constants pointed at `inputs`, the JAX
    simulators' default template at the seeded one, the twins, and the
    JAX loader given EMA weights."""
    constants = accuracy_inputs.driver_constants(inputs)
    for name, values in constants.items():
        for key, value in values.items():
            if not hasattr(script(JAX, name), key):
                continue   # the port's own knobs stay at their defaults
            for package in (JAX, PORT):
                monkeypatch.setattr(script(package, name), key, value)
    template = constants["accuracy_sim"]["DEFAULT_TEMPLATE"]
    monkeypatch.setattr(script(PORT, "accuracy_sim"), "DEFAULT_TEMPLATE",
                        template)
    sim = importlib.import_module(f"{JAX}.training.simulate")
    family = importlib.import_module(f"{JAX}.training.simulate_family")
    monkeypatch.setattr(sim, "SimConfig",
                        functools.partial(sim.SimConfig, **template))
    for cls in ("TrioSimConfig", "SomaticSimConfig"):
        monkeypatch.setattr(family, cls, functools.partial(
            getattr(family, cls), **template))
    patch_twins(monkeypatch)
    patch_jax_loader(monkeypatch)
    return constants


def ema_bundle(snapshot: str, directory: str) -> str:
    """The lean {params, batch_stats} bundle of a trainer checkpoint's
    EMA weights, with its example_info.json, in `directory`."""
    with open(snapshot, "rb") as f:
        tree = flax_msgpack.unpack(f.read())
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "model.msgpack")
    with open(path, "wb") as f:
        f.write(flax_msgpack.pack({"params": tree["ema_params"],
                                   "batch_stats": tree["batch_stats"]}))
    shutil.copy(os.path.join(os.path.dirname(snapshot), "example_info.json"),
                directory)
    return path


def patch_jax_loader(monkeypatch):
    """The JAX package's checkpoint loader, as the drivers reach it,
    given the EMA weights of a trainer checkpoint as a lean bundle.

    That loader tries the lean {params, batch_stats} layout first, and
    flax accepts a trainer checkpoint there (its extra keys are
    ignored), so the JAX package evaluates a trainer checkpoint with
    its raw params whatever `use_ema` says; the port's loader takes
    ema_params, as the JAX code means to (ROADMAP Queue 3, pinned by
    test_torch_train_checkpoint.py). With the bundle both packages call
    with the EMA weights."""
    mod = importlib.import_module(f"{JAX}.scripts.call_variants")
    plain = mod.load_variables_for_examples

    def load(checkpoint, examples_path, use_ema=True):
        path = mod.resolve_checkpoint_path(checkpoint)
        with open(path, "rb") as f:
            has_ema = "ema_params" in flax_msgpack.unpack(f.read())
        if use_ema and has_ema:
            path = ema_bundle(path, tempfile.mkdtemp(prefix="ema-"))
        return plain(path, examples_path, use_ema=use_ema)

    monkeypatch.setattr(mod, "load_variables_for_examples", load)


def run_main(package: str, name: str, argv) -> dict:
    """`main(argv)` of one package's driver; returns the JSON of the last
    line it printed (None when it printed none)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        script(package, name).main(list(argv))
    lines = [line for line in buf.getvalue().splitlines()
             if line.startswith("{")]
    return json.loads(lines[-1]) if lines else None


# File kinds of a driver's work directory (by name). Every file either
# package writes falls in one of them: an unknown file fails the
# comparison.
_BYTES = (".bam", ".bai", ".bed", ".fa", ".fai")
_SKIP_SUFFIXES = (".run_info.json", "history.json")
_MODEL_VCFS = ("out.vcf.gz", "child.vcf.gz", "somatic.vcf.gz")


def _records(path):
    return list(tfrecord.read_tfrecords(path))


def _cvos(path):
    return [CallVariantsOutput.decode(b) for b in _records(path)]


def _relative_json(path, root):
    with open(path) as f:
        text = f.read()
    return json.loads(text.replace(root.rstrip("/") + "/", ""))


def _init_leaf(key, channels):
    """A checkpoint leaf's value before training: the twin's initial
    params (also the EMA's start) and statistics, zero for the
    optimizer's state."""
    variables = twin_variables(channels)
    tree = {"params": variables["params"],
            "ema_params": variables["params"],
            "batch_stats": variables["batch_stats"]}.get(key[0])
    if tree is None:
        return 0.0
    for k in key[1:]:
        tree = tree[k]
    return tree


def assert_states_close(jax_path, port_path, what=""):
    """Two trained checkpoints: the same leaves, `step` equal, and every
    other leaf within STATE_UPDATE_RTOL of its training update, in L2
    (see the module docstring)."""
    with open(jax_path, "rb") as f:
        want = flat(flax_msgpack.unpack(f.read()))
    with open(port_path, "rb") as f:
        got = flat(flax_msgpack.unpack(f.read()))
    assert set(got) == set(want), (what, set(got) ^ set(want))
    with open(os.path.join(os.path.dirname(jax_path),
                           "example_info.json")) as f:
        channels = json.load(f)["shape"][2]
    for key in want:
        g = got[key].astype(np.float64)
        w = want[key].astype(np.float64)
        assert g.shape == w.shape, (what, key)
        if key == ("step",):
            assert int(g) == int(w), (what, key)
            continue
        update = np.linalg.norm(w - _init_leaf(key, channels))
        distance = np.linalg.norm(g - w)
        assert distance <= STATE_UPDATE_RTOL * update + \
            STATE_ATOL * np.sqrt(w.size), (what, key, distance, update)


def assert_workdirs_equal(jax_dir, port_dir, ignore=()):
    """Both runs wrote the same files; each kind compared as the module
    docstring says. `ignore`: relative paths left out (in both)."""
    jax_dir, port_dir = str(jax_dir), str(port_dir)

    def listing(root):
        out = set()
        for dirpath, _, names in os.walk(root):
            for n in names:
                out.add(os.path.relpath(os.path.join(dirpath, n), root))
        return out - set(ignore)

    files = listing(jax_dir)
    assert files == listing(port_dir), files ^ listing(port_dir)
    compared = 0
    for rel in sorted(files):
        a, b = os.path.join(jax_dir, rel), os.path.join(port_dir, rel)
        base = os.path.basename(rel)
        if base.endswith(_SKIP_SUFFIXES):
            continue
        if base.startswith("cvo") and ".tfrecord" in base:
            got, want = _cvos(b), _cvos(a)
            assert [c.variant for c in got] == [c.variant for c in want], rel
            np.testing.assert_allclose(
                [c.genotype_probabilities for c in got],
                [c.genotype_probabilities for c in want], atol=PROB_ATOL,
                err_msg=rel)
        elif base.endswith((".tfrecord.gz", ".tfrecord")):
            assert _records(b) == _records(a), rel
        elif base.endswith(".msgpack"):
            assert_states_close(a, b, rel)
        elif base.endswith(".json"):
            assert _relative_json(b, port_dir) == \
                _relative_json(a, jax_dir), rel
        elif base in _MODEL_VCFS or base in (
                name + ".tbi" for name in _MODEL_VCFS):
            continue
        elif base.endswith((".vcf.gz", ".tbi", ".md")) or \
                base.endswith(_BYTES):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fb.read() == fa.read(), rel
        else:
            raise AssertionError(f"unclassified file {rel}")
        compared += 1
    return compared


def run_both(name, args, tmp_path, ckpt_name="final.msgpack",
             report=None):
    """The port's gen,train,eval and the JAX package's gen,train then
    eval with the port's checkpoint; returns (port JSON, JAX JSON)."""
    pdir, jdir = str(tmp_path / PORT), str(tmp_path / JAX)

    def report_flag(package):
        return (["--report", str(tmp_path / f"{package}.{report}")]
                if report else [])

    port = run_main(PORT, name, ["--workdir", pdir] + args +
                    report_flag(PORT))
    run_main(JAX, name, ["--workdir", jdir, "--stages", "gen,train"] + args)
    ckpt = os.path.join(pdir, "experiment", "checkpoints", ckpt_name)
    want = run_main(JAX, name, ["--workdir", jdir, "--stages", "eval",
                                "--checkpoint", ckpt] + args +
                    report_flag(JAX))
    return port, want
