"""The port's stage 2 (deepvariant_tpu_torch: codecs, checkpoints,
call_variants, the writer pool and the CLI) against the JAX package.

Probabilities are compared to 1e-5: both run InceptionV3 in float32 and
differ only in the order of the conv sums."""

import os

import numpy as np
import pytest
import torch

import flax.serialization
import jax
import jax.numpy as jnp

from deepvariant_tpu.calling import call_variants as jax_cv
from deepvariant_tpu.core import types as jax_types
from deepvariant_tpu.io import examples as jax_examples
from deepvariant_tpu.io import tfrecord as jax_tfrecord
from deepvariant_tpu.models import inception_v3 as jax_iv3
from deepvariant_tpu.scripts import call_variants as jax_cli
from deepvariant_tpu_torch.calling import call_variants as cv
from deepvariant_tpu_torch.calling.cvo_writer import shard_paths
from deepvariant_tpu_torch.core import types
from deepvariant_tpu_torch.core.genomics_math import round_gls
from deepvariant_tpu_torch.io import examples, tfrecord
from deepvariant_tpu_torch.make_examples.pileup import WGS_CHANNELS
from deepvariant_tpu_torch.models import checkpoint
from deepvariant_tpu_torch.models import inception_v3 as iv3
from deepvariant_tpu_torch.scripts import call_variants as cli
from torch_port_util import random_flax_variables

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

SHAPE = (100, 221, 7)


def _variant(mod, i):
    """The same Variant built with either package's types module."""
    alts = [["T"], ["TAC"], ["A", "G"]][i % 3]
    return mod.Variant(
        reference_name="chr20", start=1000 + 7 * i, end=1001 + 7 * i,
        reference_bases="A" if i % 3 != 1 else "AC", alternate_bases=alts,
        names=[f"rs{i}"], quality=3.5 * i, filter=["PASS"],
        info={"DP": [10 + i], "AF": [0.25], "FLAG": [True], "S": ["x"]},
        calls=[mod.VariantCall(call_set_name="s1", genotype=[-1, 1],
                               genotype_likelihood=[-0.1, -2.5],
                               info={"AD": [3, 4], "DP": [7]})],
    )


def _examples(mod, n, seed=5):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        img = rng.randint(0, 255, SHAPE, np.uint8)
        out.append(mod.make_example(
            _variant(types if mod is examples else jax_types, i), img,
            alt_allele_indices=[0] if i % 3 != 2 else [0, 1],
            locus_region=f"chr20:{1001 + 7 * i}-{1002 + 7 * i}",
            label=i % 3))
    return out


def _write(path, records):
    with tfrecord.TFRecordWriter(path) as w:
        for r in records:
            w.write(r)
    return path


@pytest.fixture(scope="module")
def variables():
    return random_flax_variables(SHAPE[2], seed=2)


@pytest.fixture(scope="module")
def port_model(variables):
    model = iv3.InceptionV3(SHAPE[2])
    model.load_state_dict(iv3.from_flax_variables(variables))
    return model


@pytest.fixture(scope="module")
def example_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("examples")
    records = _examples(examples, 11)
    return {n: _write(str(d / f"ex{n}.tfrecord"), records[:n])
            for n in (5, 11)}


@pytest.fixture(scope="module")
def jax_cvos(variables, example_files, tmp_path_factory):
    """JAX call_variants on the 11 examples, float32, run once."""
    out = str(tmp_path_factory.mktemp("jax") / "cvo.tfrecord")
    stats = jax_cv.call_variants(
        example_files[11], out, variables, batch_size=4,
        model=jax_iv3.InceptionV3(dtype=jnp.float32))
    assert stats["num_examples"] == 11
    return list(jax_cv.read_cvos(out))


# ---------------------------------------------------------------------------
# Codecs: byte-identical to the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(3))
def test_variant_and_cvo_encode_byte_identical(i):
    assert _variant(types, i).encode() == _variant(jax_types, i).encode()
    debug = dict(predicted_label=2, has_insertion=True, is_snp=False,
                 true_label=1, logits=[0.5, -1.0, 2.0])
    for with_debug in (False, True):
        port = types.CallVariantsOutput(
            _variant(types, i), [0, 1][: i + 1 if i < 2 else 0],
            [0.25, 0.5, 0.25],
            types.CvoDebugInfo(**debug) if with_debug else None)
        ref = jax_types.CallVariantsOutput(
            _variant(jax_types, i), [0, 1][: i + 1 if i < 2 else 0],
            [0.25, 0.5, 0.25],
            jax_types.CvoDebugInfo(**debug) if with_debug else None)
        assert port.encode() == ref.encode()
        back = types.CallVariantsOutput.decode(ref.encode())
        assert back.encode() == ref.encode()


def test_make_example_and_tfrecord_bytes_identical(tmp_path):
    port, ref = _examples(examples, 3), _examples(jax_examples, 3)
    assert port == ref
    a = _write(str(tmp_path / "port.tfrecord.gz"), port)
    b = str(tmp_path / "jax.tfrecord.gz")
    jax_tfrecord.write_tfrecords(ref, b)
    import gzip
    with gzip.open(a) as fa, gzip.open(b) as fb:
        assert fa.read() == fb.read()  # CRCs included
    with tfrecord.TFRecordReader(a, verify_crc=True) as r:
        parsed = [examples.parse_example(x) for x in r]
    assert [p.variant.encode() for p in parsed] == \
        [_variant(types, i).encode() for i in range(3)]
    assert parsed[2].alt_allele_indices == [0, 1] and parsed[1].label == 1


def test_example_info_round_trip(tmp_path):
    path = str(tmp_path / "ex.tfrecord")
    examples.write_example_info(path, SHAPE, WGS_CHANNELS)
    assert examples.read_example_info(path) == \
        jax_examples.read_example_info(path)


# ---------------------------------------------------------------------------
# call_variants against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,batch", [(5, 8), (11, 4)])
def test_call_variants_matches_jax(port_model, example_files, jax_cvos,
                                   tmp_path, n, batch):
    out = str(tmp_path / "cvo.tfrecord")
    stats = cv.call_variants(example_files[n], out, port_model,
                             batch_size=batch, device="cpu",
                             dtype=torch.float32)
    assert stats["num_examples"] == n and stats["output_paths"] == [out]
    got = list(cv.read_cvos(out))
    want = jax_cvos[:n]
    assert [c.variant.encode() for c in got] == \
        [c.variant.encode() for c in want]
    assert [c.alt_allele_indices for c in got] == \
        [c.alt_allele_indices for c in want]
    p = np.array([c.genotype_probabilities for c in got])
    q = np.array([c.genotype_probabilities for c in want])
    np.testing.assert_allclose(p, q, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(p.argmax(-1), q.argmax(-1))
    for c in got:
        assert c.genotype_probabilities == round_gls(c.genotype_probabilities)


def test_writer_pool_matches_inline(port_model, example_files, tmp_path):
    inline = str(tmp_path / "inline.tfrecord.gz")
    cv.call_variants(example_files[11], inline, port_model, batch_size=4,
                     device="cpu", dtype=torch.float32)
    pooled = str(tmp_path / "pool.tfrecord.gz")
    stats = cv.call_variants(example_files[11], pooled, port_model,
                             batch_size=4, device="cpu",
                             dtype=torch.float32, num_writers=2)
    assert stats["num_examples"] == 11
    assert stats["output_paths"] == shard_paths(pooled, 2)

    def key(c):
        return c.encode()

    assert sorted(map(key, cv.read_cvos(pooled))) == \
        sorted(map(key, cv.read_cvos(inline)))
    for p in stats["output_paths"]:
        starts = [c.variant.start for c in cv.read_cvos(p)]
        assert starts == sorted(starts) and starts


def test_limit_max_batches_and_debug_info(port_model, example_files,
                                          tmp_path):
    out = str(tmp_path / "cvo.tfrecord")
    stats = cv.call_variants(example_files[11], out, port_model,
                             batch_size=4, device="cpu",
                             dtype=torch.float32, max_batches=2, limit=7,
                             include_debug_info=True)
    assert stats["num_examples"] == 7
    got = list(cv.read_cvos(out))
    assert all(c.debug_info is not None for c in got)
    assert [c.debug_info.true_label for c in got] == [i % 3 for i in range(7)]
    assert got[1].debug_info.has_insertion and got[0].debug_info.is_snp
    assert [c.debug_info.predicted_label for c in got] == \
        [int(np.argmax(c.genotype_probabilities)) for c in got]


def test_fast_graph_and_ablation(port_model, example_files, jax_cvos,
                                 tmp_path):
    out = str(tmp_path / "fast.tfrecord")
    cv.call_variants(example_files[5], out, port_model, batch_size=8,
                     device="cpu", dtype=torch.float32, fast_graph=True)
    p = np.array([c.genotype_probabilities for c in cv.read_cvos(out)])
    q = np.array([c.genotype_probabilities for c in jax_cvos[:5]])
    np.testing.assert_allclose(p, q, atol=2e-4, rtol=0)
    six = iv3.InceptionV3(6)
    predictor = cv.Predictor(six, batch_size=2, device="cpu",
                             dtype=torch.float32,
                             ablation_channels=[0, 1, 2, 3, 4, 5])
    images = np.random.RandomState(0).randint(0, 255, (2,) + SHAPE, np.uint8)
    want = cv.Predictor(six, batch_size=2, device="cpu",
                        dtype=torch.float32)(images[..., :6])
    np.testing.assert_array_equal(predictor(images), want)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _scaled(tree, factor):
    return jax.tree_util.tree_map(lambda a: np.asarray(a) * factor, tree)


@pytest.fixture(scope="module")
def checkpoint_layouts(variables):
    """The three layouts the JAX package writes, by flax itself."""
    from deepvariant_tpu.training import train as train_lib
    from deepvariant_tpu.training.config import TrainConfig

    ema = _scaled(variables["params"], 0.5)
    lean = {"params": variables["params"],
            "batch_stats": variables["batch_stats"]}
    snapshot = dict(lean, ema_params=ema, step=jnp.zeros((), jnp.int32))
    tx, _ = train_lib.make_optimizer(TrainConfig(), 100)
    state = train_lib.init_state(None, variables, tx)
    state["ema_params"] = ema
    return {name: flax.serialization.to_bytes(tree) for name, tree in
            [("lean", lean), ("snapshot", snapshot), ("train_state", state)]}


@pytest.mark.parametrize("layout", ["lean", "snapshot", "train_state"])
@pytest.mark.parametrize("use_ema", [True, False])
def test_checkpoint_layouts_load_identically(variables, checkpoint_layouts,
                                             tmp_path, layout, use_ema):
    path = str(tmp_path / "model.msgpack")
    with open(path, "wb") as f:
        f.write(checkpoint_layouts[layout])
    params = variables["params"]
    if use_ema and layout != "lean":
        params = _scaled(params, 0.5)
    want = iv3.from_flax_variables(
        {"params": params, "batch_stats": variables["batch_stats"]})
    model = checkpoint.load_variables_for_shape(
        str(tmp_path), SHAPE, use_ema=use_ema, device="cpu")
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_port_checkpoint_restores_in_flax(port_model, variables, tmp_path):
    path = str(tmp_path / "model.msgpack")
    checkpoint.save_variables(path, port_model,
                              {"shape": list(SHAPE), "channels": WGS_CHANNELS})
    restored = flax.serialization.msgpack_restore(open(path, "rb").read())
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    assert len(leaves) == len(jax.tree_util.tree_leaves(restored))
    for keys, value in leaves:
        got = restored
        for key in keys:
            got = got[key.key]
        np.testing.assert_array_equal(got, value)
    with pytest.raises(SystemExit, match="shape mismatch"):
        checkpoint.load_variables_for_shape(path, (100, 221, 6),
                                            device="cpu")


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_cli_runs_on_cpu_with_jax_exit_codes(port_model, example_files,
                                             tmp_path, capsys):
    ex = example_files[5]
    examples.write_example_info(ex, SHAPE, WGS_CHANNELS)
    ckpt = str(tmp_path / "ckpt" / "model.msgpack")
    checkpoint.save_variables(ckpt, port_model)
    out = str(tmp_path / "cvo.tfrecord.gz")
    base = ["--examples", ex, "--outfile", out, "--batch_size", "4"]
    assert jax_cli.main(base) == 2  # no checkpoint
    base += ["--device", "cpu"]
    assert cli.main(base) == 2
    assert cli.main(base + ["--checkpoint", os.path.dirname(ckpt)]) == 0
    assert "call_variants done: 5 examples" in capsys.readouterr().out
    assert len(list(cv.read_cvos(out))) == 5

    empty = str(tmp_path / "empty.tfrecord")
    _write(empty, [])
    examples.write_example_info(empty, SHAPE, WGS_CHANNELS)
    args = ["--examples", empty, "--outfile", out, "--device", "cpu",
            "--checkpoint", ckpt, "--batch_size", "4"]
    assert cli.main(args) == 0
    assert cli.main(args + ["--no-allow_empty_examples"]) == 1


def test_writer_autodetect_keys_on_device():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert cli.resolve_writer_processes(0, cpu) == 1
    assert cli.resolve_writer_processes(0, cuda) == min(os.cpu_count(), 16)
    assert cli.resolve_writer_processes(40, cpu) == 16


def test_check_example_info(tmp_path):
    path = str(tmp_path / "ex.tfrecord")
    cv.check_example_info(path, SHAPE)  # no sidecar: nothing to check
    examples.write_example_info(path, SHAPE, WGS_CHANNELS)
    cv.check_example_info(path, SHAPE, WGS_CHANNELS)
    with pytest.raises(ValueError, match="shape"):
        cv.check_example_info(path, (100, 221, 6))
    with pytest.raises(ValueError, match="channel"):
        cv.check_example_info(path, SHAPE, WGS_CHANNELS[:-1])
