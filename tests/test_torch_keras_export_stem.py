"""The Keras import, the export of checkpoints and the stem rewrites of
the port, against the JAX package, on the CPU.

  * A seeded keras InceptionV3 built with `weights=None` at 100x221x3
    (TensorFlow, where installed) and the numpy stand-in of
    `synthetic.keras_inception_stand_in` (always) convert to the same
    flax tree in both packages, array for array; the port's float32
    model from that tree is within 5e-4 of keras, and within 1e-5 once
    its 3x3 average pools divide by the unpadded count as keras's do
    (both packages count the padded zeros, as flax does: ROADMAP
    Queue 3).
  * The stem rewrites (space-to-depth, padding the stem's channels,
    both on the folded graph) are exact against the port's plain graph
    in float32, and match the JAX rewrites to 1e-4 (the conv sums'
    order); a 2x2 stem kernel carried across from JAX is the port's,
    exactly. The stem kernels are multiples of 1/8 (and the inputs of
    1/128), so every sum the stem conv forms is exact in float32 in any
    order: the rewritten stem must give the same bits, and everything
    after it then does. `stop_after` gives the JAX shapes.
  * `adapt_input_channels`: the copied slice is JAX's exactly; the new
    slice is drawn from a torch generator and held by its statistics.
  * Exported bundles cross both ways for an SGD checkpoint; the port
    exports an Adam checkpoint, which the JAX export refuses (pinned).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from deepvariant_tpu.models import inception_v3 as jiv3
from deepvariant_tpu.models import keras_import as jki
from deepvariant_tpu.scripts import export_model as jexport
from deepvariant_tpu_torch.io import flax_msgpack
from deepvariant_tpu_torch.models import inception_v3 as tiv3
from deepvariant_tpu_torch.models import keras_import as tki
from deepvariant_tpu_torch.scripts import export_model as texport
from deepvariant_tpu_torch.scripts import import_keras_model as timport
from deepvariant_tpu_torch.testing.synthetic import keras_inception_stand_in
from torch_port_util import random_flax_variables

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
SHAPE = (2, 75, 75, 7)  # odd sides: the space-to-depth pads


def flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from flat(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def assert_trees_equal(got, want):
    got, want = dict(flat(got)), dict(flat(want))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))


# -- the Keras import ---------------------------------------------------------

@pytest.mark.parametrize("num_channels", [3, 7, 2])
@pytest.mark.parametrize("head", [True, False])
def test_stand_in_converts_as_in_jax(num_channels, head):
    keras_model = keras_inception_stand_in(5, head=head)
    got = tki.convert_keras_inception(keras_model, num_channels)
    want = jki.convert_keras_inception(keras_model, num_channels)
    for g, w in zip(got[:2], want[:2]):
        assert_trees_equal(g, w)
    assert (got[2] is None) == (want[2] is None) == (not head)
    if head:
        assert_trees_equal(got[2], want[2])
    assert got[0]["stem1"]["conv"]["kernel"].shape[2] == num_channels
    assert tki.FLAX_CONV_PATHS == jki.FLAX_CONV_PATHS


def test_stand_in_loads_into_the_port_model():
    keras_model = keras_inception_stand_in(6)
    model, variables = tki.load_keras_into_model(
        keras_model, 7, height=75, width=75, device="cpu")
    want_model, want_vars = jki.load_keras_into_flax(keras_model, 7,
                                                     height=75, width=75)
    params, stats, head = tki.convert_keras_inception(keras_model, 7)
    assert_trees_equal(variables["batch_stats"], stats)
    assert_trees_equal(variables["params"]["classification"], head)
    # Everything but the head is keras's; both packages' trees agree.
    want_vars = jax.tree_util.tree_map(np.asarray, want_vars)
    assert_trees_equal(variables, want_vars)
    state = model.state_dict()
    loaded = tiv3.from_flax_variables(variables)
    for key, value in loaded.items():
        assert torch.equal(state[key].cpu(), value), key
    with pytest.raises(ValueError, match="unexpected keras"):
        bad = keras_inception_stand_in(6)
        bad.layers[0].layers = bad.layers[0].layers[:-3]
        tki.convert_keras_inception(bad)


@pytest.fixture(scope="module")
def keras_model():
    tf = pytest.importorskip("tensorflow")
    # Seeds Python, numpy and keras's own generators: the weights are
    # the same whatever ran before in the process.
    tf.keras.utils.set_random_seed(7)
    backbone = tf.keras.applications.InceptionV3(
        include_top=False, weights=None, input_shape=(100, 221, 3),
        pooling="avg")
    hid = tf.keras.layers.Dropout(0.2)(backbone.output)
    out = tf.keras.layers.Dense(3, activation="softmax")(hid)
    return tf.keras.Model(inputs=backbone.input, outputs=out)


def test_keras_model_converts_as_in_jax(keras_model, monkeypatch):
    got = tki.convert_keras_inception(keras_model, 3)
    want = jki.convert_keras_inception(keras_model, 3)
    for g, w in zip(got, want):
        assert_trees_equal(g, w)
    model, _ = tki.load_keras_into_model(keras_model, 3, device="cpu")
    x = np.random.RandomState(0).rand(4, 100, 221, 3).astype(np.float32)
    x = x * 2 - 1
    keras_out = keras_model(x, training=False).numpy()
    with torch.no_grad():
        port_out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(port_out, keras_out, atol=5e-4, rtol=0)
    # What is left is the pools' border: keras's SAME average pool
    # divides by the unpadded count.
    monkeypatch.setattr(tiv3, "_avg_pool_same", lambda t: F.avg_pool2d(
        t, 3, stride=1, padding=1, count_include_pad=False))
    with torch.no_grad():
        keras_pools = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(keras_pools, keras_out, atol=1e-5, rtol=0)
    assert np.abs(port_out - keras_out).max() > 1e-5


def test_import_keras_model_cli_matches_jax(keras_model, tmp_path):
    from deepvariant_tpu.scripts import import_keras_model as jimport

    path = str(tmp_path / "model.keras")
    keras_model.save(path)
    outs = {}
    for name, cli in (("jax", jimport), ("port", timport)):
        out = str(tmp_path / name)
        assert cli.main(["--keras_model", path, "--num_channels", "3",
                         "--channels", "1,2,3", "--height", "75",
                         "--width", "75", "--output_dir", out]) == 0
        with open(os.path.join(out, "model.msgpack"), "rb") as f:
            outs[name] = flax_msgpack.unpack(f.read())
        with open(os.path.join(out, "example_info.json")) as f:
            outs[name + "-info"] = json.load(f)
    assert outs["port-info"] == outs["jax-info"]
    assert_trees_equal(outs["port"], outs["jax"])


def test_import_keras_model_names_tensorflow_when_absent(monkeypatch,
                                                         tmp_path):
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="TensorFlow"):
        timport.main(["--keras_model", "m.h5", "--num_channels", "7",
                      "--output_dir", str(tmp_path)])


# -- the stem rewrites ---------------------------------------------------------

@pytest.fixture(scope="module")
def graphs():
    """Seeded weights in both packages, float32, and a seeded input."""
    variables = random_flax_variables(7, seed=8)
    stem = variables["params"]["stem1"]["conv"]
    stem["kernel"] = dyadic(stem["kernel"])
    model = tiv3.InceptionV3(7)
    model.load_state_dict(tiv3.from_flax_variables(variables))
    model = tiv3.prepare_for_inference(model, "cpu", torch.float32)
    rng = np.random.RandomState(2)
    img = rng.randint(0, 255, SHAPE).astype(np.uint8)
    x = tiv3.normalize_pileup(torch.from_numpy(img), torch.float32)
    with torch.no_grad():
        base = model.logits(x).numpy()
    return dict(variables=variables, model=model, img=img, x=x, base=base)


def dyadic(kernel):
    return (np.round(np.asarray(kernel) * 8) / 8).astype(np.float32)


def logits(model, x):
    with torch.no_grad():
        return model.logits(x).numpy()


def probs(model, x):
    with torch.no_grad():
        return model(x).numpy()


def jax_probs(model, variables, img):
    x = jiv3.normalize_pileup(jnp.asarray(img)).astype(jnp.float32)
    return np.asarray(model.apply(variables, x, train=False))


def padded(img, c=8):
    extra = np.zeros(img.shape[:3] + (c - img.shape[3],), np.uint8)
    return np.concatenate([img, extra], axis=-1)


def test_s2d_stem_is_exact_and_matches_jax(graphs):
    s2d = tiv3.convert_stem_to_s2d(graphs["model"])
    assert s2d.stem_s2d and tuple(s2d.stem1.conv.weight.shape) == \
        (32, 28, 2, 2)
    np.testing.assert_array_equal(logits(s2d, graphs["x"]), graphs["base"])
    jm = jiv3.InceptionV3(dtype=jnp.float32)
    jm2, jv2 = jiv3.convert_stem_to_s2d(jm, graphs["variables"])
    want = jax_probs(jm2, jv2, graphs["img"])
    np.testing.assert_allclose(probs(s2d, graphs["x"]), want, atol=1e-4,
                               rtol=0)
    # JAX's 2x2 kernel carried across is the port's, exactly.
    carried = tiv3.InceptionV3(7, stem_s2d=True)
    carried.load_state_dict(tiv3.from_flax_variables(
        jax.tree_util.tree_map(np.asarray, jv2)))
    assert torch.equal(carried.stem1.conv.weight,
                       s2d.stem1.conv.weight.contiguous())
    with pytest.raises(ValueError, match="3x3"):
        tiv3.convert_stem_to_s2d(s2d)


def test_space_to_depth_packs_as_jax():
    x = np.random.RandomState(0).rand(2, 5, 7, 3).astype(np.float32)
    got = tiv3._space_to_depth_2x2(torch.from_numpy(x)).numpy()
    want = np.asarray(jiv3._space_to_depth_2x2(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


def test_padding_and_s2d_on_the_folded_graph(graphs):
    folded = tiv3.fold_batch_norm(graphs["model"])
    with torch.no_grad():
        folded.stem1.conv.weight.copy_(torch.from_numpy(
            dyadic(folded.stem1.conv.weight.detach())))
    base = logits(folded, graphs["x"])
    x8 = tiv3.normalize_pileup(torch.from_numpy(padded(graphs["img"])),
                               torch.float32)
    pad = tiv3.pad_stem_input_channels(folded, 8)
    np.testing.assert_array_equal(logits(pad, x8), base)
    both = tiv3.convert_stem_to_s2d(pad)
    np.testing.assert_array_equal(logits(both, x8), base)
    jm = jiv3.InceptionV3(dtype=jnp.float32)
    fm, fv = jiv3.fold_batch_norm(jm, graphs["variables"])
    fv["params"]["stem1"]["conv"]["kernel"] = dyadic(
        fv["params"]["stem1"]["conv"]["kernel"])
    m2, v2 = jiv3.convert_stem_to_s2d(fm, jiv3.pad_stem_input_channels(fv, 8))
    np.testing.assert_allclose(probs(both, x8),
                               jax_probs(m2, v2, padded(graphs["img"])),
                               atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="before"):
        tiv3.pad_stem_input_channels(both, 9)


@pytest.mark.parametrize("stop_after", ["stem", "mixed0", "mixed3",
                                        "mixed7", "mixed10", None])
def test_stop_after_gives_the_jax_shapes(graphs, stop_after):
    with torch.no_grad():
        got = graphs["model"].backbone(graphs["x"], stop_after)
    jm = jiv3.InceptionV3(dtype=jnp.float32)
    want = jax.eval_shape(
        lambda x: jm.apply(graphs["variables"], x, False, stop_after,
                           method=jiv3.InceptionV3.backbone),
        jax.ShapeDtypeStruct(SHAPE, jnp.float32))
    assert tuple(got.shape) == tuple(want.shape)


@pytest.mark.parametrize("channels", [4, 7, 9, 40])
def test_adapt_input_channels(graphs, channels):
    """Shrinking keeps JAX's slice; growing keeps the old channels
    exactly and draws the new ones with mean 0 and std sqrt(2/fan_in)
    (within 15% and 0.3 std at 9 channels' 288 draws, tighter at 40)."""
    model = graphs["model"]
    got = tiv3.adapt_input_channels(model, channels,
                                    torch.Generator().manual_seed(1))
    want = jiv3.adapt_input_channels(graphs["variables"]["params"], channels)
    if channels == 7:
        assert got is model
        return
    weight = got.stem1.conv.weight.detach().permute(2, 3, 1, 0).numpy()
    want_kernel = np.asarray(want["stem1"]["conv"]["kernel"])
    assert weight.shape == want_kernel.shape == (3, 3, channels, 32)
    keep = min(channels, 7)
    np.testing.assert_array_equal(weight[:, :, :keep],
                                  want_kernel[:, :, :keep])
    assert got.num_channels == channels
    if channels > 7:
        new = weight[:, :, 7:]
        std = np.sqrt(2.0 / (9 * channels))
        assert abs(new.std() / std - 1) < 0.15
        assert abs(new.mean()) < 0.3 * std
        x = torch.zeros((1, 75, 75, channels))
        assert got.logits(x).shape == (1, 3)


# -- export ----------------------------------------------------------------------

def write_checkpoint(directory, optimizer):
    """A full TrainState of the port's trainer (seeded weights, EMA
    weights that differ from them) and example_info.json beside it."""
    from deepvariant_tpu_torch.training import train as ttrain
    from deepvariant_tpu_torch.training.config import TrainConfig

    variables = random_flax_variables(7, seed=9)
    model = tiv3.InceptionV3(7)
    model.load_state_dict(tiv3.from_flax_variables(variables))
    state_vars = ttrain.model_variables(model, "cpu")
    tx, _ = ttrain.make_optimizer(TrainConfig(optimizer=optimizer), 100)
    state = ttrain.init_state(model, state_vars, tx)
    state["ema_params"] = {k: v * 0.5 for k, v in state["params"].items()}
    path = os.path.join(directory, "ckpt.msgpack")
    ttrain.save_checkpoint(path, state, {"shape": [75, 75, 7],
                                         "channels": [1, 2, 3, 4, 5, 6, 19]})
    return path


@pytest.mark.parametrize("use_ema", [True, False])
def test_sgd_export_crosses_both_ways(tmp_path, use_ema):
    ckpt = write_checkpoint(str(tmp_path), "sgd")
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jexport.export(ckpt, jdir, use_ema=use_ema)
    assert texport.main(["--checkpoint", ckpt, "--output_dir", tdir] +
                        ([] if use_ema else ["--no-use_ema"])) == 0
    bundles = []
    for d in (jdir, tdir):
        with open(os.path.join(d, "model.msgpack"), "rb") as f:
            bundles.append(flax_msgpack.unpack(f.read()))
        with open(os.path.join(d, "example_info.json")) as f:
            assert json.load(f)["shape"] == [75, 75, 7]
    assert_trees_equal(bundles[1], bundles[0])
    stem = bundles[1]["params"]["stem1"]["conv"]["kernel"]
    plain = random_flax_variables(7, seed=9)["params"]["stem1"]["conv"][
        "kernel"]
    np.testing.assert_array_equal(stem, plain * 0.5 if use_ema else plain)
    # Each package loads the other's bundle.
    model, variables, info = texport.load_exported(jdir, device="cpu")
    assert_trees_equal(variables, bundles[0])
    _, jvars, jinfo = jexport.load_exported(tdir)
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, jvars),
                       bundles[1])
    assert info == jinfo
    assert torch.equal(model.stem1.conv.weight.detach().contiguous(),
                       torch.from_numpy(stem).permute(3, 2, 0, 1))


@pytest.mark.parametrize("optimizer", ["adam", "rmsprop"])
def test_port_exports_what_the_jax_export_refuses(tmp_path, optimizer):
    """The JAX export restores against an SGD TrainState template, and an
    Adam or RMSprop optimizer state does not fit it; the port reads the
    checkpoint by its keys and exports its EMA weights."""
    ckpt = write_checkpoint(str(tmp_path), optimizer)
    with pytest.raises(ValueError, match="opt_state"):
        jexport.export(ckpt, str(tmp_path / "jax"))
    out = texport.export(ckpt, str(tmp_path / "port"))
    with open(out, "rb") as f:
        bundle = flax_msgpack.unpack(f.read())
    assert set(bundle) == {"params", "batch_stats"}
    np.testing.assert_array_equal(
        bundle["params"]["stem1"]["conv"]["kernel"],
        random_flax_variables(7, seed=9)["params"]["stem1"]["conv"][
            "kernel"] * 0.5)
