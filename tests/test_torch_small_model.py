"""The small model of the port (`deepvariant_tpu_torch/small_model/`)
against the JAX package's, on the CPU.

Feature rows come from the candidates and reads of one seeded sample,
each package reading the files with its own processor, and must be
byte-identical as float32 (host code in both). The gate is numpy in
both packages: its probabilities, CVOs and accepted sets are exact. The
training-example codec is exact. Training differs in arithmetic only
(torch against XLA): one adamw step from JAX's initial weights, carried
across, matches JAX's params and optimizer state to 1e-6; a 30-epoch
run of the `test` config matches the final params to 1e-4 and the train
accuracy exactly. Bundles written by either package load into both
gates.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from deepvariant_tpu.core import types as jt
from deepvariant_tpu.io.tfrecord import TFRecordWriter as JWriter
from deepvariant_tpu.make_examples import core as jcore
from deepvariant_tpu.small_model import features as jfeatures
from deepvariant_tpu.small_model import model as jmodel
from deepvariant_tpu.small_model import train as jtrain
from deepvariant_tpu_torch.core import types as tt
from deepvariant_tpu_torch.io import flax_msgpack
from deepvariant_tpu_torch.make_examples import core as tcore
from deepvariant_tpu_torch.small_model import features as tfeatures
from deepvariant_tpu_torch.small_model import model as tmodel
from deepvariant_tpu_torch.small_model import train as ttrain
from torch_port_util import (
    gate_variables,
    small_model_rows,
    stage1_sample,
    wgs_options,
    write_stage1_inputs,
)

torch.set_num_threads(2)
JAX, PORT = "deepvariant_tpu", "deepvariant_tpu_torch"
CORES = {JAX: jcore, PORT: tcore}
TYPES = {JAX: jt, PORT: tt}
FEATURES = {JAX: jfeatures, PORT: tfeatures}
REGIONS = [("chr1", 0, 2000), ("chr1", 4000, 6000), ("chr2", 0, 3000)]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return write_stage1_inputs(stage1_sample(),
                               tmp_path_factory.mktemp("small_model"))


def region_inputs(package, paths, window):
    """[(candidates, ReadBatch)] of one package over REGIONS, from its
    own processor (the caller fills the context-VAF maps at `window`)."""
    processor = CORES[package].RegionProcessor(wgs_options(
        package, paths, small_model_vaf_context_window_size=window))
    out = []
    for region in REGIONS:
        rng = TYPES[package].Range(*region)
        batch = processor.region_reads(rng)
        candidates, _, _ = processor.candidates_in_region(rng, batch, False)
        out.append((processor, candidates, batch))
    return out


def encode_rows(package, paths, window, haplotypes):
    """Every (candidate, alt set) row of one package, as float32 bytes,
    with the context VAFs the processor's helper gives and, for the
    haplotype copies, the same seeded phases in both packages."""
    factory = FEATURES[package].SmallModelExampleFactory(
        vaf_context_window_size=window, expand_by_haplotype=haplotypes)
    rows = []
    for processor, candidates, batch in region_inputs(package, paths,
                                                      window):
        processor.small_model_factory = factory
        phases = np.random.RandomState(len(batch)).randint(
            0, 3, len(batch)).tolist() if haplotypes else None
        for call in candidates:
            ctx = processor._small_model_context_vafs(call)
            for alt_set in factory.alt_index_sets(call):
                row = factory.encode(call, alt_set, batch, context_vafs=ctx,
                                     read_phases=phases)
                assert row.dtype == np.float32
                rows.append(row.tobytes())
    assert factory.model_feature_names() == \
        jfeatures.SmallModelExampleFactory(
            window, haplotypes).model_feature_names()
    return rows


@pytest.mark.parametrize("window", [0, 51])
@pytest.mark.parametrize("haplotypes", [False, True])
def test_feature_rows_are_byte_identical(paths, window, haplotypes):
    want = encode_rows(JAX, paths, window, haplotypes)
    got = encode_rows(PORT, paths, window, haplotypes)
    assert got == want and len(got) > 80
    width = len(np.frombuffer(got[0], np.float32))
    assert width == 19 + (2 * (window // 2) + 1 if window else 0) + \
        (36 if haplotypes else 0)
    if window:
        # Some context VAF is not zero.
        assert any(np.frombuffer(r, np.float32)[19:19 + 51].any()
                   for r in got)


def test_feature_tables_match():
    assert tfeatures.BASE_FEATURES == jfeatures.BASE_FEATURES
    assert tfeatures.VARIANT_FEATURES == jfeatures.VARIANT_FEATURES
    for values, m in (([], 1), ([3, 4], 1), ([1, 0, 0], 100),
                      ([7, 8, 9], 1)):
        assert tfeatures._mean(values, m) == jfeatures._mean(values, m)


def test_haplotype_copies_without_phases_raise(paths):
    """The JAX factory indexes an empty phase list (IndexError); the
    port's says what is missing."""
    (processor, candidates, batch), = region_inputs(JAX, paths, 0)[:1]
    factory = jfeatures.SmallModelExampleFactory(expand_by_haplotype=True)
    call = candidates[0]
    with pytest.raises(IndexError):
        factory.encode(call, (0,), batch)
    (processor, candidates, batch), = region_inputs(PORT, paths, 0)[:1]
    factory = tfeatures.SmallModelExampleFactory(expand_by_haplotype=True)
    call = candidates[0]
    with pytest.raises(ValueError, match="phases"):
        factory.encode(call, (0,), batch)


def gate_inputs(package, paths):
    """(row meta, rows) of one package over REGIONS."""
    factory = FEATURES[package].SmallModelExampleFactory()
    meta, rows = [], []
    for _, candidates, batch in region_inputs(package, paths, 0):
        for call in candidates:
            for alt_set in factory.alt_index_sets(call):
                meta.append((len(meta), call, alt_set))
                rows.append(factory.encode(call, alt_set, batch))
    return meta, np.stack(rows)


@pytest.mark.parametrize("weights", ["numpy-init", "multiallelic-gate"])
def test_gate_calls_equal(paths, weights):
    """The seeded numpy init (what an untrained gate runs), and weights
    that accept every biallelic row and no multiallelic pair, so a
    multiallelic candidate is accepted for one set and not the other."""
    results = []
    for package, module in ((JAX, jmodel), (PORT, tmodel)):
        meta, rows = gate_inputs(package, paths)
        if weights == "numpy-init":
            model, variables = module.create_small_model(rows.shape[1])
        else:
            model, variables = None, gate_variables(rows.shape[1])
        caller = module.SmallModelVariantCaller(
            model, variables, snp_gq_threshold=20, indel_gq_threshold=25)
        probs = caller.classify(rows)
        # Renumber by candidate so accepted_sets name candidates.
        ids = {}
        meta = [(ids.setdefault(id(call), len(ids)), call, alt_set)
                for _, call, alt_set in meta]
        result = caller.call_variants(meta, rows)
        results.append((probs.tobytes(),
                        [c.encode() for c in result.cvos],
                        result.accepted_sets))
    want, got = results
    assert got == want
    accepted_sets = got[2]
    assert 0 < len(got[1]) < len(meta)
    if weights == "multiallelic-gate":
        by_candidate = {}
        for ci, alt_set in accepted_sets:
            by_candidate.setdefault(ci, []).append(alt_set)
        assert any(len(s) == 2 and (0, 1) not in s
                   for s in by_candidate.values())


def test_threshold_and_numpy_forward_match():
    for probs, threshold in (([0.01, 0.98, 0.01], 15), ([0.4, 0.3, 0.3], 15),
                             ([0.999, 0.0005, 0.0005], 30)):
        assert tmodel.passes_confidence_threshold(probs, threshold) == \
            jmodel.passes_confidence_threshold(probs, threshold)
    _, variables = jmodel.create_small_model(19, hidden_layer_sizes=(16, 8),
                                             seed=4)
    x = np.random.RandomState(0).randint(0, 60, (33, 19)).astype(np.float32)
    assert tmodel.numpy_mlp_forward(variables, x).tobytes() == \
        jmodel.numpy_mlp_forward(variables, x).tobytes()
    # The module computes what numpy computes, to float32 rounding.
    model, tvars = tmodel.create_small_model(19, (16, 8), seed=4)
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(),
                                   jmodel.numpy_mlp_forward(variables, x),
                                   atol=1e-6)
    assert all(np.array_equal(tvars["params"][k][l],
                              variables["params"][k][l])
               for k in variables["params"] for l in ("kernel", "bias"))


def test_weights_carry_across_both_ways():
    _, variables = jmodel.create_small_model(10, (6,), seed=2)
    state = tmodel.to_module_state(variables)
    assert tuple(state["Dense_0.weight"].shape) == (6, 10)
    back = tmodel.to_flax_variables(state)
    for k in variables["params"]:
        for leaf in ("kernel", "bias"):
            assert back["params"][k][leaf].tobytes() == \
                variables["params"][k][leaf].tobytes()
    model = tmodel.SmallModelMLP(10, (6,))
    model.load_state_dict(state)
    assert tmodel.to_flax_variables(model)["params"]["Dense_1"][
        "kernel"].shape == (6, 3)


def test_training_codec_is_byte_identical(tmp_path):
    rng = np.random.RandomState(3)
    for label in (0, 1, 2):
        feats = rng.randint(0, 300, 70).tolist()
        for ids in ((), ("chr1", "1234")):
            want = jtrain.encode_training_example(feats, label, ids)
            got = ttrain.encode_training_example(feats, label, ids)
            assert got == want
            x, y = ttrain.decode_training_example(want)
            jx, jy = jtrain.decode_training_example(got)
            assert x.tobytes() == jx.tobytes() and y == jy == label
    path = write_rows(str(tmp_path / "rows.tfrecord@2"), n=40)
    jx, jy = jtrain.read_training_examples(path)
    tx, ty = ttrain.read_training_examples(path)
    assert tx.tobytes() == jx.tobytes() and ty.tobytes() == jy.tobytes()
    assert tx.shape == (40, 10)
    assert ttrain.get_config("test") == ttrain.SmallModelTrainConfig(
        **vars(jtrain.get_config("test")))
    for name in ("wgs", "pacbio", "ont"):
        assert vars(ttrain.get_config(name)) == vars(jtrain.get_config(name))
    with pytest.raises(ValueError, match="unknown"):
        ttrain.get_config("exome")


def write_rows(spec, n=120, n_features=10, seed=0):
    """Separable training rows (the mean tracks the label), written by
    the JAX package's writer; `spec` may be sharded (@N)."""
    from deepvariant_tpu_torch.core.sharded_files import glob_sharded_inputs

    rng = np.random.RandomState(seed)
    paths = glob_sharded_inputs(spec) if "@" in spec else [spec]
    per = -(-n // len(paths))
    for i, path in enumerate(paths):
        with JWriter(path) as w:
            for _ in range(min(per, n - i * per)):
                label = rng.randint(0, 3)
                feats = rng.randint(0, 20, n_features) + label * 40
                w.write(jtrain.encode_training_example(
                    [int(f) for f in feats], int(label), ids=["c", "1"]))
    return spec


def jax_init(num_features, hidden, seed=0):
    model = jmodel.SmallModelMLP(tuple(hidden))
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, num_features)))
    return model, jax.tree_util.tree_map(np.asarray,
                                         jax.device_get(variables))


def test_one_adamw_step_matches_jax(tmp_path):
    """The JAX package's step (its loss, optax.adamw over the
    non-staircase decay, at the wgs config's rates) and the port's, from
    the same weights on the same batch: params, mu, nu and both counts
    to 1e-6 absolute."""
    config = ttrain.get_config("wgs")
    config.hidden_layer_sizes = (24, 16)
    x, y = jtrain.read_training_examples(write_rows(
        str(tmp_path / "rows.tfrecord"), n=32))
    x = (x - x.mean(axis=0)) / x.std(axis=0)
    jm, init = jax_init(10, config.hidden_layer_sizes)
    steps_per_epoch = 4
    tx = optax.adamw(optax.exponential_decay(
        config.learning_rate, steps_per_epoch,
        config.learning_rate_decay_rate), weight_decay=config.weight_decay)

    def loss_fn(p):
        probs = jm.apply(p, x)
        logp = jnp.log(jnp.clip(probs, 1e-9, 1.0))
        return -(jax.nn.one_hot(y, 3) * logp).sum(axis=-1).mean()

    params = jax.tree_util.tree_map(jnp.asarray, init)
    opt_state = tx.init(params)
    for _ in range(2):  # a second step sees a decayed rate
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

    model = tmodel.SmallModelMLP(10, config.hidden_layer_sizes)
    state = tmodel.to_module_state(init)
    optimizer = ttrain.make_optimizer(config, steps_per_epoch)
    tstate = optimizer.init(state)
    for _ in range(2):
        state, tstate, tloss = ttrain.train_step(
            model, optimizer, state, tstate, torch.from_numpy(x),
            torch.from_numpy(y))
    assert abs(float(tloss) - float(loss)) < 1e-6
    got = tmodel.to_flax_variables(state)["params"]
    adam = opt_state[0]
    for k in params["params"]:
        for leaf, name in (("kernel", "weight"), ("bias", "bias")):
            np.testing.assert_allclose(
                got[k][leaf], np.asarray(params["params"][k][leaf]),
                atol=1e-6, rtol=0)
            for moment in ("mu", "nu"):
                t = tstate["0"][moment][f"{k}.{name}"].numpy()
                j = np.asarray(getattr(adam, moment)["params"][k][leaf])
                np.testing.assert_allclose(t.T if t.ndim == 2 else t, j,
                                           atol=1e-6, rtol=0)
    assert int(tstate["0"]["count"]) == int(adam.count) == 2
    assert int(tstate["2"]["count"]) == int(opt_state[2].count) == 2
    schedule = optax.exponential_decay(1e-4, 7, 0.99)
    ours = ttrain.exponential_decay(1e-4, 7, 0.99)
    for count in (0, 1, 6, 7, 8, 300):
        np.testing.assert_allclose(ours(count), float(schedule(count)),
                                   rtol=1e-6)


def test_training_run_matches_jax(tmp_path):
    """30 epochs of the `test` config (batches of 16, lr 1e-2) over 120
    separable rows, from JAX's init carried across: the final params to
    1e-4 absolute, the train accuracy exactly, the normalization's bytes
    exactly."""
    rows = write_rows(str(tmp_path / "rows.tfrecord"))
    config = jtrain.get_config("test")
    jmetrics = jtrain.train_small_model(rows, str(tmp_path / "jax"), config,
                                        tune_path=rows)
    _, init = jax_init(10, config.hidden_layer_sizes)
    tmetrics = ttrain.train_small_model(
        rows, str(tmp_path / "port"), ttrain.get_config("test"),
        tune_path=rows, device="cpu", initial_variables=init)
    assert tmetrics["train_accuracy"] == jmetrics["train_accuracy"] > 0.9
    assert tmetrics["tune_accuracy"] == jmetrics["tune_accuracy"]
    assert tmetrics["epoch"] == jmetrics["epoch"] == 29
    assert abs(tmetrics["train_loss"] - jmetrics["train_loss"]) < 1e-5
    want = flax_msgpack.unpack(open(tmp_path / "jax" / tmodel.BUNDLE_NAME,
                                    "rb").read())
    got = flax_msgpack.unpack(open(tmp_path / "port" / tmodel.BUNDLE_NAME,
                                   "rb").read())
    assert got["mean"].tobytes() == want["mean"].tobytes()
    assert got["scale"].tobytes() == want["scale"].tobytes()
    for k, layer in want["params"]["params"].items():
        for leaf, value in layer.items():
            np.testing.assert_allclose(got["params"]["params"][k][leaf],
                                       value, atol=1e-4, rtol=0)
    for name in ("jax", "port"):
        with open(tmp_path / name / "small_model.json") as f:
            assert '"hidden_layer_sizes"' in f.read()


def test_small_corpus_and_seeded_init(tmp_path):
    """A corpus smaller than a batch still steps (batch capped at n);
    without initial weights the run draws from its seed: the same seed
    gives the same bundle, another seed another."""
    rows = write_rows(str(tmp_path / "rows.tfrecord"), n=60, n_features=8)
    config = ttrain.SmallModelTrainConfig(
        hidden_layer_sizes=(16,), batch_size=1024, num_epochs=60,
        learning_rate=1e-2)
    metrics = ttrain.train_small_model(rows, str(tmp_path / "a"), config,
                                       device="cpu", seed=1)
    assert metrics["train_accuracy"] > 0.9 and metrics["train_loss"] < 1.0
    ttrain.train_small_model(rows, str(tmp_path / "b"), config,
                             device="cpu", seed=1)
    ttrain.train_small_model(rows, str(tmp_path / "c"), config,
                             device="cpu", seed=2)
    blobs = [open(tmp_path / d / tmodel.BUNDLE_NAME, "rb").read()
             for d in "abc"]
    assert blobs[0] == blobs[1] != blobs[2]
    with pytest.raises(ValueError, match="no training examples"):
        empty = str(tmp_path / "empty.tfrecord")
        JWriter(empty).close()
        ttrain.train_small_model(empty, str(tmp_path / "d"), config,
                                 device="cpu")


def jax_gate_from_bundle(paths, bundle_dir):
    """The JAX processor's gate with `trained_small_model_path`."""
    processor = jcore.RegionProcessor(wgs_options(
        JAX, paths, call_small_model_examples=True,
        trained_small_model_path=bundle_dir))
    return processor.small_model_caller


@pytest.mark.parametrize("writer", [JAX, PORT])
def test_bundles_load_into_both_gates(paths, tmp_path, writer):
    """A bundle trained by `writer` (19 features, the wgs config's
    layers, 1 epoch) loads into both packages' make_examples gates:
    the same weights, mean and scale, the same probabilities."""
    rows = small_model_rows(str(tmp_path / "rows.tfrecord"), n=64)
    config = (jtrain if writer == JAX else ttrain).get_config("wgs")
    config.num_epochs = 1
    out = str(tmp_path / "bundle")
    if writer == JAX:
        jtrain.train_small_model(rows, out, config)
    else:
        ttrain.train_small_model(rows, out, config, device="cpu")
    jgate = jax_gate_from_bundle(paths, out)
    tgate = tcore.RegionProcessor(wgs_options(
        PORT, paths, call_small_model_examples=True,
        trained_small_model_path=out)).small_model_caller
    assert tgate.feature_mean.tobytes() == jgate.feature_mean.tobytes()
    assert tgate.feature_scale.tobytes() == jgate.feature_scale.tobytes()
    for k, layer in jgate.variables["params"].items():
        for leaf, value in layer.items():
            assert np.asarray(tgate.variables["params"][k][leaf]).tobytes() \
                == np.asarray(value).tobytes()
    x, _ = ttrain.read_training_examples(rows)
    assert tgate.classify(x).tobytes() == jgate.classify(x).tobytes()


def test_raw_variables_load_and_bad_bundles_raise(paths, tmp_path):
    """The legacy layout (raw variables, no normalization) loads in both;
    a bundle with other layers is refused by both."""
    _, variables = jmodel.create_small_model(19, seed=5)
    raw = tmp_path / "raw.msgpack"
    raw.write_bytes(serialization.to_bytes(variables))
    jgate = jax_gate_from_bundle(paths, str(raw))
    tgate = tcore.RegionProcessor(wgs_options(
        PORT, paths, call_small_model_examples=True,
        trained_small_model_path=str(raw))).small_model_caller
    assert jgate.feature_mean is None and tgate.feature_mean is None
    assert tgate.variables["params"]["Dense_2"]["kernel"].tobytes() == \
        np.asarray(jgate.variables["params"]["Dense_2"]["kernel"]).tobytes()
    _, other = jmodel.create_small_model(19, hidden_layer_sizes=(8,))
    bad = tmp_path / "bad.msgpack"
    bad.write_bytes(serialization.to_bytes(other))
    with pytest.raises(Exception):
        jax_gate_from_bundle(paths, str(bad))
    with pytest.raises(ValueError, match="layers"):
        tcore.RegionProcessor(wgs_options(
            PORT, paths, call_small_model_examples=True,
            trained_small_model_path=str(bad)))
    assert os.path.exists(raw)
