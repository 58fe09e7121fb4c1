"""At a small size on the CPU, the benchmark's plain reference agrees
with the port's plain versions: the painter byte for byte, the float32
forward and one float32 train step to float32 rounding. (The test imports
both; the reference imports neither the port nor JAX.)"""

import json
import os

import pytest
import torch

from benchmark import harness, plans
from benchmark.drivers import train_step
from benchmark.reference import inception_v3 as ref_net
from benchmark.reference import paint as ref_paint
from benchmark.reference import train as ref_train
from benchmark.weights import seeded_weights

CONFIGS = ("dv_wgs_inception_v3", "dv_pacbio_inception_v3")
TRAFFIC = {"min_reads": 20, "max_reads": 95, "alt_share": 0.5,
           "hom_alt_share": 0.333, "indel_share": 0.5}


def config(name):
    with open(os.path.join(harness.BENCH_DIR, "configs",
                           name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", CONFIGS)
def test_painter_equals_the_ports_plain_painter(name):
    from deepvariant_tpu_torch.make_examples.pileup import PileupOptions
    from deepvariant_tpu_torch.make_examples.pileup_device import (
        make_longread_encode_fn)

    cfg = config(name)
    p = cfg["pileup"]
    stacked = plans.make_plans(24, cfg, TRAFFIC, 99, "cpu")
    names = plans.keys(p)
    port = make_longread_encode_fn(PileupOptions(
        width=p["width"], height=p["height"],
        reference_band_height=p["reference_band_height"],
        channels=tuple(p["channels"]),
        alt_aligned_pileup=p["alt_aligned_pileup"]))
    got = port(*[stacked[k].contiguous() for k in names])
    want = ref_paint.paint(stacked, p["channels"],
                           p["alt_aligned_pileup"] == "diff_channels",
                           ref_paint.Colors(p))
    assert got.shape == want.shape
    assert torch.equal(got, want)


def test_plans_keep_the_work_for_every_seed():
    cfg = config(CONFIGS[0])
    a = plans.make_plans(60, cfg, TRAFFIC, 1, "cpu")
    b = plans.make_plans(60, cfg, TRAFFIC, 2**31 + 5, "cpu")
    assert sorted(a["row_valid"].sum(1).tolist()) == \
        sorted(b["row_valid"].sum(1).tolist())
    assert sorted(a["labels"].tolist()) == sorted(b["labels"].tolist())
    assert not torch.equal(a["bases"], b["bases"])


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_equals_the_ports_float32_model(name):
    cfg = config(name)
    p = cfg["pileup"]
    stacked = plans.make_plans(3, cfg, TRAFFIC, 5, "cpu")
    images = ref_paint.paint(stacked, p["channels"],
                             p["alt_aligned_pileup"] == "diff_channels",
                             ref_paint.Colors(p))
    weights = seeded_weights(images.shape[1:], 5, "cpu")
    from deepvariant_tpu_torch.models.inception_v3 import (
        InceptionV3, normalize_pileup)

    model = InceptionV3(images.shape[-1])
    model.load_state_dict(weights)
    model.eval()

    with torch.no_grad():
        got = model(normalize_pileup(images, torch.float32))
    want = ref_net.probabilities(weights, images)
    assert float((got.double() - want.double()).abs().max()) < 1e-5


@pytest.mark.parametrize("name", CONFIGS)
def test_train_steps_equal_the_ports_float32_steps(name):
    """Two float32 steps on each side: the losses, the first gradient,
    and after each step the parameters, their moving average, batch
    norm's running statistics, the optimizer's moments and the counts of
    predicted classes."""
    from deepvariant_tpu_torch.models.inception_v3 import InceptionV3
    from deepvariant_tpu_torch.training import train as train_lib

    cfg = config(name)
    cfg["training"]["use_mixed_precision"] = False
    cfg["batch_size"] = 4
    data = train_step.corpus(8, cfg, TRAFFIC, 3, "cpu")
    batches = [{k: v[i * 4:(i + 1) * 4] for k, v in data.items()}
               for i in range(2)]
    shape = data["images"].shape[1:]
    weights = seeded_weights(shape, 3, "cpu", bn_bias=train_step.BN_BIAS)
    tc = train_step.train_config(cfg, seed=77)
    model = InceptionV3(shape[2], bn_momentum=tc.bn_momentum)
    model.load_state_dict(weights)
    variables = train_lib.model_variables(model, "cpu")
    tx, _ = train_lib.make_optimizer(tc, 2)
    state = train_lib.init_state(model, variables, tx)
    step = train_lib.make_train_step(model, tx, tc)
    losses, after = [], {}
    for i, b in enumerate(batches):
        state, loss, cms = step(state, b)
        losses.append(float(loss))
        mu, nu = train_step._moments(state["opt_state"], tc.optimizer)
        after[i + 1] = {"params": state["params"],
                        "ema": state["ema_params"],
                        "stats": state["batch_stats"], "mu": mu, "nu": nu,
                        "cm": cms["all"]}
    want = ref_train.train_steps(weights, batches, cfg["training"], 77, 2)
    got = {"losses": losses, "after": after,
           "grads": {k: ref_train.first_gradient(v, cfg["training"])
                     for k, v in after[1]["mu"].items()}}
    assert set(after[2]["nu"]) == set(want["after"][2]["nu"])
    read = train_step.readings(got, want, weights)
    # float32 on both sides at batch 4; the two differ in the order of
    # their float32 sums (batch norm's statistics, the convs), which the
    # early layers amplify: measured up to 0.0064 of the first gradient's
    # worst leaf, 0.16 of Adam's second change on a leaf whose gradient
    # is near 0 (its update is near its sign), 0.0071 by the median leaf.
    assert read["loss_gap"] < 1e-4, read
    assert read["grad_gap"] < 1e-2, read
    assert read["cm1_gap"] == read["cm2_gap"] == 0, read
    for part in ("grad", "change1", "ema1", "stats1", "mu1", "nu1",
                 "change2", "ema2", "stats2", "mu2", "nu2"):
        if f"{part}_diff" in read:
            assert read[f"{part}_diff_median"] < 2e-2, (part, read)
            assert read[f"{part}_diff"] < 0.3, (part, read)
