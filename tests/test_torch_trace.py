"""The port's spans (deepvariant_tpu_torch.utils.trace) and the four that
`make_train_step` opens, on the tiny twin model on the CPU.

Off (no profiler, no `recording()`), a span is one shared no-op: a step
records nothing and opens no `record_function` range. On, a step records
`train.step` around `train.forward`, `train.backward` and
`train.update`, all keyed by the state's step; forward and backward once
per micro-batch. The step's outputs are bit-identical either way. Under
torch.profiler the exported chrome trace holds the `dv.` ranges, nested
as the spans are, and each span's `time.time_ns()` stamps, less the
trace's `baseTimeNanoseconds`, hold its range within 1 ms at each end.
The device numbers of `summary()` are held on events filled by hand (no
CUDA here)."""

import contextlib
import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepvariant_tpu_torch.training import train as port_train
from deepvariant_tpu_torch.training.config import TrainConfig
from deepvariant_tpu_torch.utils import trace
from torch_twin_util import TWIN_SHAPE, TorchTwin

torch.set_num_threads(2)

PHASES = ("train.forward", "train.backward", "train.update")


@pytest.fixture(autouse=True)
def _fresh_recorder():
    trace.reset()
    yield
    trace.reset()


def _twin_step(optimizer="sgd", accum=1):
    cfg = TrainConfig(batch_size=8, optimizer=optimizer,
                      gradient_accumulation_steps=accum, use_ema=True,
                      learning_rate=0.01, weight_decay=1e-3, seed=3)
    torch.manual_seed(0)
    model = TorchTwin(dropout_rate=0.3)
    tx, _ = port_train.make_optimizer(cfg, 10)
    state = port_train.init_state(
        model, port_train.model_variables(model, "cpu"), tx)
    return port_train.make_train_step(model, tx, cfg), state


def _batch(seed=0, n=8):
    g = torch.Generator().manual_seed(seed)
    return {
        "images": torch.randint(0, 256, (n,) + TWIN_SHAPE, generator=g,
                                dtype=torch.uint8),
        "labels": torch.randint(0, 3, (n,), generator=g, dtype=torch.int32),
        "sample_weights": torch.rand(n, generator=g) + 0.5,
        "variant_types": torch.randint(0, 3, (n,), generator=g,
                                       dtype=torch.int32),
    }


def _leaves(tree, prefix=""):
    if torch.is_tensor(tree):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}/{k}"))
    return out


def test_off_span_is_one_shared_noop():
    first = trace.span("a")
    assert trace.span("b", 3) is first
    with first:
        pass
    assert trace.records() == [] and trace.summary() == {}


def test_off_train_step_records_nothing_and_opens_no_range(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    step, state = _twin_step()
    step(state, _batch())
    assert opened == []
    assert trace.records() == [] and trace.summary() == {}


@pytest.mark.parametrize("accum", [1, 2])
def test_recorded_step_nests_its_phases_under_one_identifier(accum):
    step, state = _twin_step(accum=accum)
    state, _, _ = step(state, _batch(0))
    with trace.recording():
        step(state, _batch(1))
    recs = trace.records()
    names = [r.name for r in recs]
    assert names.count("train.step") == 1
    assert names.count("train.forward") == accum
    assert names.count("train.backward") == accum
    assert names.count("train.update") == 1
    # A span is recorded when it closes: the step last, its phases in
    # order before it.
    assert names == ["train.forward", "train.backward"] * accum + [
        "train.update", "train.step"]
    outer = recs[-1]
    assert outer.parent is None and outer.step == 1
    for r in recs[:-1]:
        assert r.parent == "train.step" and r.step == 1
        assert outer.host_start_ns <= r.host_start_ns <= r.host_end_ns \
            <= outer.host_end_ns
        assert r.events is None
    got = trace.summary()
    assert got["train.step"]["calls"] == 1
    assert got["train.forward"]["calls"] == accum
    assert got["train.step"]["host_ms"] >= sum(
        got[p]["host_ms"] for p in PHASES)
    assert got["train.step"]["device_ms"] is None
    assert got["train.step"]["self_ms"] is None


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_outputs_are_bit_identical_with_recording_on_and_off(optimizer):
    runs = []
    for on in (False, True):
        step, state = _twin_step(optimizer)
        losses, cms = [], []
        for s in range(2):
            with trace.recording() if on else contextlib.nullcontext():
                state, loss, cm = step(state, _batch(s))
            losses.append(loss)
            cms.append(cm)
        runs.append((_leaves(state), losses, cms))
    (state0, losses0, cms0), (state1, losses1, cms1) = runs
    assert state0.keys() == state1.keys()
    for k in state0:
        assert torch.equal(state0[k], state1[k]), k
    for a, b in zip(losses0, losses1):
        assert torch.equal(a, b)
    for a, b in zip(cms0, cms1):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert len(trace.summary()) == 4


def _chrome_trace(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return json.load(f)


def test_profiler_trace_holds_the_ranges_inside_the_spans(tmp_path):
    step, state = _twin_step()
    # A profiled step first, so that the measured one finds the
    # profiler's record_function path warm.
    with profile(activities=[ProfilerActivity.CPU]):
        state, _, _ = step(state, _batch(0))
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, _batch(1))
    data = _chrome_trace(prof, tmp_path)
    base = data["baseTimeNanoseconds"]
    ranges = {e["name"]: e for e in data["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e["name"].startswith(trace.PREFIX)}
    assert set(ranges) == {trace.PREFIX + n for n in PHASES + (
        "train.step",)}
    outer = ranges["dv.train.step"]
    for name in PHASES:
        inner = ranges[trace.PREFIX + name]
        assert inner["tid"] == outer["tid"]
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    recs = trace.records()
    assert len(recs) == 4
    for r in recs:
        rng = ranges[trace.PREFIX + r.name]
        start_us = (r.host_start_ns - base) / 1e3
        end_us = (r.host_end_ns - base) / 1e3
        lead = rng["ts"] - start_us
        lag = end_us - (rng["ts"] + rng["dur"])
        assert 0 <= lead <= 1000, (r.name, lead)
        assert 0 <= lag <= 1000, (r.name, lag)


def test_nothing_is_recorded_after_the_profiler_stops():
    step, state = _twin_step()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    state, _, _ = step(state, _batch(0))
    prof.stop()
    assert len(trace.records()) == 4
    step(state, _batch(1))
    assert len(trace.records()) == 4
    assert trace.summary()["train.step"]["calls"] == 1


def test_recording_contexts_nest():
    with trace.recording():
        with trace.recording():
            with trace.span("inner"):
                pass
        with trace.span("outer"):
            pass
    with trace.span("off"):
        pass
    assert [r.name for r in trace.records()] == ["inner", "outer"]


def test_parents_are_per_thread():
    seen = []

    def other():
        with trace.span("worker") as r:
            seen.append(r)

    with trace.recording():
        with trace.span("main", 7):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            with trace.span("child") as child:
                pass
    assert not t.is_alive()
    assert seen[0].parent is None and seen[0].step is None
    assert child.parent == "main" and child.step == 7


def test_cap_folds_records_into_totals_without_losing_calls(monkeypatch):
    monkeypatch.setattr(trace, "RECORDER", trace.Recorder(cap=3))
    step, state = _twin_step(accum=2)
    with trace.recording():
        for s in range(5):
            state, _, _ = step(state, _batch(s))
    assert len(trace.records()) < 5 * 6
    got = trace.summary()
    assert {n: got[n]["calls"] for n in got} == {
        "train.step": 5, "train.forward": 10, "train.backward": 10,
        "train.update": 5}
    trace.reset()
    assert trace.records() == [] and trace.summary() == {}


class _Event:
    """A stand-in for a CUDA timing event at `ms` on the stream."""

    def __init__(self, ms, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.ms - self.ms


def _record(name, parent, start_ms, end_ms, done=True):
    return trace.Record(name, parent, 0, int(start_ms * 1e6),
                        int(end_ms * 1e6) + 500_000,
                        (_Event(start_ms), _Event(end_ms, done)))


def test_summary_gives_device_and_self_ms():
    rec = trace.Recorder(cap=2)
    rec.add(_record("train.forward", "train.step", 1.0, 4.0))
    rec.add(_record("train.backward", "train.step", 4.0, 10.0))
    # Past the cap: an unfinished span stays a record, the rest fold.
    rec.add(_record("train.update", "train.step", 10.0, 11.5, done=False))
    assert [r.name for r in rec.records()] == ["train.update"]
    rec.records()[0].events[1].done = True
    rec.add(_record("train.step", None, 0.0, 12.0))
    got = rec.summary()
    assert got["train.step"]["device_ms"] == pytest.approx(12.0)
    assert got["train.step"]["self_ms"] == pytest.approx(1.5)
    assert got["train.step"]["host_ms"] == pytest.approx(12.5)
    assert got["train.forward"]["self_ms"] == pytest.approx(3.0)
    assert got["train.update"]["device_ms"] == pytest.approx(1.5)
    assert all(v["calls"] == 1 for v in got.values())
