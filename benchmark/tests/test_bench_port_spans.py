"""The readers of the port's spans (`benchmark/port_spans.py` and the
four `*_ms.train` metrics): None on an empty recorder and without the
port's trace module, the right number a step on a recorder filled by
hand, and what a whole small run on the CPU records."""

import sys
import time

import pytest

from benchmark import harness
from deepvariant_tpu_torch.utils import trace

READERS = ("forward_ms.train", "backward_ms.train", "update_ms.train",
           "step_host_ms.train")


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def query(self):
        return True

    def elapsed_time(self, end):
        return end.ms - self.ms


def _span(name, parent, step, start_ms, end_ms, host_ms):
    return trace.Record(name, parent, step, 0, int(host_ms * 1e6),
                        (_Event(start_ms), _Event(end_ms)))


@pytest.fixture
def recorder(monkeypatch):
    rec = trace.Recorder()
    monkeypatch.setattr(trace, "RECORDER", rec)
    return rec


@pytest.mark.parametrize("metric", READERS)
def test_reader_is_none_on_an_empty_recorder(metric, recorder):
    assert harness.metric_reader(metric).read(None) is None


@pytest.mark.parametrize("metric", READERS)
def test_reader_is_none_without_the_port_module(metric, monkeypatch):
    monkeypatch.setitem(sys.modules, "deepvariant_tpu_torch.utils.trace",
                        None)
    assert harness.metric_reader(metric).read(None) is None


def test_readers_give_ms_per_step(recorder):
    # Two steps, the second with two micro-batches.
    for step, micros in ((5, 1), (6, 2)):
        t = 100.0 * step
        for i in range(micros):
            recorder.add(_span("train.forward", "train.step", step, t,
                               t + 10, 11))
            recorder.add(_span("train.backward", "train.step", step,
                               t + 10, t + 30, 2))
            t += 30
        recorder.add(_span("train.update", "train.step", step, t, t + 3,
                           1.5))
        recorder.add(_span("train.step", None, step, 100.0 * step, t + 4,
                           50 + step))
    want = {"forward_ms.train": 30 / 2, "backward_ms.train": 60 / 2,
            "update_ms.train": 6 / 2, "step_host_ms.train": 111 / 2}
    for metric, value in want.items():
        assert harness.metric_reader(metric).read(None) == \
            pytest.approx(value), metric


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.benchmark_spec()["workloads"]])
def test_a_small_cpu_run_records_each_step(cell, recorder):
    c = harness.load_cell(cell)
    c.traffic.update(corpus_examples=12)
    c.config["batch_size"] = 4
    ctx = harness.Context(cell=c, seed=2**31 + 5, seconds=0.5, trace=False,
                          device="cpu", t_process=time.time())
    with trace.recording():
        out = harness.run(ctx)
    got = trace.summary()
    assert got["train.step"]["calls"] == out.attempted + 3
    assert all(got[n]["calls"] == got["train.step"]["calls"]
               for n in ("train.forward", "train.backward", "train.update"))
    assert harness.metric_reader("step_host_ms.train").read(out) > 0
    # No CUDA events on the CPU: no device numbers.
    assert harness.metric_reader("forward_ms.train").read(out) is None
