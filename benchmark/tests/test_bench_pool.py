"""The pooling layer's readers (`pool_ms.train`, `pool_roofline_pct.train`)
and its byte floor (`benchmark/pool_bytes.py`): the floor pinned for both
configurations, None without the port's pool spans (the port before
them records only the train step's four), the right numbers on a recorder
filled by hand."""

import sys

import pytest

from benchmark import harness, pool_bytes, roofline
from benchmark.roofline import HBM_BYTES_PER_S
from deepvariant_tpu_torch.utils import trace

READERS = ("pool_ms.train", "pool_roofline_pct.train")
WGS, PACBIO = (100, 221, 7), (100, 147, 10)


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def query(self):
        return True

    def elapsed_time(self, end):
        return end.ms - self.ms


def _span(name, start_ms, end_ms):
    return trace.Record(name, None, None, 0, 1, (_Event(start_ms),
                                                 _Event(end_ms)))


class _Out:
    def __init__(self, shape, batch=2048):
        self.facts = {"batch": batch,
                      "flops_per_example": roofline.train_flops(*shape)}


@pytest.fixture
def recorder(monkeypatch):
    rec = trace.Recorder()
    monkeypatch.setattr(trace, "RECORDER", rec)
    return rec


@pytest.mark.parametrize("shape,avg,mx,gb", [
    (WGS, 696_192, 783_040, 12.117868544),
    (PACBIO, 427_520, 506_816, 7.654080512)])
def test_floor_of_both_configurations(shape, avg, mx, gb):
    # Inputs and outputs of the nine box filters and the four max pools
    # of one example; twice (forward, backward) at 2 bytes and 2,048.
    assert pool_bytes.pool_elements(shape) == {"avg": avg, "max": mx}
    assert pool_bytes.step_bytes(_Out(shape).facts) == pytest.approx(
        gb * 1e9)
    assert pool_bytes.step_bytes(_Out(shape, 4).facts) == pytest.approx(
        gb * 1e9 * 4 / 2048)


def test_floor_is_none_for_an_unknown_shape():
    assert pool_bytes.step_bytes({"batch": 8,
                                  "flops_per_example": 1.0}) is None
    assert pool_bytes.step_bytes({}) is None


@pytest.mark.parametrize("metric", READERS)
def test_none_on_the_parents_spans(metric, recorder):
    recorder.add(_span("train.step", 0, 100))
    recorder.add(_span("train.forward", 0, 40))
    assert harness.metric_reader(metric).read(_Out(WGS)) is None


@pytest.mark.parametrize("metric", READERS)
def test_none_without_the_port_module(metric, monkeypatch):
    monkeypatch.setitem(sys.modules, "deepvariant_tpu_torch.utils.trace",
                        None)
    assert harness.metric_reader(metric).read(_Out(WGS)) is None


@pytest.mark.parametrize("shape", [WGS, PACBIO])
def test_readers_give_ms_and_share_per_step(shape, recorder):
    # Two steps of 13 pools each way: 0.2 ms forward, 0.3 ms backward.
    for step in range(2):
        t = 1000.0 * step
        for i in range(13):
            recorder.add(_span("pool.forward", t + i, t + i + 0.2))
            recorder.add(_span("pool.backward", t + 500 + i,
                               t + 500 + i + 0.3))
        recorder.add(_span("train.step", t, t + 900))
    ms = harness.metric_reader("pool_ms.train").read(_Out(shape))
    assert ms == pytest.approx(13 * 0.5)
    share = harness.metric_reader("pool_roofline_pct.train").read(
        _Out(shape))
    floor_ms = pool_bytes.step_bytes(_Out(shape).facts) / \
        HBM_BYTES_PER_S * 1e3
    assert share == pytest.approx(100 * floor_ms / ms)
