"""The reader of `bn_fused_share.train`: None without the port's
counters and on none counted, the fused share in % otherwise."""

import sys
import types

import pytest

from benchmark import harness
from deepvariant_tpu_torch.utils import trace

METRIC = "bn_fused_share.train"


@pytest.fixture
def recorder(monkeypatch):
    rec = trace.Recorder()
    monkeypatch.setattr(trace, "RECORDER", rec)
    return rec


def test_none_without_the_port_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "deepvariant_tpu_torch.utils.trace",
                        None)
    assert harness.metric_reader(METRIC).read(None) is None


def test_none_without_counters(monkeypatch):
    # The port before its counters: a trace module with spans only.
    bare = types.ModuleType("deepvariant_tpu_torch.utils.trace")
    bare.summary = lambda: {}
    monkeypatch.setitem(sys.modules, "deepvariant_tpu_torch.utils.trace",
                        bare)
    monkeypatch.setattr(sys.modules["deepvariant_tpu_torch.utils"], "trace",
                        bare)
    assert harness.metric_reader(METRIC).read(None) is None


def test_none_when_nothing_was_counted(recorder):
    assert harness.metric_reader(METRIC).read(None) is None


@pytest.mark.parametrize("fused,plain,share", [(376, 0, 100.0),
                                               (3, 1, 75.0), (0, 94, 0.0)])
def test_share_of_fused_counts(recorder, fused, plain, share):
    if fused:
        recorder.count("batch_norm.fused", fused)
    if plain:
        recorder.count("batch_norm.plain", plain)
    recorder.count("other", 5)
    assert harness.metric_reader(METRIC).read(None) == pytest.approx(share)
