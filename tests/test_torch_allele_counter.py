"""`deepvariant_tpu_torch.make_examples.allele_counter` against the JAX
package's, on reads decoded from the shared synthetic BAM: per-position
counts and every read's allele record are equal (exact)."""

import dataclasses

import numpy as np
import pytest
import torch

from deepvariant_tpu.core import types as jt
from deepvariant_tpu.io import bam as jbam
from deepvariant_tpu.make_examples import allele_counter as jac
from deepvariant_tpu_torch.core import types as tt
from deepvariant_tpu_torch.io import bam as tbam
from deepvariant_tpu_torch.make_examples import allele_counter as tac
from torch_port_util import (
    STAGE1_REGIONS as REGIONS,
    region_counters as counters,
    stage1_sample,
    write_stage1_inputs,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return write_stage1_inputs(stage1_sample(),
                               tmp_path_factory.mktemp("jax_in"))


def assert_counters_equal(got, want):
    np.testing.assert_array_equal(got.ref_count, want.ref_count)
    assert got.ref_count.dtype == want.ref_count.dtype
    assert got.n_reads_counted == want.n_reads_counted
    assert got.positions_with_alleles() == want.positions_with_alleles()
    for pos in want.positions_with_alleles():
        g, w = got.position_count(pos), want.position_count(pos)
        assert g.ref_supporting_read_count == w.ref_supporting_read_count
        assert g.ref_supporting_read_ids == w.ref_supporting_read_ids
        # The dict order decides the caller's alt and support orders.
        assert list(g.read_alleles) == list(w.read_alleles)
        for rid, rec in w.read_alleles.items():
            assert dataclasses.astuple(g.read_alleles[rid]) == \
                dataclasses.astuple(rec)
        for low in (False, True):
            assert [dataclasses.astuple(a)
                    for a in got.sum_allele_counts(pos, low)] == \
                [dataclasses.astuple(a)
                 for a in want.sum_allele_counts(pos, low)]
            assert got.total_allele_count(pos, low) == \
                want.total_allele_count(pos, low)
    for g, w in zip(got.summary_counts(), want.summary_counts()):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("region", REGIONS, ids=lambda r: "%s:%d-%d" % r)
def test_counts_and_records_match_jax(paths, region):
    want, got = counters(paths, region)
    assert_counters_equal(got, want)
    assert len(want.positions_with_alleles()) > 3


@pytest.mark.parametrize("options", [
    dict(track_ref_reads=True),
    dict(min_base_quality=25, min_mapping_quality=30),
    dict(min_base_quality=0, min_mapping_quality=0, track_ref_reads=True),
    dict(keep_legacy_behavior=True),
], ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()))
def test_counter_options(paths, options):
    for region in (REGIONS[1], REGIONS[5]):
        want, got = counters(paths, region, **options)
        assert_counters_equal(got, want)
    if options.get("track_ref_reads"):
        assert any(got.position_count(p).ref_supporting_read_ids
                   for p in got.positions_with_alleles())


def test_unit_table_matches_jax(paths):
    with jbam.BamReader(paths["reads"]) as j, \
            tbam.BamReader(paths["reads"]) as t:
        jb = j.query(jt.Range("chr1", 1000, 2000))
        tb = t.query(tt.Range("chr1", 1000, 2000))
    idx = np.arange(0, len(jb), 2)
    want = jac.build_unit_table(jb, idx, 1000)
    got = tac.build_unit_table(tb, idx, 1000)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype


def test_empty_batch_and_constants():
    for name in ("REFERENCE", "SUBSTITUTION", "INSERTION", "DELETION",
                 "SOFT_CLIP"):
        assert getattr(tac, name) == getattr(jac, name)
    counter = tac.AlleleCounter(np.frombuffer(b"ACGT", np.uint8),
                                tt.Range("chr1", 5, 9))
    counter.add_batch(tbam.ReadBatch(["chr1"]))
    assert counter.positions_with_alleles() == []
    assert counter.n_reads_counted == 0
