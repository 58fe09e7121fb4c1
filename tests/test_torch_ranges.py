"""`deepvariant_tpu_torch.core.ranges` against the JAX package's
`core.ranges`: the same seeded intervals through both, every result
equal (nothing here is approximate)."""

import gzip

import numpy as np
import pytest
import torch

from deepvariant_tpu.core import ranges as jr
from deepvariant_tpu.core import types as jt
from deepvariant_tpu_torch.core import ranges as tr
from deepvariant_tpu_torch.core import types as tt

torch.set_num_threads(2)

CONTIGS = (("chr1", 50_000), ("chr10", 20_000), ("chr2", 31_000))


def _contigs(types):
    return [types.ContigInfo(n, length, i)
            for i, (n, length) in enumerate(CONTIGS)]


def _intervals(seed, n=40):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        name, length = CONTIGS[rng.randint(len(CONTIGS))]
        start = int(rng.randint(0, length - 10))
        out.append((name, start,
                    min(length, start + int(rng.randint(0, 3000)))))
    return out


def _both(intervals, with_contigs=True):
    return tuple(
        mod.RangeSet([types.Range(*i) for i in intervals],
                     _contigs(types) if with_contigs else None)
        for mod, types in ((jr, jt), (tr, tt)))


def _plain(ranges):
    return [(r.reference_name, r.start, r.end) for r in ranges]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("with_contigs", [True, False])
def test_rangeset_merges_and_orders_alike(seed, with_contigs):
    j, t = _both(_intervals(seed), with_contigs)
    assert _plain(t) == _plain(j)
    assert len(t) == len(j) and bool(t) == bool(j)
    assert t.total_bp() == j.total_bp()


@pytest.mark.parametrize("seed", range(4))
def test_set_operations(seed):
    j, t = _both(_intervals(seed))
    j2, t2 = _both(_intervals(seed + 100, n=25))
    assert _plain(t.intersection(t2)) == _plain(j.intersection(j2))
    assert _plain(t.exclude_regions(t2)) == _plain(j.exclude_regions(j2))
    assert _plain(t2.exclude_regions(t)) == _plain(j2.exclude_regions(j))
    rng = np.random.RandomState(seed)
    for _ in range(200):
        name, length = CONTIGS[rng.randint(len(CONTIGS))]
        pos = int(rng.randint(0, length))
        end = pos + int(rng.randint(1, 500))
        assert t.overlaps(name, pos) == j.overlaps(name, pos)
        assert t.overlaps_range(tt.Range(name, pos, end)) == \
            j.overlaps_range(jt.Range(name, pos, end))
        assert t.envelops(name, pos, end) == j.envelops(name, pos, end)
        assert t.variant_overlaps(
            tt.Variant(reference_name=name, start=pos, end=end)) == \
            j.variant_overlaps(
                jt.Variant(reference_name=name, start=pos, end=end))
    assert not t.overlaps("chrUn", 5)


@pytest.mark.parametrize("size", [1, 7, 1000, 25_000, 10**6])
def test_partition(size):
    j, t = _both(_intervals(5))
    assert _plain(t.partition(size)) == _plain(j.partition(size))
    jc = jr.RangeSet.from_contigs(_contigs(jt))
    tc = tr.RangeSet.from_contigs(_contigs(tt))
    assert _plain(tc.partition(size)) == _plain(jc.partition(size))
    with pytest.raises(ValueError):
        list(t.partition(0))


@pytest.mark.parametrize("shards", [1, 2, 3, 8, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_partition_calling_regions(seed, shards):
    j, t = _both(_intervals(seed, n=12))
    got = tr.partition_calling_regions(t, shards)
    want = jr.partition_calling_regions(j, shards)
    assert [_plain(g) for g in got] == [_plain(w) for w in want]
    with pytest.raises(ValueError):
        tr.partition_calling_regions(t, 0)


def test_unknown_contig_raises_alike():
    bad = [("chrM", 1, 5)]
    for mod, types in ((jr, jt), (tr, tt)):
        with pytest.raises(ValueError, match="chrM"):
            mod.RangeSet([types.Range(*i) for i in bad], _contigs(types))


@pytest.mark.parametrize("gz", [False, True])
def test_read_bed_and_from_regions(tmp_path, gz):
    lines = ["# comment", "track name=x", "chr1\t10\t500\tname",
             "chr2\t0\t31000", "", "chr10\t19000\t20000\tn\t0\t+",
             "chr1\t400\t900"]
    path = str(tmp_path / ("r.bed.gz" if gz else "r.bed"))
    with (gzip.open if gz else open)(path, "wt") as f:
        f.write("\n".join(lines) + "\n")
    assert _plain(tr.read_bed(path)) == _plain(jr.read_bed(path))
    specs = [path, "chr10", "chr1:2,001-3,000", "chr2:77"]
    got = tr.RangeSet.from_regions(specs, _contigs(tt))
    want = jr.RangeSet.from_regions(specs, _contigs(jt))
    assert _plain(got) == _plain(want) and len(got) > 3
    with pytest.raises(ValueError, match="bare contig"):
        tr.RangeSet.from_regions(["chr1"])


@pytest.mark.parametrize("value", [
    None, "", "chr20 chr21", "a.bed,chr1:1-5", " chr1 ,  chr2:3-9 ,"])
def test_parse_region_specs(value):
    assert tr.parse_region_specs(value) == jr.parse_region_specs(value)
