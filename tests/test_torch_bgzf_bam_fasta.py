"""The port's file readers and writers (`io.bgzf`, `io.bam`,
`io.bam_writer`, `io.fasta`) against the JAX package's, on one seeded
synthetic sample (`torch_port_util.stage1_sample`) that the JAX
package's BamWriter wrote once. Everything is exact: written files are
byte-identical, and every ReadBatch is equal field by field, whichever
record decoder the JAX reader took (its native scanner when its C++
library is built, else its Python one; the port always decodes in
numpy/Python)."""

import dataclasses
import filecmp

import numpy as np
import pytest
import torch

from deepvariant_tpu.core import types as jt
from deepvariant_tpu.io import bam as jbam
from deepvariant_tpu.io import bam_writer as jbw
from deepvariant_tpu.io import bgzf as jbgzf
from deepvariant_tpu.io import fasta as jfasta
from deepvariant_tpu_torch.core import types as tt
from deepvariant_tpu_torch.io import bam as tbam
from deepvariant_tpu_torch.io import bam_writer as tbw
from deepvariant_tpu_torch.io import bgzf as tbgzf
from deepvariant_tpu_torch.io import fasta as tfasta
from deepvariant_tpu_torch.testing import synthetic
from torch_port_util import (
    assert_batches_equal,
    stage1_sample,
    to_package,
    write_stage1_inputs,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sample():
    return stage1_sample()


@pytest.fixture(scope="module")
def paths(sample, tmp_path_factory):
    return write_stage1_inputs(sample, tmp_path_factory.mktemp("jax_in"))


# -- BGZF ---------------------------------------------------------------------

@pytest.mark.parametrize("level", [1, 6])
def test_bgzf_writer_bytes_and_offsets(tmp_path, level):
    rng = np.random.RandomState(level)
    # Compressible data, written in pieces that straddle block edges.
    data = np.repeat(rng.randint(65, 70, 60_000).astype(np.uint8),
                     rng.randint(1, 9, 60_000)).tobytes()
    cuts = np.sort(rng.randint(0, len(data), 30)).tolist()
    offsets = {}
    for name, mod in (("j", jbgzf), ("t", tbgzf)):
        seen = []
        with mod.BgzfWriter(str(tmp_path / name), compresslevel=level) as w:
            for a, b in zip([0] + cuts, cuts + [len(data)]):
                w.write(data[a:b])
                seen.append(w.virtual_offset)
            w.flush()
            seen.append(w.virtual_offset)
        offsets[name] = seen
    assert offsets["t"] == offsets["j"]
    assert filecmp.cmp(tmp_path / "j", tmp_path / "t", shallow=False)
    assert tbgzf.is_bgzf(str(tmp_path / "t"))
    assert tbgzf.decompress_all(str(tmp_path / "t")) == data
    assert tbgzf.BGZF_EOF == jbgzf.BGZF_EOF
    plain = tmp_path / "plain"
    plain.write_bytes(b"not gzip at all, just text")
    assert not tbgzf.is_bgzf(str(plain))


@pytest.mark.parametrize("io_threads", [0, 2])
def test_bgzf_reader_offsets_spans_and_cache(paths, io_threads):
    with jbgzf.BgzfReader(paths["reads"]) as j, \
            tbgzf.BgzfReader(paths["reads"], io_threads=io_threads) as t:
        whole = j.read_all()
        assert t.read_all() == whole
        assert t.at_eof()
        # Block starts, from the file itself.
        starts, coff = [], 0
        raw = open(paths["reads"], "rb").read()
        while coff < len(raw):
            starts.append(coff)
            coff += tbgzf._parse_block_header(raw[coff:coff + 18])
        assert len(starts) > 4
        rng = np.random.RandomState(3)
        for _ in range(40):
            block = starts[rng.randint(len(starts) - 1)]
            within = int(rng.randint(0, 3000))
            vo = (block << 16) | within
            n = int(rng.randint(1, 150_000))
            j.seek_virtual(vo)
            t.seek_virtual(vo)
            assert t.virtual_offset == j.virtual_offset == vo
            assert t.read(n) == j.read(n)
            assert t.virtual_offset == j.virtual_offset
        # Spans: ending inside a block, exactly at a block's start, and
        # past the last data block.
        for beg, end in ((starts[1] << 16 | 17, starts[3] << 16 | 900),
                         (starts[0] << 16 | 5, starts[2] << 16),
                         (starts[2] << 16, starts[-1] << 16)):
            for margin in (0, 1 << 10, 1 << 17):
                got = t.read_span(beg, end, tail_margin=margin)
                want = j.read_span(beg, end, tail_margin=margin)
                assert got == want
        with pytest.raises(EOFError):
            t.seek_virtual(starts[-1] << 16)
            t.read_exact(10)


def test_gzi_and_decompress_range(sample, tmp_path):
    fa = synthetic.write_fasta(sample, str(tmp_path / "ref.fa"))
    gz = synthetic.bgzip_with_gzi(fa, str(tmp_path / "ref.fa.gz"), jbgzf)
    gz_t = synthetic.bgzip_with_gzi(fa, str(tmp_path / "t.fa.gz"), tbgzf)
    assert filecmp.cmp(gz, gz_t, shallow=False)
    index = tbgzf.read_gzi(gz + ".gzi")
    np.testing.assert_array_equal(index, jbgzf.read_gzi(gz + ".gzi"))
    assert len(index) > 3
    data = open(fa, "rb").read()
    rng = np.random.RandomState(0)
    edges = [int(u) for u in index[1:, 1]]
    spans = [(0, 10), (edges[0] - 3, edges[0] + 3), (edges[1], edges[2]),
             (len(data) - 50, len(data)), (len(data) - 5, len(data) + 40),
             (7, 7)]
    spans += [tuple(sorted(rng.randint(0, len(data), 2).tolist()))
              for _ in range(20)]
    for a, b in spans:
        got = tbgzf.decompress_range(gz, index, a, b)
        assert got == jbgzf.decompress_range(gz, index, a, b) == data[a:b]


# -- BAM writer ---------------------------------------------------------------

def test_bam_writer_and_index_bytes(sample, paths, tmp_path):
    got = write_stage1_inputs(sample, tmp_path, "deepvariant_tpu_torch")
    assert filecmp.cmp(got["reads"], paths["reads"], shallow=False)
    assert filecmp.cmp(got["reads"] + ".bai", paths["reads"] + ".bai",
                       shallow=False)
    assert filecmp.cmp(got["ref"], paths["ref"], shallow=False)


def test_bam_writer_write_read_bytes(sample, tmp_path):
    batch = synthetic.read_batch(sample, jbam)
    reads = batch.subset(np.arange(0, len(batch), 7)).to_reads()
    out = {}
    for name, types, bw in (("j", jt, jbw), ("t", tt, tbw)):
        contigs = [types.ContigInfo(n, length, i)
                   for i, (n, length) in enumerate(sample["contigs"])]
        out[name] = str(tmp_path / f"{name}.bam")
        with bw.BamWriter(out[name], contigs, sample_name="s1",
                          extra_header_text="@PG\tID:x\n") as w:
            for r in reads:
                w.write_read(to_package(r, types.__name__.rsplit(
                    ".", 2)[0]))
        bw.build_bam_index(out[name], out[name] + ".idx")
    assert filecmp.cmp(out["j"], out["t"], shallow=False)
    assert filecmp.cmp(out["j"] + ".idx", out["t"] + ".idx", shallow=False)


# -- BAM reader ---------------------------------------------------------------

def _regions(sample):
    regions = [("chr1", 0, 1000), ("chr1", 999, 1000), ("chr1", 1000, 1001),
               ("chr1", 0, 6000), ("chr1", 5990, 6000), ("chr1", 4500, 4800),
               ("chr2", 0, 3000), ("chr2", 2400, 2700), ("chr2", 2999, 3000),
               ("chr1", 16384 - 5, 16384 + 5), ("chr3", 0, 100),
               ("chr1", 6000, 7000)]
    rng = np.random.RandomState(11)
    for name, length in sample["contigs"]:
        for _ in range(15):
            a = int(rng.randint(0, length))
            regions.append((name, a, a + int(rng.randint(1, 1500))))
    return regions


def test_header_and_sample_names(paths):
    with jbam.BamReader(paths["reads"]) as j, \
            tbam.BamReader(paths["reads"]) as t:
        assert t.header.text == j.header.text
        assert [dataclasses.astuple(c) for c in t.header.contigs] == \
            [dataclasses.astuple(c) for c in j.header.contigs]
        assert t.header.sample_names() == j.header.sample_names() == \
            ["synthetic"]
        assert t.ref_names == j.ref_names


def test_query_matches_jax_reader(sample, paths):
    with jbam.BamReader(paths["reads"]) as j, \
            tbam.BamReader(paths["reads"]) as t:
        n = 0
        for region in _regions(sample):
            got = t.query(tt.Range(*region))
            assert_batches_equal(got, j.query(jt.Range(*region)))
            n += len(got)
        assert n > 3000
        assert len(t.query(tt.Range("chr3", 0, 100))) == 0


def test_query_at_bgzf_block_edges(paths):
    """Regions that start and end at the first read of each BGZF block,
    where a record spans two blocks and a chunk ends at a block edge."""
    index = tbam.BaiIndex(paths["reads"] + ".bai")
    with jbam.BamReader(paths["reads"]) as j, \
            tbam.BamReader(paths["reads"]) as t:
        everything = t.iterate()
        edges = set()
        for ref_id, name in enumerate(t.ref_names):
            length = t.header.contigs[ref_id].n_bases
            for beg, end in index.chunks_for(ref_id, 0, length):
                assert end > beg
            for offs in index.linear[ref_id]:
                t._bgzf.seek_virtual(int(offs))
                batch = t._scan_records(None, ref_id, 0, 1 << 29)
                if len(batch):
                    edges.add((name, int(batch.pos[0])))
        assert len(everything) > 1500 and edges
        for name, pos in sorted(edges):
            for region in ((name, pos, pos + 1), (name, max(0, pos - 300), pos),
                           (name, pos, pos + 700)):
                assert_batches_equal(t.query(tt.Range(*region)),
                                     j.query(jt.Range(*region)))


def test_iterate_matches_jax_reader(paths):
    with jbam.BamReader(paths["reads"]) as j, \
            tbam.BamReader(paths["reads"]) as t:
        assert_batches_equal(t.iterate(), j.iterate())


REQUIREMENTS = [
    dict(),
    dict(keep_duplicates=True),
    dict(keep_failed_vendor_quality_checks=True),
    dict(keep_secondary_alignments=True),
    dict(keep_supplementary_alignments=True),
    dict(keep_improperly_placed=True),
    dict(min_mapping_quality=5),
    dict(min_mapping_quality=30, keep_duplicates=True,
         keep_secondary_alignments=True, keep_supplementary_alignments=True,
         keep_failed_vendor_quality_checks=True, keep_improperly_placed=True),
]


@pytest.mark.parametrize("switches", REQUIREMENTS,
                         ids=lambda s: "+".join(s) or "default")
def test_read_requirements(paths, switches):
    sizes = []
    with jbam.BamReader(paths["reads"],
                        jbam.ReadRequirements(**switches)) as j, \
            tbam.BamReader(paths["reads"],
                           tbam.ReadRequirements(**switches)) as t:
        for region in (("chr1", 300, 2500), ("chr2", 0, 3000)):
            got = t.query(tt.Range(*region))
            assert_batches_equal(got, j.query(jt.Range(*region)))
            sizes.append(len(got))
        assert_batches_equal(t.iterate(), j.iterate())
    with tbam.BamReader(paths["reads"]) as base:
        default = len(base.query(tt.Range("chr1", 300, 2500)))
    if switches and "min_mapping_quality" not in switches:
        assert sizes[0] > default  # the switch let some reads through
    assert [f.name for f in dataclasses.fields(tbam.ReadRequirements)] == \
        [f.name for f in dataclasses.fields(jbam.ReadRequirements)]


@pytest.mark.parametrize("fraction,seed", [(0.5, 1), (0.1, 2101079370),
                                           (0.9, 7)])
def test_downsample_fraction_keeps_the_draw_order(paths, fraction, seed):
    with jbam.BamReader(paths["reads"], downsample_fraction=fraction,
                        random_seed=seed) as j, \
            tbam.BamReader(paths["reads"], downsample_fraction=fraction,
                           random_seed=seed) as t:
        for region in (("chr1", 0, 3000), ("chr2", 500, 2000),
                       ("chr1", 2000, 6000)):
            got = t.query(tt.Range(*region))
            assert_batches_equal(got, j.query(jt.Range(*region)))
        full = tbam.BamReader(paths["reads"]).query(
            tt.Range("chr1", 2000, 6000))
        assert 0 < len(got) < len(full)


def test_parse_hp_tags_and_aux(paths):
    with jbam.BamReader(paths["reads"]) as j, \
            tbam.BamReader(paths["reads"]) as t:
        got = t.query(tt.Range("chr1", 0, 6000))
        want = j.query(jt.Range("chr1", 0, 6000))
        t.parse_hp_tags(got)
        j.parse_hp_tags(want)
        assert_batches_equal(got, want)
        assert set(got.hp.tolist()) == {0, 1, 2}
        for blob in got.aux[:50]:
            assert tbam.parse_aux(blob) == jbam.parse_aux(blob)
            assert tbam.parse_aux(blob, frozenset(["RG"])) == {"RG": "rg1"}
    blob = (b"XAAq" + b"XcC\xfe" + b"Xss\xfe\xff" + b"XiI\x01\x00\x00\x80"
            + b"XfF\x00\x00\x80\x3f" + b"XZZtext\x00" + b"XHH1AE3\x00"
            + b"XBBs\x03\x00\x00\x00\x01\x00\xfe\xff\x03\x00")
    got, want = tbam.parse_aux(blob), jbam.parse_aux(blob)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_missing_index_and_bad_magic(paths, tmp_path):
    import shutil

    lone = str(tmp_path / "lone.bam")
    shutil.copy(paths["reads"], lone)
    with pytest.raises(FileNotFoundError):
        tbam.BamReader(lone).query(tt.Range("chr1", 0, 10))
    with tbgzf.BgzfWriter(str(tmp_path / "not.bam")) as w:
        w.write(b"SAM\x01" + b"\x00" * 40)
    with pytest.raises(ValueError, match="not a BAM"):
        tbam.BamReader(str(tmp_path / "not.bam"))


def test_read_batch_round_trips_between_packages(sample):
    batch = synthetic.read_batch(sample, jbam)
    there = to_package(batch, "deepvariant_tpu_torch")
    assert type(there) is tbam.ReadBatch
    assert_batches_equal(there, batch)
    assert_batches_equal(to_package(there, "deepvariant_tpu"), batch)
    np.testing.assert_array_equal(there.reference_ends(),
                                  batch.reference_ends())


# -- FASTA --------------------------------------------------------------------

@pytest.fixture(scope="module")
def fasta_paths(sample, paths, tmp_path_factory):
    gz = str(tmp_path_factory.mktemp("fa") / "ref.fa.gz")
    synthetic.bgzip_with_gzi(paths["ref"], gz, jbgzf)
    return {"plain": paths["ref"], "bgzf+gzi": gz}


@pytest.mark.parametrize("kind", ["plain", "bgzf+gzi", "bgzf"])
def test_fasta_reader(sample, fasta_paths, kind, tmp_path):
    path = fasta_paths["plain" if kind == "plain" else "bgzf+gzi"]
    gzi = str(tmp_path / "absent.gzi") if kind == "bgzf" else None
    j = jfasta.FastaReader(path, gzi_path=gzi)
    t = tfasta.FastaReader(path, gzi_path=gzi)
    assert [dataclasses.astuple(c) for c in t.contigs] == \
        [dataclasses.astuple(c) for c in j.contigs]
    assert t.contig_names() == j.contig_names() == ["chr1", "chr2"]
    assert t.has_contig("chr2") and not t.has_contig("chrX")
    assert t.contig_length("chr1") == 6000
    rng = np.random.RandomState(2)
    regions = [("chr1", 0, 6000), ("chr2", 0, 3000), ("chr1", 59, 61),
               ("chr1", 5999, 6000), ("chr2", 120, 120)]
    for name, length in sample["contigs"]:
        for _ in range(25):
            a = int(rng.randint(0, length))
            regions.append((name, a, min(length, a + int(rng.randint(0, 900)))))
    for region in regions:
        got = t.bases(tt.Range(*region))
        np.testing.assert_array_equal(got, j.bases(jt.Range(*region)))
        np.testing.assert_array_equal(
            got, sample["reference"][region[0]][region[1]:region[2]])
        assert t.query(tt.Range(*region)) == j.query(jt.Range(*region))
    for region in (("chr1", 0, 6000), ("chr1", 0, 6001), ("chr1", -1, 5),
                   ("chrX", 0, 5), ("chr2", 10, 5)):
        assert t.is_valid(tt.Range(*region)) == j.is_valid(jt.Range(*region))
    assert (t.bases(tt.Range("chr1", 4500, 4800)) == ord("N")).all()


def test_read_fai_and_in_memory_fasta(fasta_paths):
    got = tfasta.read_fai(fasta_paths["plain"] + ".fai")
    want = jfasta.read_fai(fasta_paths["plain"] + ".fai")
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in want]
    seqs = {"a": "ACGTNNACGT", "b": "GGGTTT"}
    starts = {"a": 100}
    j = jfasta.InMemoryFasta(seqs, starts)
    t = tfasta.InMemoryFasta(seqs, starts)
    assert [dataclasses.astuple(c) for c in t.contigs] == \
        [dataclasses.astuple(c) for c in j.contigs]
    assert t.contig_names() == j.contig_names()
    assert t.contig_length("a") == j.contig_length("a")
    for region in (("a", 100, 104), ("a", 103, 110), ("b", 0, 6), ("b", 2, 3)):
        assert t.query(tt.Range(*region)) == j.query(jt.Range(*region))
        np.testing.assert_array_equal(t.bases(tt.Range(*region)),
                                      j.bases(jt.Range(*region)))
        assert t.is_valid(tt.Range(*region)) == j.is_valid(jt.Range(*region))
    assert t.is_valid(tt.Range("a", 0, 4)) == j.is_valid(jt.Range("a", 0, 4))
