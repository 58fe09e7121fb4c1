"""The port's CRAM reader (deepvariant_tpu_torch.io.cram) against the JAX
package's and against the BAM of the same reads.

The CRAM files are written by `testing/cram_writer.py` from a seeded
sample, over a grid of block methods, encodings, reference placement,
mate attachment and container sizes; the JAX reader, written earlier and
on its own, is the check on the writer. Every decoded read must equal
the JAX reader's and the BAM's. The runner and the CLI read a CRAM to the
same examples, plans, candidates and gVCF records as the BAM. Where the
JAX package's CRAM route drops what the BAM route does (downsampling,
OQ, tp/t0, the sample name of the @RG line), the port does what the BAM
route does; each such case is pinned here, the JAX side included.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from deepvariant_tpu.io import bam as jbam
from deepvariant_tpu.io import cram as jcram
from deepvariant_tpu.io import native as jnative
from deepvariant_tpu.io.fasta import FastaReader as JFasta
from deepvariant_tpu.make_examples import core as jcore
from deepvariant_tpu.scripts import make_examples as jcli
from deepvariant_tpu_torch.core.types import Range, Variant
from deepvariant_tpu_torch.io import bam as tbam
from deepvariant_tpu_torch.io import cram as tcram
from deepvariant_tpu_torch.io.fasta import FastaReader
from deepvariant_tpu_torch.io.tfrecord import read_tfrecords
from deepvariant_tpu_torch.make_examples import core as tcore
from deepvariant_tpu_torch.scripts import make_examples as tcli
from deepvariant_tpu_torch.testing import cram_writer as cw
from torch_port_util import (
    READ_BATCH_COLUMNS,
    assert_planned_equal,
    cram_sample,
    run_cli_outputs,
    to_package,
    wgs_options,
    write_stage1_inputs,
)

torch.set_num_threads(2)
JAX, PORT = "deepvariant_tpu", "deepvariant_tpu_torch"

# The grid of CRAM layouts: every block method, both encodings, the
# reference embedded and not, mates attached and detached, containers of
# several sizes, and the optional features.
LAYOUTS = {
    "rans1": cw.CramLayout(),
    "rans0-core": cw.CramLayout(method="rans0", core_codes=True),
    "raw-embedded-detached-extra": cw.CramLayout(
        method="raw", embed_reference=True, attach_mates=False,
        extra_features=True),
    "gzip-core-embedded-150": cw.CramLayout(
        method="gzip", core_codes=True, embed_reference=True,
        records_per_container=150),
    "bzip2-extra-97": cw.CramLayout(
        method="bzip2", extra_features=True, records_per_container=97),
    "lzma-core-extra-detached-embedded": cw.CramLayout(
        method="lzma", core_codes=True, extra_features=True,
        attach_mates=False, embed_reference=True,
        records_per_container=400),
}
REGIONS = [("chr1", 0, 600), ("chr1", 900, 1700), ("chr1", 2300, 2500),
           ("chr2", 0, 1200), ("chr2", 500, 520)]
KEEP_ALL = dict(keep_duplicates=True, keep_secondary_alignments=True,
                keep_supplementary_alignments=True,
                keep_failed_vendor_quality_checks=True,
                keep_improperly_placed=True)


@pytest.fixture(scope="module")
def sample():
    return cram_sample()


@pytest.fixture(scope="module")
def paths(sample, tmp_path_factory):
    d = tmp_path_factory.mktemp("cram")
    out = write_stage1_inputs(sample, d)
    for name, layout in LAYOUTS.items():
        out[name] = cw.write_cram(sample, str(d / f"{name}.cram"), layout)
    return out


def _plain(value):
    if isinstance(value, np.ndarray):
        return (value.dtype.str, value.tolist())
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    return value


def read_fields(read):
    return _plain(dataclasses.asdict(read))


def bam_reads(paths):
    """The BAM's reads as Reads, every record kept, with every tag of the
    aux blob in `info` as the CRAM readers give it."""
    with jbam.BamReader(paths["reads"],
                        jbam.ReadRequirements(**KEEP_ALL)) as reader:
        batch = reader.iterate()
    reads = batch.to_reads()
    for read, blob in zip(reads, batch.aux):
        read.info = {k: [v] for k, v in jbam.parse_aux(blob).items()}
    return reads


# -- varints and rANS ---------------------------------------------------------

# tests/test_cram.py's vectors.
ITF8_VECTORS = [(b"\x7f", (127, 1)), (b"\x80\x80", (128, 2)),
                (b"\xff\xff\xff\xff\x0f", (-1, 5))]
LTF8_VECTORS = [(b"\x7f", (127, 1)), (b"\x80\xff", (255, 2))]


@pytest.mark.parametrize("buf,want", ITF8_VECTORS)
def test_itf8_vectors(buf, want):
    assert tcram.read_itf8(buf, 0) == jcram.read_itf8(buf, 0) == want


@pytest.mark.parametrize("buf,want", LTF8_VECTORS)
def test_ltf8_vectors(buf, want):
    assert tcram.read_ltf8(buf, 0) == jcram.read_ltf8(buf, 0) == want


def test_varints_round_trip_through_both_readers():
    values = [0, 1, 127, 128, 16383, 16384, 2 ** 21 - 1, 2 ** 21,
              2 ** 28 - 1, 2 ** 28, 2 ** 31 - 1, -1, -2, -(2 ** 31)]
    for v in values:
        buf = cw.itf8(v) + b"\x00"
        assert tcram.read_itf8(buf, 0) == jcram.read_itf8(buf, 0) == \
            (v, len(buf) - 1)
    for v in [0, 127, 128, 2 ** 14, 2 ** 21, 2 ** 28, 2 ** 35, 2 ** 42,
              2 ** 49, 2 ** 56, 2 ** 63 - 1]:
        buf = cw.ltf8(v)
        assert tcram.read_ltf8(buf, 0) == jcram.read_ltf8(buf, 0) == \
            (v, len(buf))


def _native(mode, monkeypatch):
    """The JAX package's rANS decoder with its native library as built
    here ("native") or switched off ("python")."""
    if mode == "python":
        monkeypatch.setattr(jnative, "_LIB", None)


RANS_SIZES = [0, 1, 2, 3, 4, 5, 7, 64, 1000, 4099, 65536]


@pytest.mark.parametrize("mode", ["native", "python"])
@pytest.mark.parametrize("order", [0, 1])
def test_rans_random_strings(order, mode, monkeypatch):
    _native(mode, monkeypatch)
    rng = np.random.RandomState(order)
    for k, n in enumerate(RANS_SIZES):
        if k % 2:
            data = rng.randint(0, 256, n).astype(np.uint8).tobytes()
        else:  # skewed, as base qualities are
            data = np.minimum(rng.geometric(0.2, n), 255).astype(
                np.uint8).tobytes()
        enc = cw.rans_encode(data, order)
        assert tcram.rans_decode(enc) == data
        assert jcram.rans_decode(enc) == data


def _rans_blocks(path):
    """The compressed payloads of a CRAM's rANS blocks."""
    with open(path, "rb") as f:
        data = f.read()
    out = []
    pos = 26
    while pos + 4 <= len(data):
        container, nxt = jcram._read_container_header(data, pos)
        p = container.body_offset
        while p < container.body_offset + container.length:
            method = data[p]
            _cid, q = jcram.read_itf8(data, p + 2)
            csize, q = jcram.read_itf8(data, q)
            _rsize, q = jcram.read_itf8(data, q)
            if method == 4:
                out.append(data[q:q + csize])
            p = q + csize + 4
        pos = nxt
    return out


@pytest.mark.parametrize("mode", ["native", "python"])
@pytest.mark.parametrize("name", ["rans1", "rans0-core"])
def test_rans_writer_streams(paths, name, mode, monkeypatch):
    _native(mode, monkeypatch)
    blocks = _rans_blocks(paths[name])
    assert len(blocks) > 10
    assert {b[0] for b in blocks} == {0 if name == "rans0-core" else 1}
    for blob in blocks:
        assert tcram.rans_decode(blob) == jcram.rans_decode(blob)


# -- the grid: readers against each other and against the BAM ---------------

@pytest.mark.parametrize("name", list(LAYOUTS))
def test_reads_equal_jax_reader_and_bam(paths, name):
    ours = list(tcram.CramReader(
        paths[name], ref_reader=FastaReader(paths["ref"])).iterate())
    theirs = list(jcram.CramReader(
        paths[name], ref_reader=JFasta(paths["ref"])).iterate())
    want = bam_reads(paths)
    assert len(ours) == len(theirs) == len(want) > 500
    for got, jax_read, bam_read in zip(ours, theirs, want):
        assert read_fields(got) == read_fields(jax_read)
        assert read_fields(got) == read_fields(bam_read)


def test_embedded_reference_needs_no_fasta(paths):
    name = "raw-embedded-detached-extra"
    ours = [read_fields(r) for r in tcram.CramReader(paths[name]).iterate()]
    assert ours == [read_fields(r) for r in bam_reads(paths)]


def test_grid_covers_every_feature_and_mate_form(paths, monkeypatch):
    seen = set()
    plain = tcram.CramReader._read_feature

    def record(self, fc, get, core, external):
        seen.add(fc)
        return plain(self, fc, get, core, external)

    monkeypatch.setattr(tcram.CramReader, "_read_feature", record)
    forms = {}
    for name in LAYOUTS:
        reader = tcram.CramReader(paths[name],
                                  ref_reader=FastaReader(paths["ref"]))
        cfs = [rec["cf"] for rec in reader._records()]
        forms[name] = (sum(cf & 0x4 != 0 for cf in cfs),
                       sum(cf & 0x2 != 0 for cf in cfs))
    assert set("XIDSNHBiQq") <= seen, seen
    for name, layout in LAYOUTS.items():
        attached, detached = forms[name]
        assert detached > 0
        assert (attached > 0) == layout.attach_mates, name


def _batch_reader(package, path, ref, **kwargs):
    cram = jcram if package == JAX else tcram
    bam = jbam if package == JAX else tbam
    return cram.CramBatchReader(
        path, ref_reader=ref,
        requirements=bam.ReadRequirements(min_mapping_quality=5), **kwargs)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_batch_reader_queries(paths, name):
    """CramBatchReader.query gives the BamReader's batch; against the JAX
    package's CRAM batch it differs only where it gives the BAM's: the
    flag of reads whose mate is unmapped (0x8, which a Read cannot
    carry), the aux blobs (empty there), and HP, which the JAX reader
    fills at query time and the port, as BamReader, on parse_hp_tags."""
    ours = _batch_reader(PORT, paths[name], FastaReader(paths["ref"]))
    theirs = _batch_reader(JAX, paths[name], JFasta(paths["ref"]))
    with tbam.BamReader(paths["reads"], tbam.ReadRequirements(
            min_mapping_quality=5)) as bam:
        for region in REGIONS:
            rng = Range(*region)
            got, want = ours.query(rng), bam.query(rng)
            jax_batch = theirs.query(to_package(rng, JAX))
            assert len(got) == len(want) == len(jax_batch) > 0
            assert got.name == want.name == jax_batch.name
            assert got.aux == want.aux
            for col in READ_BATCH_COLUMNS:
                np.testing.assert_array_equal(getattr(got, col),
                                              getattr(want, col), col)
                if col not in ("flag", "hp"):
                    np.testing.assert_array_equal(
                        getattr(got, col), getattr(jax_batch, col), col)
            np.testing.assert_array_equal(got.flag & 0xFFF7,
                                          jax_batch.flag)
            assert not got.hp.any()
            ours.parse_hp_tags(got)
            np.testing.assert_array_equal(got.hp, jax_batch.hp)
            assert set(jax_batch.aux) == {b""}


def test_crai_queries(paths):
    """CramReader.query decodes only the containers the .crai names and
    returns the reads that overlap the region, as the JAX reader does."""
    name = "bzip2-extra-97"
    ours = tcram.CramReader(paths[name], ref_reader=FastaReader(paths["ref"]))
    theirs = jcram.CramReader(paths[name], ref_reader=JFasta(paths["ref"]))
    every = list(ours.iterate())
    n_containers = len(ours._load_crai())
    assert n_containers > 8
    decoded = []
    plain = ours._decode_container

    def counting(container):
        decoded.append(container)
        return plain(container)

    ours._decode_container = counting
    for region in REGIONS + [("chr3", 0, 10)]:
        rng = Range(*region)
        got = ours.query(rng)
        want = [r for r in every if r.reference_name == rng.reference_name
                and r.position < rng.end
                and r.position + tcram._ref_span(r) > rng.start]
        assert [read_fields(r) for r in got] == [read_fields(r) for r in want]
        assert [read_fields(r) for r in got] == [
            read_fields(r) for r in theirs.query(to_package(rng, JAX))]
    assert 0 < len(decoded) < n_containers * len(REGIONS) / 2


def test_batch_reader_header(paths):
    reader = _batch_reader(PORT, paths["rans1"], FastaReader(paths["ref"]))
    with tbam.BamReader(paths["reads"]) as bam:
        assert reader.header.contigs == bam.header.contigs
        assert reader.header.sample_names() == bam.header.sample_names() \
            == ["synthetic"]
        assert reader.header_text == bam.header.text


# -- the runner and the CLI ---------------------------------------------------

RUNNER_REGIONS = ["chr1:1-2,500", "chr2:1-1,200"]


def run_runner(package, paths, reads, tmp, tag, plans=None, **overrides):
    """The WGS runner (realigner off) over the sample with the examples
    (or a plan sink), candidates and gVCF TFRecords uncompressed; returns
    their bytes."""
    core = jcore if package == JAX else tcore
    files = {k: str(tmp / f"{package}-{tag}.{k}.tfrecord")
             for k in ("examples", "candidates", "gvcf")}
    options = wgs_options(
        package, dict(paths, reads=reads), regions=RUNNER_REGIONS,
        examples_filename=files["examples"] if plans is None else "",
        candidates_filename=files["candidates"],
        gvcf_filename=files["gvcf"])
    for key, value in overrides.items():
        setattr(options, key, value)
    if plans is None:
        core.make_examples_runner(options)
    else:
        core.make_examples_runner(options, plan_sink=plans.append)
    return {k: open(p, "rb").read() for k, p in files.items()
            if os.path.exists(p)}


def test_runner_outputs_from_cram(paths, tmp_path):
    """The port's runner on the CRAM writes the port's BAM outputs and, with
    the sample name given (the JAX package's CRAM route does not take it
    from the @RG line), the JAX runner's CRAM outputs, byte for byte."""
    cram = paths["rans1"]
    got = run_runner(PORT, paths, cram, tmp_path, "cram")
    assert set(got) == {"examples", "candidates", "gvcf"}
    assert len(got["examples"]) > 10000
    assert got == run_runner(PORT, paths, paths["reads"], tmp_path, "bam")
    named = dict(sample_name="synthetic")
    assert run_runner(PORT, paths, cram, tmp_path, "cram-named", **named) \
        == run_runner(JAX, paths, cram, tmp_path, "cram-named", **named)


def test_runner_plans_from_cram(paths, tmp_path):
    """The plans from a CRAM are the BAM's, bit for bit. The JAX
    package's CRAM plans differ from its BAM plans in the per-row HP
    only: its CRAM reader fills HP at query time, where BamReader leaves
    it to parse_hp_tags (and the WGS options never call it)."""
    got, bam = [], []
    run_runner(PORT, paths, paths["rans0-core"], tmp_path, "c", plans=got)
    run_runner(PORT, paths, paths["reads"], tmp_path, "b", plans=bam)
    assert len(got) == len(bam) > 20
    assert_planned_equal(got, bam)
    named = dict(sample_name="synthetic")
    ours, jax_cram, jax_bam = [], [], []
    run_runner(PORT, paths, paths["rans0-core"], tmp_path, "cn", plans=ours,
               **named)
    run_runner(JAX, paths, paths["rans0-core"], tmp_path, "jc",
               plans=jax_cram, **named)
    run_runner(JAX, paths, paths["reads"], tmp_path, "jb", plans=jax_bam,
               **named)
    assert_planned_equal(ours, [to_package(p, PORT) for p in jax_bam])
    with_hp = 0
    for theirs, want in zip(jax_cram, jax_bam):
        with_hp += bool(theirs.plan["hp"].any())
        theirs.plan["hp"] = want.plan["hp"]
    assert with_hp > 0
    assert_planned_equal(ours, [to_package(p, PORT) for p in jax_cram])


def test_cli_reads_cram(paths, tmp_path):
    cram = dict(paths, reads=paths["lzma-core-extra-detached-embedded"])
    got = run_cli_outputs(tcli, cram, str(tmp_path / "port"), [], shards=2)
    assert len(got["examples"]) == 2
    assert got == run_cli_outputs(tcli, paths, str(tmp_path / "bam"), [],
                                  shards=2)
    named = ["--sample_name", "synthetic"]
    assert run_cli_outputs(tcli, cram, str(tmp_path / "pn"), named) == \
        run_cli_outputs(jcli, cram, str(tmp_path / "jn"), named)


# -- where the JAX package's CRAM route differs from its BAM route ------------

def test_sample_name_comes_from_the_cram_header(paths, tmp_path):
    """Without --sample_name the runner names the calls after the @RG SM
    of the CRAM, as of a BAM; the JAX package's CRAM route keeps
    "default" (its CramBatchReader has no header)."""
    def call_set_names(package, reads):
        tag = f"name-{os.path.basename(reads)}"
        run_runner(package, paths, reads, tmp_path, tag)
        path = tmp_path / f"{package}-{tag}.candidates.tfrecord"
        return {Variant.decode(buf).calls[0].call_set_name
                for buf in read_tfrecords(str(path))}

    assert call_set_names(PORT, paths["rans1"]) == {"synthetic"}
    assert call_set_names(JAX, paths["reads"]) == {"synthetic"}
    assert call_set_names(JAX, paths["rans1"]) == {"default"}


def test_downsample_fraction_draws_as_bam(paths):
    """(a) The port's CramBatchReader keeps the reads BamReader keeps at
    the same fraction and seed, query after query; the JAX package's is
    never given the fraction and keeps every read."""
    ours = _batch_reader(PORT, paths["rans1"], FastaReader(paths["ref"]),
                         downsample_fraction=0.4, random_seed=11)
    kept = 0
    with tbam.BamReader(paths["reads"], tbam.ReadRequirements(
            min_mapping_quality=5), downsample_fraction=0.4,
            random_seed=11) as bam:
        for region in REGIONS:
            got, want = ours.query(Range(*region)), bam.query(Range(*region))
            assert got.name == want.name
            np.testing.assert_array_equal(got.pos, want.pos)
            kept += len(got)
    full = _batch_reader(PORT, paths["rans1"], FastaReader(paths["ref"]))
    total = sum(len(full.query(Range(*r))) for r in REGIONS)
    assert 0.25 * total < kept < 0.55 * total
    with pytest.raises(TypeError):
        _batch_reader(JAX, paths["rans1"], JFasta(paths["ref"]),
                      downsample_fraction=0.4)


def test_runner_downsamples_a_cram_as_a_bam(paths, tmp_path):
    ds = dict(downsample_fraction=0.5, random_seed=5)
    got = run_runner(PORT, paths, paths["rans1"], tmp_path, "ds-c", **ds)
    assert got == run_runner(PORT, paths, paths["reads"], tmp_path, "ds-b",
                             **ds)
    assert got != run_runner(PORT, paths, paths["rans1"], tmp_path, "all")
    # The JAX package ignores the fraction on a CRAM.
    jax_ds = run_runner(JAX, paths, paths["rans1"], tmp_path, "ds-c", **ds)
    assert jax_ds == run_runner(JAX, paths, paths["rans1"], tmp_path, "all")


def test_original_quality_scores_from_a_cram(paths, tmp_path):
    """(b) --use_original_quality_scores on a CRAM substitutes OQ as on a
    BAM; the JAX package's CRAM reader has no OQ substitution, and its
    runner skips it."""
    oq = dict(use_original_quality_scores=True)
    got = run_runner(PORT, paths, paths["rans1"], tmp_path, "oq-c", **oq)
    assert got == run_runner(PORT, paths, paths["reads"], tmp_path, "oq-b",
                             **oq)
    plain = run_runner(PORT, paths, paths["rans1"], tmp_path, "plain")
    assert got["examples"] != plain["examples"]
    assert not hasattr(jcram.CramBatchReader,
                       "apply_original_quality_scores")
    assert run_runner(JAX, paths, paths["rans1"], tmp_path, "oq-c", **oq) \
        == run_runner(JAX, paths, paths["rans1"], tmp_path, "plain")
    assert run_runner(JAX, paths, paths["reads"], tmp_path, "oq-b", **oq) \
        == run_runner(PORT, paths, paths["reads"], tmp_path, "oq-b", **oq)


def test_ultima_tags_from_a_cram(paths):
    """(c) parse_ultima_tags reads tp/t0 from a CRAM batch as from a BAM
    batch; the JAX package's returns 0 and leaves them empty."""
    ours = _batch_reader(PORT, paths["rans0-core"], FastaReader(paths["ref"]))
    theirs = _batch_reader(JAX, paths["rans0-core"], JFasta(paths["ref"]))
    with tbam.BamReader(paths["reads"], tbam.ReadRequirements(
            min_mapping_quality=5)) as bam:
        for region in REGIONS[:3]:
            got, want = ours.query(Range(*region)), bam.query(Range(*region))
            n = ours.parse_ultima_tags(got)
            assert n == bam.parse_ultima_tags(want) > 0
            for a, b in zip(got.tp + got.t0, want.tp + want.t0):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
            jax_batch = theirs.query(to_package(Range(*region), JAX))
            assert theirs.parse_ultima_tags(jax_batch) == 0
            assert set(map(type, jax_batch.tp)) == {type(None)}


def test_runner_homopolymer_channels_from_a_cram(paths, tmp_path):
    """The channels that read tp/t0 paint the CRAM's reads as the BAM's."""
    chans = (1, 2, 3, 4, 5, 6, 19, 28, 29, 30)

    def run(reads, tag):
        options = wgs_options(PORT, dict(paths, reads=reads),
                              regions=["chr1:1,001-2,000"],
                              examples_filename=str(tmp_path / f"{tag}.ex"))
        options.pileup_options.channels = chans
        tcore.make_examples_runner(options)
        return (tmp_path / f"{tag}.ex").read_bytes()

    got = run(paths["rans1"], "hc")
    assert len(got) > 10000
    assert got == run(paths["reads"], "hb")


def test_use_ref_for_cram_changes_nothing(paths, tmp_path):
    """(d) --use_ref_for_cram is parsed and, as in the JAX package, reads
    nothing: an embedded-reference CRAM and one that needs the FASTA
    decode to the same outputs either way."""
    outs = [run_runner(PORT, paths, paths[name], tmp_path, f"{name}-{flag}",
                       use_ref_for_cram=flag)
            for name in ("rans1", "raw-embedded-detached-extra")
            for flag in (True, False)]
    assert all(o == outs[0] for o in outs[1:])
