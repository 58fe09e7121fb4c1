"""tools/vis.py and tools/show_examples.py of the PyTorch port against
the JAX package's.

The examples are the port's labeled examples of a simulated corpus
(seeded template, 20 kb, seed 2). On each, vis gives the same arrays,
channels, RGB composite, locus ids, labels and curation tags as the
JAX module. The port writes an image without a header with its own PNG
encoder, the JAX package with Pillow, so PNGs are compared as pixels
decoded by Pillow, never as bytes; an image with a
header of channel names is drawn by Pillow in both. The show_examples
CLI, with and without the header, must write the same file names,
pixels, curation TSV and examples. The JAX `tests/test_vis_port.py`
cases run once more on the port's module.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import test_vis_port
from deepvariant_tpu.tools import show_examples as jshow
from deepvariant_tpu.tools import vis as jvis
from deepvariant_tpu_torch.core.sharded_files import glob_sharded_inputs
from deepvariant_tpu_torch.io.tfrecord import TFRecordReader
from deepvariant_tpu_torch.tools import show_examples as tshow
from deepvariant_tpu_torch.tools import vis as tvis
from torch_multisample_util import port_twin, run_twin_case, twin_cases
from torch_sim_util import (
    PORT,
    label_corpus,
    simulate,
    write_templates,
)

torch.set_num_threads(2)

TWIN = port_twin(test_vis_port)
CASES = twin_cases(TWIN, ("tmp_path",))


def test_jax_cases_are_collected():
    assert len(CASES) >= 60


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_jax_case_on_the_port(case, tmp_path):
    _id, cls_name, name, params = case
    run_twin_case(TWIN, cls_name, name, params, tmp_path=tmp_path)


@pytest.fixture(scope="module")
def labeled(tmp_path_factory):
    root = tmp_path_factory.mktemp("vis")
    templates = write_templates(root / "templates")
    sim = simulate(PORT, "short", templates, root / "corpus", seed=2,
                   windows=[(5000, 25_000)])
    out = label_corpus(sim, templates["ref"], root / "labeled",
                       "chr20:9000-12000", num_shards=1)
    records = [r for p in glob_sharded_inputs(out["examples"])
               for r in TFRecordReader(p)]
    assert len(records) >= 8
    return dict(out, records=records)


def pixels(path: str) -> tuple:
    image = Image.open(path)
    return image.mode, np.asarray(image)


def test_vis_arrays_and_curation_equal_jax(labeled):
    tags = set()
    for record in labeled["records"]:
        got = {}
        for name, vis in (("jax", jvis), ("port", tvis)):
            channels = vis.channels_from_example(record)
            got[name] = dict(
                image=vis.get_image_array_from_example(record),
                channels=np.stack(channels),
                rgb=vis.convert_6_channels_to_rgb(channels),
                scaled=vis.autoscale_colors_for_png(
                    vis.convert_6_channels_to_rgb(channels)),
                ids=(vis.locus_id_from_variant(
                    vis.variant_from_example(record)),
                    vis.locus_id_with_alt(record), vis.alt_from_example(record),
                    vis.alt_allele_indices_from_example(record),
                    vis.label_from_example(record)),
                numbers=(vis.fraction_low_base_quality(channels),
                         vis.fraction_reads_with_low_mapq(channels),
                         vis.fraction_read_support(channels),
                         vis.pvalue_for_strand_bias(channels),
                         vis.analyze_diff_and_nearby_variants(channels)),
                curation=tuple(str(t) for t in vis.curate_pileup(channels)),
                names=vis._deepvariant_channel_names(len(channels)))
        want, have = got["jax"], got["port"]
        for key in ("image", "channels", "rgb"):
            np.testing.assert_array_equal(have[key], want[key], err_msg=key)
        np.testing.assert_array_equal(have["scaled"][0], want["scaled"][0])
        assert have["scaled"][1] == want["scaled"][1] == "RGB"
        for key in ("ids", "numbers", "curation", "names"):
            assert have[key] == want[key], key
        tags.add(have["curation"])
    assert {t[4] for t in tags} >= {"ReadSupport.HALF"}


@pytest.mark.parametrize("labels", [False, True])
@pytest.mark.parametrize("composite", [None, "RGB"])
def test_draw_pileup_pixels_equal_jax(composite, labels, labeled, tmp_path):
    record = labeled["records"][3]
    out = []
    for name, vis in (("jax", jvis), ("port", tvis)):
        path = str(tmp_path / f"{name}.png")
        image = vis.draw_deepvariant_pileup(
            example=record, composite_type=composite, annotated=labels,
            path=path, scale=2)
        out.append((image.size, image.mode, pixels(path)))
    assert out[1][:2] == out[0][:2]
    assert out[1][2][0] == out[0][2][0]
    np.testing.assert_array_equal(out[1][2][1], out[0][2][1])
    if not labels:
        assert isinstance(image, tvis.PngImage)


@pytest.mark.parametrize("scale", [1, 3])
def test_save_example_png_pixels_equal_jax(scale, labeled, tmp_path):
    image = tvis.get_image_array_from_example(labeled["records"][0])
    decoded = []
    for name, show in (("jax", jshow), ("port", tshow)):
        path = str(tmp_path / f"{name}.png")
        show.save_example_png(image, path, scale=scale)
        decoded.append(pixels(path))
    assert decoded[1][0] == decoded[0][0] == "L"
    np.testing.assert_array_equal(decoded[1][1], decoded[0][1])
    assert decoded[1][1].shape == (scale * image.shape[0],
                                   scale * 7 * (image.shape[1] + 2))


@pytest.mark.parametrize("annotation", [False, True])
def test_show_examples_cli_equals_jax(annotation, labeled, tmp_path):
    outs = {}
    for name, show in (("jax", jshow), ("port", tshow)):
        out = str(tmp_path / name)
        show.main(["--examples", labeled["examples"], "--output", out,
                   "--image_type", "both", "--curate", "--write_tfrecords",
                   "--num_records", "6", "--scale", "2",
                   "--regions", "chr20:9000-12000"]
                  + ([] if annotation else ["--noannotation"]))
        files = sorted(os.listdir(out))
        outs[name] = dict(
            files=files,
            pngs=[pixels(os.path.join(out, f)) for f in files
                  if f.endswith(".png")],
            tsv=open(os.path.join(out, "curation.tsv")).read(),
            records=list(TFRecordReader(
                os.path.join(out, "examples.tfrecord.gz"))))
    want, have = outs["jax"], outs["port"]
    assert have["files"] == want["files"]
    assert have["tsv"] == want["tsv"] and have["records"] == want["records"]
    assert len(have["pngs"]) == 12 and len(have["records"]) == 6
    for (mode, got), (want_mode, expect) in zip(have["pngs"], want["pngs"]):
        assert mode == want_mode
        np.testing.assert_array_equal(got, expect)
