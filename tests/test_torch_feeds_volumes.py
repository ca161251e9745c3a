"""The port's webdataset and TFRecord feeds through the control plane,
held against the JAX package's on the same published volumes (JAX's
registry in process, each package's controller, each package's Feeder).

* Webdataset token shards: whole (with and without ``--shuffle``) and
  streamed a shard at a time, batch for batch over several epoch wraps;
  the streaming core ``wds_token_stream`` over ``read_window`` of the
  staged tensor, without a Feeder; the "no samples", "no batches" and
  "shards changed since staging" errors, word for word.
* Labeled images: TFRecord-framed tf.Examples and webdataset jpg/cls
  samples, whole and windowed, images and labels equal to JAX's, with
  ``--label-offset -1`` on 1-based labels; ``_check_label``'s message.
* The read engine's ``decode_jpeg_batch`` byte-equal to JAX's, PNG
  through Pillow, a corrupt JPEG's index; ``stage_file_to_device`` as
  JAX's, its progress hook's abort included.
* Three ResNet trainer steps on fed random-texture images from JAX's
  initial weights, the update included: the port's f64 steps within
  2e-5 of JAX's f64 steps; in f32 (see the test) the port's losses
  before the update within twice JAX's own distance from that truth.
"""

from __future__ import annotations

import argparse
import io
import itertools
import shutil
import tarfile

import numpy as np
import pytest
import torch

from oim_tpu.data import feeds as jfeeds
from oim_tpu.data import readers as jreaders
from oim_tpu.data import staging as jstaging
from oim_tpu.feeder import driver as jdriver
from oim_tpu.train import trainer as jtrainer
from oim_tpu_torch.cli import oim_trainer as tcli
from oim_tpu_torch.common import logging as tlogging
from oim_tpu_torch.controller import CUDABackend
from oim_tpu_torch.controller import controller as tcontroller
from oim_tpu_torch.controller.backend import read_window
from oim_tpu_torch.data import feeds as tfeeds
from oim_tpu_torch.data import readers as treaders
from oim_tpu_torch.data import staging as tstaging
from oim_tpu_torch.data import webdataset as twds
from oim_tpu_torch.feeder import driver as tdriver
from oim_tpu_torch.train import trainer as ttrainer
from tests import resnet_fed_step as fed_step
from tests.test_torch_feeder_train import both_clusters, remote

torch.set_num_threads(2)

SEQ, BATCH = 16, 3
IMAGE, CLASSES = 24, 5


@pytest.fixture(autouse=True, scope="module")
def quiet_port_logger():
    prev = tlogging.set_global(tlogging.Logger(level=tlogging.ERROR))
    yield
    tlogging.set_global(prev)


@pytest.fixture(scope="module", autouse=True)
def native_engines():
    """Both packages' read engines built (with the JPEG decoder where the
    compiler finds <jpeglib.h>)."""
    tstaging.build()
    jstaging.build()


def tar_shard(path, samples: list[dict]) -> None:
    """A webdataset shard: each sample's members ``<key>.<ext>``."""
    with tarfile.open(path, "w") as tf:
        for s in samples:
            for ext, payload in s.items():
                if ext == "__key__":
                    continue
                info = tarfile.TarInfo(f"{s['__key__']}.{ext}")
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))


@pytest.fixture(scope="module")
def token_shards(tmp_path_factory):
    """3 shards of samples whose .bin members hold 5-40 int32 tokens (a
    record straddles members and shards), some with a .txt member only;
    the total leaves a partial record at the end."""
    d = tmp_path_factory.mktemp("wds-tokens")
    rng = np.random.default_rng(21)
    paths, k = [], 0
    for i in range(3):
        samples = []
        for _ in range(9):
            s = {"__key__": f"{k:06d}"}
            if k % 7 == 3:
                s["txt"] = b"no tokens here"
            else:
                s["bin"] = rng.integers(0, 256, int(rng.integers(5, 41)),
                                        dtype=np.int32).tobytes()
            samples.append(s)
            k += 1
        path = d / f"shard-{i}.tar"
        tar_shard(path, samples)
        paths.append(str(path))
    return paths


def jpeg_images(n, seed):
    rng = np.random.RandomState(seed)
    imgs = [rng.randint(0, 256, (32, 40, 3), dtype=np.uint8) for _ in range(n)]
    return [jreaders.encode_jpeg(im, quality=85) for im in imgs]


@pytest.fixture(scope="module")
def image_volumes(tmp_path_factory):
    """Two TFRecord files of 1-based ImageNet-convention tf.Examples (JPEG
    payloads, labels 1..CLASSES) and two webdataset shards of jpg/cls
    samples, one of them a PNG."""
    d = tmp_path_factory.mktemp("images")
    payloads = jpeg_images(14, 3)
    labels = [1 + i % CLASSES for i in range(14)]
    tfr = []
    for f in range(2):
        recs = [jreaders.encode_example({"image/encoded": payloads[i],
                                         "image/class/label": labels[i]})
                for i in range(f * 7, f * 7 + 7)]
        path = d / f"train-{f}.tfrecord"
        jreaders.write_tfrecords(path, recs)
        tfr.append(str(path))
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.RandomState(4).randint(0, 256, (20, 30, 3), np.uint8)).save(
        buf, format="PNG")
    wds = []
    for f in range(2):
        samples = [{"__key__": f"{f}{i:04d}", "jpg": payloads[f * 7 + i],
                    "cls": str(labels[f * 7 + i] - 1).encode()} for i in range(7)]
        if f == 1:
            samples[2] = {"__key__": "1png", "png": buf.getvalue(), "cls": b"4"}
        path = d / f"img-{f}.tar"
        tar_shard(path, samples)
        wds.append(str(path))
    return {"tfrecord": tfr, "webdataset": wds}


def args_for(addr, **kw):
    base = dict(registry=addr, controller_id="host-0", volume="vol", volume_file="",
                volume_tfrecord="", volume_webdataset="", feed_window_bytes=0,
                publish_timeout=30.0, shuffle=False, shuffle_seed=0, direct_data=True,
                eval_volume_file="", eval_volume_tfrecord="", eval_volume_webdataset="",
                wds_ext="bin")
    base.update(kw)
    return argparse.Namespace(**base)


def cfgs(model="llama-tiny", **kw):
    common = dict(model=model, batch_size=BATCH, seq_len=SEQ, image_size=IMAGE,
                  num_classes=CLASSES)
    common.update(kw)
    return jtrainer.TrainConfig(**common), ttrainer.TrainConfig(**common)


def both_feeds(n, cfg_kw=None, **kw):
    """n batches of each package's feeder_batches on its own cluster."""
    jcfg, tcfg = cfgs(**(cfg_kw or {}))
    with both_clusters() as ((jaddr, _), (taddr, _)):
        jf = jdriver.Feeder(registry_address=jaddr, controller_id="host-0")
        tf = tdriver.Feeder(registry_address=taddr, controller_id="host-0")
        try:
            jb = list(itertools.islice(
                jfeeds.feeder_batches(args_for(jaddr, **kw), jcfg, None, feeder=jf), n))
            tb = list(itertools.islice(
                tfeeds.feeder_batches(args_for(taddr, **kw), tcfg, None, feeder=tf), n))
        finally:
            jf.close()
            tf.close()
    return jb, tb


def same_batches(jb, tb):
    assert len(jb) == len(tb)
    for i, (a, b) in enumerate(zip(tb, jb)):
        assert a.keys() == b.keys()
        for k in a:
            got, want = np.asarray(a[k]), np.asarray(b[k])
            assert got.dtype == want.dtype and got.shape == want.shape, (i, k)
            np.testing.assert_array_equal(got, want, err_msg=f"batch {i} {k}")


# ------------------------------------------------------ webdataset tokens --


TOKEN_FEEDS = {
    "whole": dict(feed_window_bytes=0),
    "whole-shuffled": dict(feed_window_bytes=0, shuffle=True, shuffle_seed=7),
    "streamed": dict(feed_window_bytes=1 << 20),
}


@pytest.mark.parametrize("name", sorted(TOKEN_FEEDS))
def test_webdataset_token_batches_match_jax(token_shards, name):
    """About 24 records a pass: 30 batches of 3 wrap the volume 3 times."""
    jb, tb = both_feeds(30, volume_webdataset=",".join(token_shards), **TOKEN_FEEDS[name])
    same_batches(jb, tb)
    assert tb[0]["tokens"].shape == (BATCH, SEQ + 1)


def test_token_stream_over_read_window_gives_the_feeders_batches(token_shards):
    """The card's path: ``wds_token_stream`` over ``read_window`` of the
    staged tensor, without a Feeder, gives the streamed feed's batches;
    the whole volume's ``_cycle_token_batches`` gives the same."""
    _, tcfg = cfgs()
    url = ",".join(token_shards)
    with remote(tcontroller, CUDABackend(device="cpu")) as (addr, service):
        f = tdriver.Feeder(registry_address=addr, controller_id="host-0")
        try:
            want = [b["tokens"] for b in itertools.islice(tfeeds.feeder_batches(
                args_for(addr, volume_webdataset=url, feed_window_bytes=1), tcfg, None,
                feeder=f), 30)]
        finally:
            f.close()
        arr = service.get_volume("vol").array
        got = list(itertools.islice(tfeeds.wds_token_stream(
            lambda o, n: read_window(arr, o, n), twds.shard_sizes(token_shards), SEQ + 1,
            BATCH), 30))
        whole = tfeeds._wds_tokens(read_window(arr, 0, 0)[0])
        cycled = [b["tokens"] for b in itertools.islice(
            tfeeds._cycle_token_batches(whole, tcfg, "vol"), 30)]
    for a, b, c in zip(got, want, cycled, strict=True):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def feed_error(pkg, addr, cfg, feeder_mod, prepare=None, **kw):
    f = feeder_mod.Feeder(registry_address=addr, controller_id="host-0")
    try:
        if prepare is not None:
            prepare(f)
        with pytest.raises(SystemExit) as e:
            next(pkg.feeder_batches(args_for(addr, **kw), cfg, None, feeder=f))
    finally:
        f.close()
    return str(e.value)


@pytest.mark.parametrize("case", ["no-samples", "no-batches", "shards-changed"])
def test_webdataset_token_errors_match_jax(token_shards, tmp_path, case):
    jcfg, tcfg = cfgs()
    shards = []
    for p in token_shards:
        shards.append(str(tmp_path / p.rsplit("/", 1)[-1]))
        shutil.copy(p, shards[-1])
    url = ",".join(shards)
    kw = {"no-samples": dict(volume_webdataset=url, wds_ext="npy"),
          "no-batches": dict(volume_webdataset=url, wds_ext="npy", feed_window_bytes=1),
          "shards-changed": dict(volume_webdataset=url, feed_window_bytes=1)}[case]
    prepare = None
    if case == "shards-changed":
        from oim_tpu.spec import pb

        def prepare(f):
            req = pb.MapVolumeRequest(volume_id="vol")
            req.webdataset.shard_urls.extend(shards)
            f.publish(req, timeout=30)
            with open(shards[1], "ab") as fh:  # the shard grows after staging
                fh.write(b"\0" * 512)
    with both_clusters() as ((jaddr, _), (taddr, _)):
        want = feed_error(jfeeds, jaddr, jcfg, jdriver, prepare, **kw)
        if prepare is not None:
            shutil.copy(token_shards[1], shards[1])
        got = feed_error(tfeeds, taddr, tcfg, tdriver, prepare, **kw)
    assert got == want.replace(jaddr, taddr)
    assert {"no-samples": "has no samples with extension 'npy'",
            "no-batches": "produced no 'npy' token batches",
            "shards-changed": "shards changed since staging?"}[case] in got


# ----------------------------------------------------------- image feeds --


IMAGE_FEEDS = {
    "tfrecord-whole": ("tfrecord", dict(feed_window_bytes=0), -1),
    "tfrecord-whole-shuffled": ("tfrecord", dict(feed_window_bytes=0, shuffle=True,
                                                 shuffle_seed=3), -1),
    "tfrecord-windowed": ("tfrecord", dict(feed_window_bytes=1500), -1),
    "webdataset-whole": ("webdataset", dict(feed_window_bytes=0), 0),
    "webdataset-streamed": ("webdataset", dict(feed_window_bytes=1), 0),
}


@pytest.mark.parametrize("name", sorted(IMAGE_FEEDS))
def test_image_batches_match_jax(image_volumes, name):
    """14 samples a pass, 12 batches of 3: the feeds wrap twice. Labels are
    1-based in the TFRecords (--label-offset -1) and 0-based in the
    webdataset cls members."""
    kind, kw, offset = IMAGE_FEEDS[name]
    src = {f"volume_{kind}": ",".join(image_volumes[kind])}
    jb, tb = both_feeds(12, dict(model="resnet50", label_offset=offset), **src, **kw)
    same_batches(jb, tb)
    assert tb[0]["images"].dtype == np.uint8 and tb[0]["images"].shape == (
        BATCH, IMAGE, IMAGE, 3)
    labels = np.concatenate([b["labels"] for b in tb])
    assert labels.min() >= 0 and labels.max() < CLASSES


def test_label_out_of_range_gives_jax_message(image_volumes):
    """Without --label-offset the 1-based label CLASSES is out of range."""
    jcfg, tcfg = cfgs(model="resnet50")
    src = dict(volume_tfrecord=",".join(image_volumes["tfrecord"]))
    with both_clusters() as ((jaddr, _), (taddr, _)):
        want = feed_error(jfeeds, jaddr, jcfg, jdriver, **src)
        got = feed_error(tfeeds, taddr, tcfg, tdriver, **src)
    assert got == want and "--label-offset -1" in got
    for label, origin in ((CLASSES, "y"), (-1, "z"), (CLASSES + 3, "x")):
        with pytest.raises(SystemExit) as je:
            jfeeds._check_label(label, jcfg, origin)
        with pytest.raises(SystemExit) as te:
            tfeeds._check_label(label, tcfg, origin)
        assert str(te.value) == str(je.value)
    assert tfeeds._check_label(1, cfgs(model="resnet50", label_offset=-1)[1], "w") == 0


def test_eval_feed_args_cover_every_kind():
    base = args_for("", volume="train", eval_volume_webdataset="a.tar,b.tar", shuffle=True,
                    feed_window_bytes=1 << 20)
    for kw in ({"eval_volume_webdataset": "a.tar,b.tar"}, {"eval_volume_tfrecord": "x.tfr"},
               {"eval_volume_file": "v.npy"}, {}):
        args = args_for("", volume="train", shuffle=True, feed_window_bytes=1 << 20, **kw)
        want, got = jfeeds.eval_feed_args(args), tfeeds.eval_feed_args(args)
        assert (vars(got) if got else None) == (vars(want) if want else None)
    assert vars(tfeeds.eval_feed_args(base))["volume"] == "train-eval"


# ------------------------------------------------------------ JPEG decode --


def test_decode_jpeg_batch_is_byte_equal_to_jax():
    payloads = jpeg_images(9, 11)
    for size in (16, 32, 40):
        want = jstaging.decode_jpeg_batch(payloads, size)
        got = tstaging.decode_jpeg_batch(payloads, size)
        assert got is not None and got.shape == (9, size, size, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    assert tstaging.decode_jpeg_batch([b"\x89PNG...."], 16) is None
    assert tstaging.decode_jpeg_batch([], 16) is None


def test_corrupt_jpeg_names_its_index():
    payloads = jpeg_images(4, 12)
    payloads[2] = payloads[2][:40]
    with pytest.raises(tstaging.StagingError, match="image 2") as e:
        tstaging.decode_jpeg_batch(payloads, 16)
    with pytest.raises(jstaging.StagingError) as je:
        jstaging.decode_jpeg_batch(payloads, 16)
    assert str(e.value) == str(je.value)


def test_png_decodes_through_pillow_as_jax():
    """A batch holding a PNG goes through the Pillow pool in both."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.RandomState(5).randint(0, 256, (12, 18, 3), np.uint8)).save(
        buf, format="PNG")
    payloads = jpeg_images(3, 13) + [buf.getvalue()]
    jcfg, tcfg = cfgs(model="resnet50")
    got, want = tfeeds._decode_images(payloads, tcfg), jfeeds._decode_images(payloads, jcfg)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(treaders.decode_image(payloads[3]),
                                  jreaders.decode_image(payloads[3]))
    im = np.random.RandomState(6).randint(0, 256, (10, 14, 3), np.uint8)
    assert treaders.encode_jpeg(im, 70) == jreaders.encode_jpeg(im, 70)
    np.testing.assert_array_equal(treaders.resize_image(im, 8), jreaders.resize_image(im, 8))


# --------------------------------------------------- a step on fed images --


@pytest.fixture(scope="module")
def texture_tfrecord(tmp_path_factory):
    """One TFRecord file of ResNet step's images: random-texture JPEGs at
    the model's own size, 1-based labels."""
    n = fed_step.STEPS * fed_step.BATCH
    path = tmp_path_factory.mktemp("texture") / "train.tfrecord"
    jreaders.write_tfrecords(path, [
        jreaders.encode_example({"image/encoded": p, "image/class/label": 1 + i % CLASSES})
        for i, p in enumerate(fed_step.texture_jpegs(n, seed=0))])
    return str(path)


# JAX's own f32 ResNet losses before the update lie 3.2e-6 to 2.0e-4 from
# the f64 truth over five image sets (``python -m tests.resnet_fed_step``).
FED_JAX_F32 = 5e-4


def test_resnet_step_on_fed_images_matches_jax(texture_tfrecord):
    """Three ResNet-50 trainer steps (64x64, 5 classes, batch 8) from
    JAX's initial weights on each package's fed TFRecord batches (the same
    bytes, ``--label-offset -1``). Step 1 runs at lr 0, step 2 at lr > 0,
    so step 3's loss and grad norm read the update.

    The truth is JAX's f64 evaluation of the steps (``tests/
    resnet_fed_step.py``): the port's f64 steps equal it within 2e-5 at
    every step, loss and grad norm (read: 6e-14 before the update, 1.5e-7
    after). In f32 neither package holds 2e-5 of the other: batch norm
    over few samples amplifies f32 rounding through the 53 of them, and
    JAX's own f32 losses lie up to 2.0e-4 from the truth. So, as
    ``tests/test_torch_resnet.py`` holds the gradients, the port's f32
    losses before the update are held within twice JAX's f32 error of the
    truth, and JAX's within FED_JAX_F32. After the update both packages'
    f32 steps lie 1e-3 to 3e-2 from the truth (Adam's first step divides
    each gradient by its own magnitude), so step 3 is held in f64 only."""
    feed = dict(model="resnet50", batch_size=fed_step.BATCH, image_size=fed_step.SIZE,
                label_offset=-1)
    jb, tb = both_feeds(fed_step.STEPS, feed, volume_tfrecord=texture_tfrecord)
    same_batches(jb, tb)
    got = fed_step.spread(tb, fed_step.jax_initial())
    assert max(max(r) for r in got["port_f64"]) <= 2e-5, got
    port, jax_err = (max(r[0] for r in got[k][:2]) for k in ("port_f32", "jax_f32"))
    assert jax_err <= FED_JAX_F32, got
    assert port <= 2 * jax_err, got


def test_trainer_cli_takes_the_image_flags():
    args = tcli.parse_args(["--model", "resnet50", "--volume-tfrecord", "a,b",
                            "--label-offset", "-1", "--eval-volume-webdataset", "c.tar",
                            "--wds-ext", "tok"])
    cfg = tcli.config_from_args(args)
    assert cfg.label_offset == -1 and args.wds_ext == "tok"
    assert tfeeds.eval_feed_args(args).volume_webdataset == "c.tar"


# ---------------------------------------------------- single-device stage --


def test_stage_file_to_device_matches_jax(tmp_path):
    """A file onto one device through the plane, in small chunks: the
    bytes, dtype and shape of JAX's (a -1 dim inferred); a progress hook
    returning False frees the stage and gives None, as JAX's does."""
    vals = np.random.default_rng(8).integers(-5000, 5000, (48, 33), dtype=np.int32)
    path = tmp_path / "v.bin"
    vals.tofile(path)
    got = tstaging.stage_file_to_device(path, "cpu", "int32", (-1, 33), chunk_bytes=1000)
    want = np.asarray(jstaging.stage_file_to_device(path, None, "int32", (-1, 33),
                                                    chunk_bytes=1000))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (48, 33)
    np.testing.assert_array_equal(got.numpy(), want)
    flat = tstaging.stage_file_to_device(path, "cpu")
    assert flat.dtype == torch.uint8 and flat.numel() == vals.nbytes
    seen = []
    assert tstaging.stage_file_to_device(path, "cpu", "int32", chunk_bytes=1000,
                                         progress=lambda n: seen.append(n) or False) is None
    assert seen and jstaging.stage_file_to_device(
        path, None, "int32", chunk_bytes=1000, progress=lambda n: False) is None
    odd = tmp_path / "odd.bin"
    odd.write_bytes(b"\0" * 6)
    with pytest.raises(tstaging.StagingError, match="not a multiple"):
        tstaging.stage_file_to_device(odd, "cpu", "int32")
