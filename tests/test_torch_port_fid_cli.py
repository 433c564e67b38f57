"""The in-loop evaluation of the port's train CLIs and its scoring CLIs, end
to end on the CPU (port only; the reference statistics go to a temporary
directory):

* ``train_stylegan2`` (``stylegan2_tiny``, 8x8) and ``train_gan`` (SNDCGAN
  at full width, 16x16) with ``--fid_embed moments --evaluate_every 2
  --n_eval_avg 2`` for 4 steps, then ``--resume`` to 6: one row of
  ``results_fid_<eval_seed>.csv`` an evaluation under the JAX CLIs' header,
  one file across the restart (``eval_seed`` kept), ``ckpt/best.pt`` at the
  best score, the FID scalars, ``training_progress_<eval_seed>.gif`` decoded
  by pillow with one frame an evaluation, each within the palette's step of
  its grid, the preview PNG, and ``eval_state.npz``;
* ``test_gan_sample_cddls`` on ``best`` by default, and refusing a run
  without one;
* the GIF writer and the PNG reader against pillow (every row filter);
* ``test_fid_is`` and ``test_tf_inception`` on a directory of PNGs with
  ``--embed moments``, against the JAX package's functions on the same
  images;
* ``train_stylegan2 --penalty`` in the run's name and its losses."""

import glob
import json
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import contrad_tpu_torch.evaluate.fid as pfid
from contrad_tpu_torch.evaluate.visual import (
    PALETTE, encode_gif, encode_png, gif_frame, quantize, read_png, write_png)
from torch_port_jax import one_torch_thread  # noqa: F401  (autouse)

SG2 = ["configs/gan/stylegan2/c10_style64.toml", "stylegan2_tiny",
       "--mode", "contrad", "--aug", "simclr", "--lbd_r1", "0.1", "--no_lazy",
       "--device", "cpu", "--print_every", "1", "--evaluate_every", "2",
       "--fid_embed", "moments", "--n_eval_avg", "2", "--override",
       "options.dataset=synthetic_8_256", "options.batch_size=4",
       "options.fid_size=40"]
GAN = ["configs/gan/cifar10/c10_b64.toml", "sndcgan", "--mode", "contrad",
       "--aug", "simclr", "--use_warmup", "--device", "cpu", "--print_every",
       "1", "--evaluate_every", "2", "--fid_embed", "moments", "--n_eval_avg",
       "2", "--override", "options.dataset=synthetic_16_256",
       "options.batch_size=8", "options.fid_size=64"]
HALF_STEP = np.array([255 / 14, 255 / 14, 255 / 6])  # half the palette's step


@pytest.fixture(scope="module")
def stats_dir(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        d = str(tmp_path_factory.mktemp("fid_stats"))
        mp.setattr(pfid, "STATS_DIR", d)
        yield d


def _run_and_resume(main, argv, root):
    first = main(argv + ["options.max_steps=4", "--logdir_root", root])
    resumed = main(argv + ["options.max_steps=6", "--resume", first.logdir,
                           "--logdir_root", root])
    return first, resumed


@pytest.fixture(scope="module")
def runs(stats_dir, tmp_path_factory):
    from contrad_tpu_torch import train_gan, train_stylegan2

    root = str(tmp_path_factory.mktemp("logs"))
    return {"stylegan2_tiny": _run_and_resume(train_stylegan2.main, SG2, root),
            "sndcgan": _run_and_resume(train_gan.main, GAN, root)}


@pytest.mark.parametrize("arch", ["stylegan2_tiny", "sndcgan"])
def test_evaluations_write_the_jax_clis_files(runs, arch, stats_dir):
    from contrad_tpu_torch.utils.checkpoint import restore_checkpoint

    first, resumed = runs[arch]
    logdir = first.logdir
    assert resumed.logdir == logdir
    assert [e["step"] for e in first.evals] == [2, 4]
    assert [e["step"] for e in resumed.evals] == [6]
    size = 8 if "style" in arch else 16
    assert os.path.exists(os.path.join(stats_dir, "moments",
                                       f"synthetic_{size}_256_stats.npz"))
    csvs = glob.glob(os.path.join(logdir, "results_fid_*.csv"))
    assert len(csvs) == 1  # the restart appends to the same file
    seed = csvs[0].rsplit("_", 1)[1][:-4]
    rows = open(csvs[0]).read().splitlines()
    assert rows[0] == "step,fid_0,fid_1,mean"
    table = np.array([[float(v) for v in r.split(",")] for r in rows[1:]])
    assert table[:, 0].tolist() == [2, 4, 6] and np.isfinite(table).all()
    np.testing.assert_allclose(table[:, 1:3].mean(axis=1), table[:, 3])
    evals = first.evals + resumed.evals
    np.testing.assert_allclose([e["fid"] for e in evals], table[:, 3])
    best_step = int(table[np.argmin(table[:, 3]), 0])
    assert restore_checkpoint(logdir, "best")["step"] == best_step
    improved = [int(r[0]) for i, r in enumerate(table)
                if r[3] == table[:i + 1, 3].min()]
    assert [s["step"] for s in first.saves + resumed.saves
            if s["name"] == "best"] == improved

    tags = {}
    for line in open(os.path.join(logdir, "scalars.jsonl")):
        rec = json.loads(line)
        tags.setdefault(rec["tag"], []).append(rec["step"])
    for tag in ("", "/best", "/diversity", "/meanshift"):
        assert tags["gan/test/fid" + tag] == [2, 4, 6]

    frames = [np.load(f) for f in sorted(glob.glob(
        os.path.join(logdir, "eval_gif_frames", "*.npy")))]
    assert len(frames) == 3
    gif = Image.open(os.path.join(logdir, f"training_progress_{seed}.gif"))
    assert gif.n_frames == 3 and gif.info.get("loop") == 0
    for i, frame in enumerate(frames):
        gif.seek(i)
        got = np.asarray(gif.convert("RGB")).astype(np.float64)
        assert got.shape == frame.shape
        assert (np.abs(got - frame) <= HALF_STEP + 0.5).all()
    preview = np.asarray(Image.open(os.path.join(
        logdir, f"real_augment_{seed}.png")))
    assert preview.shape == (size + 4, 8 * (size + 2) + 2, 3)

    with np.load(os.path.join(logdir, "eval_state.npz")) as d:
        assert int(d["eval_seed"]) == int(seed)
        assert np.array_equal(d["fid_history"], table)
        assert float(d["fid_best"]) == table[:, 3].min()
        assert str(d["fid_embedder"]) == "moments"
        assert int(d["gif_n_frames"]) == 3
    log = open(os.path.join(logdir, "log.txt")).read()
    assert f"Eval state restored (eval_seed {seed}, FID best" in log


def test_cddls_samples_from_best_by_default(runs, tmp_path):
    from contrad_tpu_torch import test_gan_sample_cddls
    from contrad_tpu_torch.utils.run_loading import load_run

    logdir = runs["sndcgan"][0].logdir
    _, _, D, _, _ = load_run(logdir, "sndcgan", ckpt="best", device="cpu")
    probe = tmp_path / "lin.npz"
    np.savez(probe, w=np.zeros((D.d_penul, 3), np.float32),
             b=np.zeros(3, np.float32))
    args = [str(probe), "sndcgan", "--n_steps", "1", "--n_samples", "3",
            "--n_classes", "3", "--batch_size", "1", "--device", "cpu"]
    assert test_gan_sample_cddls.parse_args([logdir] + args).ckpt == "best"
    out = test_gan_sample_cddls.main([logdir] + args)
    assert out["samples"] == 3
    shutil.rmtree(out["subdir"])
    bare = tmp_path / "run"
    shutil.copytree(logdir, bare)
    os.remove(bare / "ckpt" / "best.pt")
    with pytest.raises(FileNotFoundError, match="'best'"):
        test_gan_sample_cddls.main([str(bare)] + args)


def test_train_stylegan2_takes_the_penalty(tmp_path):
    from contrad_tpu_torch import train_stylegan2

    history = train_stylegan2.main([
        "configs/gan/stylegan2/c10_style64.toml", "stylegan2_tiny", "--mode",
        "std", "--penalty", "gp", "--no_lazy", "--lbd_r1", "0.1", "--device",
        "cpu", "--print_every", "1", "--no_fid", "--no_gif", "--logdir_root",
        str(tmp_path), "--override", "options.dataset=synthetic_8_64",
        "options.batch_size=4", "options.max_steps=2"])
    assert os.path.relpath(history.logdir, tmp_path).split(os.sep)[3] \
        .startswith("std_gp_R0.1_mix0.9")
    assert all(r["D_penalty"] > 0 and np.isfinite(r["D_loss"])
               for r in history)


# ------------------------------------------------------- GIF and PNG codecs

def write_gif(path, frames):
    h, w = frames[0].shape[:2]
    with open(path, "wb") as f:
        f.write(encode_gif([gif_frame(im) for im in frames], w, h))


def test_gif_writer_against_pillow(tmp_path):
    rng = np.random.default_rng(0)
    ramp = np.tile(np.linspace(0, 255, 300).astype(np.uint8)[None, :, None],
                   (70, 1, 3))
    frames = [rng.integers(0, 256, (70, 300, 3), dtype=np.uint8), ramp,
              ramp[::-1].copy()]
    path = str(tmp_path / "a.gif")
    write_gif(path, frames)
    gif = Image.open(path)
    assert gif.n_frames == 3 and gif.size == (300, 70)
    for i, frame in enumerate(frames):
        gif.seek(i)
        got = np.asarray(gif.convert("RGB"))
        assert np.array_equal(got, PALETTE[quantize(frame)])
        assert (np.abs(got.astype(float) - frame) <= HALF_STEP + 0.5).all()
    write_gif(path, [np.full((1, 1, 3), 200, np.uint8)])
    assert np.asarray(Image.open(path).convert("RGB"))[0, 0].tolist() == \
        PALETTE[quantize(np.full((1, 1, 3), 200, np.uint8))][0, 0].tolist()


@pytest.mark.parametrize("n", [1, 2, 255, 256, 257, 511, 512, 513, 4096,
                               5000])
def test_gif_codes_widen_and_reset_where_pillow_expects(tmp_path, n):
    """A row of ``n`` random pixels: about one new table entry a pixel, so
    the code width grows past 9, 10 and 11 bits, the table fills and is
    cleared, and the stream ends at each side of a width change."""
    row = np.random.default_rng(n).integers(0, 256, (1, n, 3), dtype=np.uint8)
    path = str(tmp_path / "row.gif")
    write_gif(path, [row])
    got = np.asarray(Image.open(path).convert("RGB"))
    assert np.array_equal(got, PALETTE[quantize(row)])


def _png_with_filters(image: np.ndarray) -> bytes:
    """An 8-bit PNG of ``image`` (HWC) whose row ``y`` uses filter
    ``y % 5``, so each of the five filter types is read."""
    h, w, c = image.shape
    x = image.astype(np.int32).reshape(h, w * c)
    rows = []
    for y in range(h):
        kind, prev = y % 5, (x[y - 1] if y else np.zeros(w * c, np.int32))
        left = np.concatenate([np.zeros(c, np.int32), x[y, :-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        rows.append(bytes([kind]) + ((x[y] - pred) & 0xFF).astype(
            np.uint8).tobytes())

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reader_against_pillow(tmp_path, channels):
    rng = np.random.default_rng(channels)
    image = rng.integers(0, 256, (11, 13, channels), dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_png_with_filters(image))
    want = np.asarray(Image.open(path).convert("RGB"))
    assert np.array_equal(read_png(str(path)), want)
    mode = {1: "L", 3: "RGB"}.get(channels)
    if mode:  # pillow's own encoder, and the port's
        Image.fromarray(image.squeeze(-1) if channels == 1 else image,
                        mode).save(path)
        assert np.array_equal(read_png(str(path)), want)
        path.write_bytes(encode_png(image))
        assert np.array_equal(read_png(str(path)), want)


def test_png_reader_refuses_what_it_cannot_read(tmp_path):
    path = tmp_path / "f.png"
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(path)  # 16-bit grey
    with pytest.raises(ValueError, match="8-bit"):
        read_png(str(path))
    path.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(str(path))


# ----------------------------------------------------------- scoring CLIs

@pytest.fixture
def sample_dir(tmp_path):
    d = tmp_path / "samples_1_n30"
    d.mkdir()
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (30, 8, 8, 3), dtype=np.uint8)
    for i, image in enumerate(images):
        write_png(str(d / f"{i}.png"), image)
    files = sorted(f"{i}.png" for i in range(30))  # the CLIs' order
    return d, np.stack([images[int(f[:-4])] for f in files])


def test_fid_is_cli_scores_a_directory(sample_dir, stats_dir):
    import contrad_tpu.evaluate.fid as jfid
    from contrad_tpu.data import get_dataset_ref
    from contrad_tpu_torch import test_fid_is

    d, images = sample_dir
    out = test_fid_is.main([str(d), "--dataset", "synthetic_8_64", "--embed",
                            "moments", "--no_is", "--batch_size", "7",
                            "--device", "cpu"])
    ref = jfid.compute_stats(jfid.moments_embed_fn(
        get_dataset_ref("synthetic_8_64").images))
    want = jfid.calculate_frechet_distance(
        *jfid.compute_stats(jfid.moments_embed_fn(images)), *ref)
    np.testing.assert_allclose(out["fid"], want, rtol=1e-10)
    assert out["n_images"] == 30 and np.isnan(out["is_mean"])
    assert os.path.exists(os.path.join(stats_dir, "moments",
                                       "synthetic_8_64_stats.npz"))
    rows = open(d / "fid_is.csv").read().splitlines()
    assert rows[0] == "n_images,fid,is_mean,is_std" and rows[1].startswith(
        "30,")
    out = test_fid_is.main([str(d), "--stats", os.path.join(
        stats_dir, "moments", "synthetic_8_64_stats.npz"), "--embed",
        "moments", "--no_is", "--size", "10", "--device", "cpu"])
    assert out["n_images"] == 10
    assert len(open(d / "fid_is.csv").read().splitlines()) == 3
    with pytest.raises(ValueError, match="--stats or --dataset"):
        test_fid_is.main([str(d), "--embed", "moments", "--device", "cpu"])


def test_tf_inception_cli_writes_the_reference_logs(sample_dir, tmp_path):
    import contrad_tpu.evaluate.fid as jfid
    from contrad_tpu_torch import test_tf_inception

    d, images = sample_dir
    ref = np.random.default_rng(5).uniform(size=(50, 8, 8, 3))
    mu, sigma = jfid.compute_stats(jfid.moments_embed_fn(ref))
    np.savez(tmp_path / "ref.npz", mu=mu, sigma=sigma)
    out = test_tf_inception.main([str(d), str(tmp_path / "ref.npz"),
                                  "--embed", "moments", "--n_imgs", "20",
                                  "--device", "cpu"])
    want = jfid.calculate_frechet_distance(
        *jfid.compute_stats(jfid.moments_embed_fn(images[:20])), mu, sigma)
    np.testing.assert_allclose(out["fid"], want, rtol=1e-10)
    assert (tmp_path / "fid.log").read_text() == f"{d.name}, {out['fid']}\n"
    assert (tmp_path / "inception.log").read_text() == f"{d.name}, nan, nan\n"
    with pytest.raises(FileNotFoundError, match="no images"):
        test_tf_inception.main([str(tmp_path / "ref.npz"), "x.npz",
                                "--embed", "moments", "--device", "cpu"])
