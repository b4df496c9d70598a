"""The port's io modules against the JAX package's: load_grayscale without
PIL (bit for bit on grey8, grey16, RGB and RGBA PNGs), the TUM, KITTI and
EuRoC sequences on folders written here, rectification (on a EuRoC-style
settings file written here: the JAX package's own rectifier test reads the
reference's tree, which is not part of this repo), the live runner, and the
host library (the PNG decoder, prefetcher, quadtree oracle, ATE/RPE and
FAST+NMS) held against PIL, numpy and the port's own functions."""

import time

import numpy as np
import pytest
import torch
from PIL import Image

from tpuslam.io import datasets as jax_datasets
from tpuslam.io import rectify as jax_rectify
from tpuslam_torch.io import native
from tpuslam_torch.io.datasets import EuRoCSequence, KITTISequence, TUMSequence, load_grayscale
from tpuslam_torch.io.live import LiveRunner
from tpuslam_torch.io.rectify import StereoRectifier, init_rectify_map, remap_bilinear
from tpuslam_torch.io.settings import load_settings

from test_torch_settings import EUROC

torch.set_num_threads(2)


def _images(rng):
    """Every PNG kind the loaders take, as PIL writes them: noise and smooth
    ramps, so the encoder picks several row filters."""
    ramp = np.add.outer(np.arange(40), np.arange(56)).astype(np.uint8)
    noise = rng.integers(0, 256, (40, 56)).astype(np.uint8)
    return {
        "grey8": Image.fromarray(noise),
        "grey8_ramp": Image.fromarray(ramp),
        "grey16": Image.fromarray(rng.integers(0, 65536, (40, 56)).astype(np.uint16)),
        "grey_alpha": Image.fromarray(np.stack([noise, ramp], -1), "LA"),
        "rgb": Image.fromarray(rng.integers(0, 256, (40, 56, 3)).astype(np.uint8)),
        "rgb_ramp": Image.fromarray(np.stack([ramp, ramp[::-1], noise], -1)),
        "rgba": Image.fromarray(rng.integers(0, 256, (40, 56, 4)).astype(np.uint8)),
    }


@pytest.mark.parametrize("kind", ["grey8", "grey8_ramp", "grey16", "grey_alpha", "rgb", "rgb_ramp",
                                  "rgba"])
def test_load_grayscale_equals_jax_bit_for_bit(tmp_path, rng, kind):
    p = str(tmp_path / f"{kind}.png")
    _images(rng)[kind].save(p)
    want = jax_datasets.load_grayscale(p)
    got = load_grayscale(p)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_load_grayscale_takes_every_rgb_value_as_pil_does(tmp_path):
    """PIL's integer luma on every R and G value at 64 B values."""
    a = np.arange(256, dtype=np.uint8)
    r, g, b = np.meshgrid(a, a, a[::4], indexing="ij")
    img = np.stack([r, g, b], -1).reshape(1024, 4096, 3)
    p = str(tmp_path / "all.png")
    Image.fromarray(img).save(p)
    assert load_grayscale(p).tobytes() == jax_datasets.load_grayscale(p).tobytes()


def test_load_grayscale_refuses_other_formats(tmp_path, rng):
    p = str(tmp_path / "pal.png")
    Image.fromarray(rng.integers(0, 256, (8, 8)).astype(np.uint8)).convert("P").save(p)
    with pytest.raises(ValueError, match="PNG decode failed"):
        load_grayscale(p)
    q = tmp_path / "not.png"
    q.write_bytes(b"GIF89a" + bytes(40))
    with pytest.raises(ValueError, match="PNG decode failed"):
        load_grayscale(str(q))


def _same_items(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert len(x) == len(y) and x[0] == y[0]
        for u, v in zip(x[1:], y[1:]):
            assert (u is None) == (v is None)
            if u is not None:
                assert u.dtype == v.dtype and u.tobytes() == v.tobytes()


def test_tum_sequences_equal_jax(tmp_path, rng):
    (tmp_path / "rgb").mkdir()
    (tmp_path / "depth").mkdir()
    rgb_lines, assoc = ["# timestamp filename"], []
    for i in range(4):
        t = 1305031102.175304 + i / 30
        Image.fromarray(rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)).save(tmp_path / f"rgb/{i}.png")
        Image.fromarray(rng.integers(0, 30000, (24, 32)).astype(np.uint16)).save(tmp_path / f"depth/{i}.png")
        rgb_lines.append(f"{t:.6f} rgb/{i}.png")
        assoc.append(f"{t:.6f} rgb/{i}.png {t + 0.01:.6f} depth/{i}.png")
    (tmp_path / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (tmp_path / "assoc.txt").write_text("\n".join(assoc) + "\n\n")
    root = str(tmp_path)
    _same_items(TUMSequence(root), jax_datasets.TUMSequence(root))
    a = str(tmp_path / "assoc.txt")
    _same_items(TUMSequence(root, association=a), jax_datasets.TUMSequence(root, association=a))
    assert len(TUMSequence(root, association=a)) == 4


@pytest.mark.parametrize("stereo", [True, False])
def test_kitti_sequences_equal_jax(tmp_path, rng, stereo):
    for cam in ("image_0", "image_1") if stereo else ("image_0",):
        (tmp_path / cam).mkdir()
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (20, 30)).astype(np.uint8)).save(tmp_path / cam / f"{i:06d}.png")
    (tmp_path / "times.txt").write_text("0.000000e+00\n1.036400e-01\n2.073480e-01\n")
    _same_items(KITTISequence(str(tmp_path)), jax_datasets.KITTISequence(str(tmp_path)))


@pytest.mark.parametrize("stamps_file", [True, False])
def test_euroc_sequences_equal_jax(tmp_path, rng, stamps_file):
    stamps = ["1403636579763555584", "1403636579813555456", "1403636579863555584"]
    for cam in ("cam0", "cam1"):
        d = tmp_path / "mav0" / cam / "data"
        d.mkdir(parents=True)
        for s in stamps:
            Image.fromarray(rng.integers(0, 256, (20, 30)).astype(np.uint8)).save(d / f"{s}.png")
    ts = None
    if stamps_file:
        ts = str(tmp_path / "stamps.txt")
        (tmp_path / "stamps.txt").write_text("\n".join(stamps[::-1][:2]) + "\n")
    for stereo in (True, False):
        _same_items(EuRoCSequence(str(tmp_path), ts, stereo),
                    jax_datasets.EuRoCSequence(str(tmp_path), ts, stereo))


@pytest.fixture
def euroc_settings(tmp_path):
    p = tmp_path / "EuRoC.yaml"
    p.write_text(EUROC)
    return load_settings(str(p), width=752, height=480)


def test_rectify_maps_equal_jax(euroc_settings):
    s = euroc_settings
    for side in (s.left_rect, s.right_rect):
        got = init_rectify_map(side["K"], side["D"], side["R"], side["P"], 752, 480)
        want = jax_rectify.init_rectify_map(side["K"], side["D"], side["R"], side["P"], 752, 480)
        for a, b in zip(got, want):
            assert a.dtype == np.float32 and a.tobytes() == b.tobytes()
    assert np.abs(got[0] - np.arange(752)[None, :]).max() > 1.0  # EuRoC moves pixels


def test_remap_bilinear_equals_jax(rng, euroc_settings):
    """The EuRoC maps (edges clamped) and an identity grid, within 1e-4
    (the JAX package's arithmetic in the same dtypes: equal in fact)."""
    s = euroc_settings
    img = rng.uniform(0, 255, (480, 752)).astype(np.float32)
    mx, my = init_rectify_map(s.left_rect["K"], s.left_rect["D"], s.left_rect["R"], s.left_rect["P"],
                              752, 480)
    u, v = np.meshgrid(np.arange(752, dtype=np.float32), np.arange(480, dtype=np.float32))
    for x, y in ((mx, my), (u, v)):
        got = remap_bilinear(torch.from_numpy(img), torch.from_numpy(x), torch.from_numpy(y))
        want = jax_rectify.remap_bilinear(img, x, y)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
        assert got.numpy().tobytes() == want.tobytes()


def test_stereo_rectifier_equals_jax(rng, euroc_settings):
    s = euroc_settings
    L = rng.uniform(0, 255, (480, 752))
    R = rng.uniform(0, 255, (480, 752)).astype(np.float32)
    got = StereoRectifier(s.left_rect, s.right_rect, 752, 480, device="cpu")(L, torch.from_numpy(R))
    want = jax_rectify.StereoRectifier(s.left_rect, s.right_rect, 752, 480)(L, R)
    for g, w in zip(got, want):
        assert g.shape == (480, 752) and g.numpy().tobytes() == w.tobytes()


class _StubSystem:
    """A System stand-in: a slow tracker that records timestamps."""

    def __init__(self, delay=0.03):
        self.delay = delay
        self.seen = []

    def track_monocular(self, img, ts):
        time.sleep(self.delay)
        self.seen.append(ts)
        return np.eye(3), np.zeros(3)


def test_live_runner_drops_stale_frames_and_tracks_latest():
    stub = _StubSystem(delay=0.03)
    got = []
    r = LiveRunner(stub, on_result=lambda i, ts, pose: got.append(ts))
    r.start()
    for i in range(20):
        r.push(None, float(i))
        time.sleep(0.005)  # the producer ~6x faster than the tracker
    while stub.seen and stub.seen[-1] != 19.0 and r.n_tracked + r.n_dropped < r.n_pushed:
        time.sleep(0.02)
    r.stop()
    assert r.n_pushed == 20
    assert r.n_dropped > 0                      # the queue-1 drop policy
    assert r.n_tracked == len(stub.seen) == len(got)
    assert stub.seen == sorted(stub.seen)       # in-order consumption
    assert stub.seen[-1] == 19.0                # the newest frame wins
    assert r.n_tracked + r.n_dropped == r.n_pushed


def test_live_runner_stop_drains_cleanly():
    stub = _StubSystem(delay=0.0)
    r = LiveRunner(stub)
    r.start()
    r.push(None, 0.0)
    time.sleep(0.1)
    r.stop()
    assert r.n_tracked == 1


def test_live_runner_routes_by_sensor():
    calls = []

    class Stub:
        def track_rgbd(self, img, depth, ts):
            calls.append(("rgbd", ts))

        def track_stereo(self, left, right, ts):
            calls.append(("stereo", ts))

    def wait_for(n):
        deadline = time.monotonic() + 10.0
        while r.n_tracked < n and time.monotonic() < deadline:
            time.sleep(0.01)

    r = LiveRunner(Stub())
    r.start()
    r.push("L", 1.0, right="R")
    wait_for(1)
    r.push("I", 2.0, depth="D")
    wait_for(2)
    r.stop()
    assert calls == [("stereo", 1.0), ("rgbd", 2.0)]


# ---------------------------------------------------------------- host library


def test_native_decode_gray8_exact(tmp_path, rng):
    img = rng.integers(0, 255, (40, 56)).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "g.png")
    out = native.decode_png_gray((tmp_path / "g.png").read_bytes())
    np.testing.assert_array_equal(out, img.astype(np.float32))


def test_native_decode_gray16_scaled(tmp_path, rng):
    img = rng.integers(0, 60000, (24, 32)).astype(np.uint16)
    Image.fromarray(img).save(tmp_path / "d.png")
    out = native.decode_png_gray((tmp_path / "d.png").read_bytes(), scale16=1.0 / 5000.0)
    np.testing.assert_allclose(out, img.astype(np.float32) / 5000.0, atol=1e-4)
    raw = native.decode_png_raw((tmp_path / "d.png").read_bytes())
    assert raw.dtype == np.uint16 and raw.shape == (24, 32, 1)
    np.testing.assert_array_equal(raw[..., 0], img)


def test_native_decode_rgb_float_luma(tmp_path, rng):
    """decode_png_gray keeps the JAX package's float luma (not PIL's)."""
    img = rng.integers(0, 255, (20, 20, 3)).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "c.png")
    out = native.decode_png_gray((tmp_path / "c.png").read_bytes())
    exp = 0.299 * img[:, :, 0] + 0.587 * img[:, :, 1] + 0.114 * img[:, :, 2]
    assert np.abs(out - exp).max() < 0.01
    raw = native.decode_png_raw((tmp_path / "c.png").read_bytes())
    np.testing.assert_array_equal(raw, img)


def test_native_decode_truncated_raises(tmp_path, rng):
    Image.fromarray(rng.integers(0, 255, (20, 20)).astype(np.uint8)).save(tmp_path / "t.png")
    data = (tmp_path / "t.png").read_bytes()[:40]
    for decode in (native.decode_png_gray, native.decode_png_raw):
        with pytest.raises(ValueError):
            decode(data)


@pytest.fixture
def png_dir(tmp_path, rng):
    paths, imgs = [], []
    for i in range(12):
        img = rng.integers(0, 255, (48, 64)).astype(np.uint8)
        p = tmp_path / f"img_{i:03d}.png"
        Image.fromarray(img).save(p)
        paths.append(str(p))
        imgs.append(img)
    return paths, imgs


def test_native_prefetcher_in_order_and_exact(png_dir):
    paths, imgs = png_dir
    pf = native.NativePrefetcher(paths, n_threads=3, capacity=4)
    seen = []
    for idx, arr in pf:
        np.testing.assert_array_equal(arr, imgs[idx].astype(np.float32))
        seen.append(idx)
    pf.close()
    assert seen == list(range(len(paths)))


def test_native_prefetcher_skips_a_missing_file(png_dir):
    paths, _ = png_dir
    pf = native.NativePrefetcher(paths[:3] + ["/nonexistent/x.png"] + paths[3:5], n_threads=2, capacity=3)
    seen = [i for i, _ in pf]
    pf.close()
    assert seen == [0, 1, 2, 4, 5]


def test_native_quadtree_budget_and_spread(rng):
    n = 600
    xs = rng.uniform(0, 640, n).astype(np.float32)
    ys = rng.uniform(0, 480, n).astype(np.float32)
    rs = rng.uniform(0, 100, n).astype(np.float32)
    keep = native.distribute_quadtree(xs, ys, rs, (0, 640, 0, 480), 120)
    assert 100 <= keep.sum() <= 120
    counts = np.bincount((ys[keep] > 240).astype(int) * 2 + (xs[keep] > 320).astype(int), minlength=4)
    assert counts.min() > 0.1 * counts.sum()


@pytest.mark.parametrize("fix_scale,s_true", [(False, 0.7), (True, 1.0)])
def test_native_ate_matches_horn(rng, fix_scale, s_true):
    """The C++ Umeyama ATE against the port's horn_sim3, Sim3 and SE3."""
    from tpuslam_torch.geometry.se3 import so3_exp
    from tpuslam_torch.sfm.sim3solver import horn_sim3

    gt = rng.normal(size=(50, 3)) * 2.0
    R_true = so3_exp(torch.tensor([0.2, -0.1, 0.4])).double().numpy()
    est = (gt - np.array([0.3, 1.0, -0.5])) @ R_true / s_true
    est += rng.normal(size=est.shape) * 0.01
    rmse, s, R, t = native.evaluate_ate(est, gt, fix_scale=fix_scale)
    assert abs(s - s_true) < 0.02
    aligned = s * est @ R.T + t
    np.testing.assert_allclose(rmse, np.sqrt(np.mean(np.sum((aligned - gt) ** 2, -1))), rtol=1e-9)
    assert rmse < 0.03
    sj, Rj, tj = horn_sim3(torch.from_numpy(est.astype(np.float32)), torch.from_numpy(gt.astype(np.float32)),
                           torch.ones(len(est)), fix_scale=fix_scale)
    alj = float(sj) * est @ Rj.double().numpy().T + tj.double().numpy()
    np.testing.assert_allclose(rmse, np.sqrt(np.mean(np.sum((alj - gt) ** 2, -1))), rtol=1e-3, atol=1e-5)
    with pytest.raises(ValueError):
        native.evaluate_ate(est[:2], gt[:2])


def test_native_rpe(rng):
    gt = np.cumsum(rng.normal(size=(30, 3)), axis=0)
    est = gt + rng.normal(size=gt.shape) * 0.05
    de, dg = est[1:] - est[:-1], gt[1:] - gt[:-1]
    np.testing.assert_allclose(native.evaluate_rpe(est, gt, delta=1),
                               np.sqrt(np.mean(np.sum((de - dg) ** 2, -1))), rtol=1e-9)
    with pytest.raises(ValueError):
        native.evaluate_rpe(est[:3], gt[:3], delta=3)


def test_native_fast_nms_equals_the_plain_version(rng):
    """The host FAST+NMS against ops/fast.py's plain PyTorch version, with a
    plateau (NMS ties)."""
    from tpuslam_torch.ops.fast import fast_nms_plain

    img = rng.uniform(0, 255, (97, 131)).astype(np.float32)
    img[10:20, 10:20] = 255.0
    got = native.fast_nms_native(img, 7.0)
    want = fast_nms_plain(torch.from_numpy(img)[None], 7.0)[0].numpy()
    np.testing.assert_array_equal(got, want)
