"""The port's FFmpeg decoder (rspnet_tpu_torch/native/) against the JAX
package's (rspnet_tpu/native/), on the CPU.

Both build the same C++ source; the port builds it with ``g++`` into
``build/rspnet_tpu_torch/native/`` at first use. On MJPG videos written
with OpenCV, the same calls on a reader of each package give the same
frames bit for bit: unsorted indices, a seek back then forth, requests
past the end (padded with the last frame, also on repeated calls), an
odd width (RGB rows of 510 bytes, the aligned staging buffer), scaled
decode with a change of size, and two threads decoding at once. Against
OpenCV the port stays within the JAX tests' limits (2 levels at full
size, a mean of 6 scaled). ``open_video`` takes the native decoder, and
OpenCV with the build error logged when the build fails; the loader's
samples equal the JAX loader's.
"""
import logging
import threading

import numpy as np
import pytest

from rspnet_tpu_torch.data import video_reader
from rspnet_tpu_torch.native import video_decode

cv2 = pytest.importorskip("cv2")


def _write(path, w, h, frames, fill):
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 25,
                         (w, h))
    for t in range(frames):
        f = np.zeros((h, w, 3), np.uint8)
        fill(f, t)
        wr.write(f[..., ::-1])
    wr.release()
    return str(path)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("vids")

    def ramp(f, t):
        f[:, :, 1] = t * 4
        f[:, : f.shape[1] // 2, 0] = 200 - t * 3

    out = {"plain": _write(d / "t.avi", 64, 48, 60, ramp)}
    for v in range(2):
        def odd(f, t, v=v):
            f[:, :, 0] = t * 3
            f[:, :, 2] = v * 50
            f[t % 128:, 7::13, 1] = 90
        out[f"odd{v}"] = _write(d / f"odd{v}.avi", 170, 128, 64, odd)
    return out


@pytest.fixture(scope="module")
def jax_native():
    from rspnet_tpu.native import video_decode as jvd
    if not jvd.is_available():
        pytest.skip("the JAX package's native decoder is unavailable")
    return jvd


@pytest.fixture(scope="module")
def native():
    if not video_decode.is_available():
        pytest.skip(f"native decoder unavailable: {video_decode.build_error}")
    return video_decode


def test_builds_into_the_build_dir(native):
    so = native.library_path()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert so.parent.parts[-3:] == ("build", "rspnet_tpu_torch", "native")
    assert not list(native.SOURCE.parent.glob("*.so"))


# each case: the video and the calls, in order, on one reader; an entry is
# (indices, out_wh or None)
CASES = {
    "unsorted": ("plain", [([5, 50, 0, 20], None)]),
    "seek_back_forth": ("plain", [([40, 45], None), ([1, 2], None),
                                  ([55, 56], None), ([30], None)]),
    "past_eof": ("plain", [([58, 59, 60, 70], None), ([65, 66], None),
                           ([0], None), ([100], None)]),
    "odd_width": ("odd0", [([0, 13, 40, 63], None), ([2, 3], None)]),
    "scaled": ("odd1", [([0, 9, 33], (171, 128)), ([10, 11], (64, 48)),
                        ([12], None), ([50, 70], (85, 64))]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_frames_equal_jax(case, videos, native, jax_native):
    name, calls = CASES[case]
    mine = native.RspVideoReader(videos[name])
    ref = jax_native.RspVideoReader(videos[name])
    assert (mine.num_frames, mine.fps, mine.width, mine.height) == (
        ref.num_frames, ref.fps, ref.width, ref.height)
    for idx, wh in calls:
        got, want = mine.get_batch(idx, wh), ref.get_batch(idx, wh)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{idx} {wh}")
    mine.close()
    ref.close()


def test_two_threads(videos, native, jax_native):
    jobs = [(videos[f"odd{v}"], list(range(s, 64, 7)), wh)
            for v in range(2) for s, wh in ((0, None), (3, (86, 64)))]
    want = []
    for path, idx, wh in jobs:
        with jax_native.RspVideoReader(path) as r:
            want.append(r.get_batch(idx, wh))
    got = [None] * len(jobs)

    def work(k):
        for j in range(k, len(jobs), 2):
            path, idx, wh = jobs[j]
            with native.RspVideoReader(path) as r:
                for _ in range(3):
                    got[j] = r.get_batch(idx, wh)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_within_the_jax_limits_of_opencv(videos, native):
    for name in ("plain", "odd0"):
        idx = [0, 7, 33, 59]
        with native.RspVideoReader(videos[name]) as r:
            got = r.get_batch(idx).astype(int)
            scaled = r.get_batch(idx, (85, 64)).astype(int)
        c = video_reader.CvVideoReader(videos[name])
        ref = c.get_batch(idx)
        c.close()
        assert np.abs(got - ref.astype(int)).max() <= 2
        ref_scaled = np.stack([cv2.resize(f, (85, 64),
                                          interpolation=cv2.INTER_LINEAR)
                               for f in ref]).astype(int)
        assert np.abs(scaled - ref_scaled).mean() < 6


def test_open_video_and_the_fallback(videos, native, monkeypatch, tmp_path,
                                     caplog):
    with video_reader.open_video(videos["plain"]) as r:
        assert isinstance(r, native.RspVideoReader)
    # a build that fails: OpenCV decodes, the error is logged and kept
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "build_error", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "librspnet_video_x.so")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with caplog.at_level(logging.WARNING):
        with video_reader.open_video(videos["plain"]) as r:
            assert isinstance(r, video_reader.CvVideoReader)
            assert r.get_batch([3]).shape == (1, 48, 64, 3)
    assert "no-such-compiler" in native.build_error
    assert "decoding with OpenCV" in caplog.text
    assert not native.is_available()


def test_loader_samples_equal_jax(videos, native, jax_native):
    """The port's ``_load_one`` on real files (the native decoder, decode
    -time scaling) against the JAX package's."""
    from rspnet_tpu.data import pipeline as jpipe
    from rspnet_tpu_torch.data import pipeline as ppipe

    class Sample:
        def __init__(self, p):
            self.video_path, self.class_index = p, 1

    catalog = [Sample(videos[k]) for k in ("odd0", "odd1", "plain")]
    kw = dict(clip_len=8, num_clips=2, out_size=32, batch_size=1,
              train=True, num_workers=0, seed=0, device_geometry=True,
              decode_size=(40, 48))
    for i in range(len(catalog)):
        got, gl = ppipe._load_one(catalog, ppipe.PipelineConfig(**kw), i,
                                  np.random.default_rng(i))
        want, wl = jpipe._load_one(catalog, jpipe.PipelineConfig(**kw), i,
                                   np.random.default_rng(i))
        assert gl == wl
        for g, w in zip(got, want):
            assert g.shape == (8, 40, 48, 3)
            np.testing.assert_array_equal(g, w)
