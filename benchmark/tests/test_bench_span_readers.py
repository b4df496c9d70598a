"""The readers of the program's spans (step_launch_ms, step_device_ms,
step_read_wait_ms, upload_ms) on hand-made frame stages: the median over
the frames they take, and nothing where they find nothing."""

import pytest

from benchmark import manifest

READERS = ("step_launch_ms", "step_device_ms", "step_read_wait_ms", "upload_ms")

# Seconds per frame, as the harness hands them over: name -> summed
# samples of the frame. Three frame-step frames (two motion-model, one
# reference-keyframe), a keyframe frame, a lost frame.
FRAMES = [
    {"frame.mm": 0.052, "sys.upload": 0.0021, "track.dispatch": 0.004, "launch.front": 0.0004,
     "launch.mm": 0.0010, "launch.local": 0.0011, "dev.launch.front": 0.0030, "dev.launch.mm": 0.0200,
     "dev.launch.local": 0.0210, "read.verdict": 0.0150, "read.fetch": 0.0200},
    {"frame.ref": 0.040, "sys.upload": 0.0025, "launch.front": 0.0005, "launch.ref": 0.0020,
     "launch.local": 0.0012, "dev.launch.front": 0.0031, "dev.launch.ref": 0.0100,
     "dev.launch.local": 0.0190, "read.fetch": 0.0280, "read.pose": 0.0002},
    {"frame.mm": 0.055, "sys.upload": 0.0019, "launch.front": 0.0004, "launch.mm": 0.0030,
     "launch.local": 0.0013, "dev.launch.front": 0.0029, "dev.launch.mm": 0.0220,
     "dev.launch.local": 0.0230, "read.verdict": 0.0160, "read.fetch": 0.0210},
    {"frame.mm.kf": 0.43, "sys.upload": 0.0030, "launch.mm": 0.0500, "dev.launch.mm": 0.4000,
     "read.fetch": 0.3000, "map.front": 0.17},
    {"frame.lost": 0.1, "sys.upload": 0.0022, "read.fetch": 0.0900},
]
STAGES = {}
for _fs in FRAMES:
    for _k, _v in _fs.items():
        STAGES.setdefault(_k, []).append(_v)

WANT = {
    # frame-step frames: 0.0025, 0.0037, 0.0047 s of launches
    "step_launch_ms": 3.7,
    # 0.0440, 0.0321, 0.0479 s
    "step_device_ms": 44.0,
    # 0.0350, 0.0282, 0.0370 s
    "step_read_wait_ms": 35.0,
    # every frame: 0.0021, 0.0025, 0.0019, 0.0030, 0.0022 s
    "upload_ms": 2.2,
}


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_the_median_of_its_frames(name):
    read = manifest.Manifest().reader(name)
    assert read({"frame_stages": FRAMES, "stages": STAGES}) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_without_spans(name):
    """None on test_bench_discovery's empty context, and on a window of a
    program that records no span (the stages alone)."""
    read = manifest.Manifest().reader(name)
    empty = {"frames": 0, "frame_stages": [], "stages": {}, "syncs": [],
             "counters0": {"keyframes": 0, "captures": 0}, "counters1": {"keyframes": 0, "captures": 0}}
    assert read(empty) is None
    plain = [{"track.dispatch": 0.004, "track.fetch": 0.04}, {"track.stereo_features": 0.002}]
    assert read({"frame_stages": plain, "stages": {"track.dispatch": [0.004], "track.fetch": [0.04],
                                                   "track.stereo_features": [0.002]}}) is None
