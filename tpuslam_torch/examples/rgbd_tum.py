"""RGB-D TUM driver (the reference's Examples/RGB-D/rgbd_tum.cc). Port of
examples/rgbd_tum.py. The depth images arrive in metres (TUMSequence
applies DepthMapFactor), so the System's depth_map_factor stays 1.

Usage: python -m tpuslam_torch.examples.rgbd_tum <settings.yaml> <sequence_dir> <associations.txt> [out.txt]
"""

from __future__ import annotations

import sys

from tpuslam_torch.examples._driver import DriverRun, drive, report
from tpuslam_torch.io import TUMSequence, load_settings
from tpuslam_torch.pipeline.system import SensorType, System


def run(settings, sequence: str, association: str, out: str = "CameraTrajectory.txt",
        device="cuda", viewer=None, viewer_every: int = 1) -> DriverRun:
    """`viewer`, a LiveViewer, is attached to the System if given and fed
    every `viewer_every` frames."""
    seq = TUMSequence(sequence, association=association,
                      depth_factor=settings.depth_map_factor or 1.0 / 5000.0)
    system = System(settings.cam, SensorType.RGBD, orb=settings.orb, device=device,
                    kf_max_frames=int(settings.fps), th_depth_factor=settings.th_depth_factor)
    if viewer is not None:
        system.attach_viewer(viewer, every=viewer_every)
    res = drive(system, seq, lambda f: system.track_rgbd(f[1], f[2], f[0]))
    system.save_trajectory_tum(out)
    report(res, out)
    return res


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    run(load_settings(argv[0]), argv[1], argv[2], *argv[3:4])


if __name__ == "__main__":
    main()
