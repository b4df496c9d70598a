"""OpenCV-YAML settings files -> camera, ORB and tracker settings. Port of
tpuslam/io/settings.py.

Parses the reference's settings schema (e.g. Examples/Monocular/TUM1.yaml):
Camera.{fx,fy,cx,cy,k1,k2,p1,p2,k3,bf,fps,RGB,width,height},
ORBextractor.{nFeatures,scaleFactor,nLevels,iniThFAST,minThFAST}, ThDepth,
DepthMapFactor, and the stereo LEFT.* / RIGHT.* rectification blocks of the
EuRoC settings. A DepthMapFactor above 1 is a scale (5000 per metre for
TUM) and becomes its inverse, the factor that turns raw depth into metres.

OpenCV's YAML needs three fixes for PyYAML: the '%YAML:1.0' directive, the
'!!opencv-matrix' tags, and 'Key:value' without a space. PyYAML is imported
by load_settings alone, so importing this module never needs it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np

from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.ops.orb import ORBConfig


@dataclasses.dataclass
class Settings:
    cam: PinholeCamera
    orb: ORBConfig
    fps: float = 30.0
    rgb: bool = True
    th_depth_factor: float = 40.0
    depth_map_factor: float = 1.0
    # Optional stereo rectification blocks (EuRoC): K, D, R, P per side.
    left_rect: Optional[dict] = None
    right_rect: Optional[dict] = None


def _parse_opencv_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        text = f.read()
    text = re.sub(r"^%YAML:.*$", "", text, flags=re.M)
    text = text.replace("!!opencv-matrix", "")
    text = re.sub(r"^(\s*[A-Za-z0-9_.]+):(\S)", r"\1: \2", text, flags=re.M)
    return yaml.safe_load(text) or {}


def _matrix(node: dict) -> np.ndarray:
    return np.array(node["data"], dtype=np.float64).reshape(int(node["rows"]), int(node["cols"]))


def load_settings(path: str, width: int = 640, height: int = 480) -> Settings:
    """The Settings of one settings file; the image size defaults to
    width x height where the file gives none."""
    d = _parse_opencv_yaml(path)

    def g(key, default=0.0):
        return float(d.get(key, default))

    cam = PinholeCamera(
        fx=g("Camera.fx"), fy=g("Camera.fy"), cx=g("Camera.cx"), cy=g("Camera.cy"),
        k1=g("Camera.k1"), k2=g("Camera.k2"), p1=g("Camera.p1"), p2=g("Camera.p2"),
        k3=g("Camera.k3"), bf=g("Camera.bf"),
        width=int(d.get("Camera.width", width)), height=int(d.get("Camera.height", height)),
    )
    orb = ORBConfig(
        n_features=int(d.get("ORBextractor.nFeatures", 1000)),
        scale_factor=float(d.get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(d.get("ORBextractor.nLevels", 8)),
        ini_th_fast=float(d.get("ORBextractor.iniThFAST", 20)),
        min_th_fast=float(d.get("ORBextractor.minThFAST", 7)),
    )
    depth_factor = float(d.get("DepthMapFactor", 1.0))
    if depth_factor != 0 and depth_factor > 1.0 + 1e-6:
        depth_factor = 1.0 / depth_factor

    left = right = None
    if "LEFT.K" in d:
        left = {k.split(".")[1]: _matrix(d[k]) for k in ("LEFT.K", "LEFT.D", "LEFT.R", "LEFT.P")}
        right = {k.split(".")[1]: _matrix(d[k]) for k in ("RIGHT.K", "RIGHT.D", "RIGHT.R", "RIGHT.P")}

    return Settings(
        cam=cam, orb=orb, fps=float(d.get("Camera.fps", 30.0)), rgb=bool(d.get("Camera.RGB", 1)),
        th_depth_factor=float(d.get("ThDepth", 40.0)), depth_map_factor=depth_factor,
        left_rect=left, right_rect=right,
    )
