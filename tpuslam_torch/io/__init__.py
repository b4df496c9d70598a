"""Dataset readers, settings parsing and the host library. Port of
tpuslam/io/__init__.py: TUM, KITTI and EuRoC sequence loaders and the
OpenCV-YAML settings schema (PyYAML is imported by load_settings alone)."""

from tpuslam_torch.io.datasets import EuRoCSequence, KITTISequence, TUMSequence, load_grayscale
from tpuslam_torch.io.settings import Settings, load_settings
