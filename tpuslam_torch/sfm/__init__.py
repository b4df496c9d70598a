"""Geometric solvers: two-view initialization, EPnP RANSAC, Horn Sim3.
Port of tpuslam/sfm."""

from tpuslam_torch.sfm.initializer import TwoViewResult, initialize_two_view
from tpuslam_torch.sfm.pnp import PnPResult, pnp_ransac
from tpuslam_torch.sfm.sim3solver import horn_sim3
