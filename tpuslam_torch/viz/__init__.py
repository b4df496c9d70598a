"""Visualization: offline PNG rendering and a live web viewer. Port of
tpuslam/viz: the reference's Pangolin GL viewer (Viewer, FrameDrawer,
MapDrawer) becomes (a) an offline renderer producing PNGs (PIL, imported
when drawing) and (b) a dependency-free live HTTP viewer
(tpuslam_torch.viz.server.LiveViewer) serving an orbiting 3D map view to any
browser, the headless-friendly forms for a GPU server."""

from tpuslam_torch.viz.render import draw_frame, render_map_topdown
from tpuslam_torch.viz.server import LiveViewer
