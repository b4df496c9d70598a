"""Runnable drivers, the port's counterparts of examples/*.py: dataset
drivers for TUM, KITTI and EuRoC (mono, stereo, RGB-D), a synthetic
end-to-end demo and the AR demo. Run one as

    python -m tpuslam_torch.examples.rgbd_tum <settings.yaml> <seq> <assoc> [out]

Each driver is a `run(...)` that `main(argv)` wraps after load_settings
(PyYAML); `run` takes a Settings built in code as well, and tracks on
`device` ("cuda" unless the caller asks for the CPU)."""
