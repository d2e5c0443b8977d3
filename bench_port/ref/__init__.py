"""Part of the benchmark of slam_toolbox_tpu_torch."""
