"""Engine utilities: logging, stats, diagnostics, checkpoints, configs."""
