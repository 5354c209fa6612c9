"""Cells cut to what a CPU test can run."""


def small(cell) -> None:
    """A cell cut to what a CPU test can run: narrow stages, short
    meetings of two channels, small buckets, a small split; inference in
    float32 (the CPU's bfloat16 convs round otherwise than the card's, so
    the card's limits do not hold for them)."""
    cell.config["model"]["filter_sizes"] = [8, 8, 8, 16]
    if "inference" in cell.config:
        cell.config["precision"] = "float32"
        cell.config["inference"].update(chunk=256, bucket_frames=512)
        cell.config["weights"].update(calibration_windows=32, calibration_seconds=4)
        cell.traffic.update(meeting_seconds=8, channels=2, pool_meetings=2, offset_max_seconds=2)
        cell.check["sample_frames"] = 128
    else:
        cell.traffic.update(rows=256, batch_size=8, trace_steps=3)
