"""Command-line tools of the PyTorch port (counterparts of video_segment_tpu/tools/)."""
