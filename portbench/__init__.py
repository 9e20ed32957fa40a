"""portbench: the benchmark of video_features_torch on the card (see
README.md)."""
