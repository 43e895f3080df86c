"""Training: AdamW, the train step and loop, checkpoints, synthetic data."""
