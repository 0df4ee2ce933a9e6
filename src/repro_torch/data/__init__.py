"""The synthetic, deterministic data pipeline of the training path."""
